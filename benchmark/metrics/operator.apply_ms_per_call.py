"""One operator apply (the program's span ``operator.apply``: gather, PA or
EA contraction, scatter-add), in ms, over every apply in the window. The
spans come in the stats of the window's Newton solves (each solve's
``spans``: what the program's regions recorded since the previous
solve)."""


def read(data):
    rows = [s["spans"]["operator.apply"] for s in data["newton"]
            if "operator.apply" in s.get("spans", {})]
    calls = sum(r["calls"] for r in rows)
    if not calls:
        return None
    return 1e3 * sum(r["seconds"] for r in rows) / calls
