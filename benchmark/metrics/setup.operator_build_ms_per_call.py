"""One operator build (the program's span ``setup.operator_build``: the PA,
EA or B-bar assembly of one setup chunk and its diagonal), in ms. The
spans come in the stats of the window's Newton solves (each solve's
``spans``: what the program's regions recorded since the previous
solve)."""


def read(data):
    rows = [s["spans"]["setup.operator_build"] for s in data["newton"]
            if "setup.operator_build" in s.get("spans", {})]
    calls = sum(r["calls"] for r in rows)
    if not calls:
        return None
    return 1e3 * sum(r["seconds"] for r in rows) / calls
