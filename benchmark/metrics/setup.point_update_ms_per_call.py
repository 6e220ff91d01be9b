"""One point update (the program's span ``setup.point_update``: the
velocity gradient and the material update of one setup chunk, in the
Newton setups, the line-search residuals and the corrector's setup), in
ms. The spans come in the stats of the window's Newton solves (each
solve's ``spans``: what the program's regions recorded since the
previous solve)."""


def read(data):
    rows = [s["spans"]["setup.point_update"] for s in data["newton"]
            if "setup.point_update" in s.get("spans", {})]
    calls = sum(r["calls"] for r in rows)
    if not calls:
        return None
    return 1e3 * sum(r["seconds"] for r in rows) / calls
