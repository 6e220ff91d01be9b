"""One GMG hierarchy build (the program's span ``gmg.build``: masking,
the Galerkin RAP, the coarse diagonals, the power iterations and the
coarse Cholesky, once a Krylov solve), in ms, over every build in the
window. The spans come in the stats of the window's Newton solves (each
solve's ``spans``: what the program's regions recorded since the previous
solve)."""


def read(data):
    rows = [s["spans"]["gmg.build"] for s in data["newton"]
            if "gmg.build" in s.get("spans", {})]
    calls = sum(r["calls"] for r in rows)
    if not calls:
        return None
    return 1e3 * sum(r["seconds"] for r in rows) / calls
