"""One GMG V-cycle (the program's span ``gmg.v_cycle``: one preconditioner
call of the Krylov solve, in either leg of the mixed-precision PCG:
smoothing, transfers, the dense coarse solve and the fine-level applies
inside them), in ms, over every V-cycle in the window. The spans come in
the stats of the window's Newton solves (each solve's ``spans``: what the
program's regions recorded since the previous solve)."""


def read(data):
    rows = [s["spans"]["gmg.v_cycle"] for s in data["newton"]
            if "gmg.v_cycle" in s.get("spans", {})]
    calls = sum(r["calls"] for r in rows)
    if not calls:
        return None
    return 1e3 * sum(r["seconds"] for r in rows) / calls
