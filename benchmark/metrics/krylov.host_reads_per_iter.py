"""Blocking scalar reads of the Krylov solves per Krylov iteration: the
program's counter ``host_reads`` over ``krylov.iterations``, both as
counted with region ``krylov_solve`` the innermost open (the Newton
solves' Krylov solves: their stop tests, refinement rounds and relative
reductions).  The counters come in the stats of the window's Newton
solves (each solve's ``counters``: what the program's regions counted
since the previous solve)."""


def read(data):
    reads = iters = 0
    for s in data["newton"]:
        counters = s.get("counters", {})
        reads += counters.get("host_reads", {}).get("krylov_solve", 0)
        iters += counters.get("krylov.iterations", {}).get("krylov_solve", 0)
    return reads / iters if iters else None
