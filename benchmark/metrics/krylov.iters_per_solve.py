"""Krylov iterations per Newton solve's linear solve: ``krylov_iters`` of
every Newton iteration in the window."""


def read(data):
    iters = [k for s in data["newton"] for k in s["krylov_iters"]]
    return sum(iters) / len(iters) if iters else None
