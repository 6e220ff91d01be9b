"""One Krylov iteration (region ``krylov_solve`` over the iterations the
Newton solves report), in ms: the preconditioner, the operator apply,
the dots and the host's stop test."""


def read(data):
    seconds, _ = data["regions"].get("krylov_solve", (0.0, 0))
    iters = sum(k for s in data["newton"] for k in s["krylov_iters"])
    return 1e3 * seconds / iters if iters else None
