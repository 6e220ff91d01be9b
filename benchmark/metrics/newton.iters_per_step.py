"""Newton iterations per load step: ``last_newton_stats["nr_iters"]`` of
every Newton solve in the window, sub-solves included."""


def read(data):
    if not data.get("steps") or not data["newton"]:
        return None
    return sum(s["nr_iters"] for s in data["newton"]) / data["steps"]
