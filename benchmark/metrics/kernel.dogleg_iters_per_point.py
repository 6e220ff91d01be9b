"""Trust-region iterations per lane of the point-solve stage: the
program's counters ``dogleg.iterations`` over ``dogleg.points`` over the
window.  The counters come in the stats of the window's Newton solves
(each solve's ``counters``: what the program's regions counted since the
previous solve)."""


def read(data):
    points = iters = 0
    for s in data["newton"]:
        counters = s.get("counters", {})
        points += sum(counters.get("dogleg.points", {}).values())
        iters += sum(counters.get("dogleg.iterations", {}).values())
    return iters / points if points else None
