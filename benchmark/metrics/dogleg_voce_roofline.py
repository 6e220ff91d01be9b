"""The point-solve kernel's share of its roofline, in %: over the traced
episode, the least time of the f32 operations and bytes the launched
points and their reported trust-region iterations need
(``roofline.stage_work``), over the profiler's device time of the
``dogleg_voce`` kernel."""

from benchmark import roofline


def read(data):
    d = data.get("dogleg") or {}
    if not d.get("launches") or not d.get("kernel_s"):
        return None
    ops, nbytes = roofline.stage_work(d["points"], d["iters"])
    return 100.0 * roofline.bound_seconds(ops, nbytes, 4)[0] / d["kernel_s"]
