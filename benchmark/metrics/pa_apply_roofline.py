"""The PA operator apply's share of its roofline, in %: over every apply
in the window (CUDA events around ``MechSystem.apply_k``), the least
time its point tensors, vectors, index tables and operations need on the card over the time
it took."""

from benchmark import roofline


def read(data):
    calls = [a for a in data.get("apply", []) if a["kind"] == "pa"]
    if not calls:
        return None
    least = sum(roofline.bound_seconds(a["ops"], a["bytes"],
                                       a["dtype_bytes"])[0] for a in calls)
    return 100.0 * least / sum(a["seconds"] for a in calls)
