"""The share of the traced episode in which no kernel, copy or memset ran
on the card, in %."""


def read(data):
    tr = data.get("trace") or {}
    if not tr.get("busy_s") or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
