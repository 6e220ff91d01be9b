"""The time loop's own time per load step (BC update, the BC-change
corrector's setup and solve, the averages, the host's bookkeeping): the
window's step clock less the three regions, over the steps, in ms."""


def read(data):
    if not data.get("steps"):
        return None
    regions = sum(s for s, _ in data["regions"].values())
    return 1e3 * (data["step_s"] - regions) / data["steps"]
