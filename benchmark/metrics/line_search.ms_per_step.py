"""The line search's residuals (region ``line_search``) per load step, in
ms; 0 where every Newton step was taken whole."""


def read(data):
    if not data.get("steps"):
        return None
    seconds, _ = data["regions"].get("line_search", (0.0, 0))
    return 1e3 * seconds / data["steps"]
