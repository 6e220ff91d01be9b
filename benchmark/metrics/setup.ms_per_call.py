"""One setup of the Newton loop (region ``operator_setup``: geometry,
point update, tangent and operator build, in element chunks), in ms."""


def read(data):
    seconds, calls = data["regions"].get("operator_setup", (0.0, 0))
    return 1e3 * seconds / calls if calls else None
