"""Share of the traced window in which no operation ran on the device."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "design_cands_per_s"


def read(ctx):
    s = ctx["summary"]
    if s["ops"] == 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
