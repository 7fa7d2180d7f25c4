"""Device time of one batch of cell solves: the profiler's busy time over
the traced batches."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "cell solve"
MOVES = "solves_per_s"


def read(ctx):
    s = ctx["summary"]
    if s["ops"] == 0:
        return None
    return 1e3 * s["busy_s"] / ctx["units"]
