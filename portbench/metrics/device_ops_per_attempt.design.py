"""Device operations per attempt of the fused design loop: the profiler's
device operations over the attempts of the traced call (each attempt one
FOM batch)."""

UNIT, BETTER, SOURCE = "ops", "lower", "device_trace"
LAYER = "fused design loop"
MOVES = "design_cands_per_s"


def read(ctx):
    s = ctx["summary"]
    if s["ops"] == 0:
        return None
    calls = ctx["state"]["calls"][-ctx["units"]:]
    return s["ops"] / sum(c["attempts"] for c in calls)
