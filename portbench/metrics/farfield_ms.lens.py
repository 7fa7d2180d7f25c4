"""CUDA-event milliseconds of ``farfield`` and ``focal_metrics`` per lens
check of the traced window."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "far field"
MOVES = "lens_check_s"


def read(ctx):
    ms = ctx["spans"].device_ms("farfield")
    return sum(ms) / len(ms) if ms else None
