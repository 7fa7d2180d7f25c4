"""CUDA-event milliseconds of ``build_nearfield`` (the stitch) per lens
check of the traced window."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "near field"
MOVES = "lens_check_s"


def read(ctx):
    ms = ctx["spans"].device_ms("build_nearfield")
    return sum(ms) / len(ms) if ms else None
