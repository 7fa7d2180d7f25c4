"""Host-clock milliseconds of ``make_design`` (the rings, the centre's
member picks and the pillar list) per lens check of the traced window."""

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "assembly"
MOVES = "lens_check_s"


def read(ctx):
    ms = ctx["spans"].host_ms("make_design")
    return sum(ms) / len(ms) if ms else None
