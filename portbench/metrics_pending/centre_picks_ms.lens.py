"""Host-clock milliseconds of the centre's member picks per lens check:
the program's span ``assembly.centre_picks`` (``design_center``, one pick
per hex site) over the traced checks."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "assembly"
MOVES = "lens_check_s"


def read(ctx):
    from portbench.program_trace import per, span
    return per(span(ctx, "assembly.centre_picks", "host_ms"), ctx["units"])
