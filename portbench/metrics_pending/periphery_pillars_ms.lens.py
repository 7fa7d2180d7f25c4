"""Host-clock milliseconds of the periphery's pillar list per lens check:
the program's span ``assembly.periphery_pillars``
(``make_periphery_xyrra_list``) over the traced checks."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "assembly"
MOVES = "lens_check_s"


def read(ctx):
    from portbench.program_trace import per, span
    return per(span(ctx, "assembly.periphery_pillars", "host_ms"),
               ctx["units"])
