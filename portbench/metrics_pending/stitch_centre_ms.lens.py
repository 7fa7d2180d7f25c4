"""CUDA-event milliseconds of the stitch's centre block per lens check: the
program's span ``nearfield.centre`` (the site table, the lattice lookup,
the brute-force fallback and the centre's orders) over the traced
checks."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "near field"
MOVES = "lens_check_s"


def read(ctx):
    from portbench.program_trace import per, span
    return per(span(ctx, "nearfield.centre", "device_ms"), ctx["units"])
