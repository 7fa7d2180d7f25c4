"""Host reads of device data in the stitch per lens check: the program's
counter ``nearfield.host_reads`` (each region's statistics, the lookup's
misses and their points, the power) over the traced checks."""

UNIT, BETTER, SOURCE = "reads", "lower", "program_counter"
LAYER = "near field"
MOVES = "lens_check_s"


def read(ctx):
    from portbench.program_trace import counter, per
    return per(counter(ctx, "nearfield.host_reads", "nearfield.build"),
               ctx["units"])
