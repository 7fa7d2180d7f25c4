"""Copies of host data to the device per batch of cell solves: the
program's counter ``rcwa.h2d_copies`` (the eps front end's and the solve's
uploads) over the traced batches."""

UNIT, BETTER, SOURCE = "copies", "lower", "program_counter"
LAYER = "cell solve"
MOVES = "solves_per_s"


def read(ctx):
    from portbench.program_trace import counter, per
    return per(counter(ctx, "rcwa.h2d_copies", "rcwa.solve"), ctx["units"])
