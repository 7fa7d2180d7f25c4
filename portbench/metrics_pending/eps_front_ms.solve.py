"""CUDA-event milliseconds of the eps front end per batch of cell solves:
the program's span ``rcwa.eps`` (``build_layer_eps``: the Laurent eps
matrix and the NV blocks) over the traced batches."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "cell solve"
MOVES = "solves_per_s"


def read(ctx):
    from portbench.program_trace import per, span
    return per(span(ctx, "rcwa.eps", "device_ms"), ctx["units"])
