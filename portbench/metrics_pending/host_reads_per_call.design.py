"""Host reads of device data per fused design call: the program's counter
``fused.host_reads`` over the count of its span ``fused.call`` in the
traced calls."""

UNIT, BETTER, SOURCE = "reads", "lower", "program_counter"
LAYER = "fused design loop"
MOVES = "design_cands_per_s"


def read(ctx):
    from portbench.program_trace import counter, per, span
    return per(counter(ctx, "fused.host_reads", "fused.call"),
               span(ctx, "fused.call", "count"))
