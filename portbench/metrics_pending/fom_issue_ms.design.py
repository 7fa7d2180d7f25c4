"""Host-clock milliseconds the fused loop spends issuing one FOM batch: the
program's span ``engine.fom_eval`` over its counter ``fused.attempts`` in
the traced calls (the start's FOM of each call included)."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "fused design loop"
MOVES = "design_cands_per_s"


def read(ctx):
    from portbench.program_trace import counter, per, span
    return per(span(ctx, "engine.fom_eval", "host_ms"),
               counter(ctx, "fused.attempts", "fused.call"))
