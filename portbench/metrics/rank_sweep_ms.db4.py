"""The slowest rank's time for one pass of the sharded database sweep, by
the harness's CUDA events around the pass."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "sharded paths"
MOVES = "db_cells_per_s"


def read(ctx):
    per_rank = [sum(r["pass_ms"]) / ctx["units"] for r in ctx["ranks"]
                if r.get("pass_ms")]
    return max(per_rank) if per_rank else None
