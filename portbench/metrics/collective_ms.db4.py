"""Device time of the collectives (NCCL kernels, by name) per pass of the
sharded database sweep, on the rank whose pass took longest."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "sharded paths"
MOVES = "db_cells_per_s"
KERNELS = ("nccl", "Nccl")


def read(ctx):
    from portbench.harness import kernel_seconds
    ranks = [r for r in ctx["ranks"] if r.get("pass_ms")]
    if not ranks:
        return None
    slow = max(ranks, key=lambda r: sum(r["pass_ms"]))
    secs = kernel_seconds(slow["summary"], KERNELS)
    return None if secs is None else 1e3 * secs / ctx["units"]
