"""The inverse kernels' share of their roofline over the traced batches:
the bound of the inverses one cell solve needs (at N and at 2N, by the
doubling schedule) over their device time by kernel name."""

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "solves_per_s"
KERNELS = ("cinv_",)


def read(ctx):
    from portbench.harness import kernel_seconds
    secs = kernel_seconds(ctx["summary"], KERNELS)
    if not secs:
        return None
    st, w = ctx["state"], ctx["work"]
    B = st["tr"]["batch"]
    bound = 0.0
    for n, count in w.cell_solve_inverses(len(st["orders"]), st["n_slabs"],
                                          st["cfg"]["nv"]):
        bound += count * w.bound_ms(*w.inverse_work(n, B))
    return 100.0 * ctx["units"] * bound / (1e3 * secs)
