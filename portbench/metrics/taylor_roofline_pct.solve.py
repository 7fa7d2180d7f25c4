"""The Taylor kernels' share of their roofline over the traced batches: the
bound of the thin-slab Taylor work of one batch (n = 2N, B = batch, the
schedule's series length) over their device time by kernel name."""

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "solves_per_s"
KERNELS = ("cgemm_kernel", "ps_chunks_kernel")


def read(ctx):
    from portbench.harness import kernel_seconds
    secs = kernel_seconds(ctx["summary"], KERNELS)
    if not secs:
        return None
    st, w = ctx["state"], ctx["work"]
    n = 2 * len(st["orders"])
    flops, nbytes = w.taylor_work(n, st["tr"]["batch"], st["terms"])
    return 100.0 * ctx["units"] * w.bound_ms(flops, nbytes) / (1e3 * secs)
