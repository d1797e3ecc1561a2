"""Percent of the least time in the device time of every kernel (copies
left out) per factorization.  The least time is max(F / peak FLOP/s,
B / peak bytes/s) of the exact factor of these inputs (``counts.py``), so
padding, relaxed amalgamation and slow kernels all show as waste."""


def read(ctx):
    if ctx.trace is None or ctx.trace.kernel_s <= 0 or ctx.peaks is None or ctx.least is None:
        return None
    least = max(ctx.least["flops"] / ctx.peaks["flops"][ctx.config["dtype"]],
                ctx.least["bytes"] / ctx.peaks["bytes_per_s"])
    return 100.0 * least / (ctx.trace.kernel_s / ctx.count)
