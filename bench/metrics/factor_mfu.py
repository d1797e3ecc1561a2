"""Percent of the card's peak rate that the whole factorization reaches:
100 x F / (traced seconds per factorization x peak FLOP/s)."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or ctx.least is None or not ctx.count:
        return None
    per = ctx.trace.window_s / ctx.count
    return 100.0 * ctx.least["flops"] / (per * ctx.peaks["flops"][ctx.config["dtype"]])
