"""Milliseconds of host<->device copies and memsets per factorization, from
the device trace."""


def read(ctx):
    if ctx.trace is None or ctx.trace.copy_s <= 0 or not ctx.count:
        return None
    return 1e3 * ctx.trace.copy_s / ctx.count
