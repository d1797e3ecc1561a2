"""Percent of the traced window in which no operation ran on the device:
100 x (1 - union of all device intervals, every stream / window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
