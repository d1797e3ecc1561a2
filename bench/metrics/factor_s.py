"""Seconds per factorization: the whole window, to the end of its last
factorization, over the factorizations completed in it."""


def read(ctx):
    return ctx.window_s / ctx.count if ctx.count else None
