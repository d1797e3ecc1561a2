"""Kernel dispatches per factorization: ``ExecutionReport.n_dispatches``,
the mean over the window."""


def read(ctx):
    if not ctx.dispatches:
        return None
    return sum(ctx.dispatches) / len(ctx.dispatches)
