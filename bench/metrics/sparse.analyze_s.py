"""Host seconds of ``Session.analyze`` + ``plan`` in set-up (host clock
around the calls)."""


def read(ctx):
    return ctx.analyze_s
