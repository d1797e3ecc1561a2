"""Milliseconds per factorization of pauses of Python's garbage collector
while ``PlanExecutor.run`` is in progress: the program's counter
``repro_host_gc_seconds_total``, over the window."""


def read(ctx):
    from repro_torch.obs import REGISTRY

    gc_seconds = REGISTRY.get("repro_host_gc_seconds_total")
    if gc_seconds is None or not ctx.count:
        return None
    return 1e3 * gc_seconds.value / ctx.count
