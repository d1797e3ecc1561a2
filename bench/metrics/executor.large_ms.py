"""Milliseconds per factorization that the executor's threads spend in
the large route (fronts padded past 1,024: copy in, padding on the card,
the panel + SYRK loop, the gather, copy out): the program's counter
``repro_executor_large_seconds_total``, over the window."""


def read(ctx):
    from repro_torch.obs import REGISTRY

    seconds = REGISTRY.get("repro_executor_large_seconds_total")
    if seconds is None or not ctx.count:
        return None
    return 1e3 * seconds.value / ctx.count
