"""Megabytes per factorization that the large route copies between host
and device (each large front in, its panel and Schur block out; a part of
``executor.copy_mb``): the program's counter
``repro_executor_large_bytes_total``, over the window."""


def read(ctx):
    from repro_torch.obs import REGISTRY

    copies = REGISTRY.get("repro_executor_large_bytes_total")
    if copies is None or not ctx.count:
        return None
    return copies.value / 1e6 / ctx.count
