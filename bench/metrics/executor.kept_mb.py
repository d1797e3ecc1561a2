"""Megabytes per factorization of Schur blocks that the large route keeps
on the card for a large parent's extend-add, instead of copying them to
the host and back: the program's counter
``repro_executor_kept_bytes_total``, over the window."""


def read(ctx):
    from repro_torch.obs import REGISTRY

    kept = REGISTRY.get("repro_executor_kept_bytes_total")
    if kept is None or not ctx.count:
        return None
    return kept.value / 1e6 / ctx.count
