"""Megabytes per factorization of the matrix's original entries gathered
into fronts on the card, 8 bytes each, each entry once (not mirrored):
the program's counter ``repro_executor_entry_bytes_total``, over the
window."""


def read(ctx):
    from repro_torch.obs import REGISTRY

    entries = REGISTRY.get("repro_executor_entry_bytes_total")
    if entries is None or not ctx.count:
        return None
    return entries.value / 1e6 / ctx.count
