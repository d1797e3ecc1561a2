"""Megabytes copied between host and device per factorization: kind
``copied`` of the program's counter ``repro_executor_copy_bytes_total``
(padded stacks both ways, large fronts in, their panels and Schur blocks
out), over the window."""


def read(ctx):
    from repro_torch.obs import REGISTRY

    copies = REGISTRY.get("repro_executor_copy_bytes_total")
    if copies is None or not ctx.count:
        return None
    return copies.value_of(kind="copied") / 1e6 / ctx.count
