"""Percent of the bytes copied between host and device that are the
fronts' own: 100 x kind ``useful`` (each front's m^2 entries sent, its
panel and Schur block received) / kind ``copied`` of the program's counter
``repro_executor_copy_bytes_total``, over the window."""


def read(ctx):
    from repro_torch.obs import REGISTRY

    copies = REGISTRY.get("repro_executor_copy_bytes_total")
    if copies is None or copies.value_of(kind="copied") <= 0:
        return None
    return 100.0 * copies.value_of(kind="useful") / copies.value_of(kind="copied")
