"""Architecture registry: one module per assigned architecture (+ the
paper's own multifrontal solver config).  ``get(name)`` resolves the exact
public-literature config; ``--arch <id>`` in the launchers goes through
here."""
from . import (
    granite_moe_3b_a800m,
    multifrontal,
    pixtral_12b,
    qwen2_5_32b,
    qwen2_5_3b,
    qwen2_moe_a2_7b,
    qwen3_4b,
    rwkv6_1_6b,
    seamless_m4t_large_v2,
    starcoder2_7b,
    zamba2_2_7b,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen3_4b,
        starcoder2_7b,
        qwen2_5_3b,
        qwen2_5_32b,
        qwen2_moe_a2_7b,
        granite_moe_3b_a800m,
        rwkv6_1_6b,
        pixtral_12b,
        seamless_m4t_large_v2,
        zamba2_2_7b,
    )
}

SOLVER = multifrontal.CONFIG


def get(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
