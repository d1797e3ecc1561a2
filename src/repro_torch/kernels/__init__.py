"""Hand-written CUDA kernels for the compute hot spots (+ PyTorch oracles).

frontal_cholesky   blocked partial Cholesky of frontal matrices: wrappers,
                   plain versions, launch counters and the build of
                   ``csrc/frontal_cholesky.cu``
ops                public wrappers (padding, path selection)
ref                torch.linalg oracles the kernels are tested against
"""
from .frontal_cholesky import (
    LAUNCHES,
    PLAIN_RUNS,
    front_factor,
    load_library,
    panel_factor,
    reset_counters,
    syrk_downdate,
)
from .ops import batched_front_factor, factor_fn, partial_cholesky
from .ref import panel_factor_ref, partial_cholesky_ref, syrk_update_ref

__all__ = [k for k in dir() if not k.startswith("_")]
