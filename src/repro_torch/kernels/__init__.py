"""Hand-written CUDA kernels for the compute hot spots (+ PyTorch oracles).

frontal_cholesky   blocked partial Cholesky of frontal matrices: wrappers,
                   plain versions and launch counters (``csrc/frontal_cholesky.cu``)
flash_attention    forward online-softmax attention: wrapper, plain version
                   and launch counter (``csrc/flash_attention.cu``)
_build             one nvcc call for every csrc source, ctypes loading
ops                public wrappers (padding, path selection)
ref                torch.linalg oracles the kernels are tested against
"""
from ._build import load_library
from .frontal_cholesky import (
    LAUNCHES,
    PLAIN_RUNS,
    front_factor,
    panel_factor,
    reset_counters,
    syrk_downdate,
)
from .ops import batched_front_factor, factor_fn, partial_cholesky
from .ref import panel_factor_ref, partial_cholesky_ref, syrk_update_ref

__all__ = [k for k in dir() if not k.startswith("_")]
