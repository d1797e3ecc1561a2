"""Assigned-architecture model zoo (port of ``repro.models``, PyTorch).

config       ModelConfig / MoEConfig / SSMConfig, the shape cells
common       norms, RoPE, MLPs, losses, the parameter tree and draws
attention    GQA; full-sequence attention on the card's flash kernel or
             blocked attention; decode cache
moe          shared+routed top-k experts, per-row sort dispatch
gla          chunked gated linear attention (RWKV-6 / Mamba-2 core)
rwkv6        Finch blocks (time-mix / channel-mix)
mamba2       SSD blocks
transformer  model assembly, the layer loop, loss
decode       prefill + single-token decode with caches
model        facade: step builders, meta-tensor input specs
weights      the reference's parameters and caches in and out (numpy)

Entry points run on the first CUDA device unless the caller passes
``device="cpu"``; they raise without one.
"""
from .config import (
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeCell,
    SSMConfig,
    cell_is_runnable,
    shape_by_name,
)
from .model import (
    batch_specs,
    build_decode_fn,
    build_loss_fn,
    build_prefill_fn,
    decode_input_specs,
    param_specs,
    random_batch,
)
from .transformer import forward, init_params, loss_fn

__all__ = [k for k in dir() if not k.startswith("_")]
