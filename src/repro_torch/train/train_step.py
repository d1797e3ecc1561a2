"""The training step (port of ``repro.train.train_step``): loss → grad →
AdamW, with microbatch gradient accumulation, so the per-step activation
footprint is global_batch / microbatches whatever the global batch.

The reference's ``jax.value_and_grad`` is autograd over the port's
``models.build_loss_fn``: the step turns ``requires_grad`` on for the
parameters' leaves for the step's length (a :class:`ParamTree` is made with
it off) and takes the gradients with ``torch.autograd.grad``, so nothing
lands in ``.grad``.  The reference's ``lax.scan`` over microbatches is a
Python loop averaging loss and gradients into f32 accumulators (the scan's
f32 ``zero``), whatever the parameters' dtype.  Under grad every attention
takes ``blocked_attention``: the flash kernel is forward only, as the
reference's, which trains through XLA blocked attention.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.distributed.constraints import zeros_like
from repro_torch.models import build_loss_fn
from repro_torch.models.common import Params, tree_from_items, tree_items
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params

from .optimizer import OptConfig, adamw_update, init_opt_state


def _split(batch: Dict[str, torch.Tensor], microbatches: int):
    """The batch's rows in ``microbatches`` equal consecutive slices (the
    reference's reshape to (microbatches, B / microbatches, ...)).  Under a
    mesh a slice of the batch-sharded rows is gathered (the tokens: small)
    and the model shards its rows again at the embedding."""
    b = next(iter(batch.values())).shape[0]
    if b % microbatches:
        raise ValueError(f"global batch {b} is not a multiple of {microbatches} microbatches")
    m = b // microbatches
    return [{k: v[i * m : (i + 1) * m] for k, v in batch.items()} for i in range(microbatches)]


def build_value_and_grad(
    cfg: ModelConfig, microbatches: int = 1, remat: bool = True, attn_block: int = 512
) -> Callable[[Params, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict[str, Any]]]:
    """``fn(params, batch) -> (loss, grads)``: the loss (0-d f32) and its
    gradient as nested dicts under the parameters' keys.  One microbatch:
    the gradients in the parameters' dtype (``jax.value_and_grad``); more:
    the mean over microbatches in f32."""
    loss_fn = build_loss_fn(cfg, remat=remat, attn_block=attn_block)

    def grad_of(params, batch, leaves):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), grads

    def value_and_grad(params: Params, batch: Dict[str, torch.Tensor]):
        items = tree_items(params)
        leaves = [p for _, p in items]
        was = [p.requires_grad for p in leaves]
        try:
            for p in leaves:
                p.requires_grad_(True)
            with torch.enable_grad():
                if microbatches == 1:
                    loss, grads = grad_of(params, batch, leaves)
                else:
                    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
                    grads = [zeros_like(p, torch.float32) for p in leaves]
                    for mb in _split(batch, microbatches):
                        l, g = grad_of(params, mb, leaves)
                        with torch.no_grad():
                            loss = loss + l / microbatches
                            for acc, gi in zip(grads, g):
                                acc.add_(gi / microbatches)
                        del g
        finally:
            for p, w in zip(leaves, was):
                p.requires_grad_(w)
        return loss, tree_from_items((path, g) for (path, _), g in zip(items, grads))

    return value_and_grad


def build_train_step(
    cfg: ModelConfig,
    opt_cfg: OptConfig,
    microbatches: int = 1,
    remat: bool = True,
    attn_block: int = 512,
) -> Callable[[Params, Dict[str, Any], Dict[str, torch.Tensor]], Tuple[Params, Dict, Dict]]:
    """``step(params, opt_state, batch) -> (params, opt_state, stats)``;
    ``stats``: ``loss`` (before the update), ``lr``, ``grad_norm`` (0-d
    tensors).  Parameters and optimizer state are updated in place."""
    value_and_grad = build_value_and_grad(cfg, microbatches, remat, attn_block)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch)
        params, opt_state, stats = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {**stats, "loss": loss}

    return train_step


def init_train_state(cfg: ModelConfig, seed_or_generator=0, dtype=torch.float32, device=None):
    """``(params, opt_state)``: ``init_params`` (on the first CUDA device
    by default; raises without one unless ``device`` is given) and its
    zero optimizer state."""
    params = init_params(cfg, seed_or_generator, dtype=dtype, device=device)
    return params, init_opt_state(params)
