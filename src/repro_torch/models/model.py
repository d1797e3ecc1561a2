"""Facade (port of ``repro.models.model``): loss / prefill / decode
callables and input specs for any registered architecture.

The specs are tensors on ``torch.device("meta")``: shapes and dtypes,
nothing allocated (the reference's ``ShapeDtypeStruct`` stand-ins).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from . import decode as dec
from . import transformer as tf
from .config import ModelConfig, ShapeCell

META = torch.device("meta")


# ----------------------------------------------------------------------
# Input specs (meta tensors).  ``batch`` is the GLOBAL batch of the cell.
# ----------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, shape: ShapeCell) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META)}
    if cfg.family == "vlm":
        specs["patches"] = torch.empty((b, cfg.frontend_len, cfg.frontend_dim),
                                       dtype=torch.bfloat16, device=META)
    if cfg.family == "audio":
        specs["frames"] = torch.empty((b, s, cfg.frontend_dim), dtype=torch.bfloat16,
                                      device=META)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeCell, cache_dtype=torch.bfloat16
                       ) -> Dict[str, object]:
    b, s = shape.global_batch, shape.seq_len
    return {
        "cache": dec.init_cache(cfg, b, s, dtype=cache_dtype, device=META),
        "token": torch.empty((b, 1), dtype=torch.int32, device=META),
    }


def param_specs(cfg: ModelConfig, dtype=torch.bfloat16):
    """The parameter tree on the meta device (no allocation)."""
    return tf.init_params(cfg, None, dtype=dtype, device=META)


# ----------------------------------------------------------------------
# Step builders
# ----------------------------------------------------------------------
def build_loss_fn(cfg: ModelConfig, remat: bool = True, attn_block: int = 512) -> Callable:
    return functools.partial(tf.loss_fn, cfg, remat=remat, attn_block=attn_block)


def build_prefill_fn(cfg: ModelConfig, remat: bool = True, attn_block: int = 512) -> Callable:
    def fn(params, batch):
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        return dec.prefill(cfg, params, batch["tokens"], extra=extra, remat=remat,
                           attn_block=attn_block)

    return fn


def build_decode_fn(cfg: ModelConfig) -> Callable:
    def fn(params, cache, token):
        return dec.decode_step(cfg, params, dict(cache), token)

    return fn


# ----------------------------------------------------------------------
# Smoke-test helpers
# ----------------------------------------------------------------------
def random_batch(cfg: ModelConfig, batch: int, seq: int, generator: torch.Generator
                 ) -> Dict[str, torch.Tensor]:
    """Random tokens (and patches / frames, f32) drawn by ``generator`` on
    its own device."""
    dev = generator.device
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator,
                                   dtype=torch.int32, device=dev)}
    if cfg.family == "vlm":
        out["patches"] = torch.randn(batch, cfg.frontend_len, cfg.frontend_dim,
                                     generator=generator, device=dev)
    if cfg.family == "audio":
        out["frames"] = torch.randn(batch, seq, cfg.frontend_dim, generator=generator,
                                    device=dev)
    return out
