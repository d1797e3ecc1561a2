"""Model assembly (port of ``repro.models.transformer``): per-family layer
parameters, the layer loop, forward and loss.

Parameter layout: every per-layer tensor is stacked on a leading L axis, as
the reference's ``vmap`` init leaves it, and the reference's ``lax.scan``
over layers is a Python loop over that axis (:func:`tree_index` hands each
layer views of its slices).  Weight-shared blocks (zamba2's attention) and
globals (embeddings, norms, heads) live beside the stack.  The tree is a
:class:`ParamTree` whose attribute paths are the reference's pytree keys.

``remat`` is accepted: with grad on, each layer runs under
``torch.utils.checkpoint``; with grad off it changes nothing.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.constraints import shard_over_dp

from . import attention as attn
from . import mamba2 as m2
from . import moe as moe_mod
from . import rwkv6 as r6
from .common import (
    Draw,
    Params,
    ParamTree,
    apply_norm,
    cross_entropy,
    dense_init,
    embed_init,
    mlp_apply,
    mlp_params,
    norm_params,
    tree_index,
)
from .config import ModelConfig


def default_device() -> torch.device:
    """The first CUDA device; raises when there is none (the models run on
    the CPU only when the caller passes ``device="cpu"``)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "models: no CUDA device; pass device='cpu' to run the models on the CPU")
    return torch.device("cuda", 0)


def resolve_device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


# ----------------------------------------------------------------------
# Per-layer parameter builders
# ----------------------------------------------------------------------
def _dense_layer_params(draw: Draw, cfg: ModelConfig) -> Dict:
    return {
        "attn_norm": norm_params(draw, cfg.d_model, cfg.norm),
        "attn": attn.attn_params(draw, cfg),
        "mlp_norm": norm_params(draw, cfg.d_model, cfg.norm),
        "mlp": mlp_params(draw, cfg.d_model, cfg.d_ff, cfg.mlp),
    }


def _moe_layer_params(draw: Draw, cfg: ModelConfig) -> Dict:
    return {
        "attn_norm": norm_params(draw, cfg.d_model, cfg.norm),
        "attn": attn.attn_params(draw, cfg),
        "mlp_norm": norm_params(draw, cfg.d_model, cfg.norm),
        "moe": moe_mod.moe_params(draw, cfg),
    }


def _ssm_layer_params(draw: Draw, cfg: ModelConfig) -> Dict:
    if cfg.ssm.kind == "rwkv6":
        return {
            "tm_norm": norm_params(draw, cfg.d_model, cfg.norm),
            "rwkv": r6.rwkv6_params(draw, cfg),
            "cm_norm": norm_params(draw, cfg.d_model, cfg.norm),
        }
    return {
        "norm": norm_params(draw, cfg.d_model, cfg.norm),
        "mamba": m2.mamba2_params(draw, cfg),
    }


def _encdec_layer_params(draw: Draw, cfg: ModelConfig, decoder: bool) -> Dict:
    p = _dense_layer_params(draw, cfg)
    if decoder:
        p["cross_norm"] = norm_params(draw, cfg.d_model, cfg.norm)
        p["cross"] = attn.cross_attn_params(draw, cfg)
    return p


def layer_params(draw: Draw, cfg: ModelConfig) -> Dict:
    """One layer's parameters (each tensor stacked on ``draw.stack``)."""
    if cfg.family in ("dense", "vlm"):
        return _dense_layer_params(draw, cfg)
    if cfg.family == "moe":
        return _moe_layer_params(draw, cfg)
    if cfg.family in ("ssm", "hybrid"):
        return _ssm_layer_params(draw, cfg)
    if cfg.family == "audio":
        return _encdec_layer_params(draw, cfg, decoder=True)
    raise ValueError(cfg.family)


# ----------------------------------------------------------------------
# Whole-model parameters
# ----------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator=0, dtype=torch.float32, device=None) -> ParamTree:
    """Random parameters of ``cfg`` (the reference's initialisers and
    layout; not its numbers).  ``generator``: a ``torch.Generator`` on the
    device's type, or an int seed.  ``device``: the first CUDA device by
    default (raises without one); ``"meta"`` allocates nothing."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = (None if device.type == "meta"
                     else torch.Generator(device).manual_seed(generator))
    draw = Draw(generator, dtype, device)
    v = cfg.padded_vocab()
    params: Dict = {
        "embed": embed_init(draw, v, cfg.d_model),
        "final_norm": norm_params(draw, cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(draw, (cfg.d_model, v))
    params["layers"] = layer_params(draw.stacked(cfg.n_layers), cfg)
    if cfg.family == "hybrid":
        params["shared_attn"] = _dense_layer_params(draw, cfg)
    if cfg.encdec:
        params["encoder"] = {
            "layers": _encdec_layer_params(draw.stacked(cfg.n_encoder_layers), cfg,
                                           decoder=False),
            "final_norm": norm_params(draw, cfg.d_model, cfg.norm),
        }
    if cfg.frontend:
        params["frontend_proj"] = dense_init(draw, (cfg.frontend_dim, cfg.d_model))
    return ParamTree(params)


# ----------------------------------------------------------------------
# Layer application (training / prefill path)
# ----------------------------------------------------------------------
def _apply_dense_layer(x, lp, cfg, positions, window=None, block=512):
    h = apply_norm(x, lp["attn_norm"], cfg.norm, cfg.norm_eps)
    x = x + attn.attention_forward(h, lp["attn"], cfg, positions, window=window, block=block)
    h = apply_norm(x, lp["mlp_norm"], cfg.norm, cfg.norm_eps)
    return x + mlp_apply(h, lp["mlp"], cfg.mlp)


def _apply_moe_layer(x, lp, cfg, positions, block=512):
    h = apply_norm(x, lp["attn_norm"], cfg.norm, cfg.norm_eps)
    x = x + attn.attention_forward(h, lp["attn"], cfg, positions, block=block)
    h = apply_norm(x, lp["mlp_norm"], cfg.norm, cfg.norm_eps)
    out, aux = moe_mod.moe_apply(h, lp["moe"], cfg)
    return x + out, aux


def _apply_ssm_layer(x, lp, cfg):
    chunk = cfg.ssm.chunk
    if cfg.ssm.kind == "rwkv6":
        h = apply_norm(x, lp["tm_norm"], cfg.norm, cfg.norm_eps)
        x = x + r6.time_mix(h, lp["rwkv"], cfg, chunk)
        h = apply_norm(x, lp["cm_norm"], cfg.norm, cfg.norm_eps)
        return x + r6.channel_mix(h, lp["rwkv"])
    h = apply_norm(x, lp["norm"], cfg.norm, cfg.norm_eps)
    return x + m2.mamba2_forward(h, lp["mamba"], cfg, chunk)


def _remat(body: Callable, remat: bool) -> Callable:
    """``body`` under activation checkpointing when it matters (grad on)."""
    if not (remat and torch.is_grad_enabled()):
        return body
    return functools.partial(checkpoint, body, use_reentrant=False)


def _scan_layers(x, layers: Params, body: Callable, remat: bool, idx=None):
    """Apply ``body(x, layer)`` over the stacked layers (or the indices
    ``idx`` of the stack)."""
    fn = _remat(body, remat)
    for i in range(_depth(layers)) if idx is None else idx:
        x = fn(x, tree_index(layers, i))
    return x


def _scan_layers_aux(x, layers: Params, body: Callable, remat: bool):
    fn = _remat(body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(_depth(layers)):
        x, a = fn(x, tree_index(layers, i))
        aux = aux + a
    return x, aux


def _depth(tree: Params) -> int:
    """The length of a stacked tree's leading (layer) axis."""
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree.shape[0]


# ----------------------------------------------------------------------
# Forward (logits) per family
# ----------------------------------------------------------------------
def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    *,
    extra: Optional[Dict[str, torch.Tensor]] = None,
    remat: bool = True,
    window: Optional[int] = None,
    attn_block: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, T) → (logits (B, T', Vp), aux_loss).  For vlm, T' includes
    the prepended patch positions; for audio, tokens are the decoder side and
    ``extra['frames']`` feeds the encoder."""
    x = shard_over_dp(params["embed"][tokens])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "vlm":
        patches = extra["patches"] @ params["frontend_proj"]
        x = shard_over_dp(torch.cat([patches.to(x.dtype), x], dim=1))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    if cfg.family in ("dense", "vlm"):
        body = functools.partial(_apply_dense_layer, cfg=cfg, positions=positions,
                                 window=window, block=attn_block)
        x = _scan_layers(x, params["layers"], body, remat)
    elif cfg.family == "moe":
        body = functools.partial(_apply_moe_layer, cfg=cfg, positions=positions,
                                 block=attn_block)
        x, aux = _scan_layers_aux(x, params["layers"], body, remat)
    elif cfg.family == "ssm":
        x = _scan_layers(x, params["layers"], functools.partial(_apply_ssm_layer, cfg=cfg),
                         remat)
    elif cfg.family == "hybrid":
        x = _hybrid_forward(cfg, params, x, positions, remat, window, attn_block)
    elif cfg.family == "audio":
        x = _encdec_forward(cfg, params, x, extra["frames"], positions, remat, attn_block)
    else:
        raise ValueError(cfg.family)

    x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return lm_logits(params, x), aux


def lm_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The head: ``lm_head``, or the tied embedding's transpose."""
    head = params.get("lm_head")
    return x @ head if head is not None else x @ params["embed"].T


def hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, mamba layers per group) of zamba2's stack: a weight-shared
    attention block after each group, the remaining layers after."""
    every = cfg.hybrid_attn_every or cfg.n_layers
    return cfg.n_layers // every, every


def _hybrid_forward(cfg, params, x, positions, remat, window, attn_block):
    n_groups, every = hybrid_groups(cfg)
    sp = params["shared_attn"]
    ssm = functools.partial(_apply_ssm_layer, cfg=cfg)
    for g in range(n_groups):
        x = _scan_layers(x, params["layers"], ssm, remat, range(g * every, (g + 1) * every))
        x = _apply_dense_layer(x, sp, cfg, positions, window=window, block=attn_block)
    return _scan_layers(x, params["layers"], ssm, remat, range(n_groups * every, cfg.n_layers))


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, remat: bool,
           attn_block: int) -> torch.Tensor:
    """The audio encoder: non-causal self-attention layers over the
    projected frames, then its final norm (the decoder's memory)."""
    enc_x = frames @ params["frontend_proj"]
    enc_pos = torch.arange(enc_x.shape[1], device=enc_x.device)[None, :]

    def enc_body(x, lp):
        h = apply_norm(x, lp["attn_norm"], cfg.norm, cfg.norm_eps)
        q, k, v = attn._project_qkv(h, lp["attn"], cfg, enc_pos)
        o = attn.attend(q, k, v, causal=False, block=attn_block)
        x = x + o.reshape(x.shape[0], x.shape[1], -1) @ lp["attn"]["wo"]
        h = apply_norm(x, lp["mlp_norm"], cfg.norm, cfg.norm_eps)
        return x + mlp_apply(h, lp["mlp"], cfg.mlp)

    enc_x = _scan_layers(enc_x, params["encoder"]["layers"], enc_body, remat)
    return apply_norm(enc_x, params["encoder"]["final_norm"], cfg.norm, cfg.norm_eps)


def _encdec_forward(cfg, params, x_dec, frames, positions, remat, attn_block):
    memory = encode(cfg, params, frames, remat, attn_block)

    def dec_body(x, lp):
        h = apply_norm(x, lp["attn_norm"], cfg.norm, cfg.norm_eps)
        x = x + attn.attention_forward(h, lp["attn"], cfg, positions, block=attn_block)
        h = apply_norm(x, lp["cross_norm"], cfg.norm, cfg.norm_eps)
        mem_kv = attn.encode_memory_kv(memory, lp["cross"], cfg)
        x = x + attn.cross_attention(h, mem_kv, lp["cross"], cfg)
        h = apply_norm(x, lp["mlp_norm"], cfg.norm, cfg.norm_eps)
        return x + mlp_apply(h, lp["mlp"], cfg.mlp)

    return _scan_layers(x_dec, params["layers"], dec_body, remat)


# ----------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------
def loss_fn(
    cfg: ModelConfig,
    params: Params,
    batch: Dict[str, torch.Tensor],
    remat: bool = True,
    attn_block: int = 512,
) -> torch.Tensor:
    logits, aux = forward(cfg, params, batch["tokens"], extra=batch, remat=remat,
                          attn_block=attn_block)
    tokens = batch["tokens"]
    logits = logits[:, -tokens.shape[1]:, :]  # drop patch positions (vlm)
    # next-token labels; the last position has none (-1: ignored), which
    # keeps T whole for a mesh to split
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
    return cross_entropy(logits, labels) + aux
