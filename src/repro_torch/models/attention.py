"""Grouped-query attention: train/prefill and decode (port of
``repro.models.attention``).

Full-sequence attention goes through :func:`attend`, which picks one of two
implementations of the same function by its arguments alone
(:func:`takes_flash`):

* the port's hand-written flash kernel
  (:func:`repro_torch.kernels.flash_attention.flash_attention`) for CUDA
  tensors with no window, no ``q_offset``, no ``kv_len``, q and k of one
  shape and no tensor that requires grad (the kernel is forward only):
  causal self-attention in prefill and forward, the encoder's non-causal
  self-attention, a cross-attention over a memory of the queries' length;
* :func:`blocked_attention` otherwise: the CPU, the sliding window,
  cross-attention with ``kv_len`` or over another length, and autograd.

Both compute the reference's ``blocked_attention``: scale Dh^-0.5, causal
mask key ≤ query with masked logits at -1e30, f32 state, the output in q's
dtype.  Decode (:func:`decode_attention`) is grouped PyTorch ops with an
f32 accumulation, as the reference computes it outside any kernel; it
writes the new K/V row into the cache in place.

GQA: KV heads are repeated on the activations (:func:`repeat_kv`) for the
full-sequence path; decode groups the query heads instead.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention

from .common import Draw, Params, apply_rope, dense_init, rmsnorm
from .config import ModelConfig

NEG_INF = -1e30


def attn_params(draw: Draw, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    dh = cfg.resolved_head_dim
    h, hkv = cfg.padded_n_heads, cfg.n_kv_heads
    wo = dense_init(draw, (h * dh, d))
    if h != cfg.n_heads:  # inert padding heads: zero their output rows
        wo[..., cfg.n_heads * dh :, :] = 0.0
    p = {
        "wq": dense_init(draw, (d, h * dh)),
        "wk": dense_init(draw, (d, hkv * dh)),
        "wv": dense_init(draw, (d, hkv * dh)),
        "wo": wo,
    }
    if cfg.qkv_bias:
        p["bq"] = draw.full((h * dh,), 0.0)
        p["bk"] = draw.full((hkv * dh,), 0.0)
        p["bv"] = draw.full((hkv * dh,), 0.0)
    if cfg.qk_norm:
        p["q_norm"] = draw.full((dh,), 1.0)
        p["k_norm"] = draw.full((dh,), 1.0)
    return p


def _project_qkv(
    x: torch.Tensor, p: Params, cfg: ModelConfig, positions: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, t, _ = x.shape
    dh = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, t, cfg.padded_n_heads, dh)
    k = k.reshape(b, t, cfg.n_kv_heads, dh)
    v = v.reshape(b, t, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:  # rope (None for cross-attention keys)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, T, Hkv, Dh) → (B, T, Hkv·n_rep, Dh)."""
    if n_rep == 1:
        return x
    b, t, h, dh = x.shape
    return x[:, :, :, None, :].expand(b, t, h, n_rep, dh).reshape(b, t, h * n_rep, dh)


# ----------------------------------------------------------------------
# Blocked attention (flash-style online softmax over KV blocks)
# ----------------------------------------------------------------------
def blocked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    block: int = 512,
    q_offset: int = 0,
    kv_len=None,
) -> torch.Tensor:
    """q: (B, Tq, H, Dh); k, v: (B, Tk, H, Dh) — same head count (pre-repeated).

    Walks KV in blocks with a running (max, sum, acc) per query.
    ``q_offset``: absolute position of q[0] relative to k[0].  ``kv_len``:
    count of valid KV positions (cross-attention over a partially filled
    memory; an int or a 0-d tensor)."""
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    blk = min(block, tk)
    tk_p = -(-tk // blk) * blk  # KV padded to a block multiple with masked slots
    if tk_p != tk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, tk_p - tk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, tk_p - tk))
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    qf = (q.float() * dh**-0.5).transpose(1, 2)  # (B, H, Tq, Dh)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    q_pos = q_offset + torch.arange(tq, device=dev)
    m = torch.full((b, h, tq), -torch.inf, **f32)
    l = torch.zeros(b, h, tq, **f32)
    acc = torch.zeros(b, h, tq, dh, **f32)
    for j in range(tk_p // blk):
        kv_pos = j * blk + torch.arange(blk, device=dev)
        logits = qf @ kf[:, :, j * blk : (j + 1) * blk].transpose(-1, -2)
        mask = kv_pos[None, :] <= (q_pos[:, None] if causal else tk_p)
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        mask = mask & (kv_pos < tk)[None, :]
        if kv_len is not None:
            mask = mask & (kv_pos < kv_len)[None, :]
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vf[:, :, j * blk : (j + 1) * blk]
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B, Tq, H, Dh)


def takes_flash(q, k, v, window=None, q_offset: int = 0, kv_len=None) -> bool:
    """Whether :func:`attend` runs the flash kernel: CUDA tensors, no
    window, no ``q_offset``, no ``kv_len``, q and k (pre-repeated) of one
    shape, and no input that requires grad.  A pure function of the
    arguments: no fallback catches a failing kernel."""
    return (
        q.device.type == "cuda"
        and window is None
        and q_offset == 0
        and kv_len is None
        and q.shape == k.shape == v.shape
        and not (q.requires_grad or k.requires_grad or v.requires_grad)
    )


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    block: int = 512,
    kv_len=None,
) -> torch.Tensor:
    """Attention of q (B, Tq, H, Dh) over k, v (B, Tk, Hkv, Dh): KV heads
    repeated to H, then the flash kernel or :func:`blocked_attention` as
    :func:`takes_flash` says.  The kernel's tiles are its own: it gets
    blocks of T (the wrapper's rule that they divide T then holds for any
    T)."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    if takes_flash(q, k, v, window=window, kv_len=kv_len):
        t = q.shape[1]
        return flash_attention(q, k, v, causal=causal, block_q=t, block_kv=t)
    return blocked_attention(q, k, v, causal=causal, window=window, block=block,
                             kv_len=kv_len)


def attention_forward(
    x: torch.Tensor,
    p: Params,
    cfg: ModelConfig,
    positions: torch.Tensor,
    window: Optional[int] = None,
    block: int = 512,
) -> torch.Tensor:
    """Full-sequence causal self-attention (train / prefill)."""
    q, k, v = _project_qkv(x, p, cfg, positions)
    o = attend(q, k, v, causal=True, window=window, block=block)
    b, t = x.shape[:2]
    return o.reshape(b, t, -1) @ p["wo"]


# ----------------------------------------------------------------------
# Decode with KV cache
# ----------------------------------------------------------------------
def init_kv_cache(batch: int, max_len: int, cfg: ModelConfig, dtype=torch.bfloat16,
                  device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(
    x: torch.Tensor,
    p: Params,
    cfg: ModelConfig,
    cache: Dict[str, torch.Tensor],
    position: torch.Tensor,
    window: Optional[int] = None,
    write_slot: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step: x (B, 1, D); cache (B, S, Hkv, Dh); position a 0-d
    int tensor.

    The new K/V row is written at ``write_slot`` (default ``position``)
    into the cache's tensors in place (the reference returns new arrays);
    attention runs over the whole cache with a validity mask.  Ring-buffer
    caches pass ``write_slot = position % S``: once the ring has wrapped
    every slot is valid.  Query heads are grouped over their KV head (no
    repeated cache); products and sums in f32."""
    b = x.shape[0]
    dh = cfg.resolved_head_dim
    q, k, v = _project_qkv(x, p, cfg, position.reshape(1) if position.ndim == 0 else position)
    slot = (position if write_slot is None else write_slot).reshape(1).long()
    cache_k, cache_v = cache["k"], cache["v"]
    cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v.to(cache_v.dtype))
    kv_pos = torch.arange(cache_k.shape[1], device=x.device)
    valid = kv_pos <= position
    if window is not None and write_slot is None:
        valid = valid & (kv_pos > position - window)
    n_rep = cfg.padded_n_heads // cfg.n_kv_heads
    qg = (q * dh**-0.5).reshape(b, 1, cfg.n_kv_heads, n_rep, dh)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), cache_k.float())
    logits = torch.where(valid, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkrqs,bskd->bqkrd", w.to(cache_v.dtype).float(), cache_v.float())
    out = o.reshape(b, 1, -1).to(x.dtype) @ p["wo"]
    return out, {"k": cache_k, "v": cache_v}


# ----------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ----------------------------------------------------------------------
def cross_attn_params(draw: Draw, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    return attn_params(draw, cfg)


def cross_attention(
    x: torch.Tensor,
    memory_kv: Tuple[torch.Tensor, torch.Tensor],
    p: Params,
    cfg: ModelConfig,
    kv_len=None,
) -> torch.Tensor:
    """x: (B, Tq, D); memory_kv: precomputed (K, V) of the encoder output."""
    b, tq, _ = x.shape
    q = (x @ p["wq"]).reshape(b, tq, cfg.padded_n_heads, cfg.resolved_head_dim)
    k, v = memory_kv
    o = attend(q, k, v, causal=False, kv_len=kv_len)
    return o.reshape(b, tq, -1) @ p["wo"]


def encode_memory_kv(
    enc_out: torch.Tensor, p: Params, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, _ = enc_out.shape
    dh = cfg.resolved_head_dim
    k = (enc_out @ p["wk"]).reshape(b, t, cfg.n_kv_heads, dh)
    v = (enc_out @ p["wv"]).reshape(b, t, cfg.n_kv_heads, dh)
    return k, v
