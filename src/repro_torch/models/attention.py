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

import functools
from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.constraints import constrain, mesh_axis_size, on_shards
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.obs.scopes import cost_scope

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
    q = split_heads(q, cfg.padded_n_heads, dh)
    k = split_heads(k, cfg.n_kv_heads, dh)
    v = split_heads(v, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:  # rope (None for cross-attention keys)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def split_heads(x: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    """(B, T, h·dh) → (B, T, h, dh).  Under a mesh whose "model" axis does
    not divide h, the column-sharded projection is first gathered on that
    axis (a shard would cut a head; XLA reshards there, DTensor refuses the
    reshape)."""
    if h % mesh_axis_size("model"):
        x = constrain(x, ("pod", "data"), None, None)
    return x.reshape(x.shape[0], x.shape[1], h, dh)


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
    """Whether :func:`attend` runs the flash kernel: CUDA tensors (a DTensor
    counts by its shards, a fake tensor of a dry run does not: it has no
    memory to launch on), no window, no ``q_offset``, no ``kv_len``, q and
    k (pre-repeated) of one shape, and no input that requires grad.  A pure
    function of the arguments: no fallback catches a failing kernel."""
    return (
        q.device.type == "cuda"
        and not is_fake(q)
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
    T).  Counted as the ``"attention"`` scope (``launch.hlocost``).

    Under a mesh q, k and v are held with the batch on the DP axes and the
    heads on "model" (where those divide them), and each rank attends its
    own heads on its own shards (``on_shards``): the kernel takes a
    shard's memory, not a DTensor's, and blocked attention's per-head ops
    need no sharding rule of DTensor's."""
    with cost_scope("attention"):
        n_rep = q.shape[2] // k.shape[2]
        k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
        if takes_flash(q, k, v, window=window, kv_len=kv_len):
            t = q.shape[1]
            fn = functools.partial(flash_attention, causal=causal, block_q=t, block_kv=t)
        else:
            if isinstance(kv_len, DTensor):
                kv_len = kv_len.full_tensor()
            fn = functools.partial(blocked_attention, causal=causal, window=window,
                                   block=block, kv_len=kv_len)
        bh = (0, 2)
        return on_shards(fn, (q, k, v), (bh, bh, bh), (bh,))


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
    write_row(cache_k, slot, k)
    write_row(cache_v, slot, v)
    win = window if write_slot is None else None
    n_rep = cfg.padded_n_heads // cfg.n_kv_heads
    if isinstance(cache_k, DTensor):
        o = _decode_on_shards(q, cache_k, cache_v, position, win, n_rep)
    else:
        o = _grouped_attention(q, cache_k, cache_v, position, win, n_rep, 0, None)
    out = o.reshape(b, 1, -1).to(x.dtype) @ p["wo"]
    return out, {"k": cache_k, "v": cache_v}


def _grouped_attention(q, cache_k, cache_v, position, window, n_rep: int, start: int, group):
    """One query (B, 1, H, Dh) over a cache (B, S, Hkv, Dh) whose slots
    are positions ``start`` … ``start + S − 1``, the heads grouped over
    their KV head: (B, 1, H, Dh) in f32.  With ``group`` the cache is this
    rank's part of the sequence, and the softmax's max and sums and the
    output are combined over the group (flash-decoding)."""
    b, dh = q.shape[0], q.shape[-1]
    kv_pos = start + torch.arange(cache_k.shape[1], device=q.device)
    valid = kv_pos <= position
    if window is not None:
        valid = valid & (kv_pos > position - window)
    qg = (q * dh**-0.5).reshape(b, 1, cache_k.shape[2], n_rep, dh)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), cache_k.float())
    logits = torch.where(valid, logits, NEG_INF)
    if group is None:
        w = torch.softmax(logits, dim=-1)
        o = torch.einsum("bkrqs,bskd->bqkrd", w.to(cache_v.dtype).float(), cache_v.float())
    else:
        import torch.distributed._functional_collectives as funcol

        m = funcol.wait_tensor(funcol.all_reduce(logits.amax(-1, keepdim=True), "max", group))
        e = torch.exp(logits - m)
        den = funcol.wait_tensor(funcol.all_reduce(e.sum(-1, keepdim=True), "sum", group))
        o = torch.einsum("bkrqs,bskd->bqkrd", (e / den).to(cache_v.dtype).float(),
                         cache_v.float())
        o = funcol.wait_tensor(funcol.all_reduce(o, "sum", group))
    return o.reshape(b, 1, -1, dh)


def _decode_on_shards(q, cache_k, cache_v, position, window, n_rep: int):
    """:func:`_grouped_attention` on each rank's shards of a DTensor cache:
    the query held as the cache is on its batch and heads; a cache split on
    its sequence (``cache_pspecs``' policy for kv_heads < TP) combines the
    softmax over the ranks that split it.  DTensor has no rule for the
    grouped heads' reshape in every torch release, and would gather the
    sequence for the softmax."""
    mesh, place = cache_k.device_mesh, cache_k.placements
    q_place = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in place)
    if tuple(q.placements) != q_place:
        q = q.redistribute(mesh, q_place)
    if isinstance(position, DTensor):
        position = position.full_tensor()
    seq_dims = [i for i, p in enumerate(place) if p == Shard(1)]
    group = mesh.get_group(seq_dims[0]) if seq_dims else None
    start = shard_start(cache_k.shape[1], mesh, place, 1)
    fn = functools.partial(_grouped_attention, position=position, window=window, n_rep=n_rep,
                           start=start, group=group)
    return local_map(fn, out_placements=list(q_place), in_placements=(q_place, place, place),
                     device_mesh=mesh)(q, cache_k, cache_v)


def write_row(cache: torch.Tensor, slot: torch.Tensor, row: torch.Tensor) -> None:
    """``cache[:, slot] = row`` in place: cache (B, S, H, Dh), row (B, 1, H,
    Dh), slot a 1-element index.  Under a mesh the cache is a DTensor, and
    DTensor has no sharding strategy for ``index_copy_`` in every torch
    release: the row, laid out as the cache but whole on the sequence, is
    written into each rank's own shard, by the rank whose sequence range
    holds the slot (the others write their own rows back: no host sync)."""
    if not isinstance(cache, DTensor):
        cache.index_copy_(1, slot, row.to(cache.dtype))
        return
    mesh, place = cache.device_mesh, cache.placements
    whole = tuple(Replicate() if p == Shard(1) else p for p in place)
    local_row = row.to(cache.dtype).redistribute(mesh, whole).to_local()
    if isinstance(slot, DTensor):
        slot = slot.full_tensor()
    local = cache.to_local()
    start = shard_start(cache.shape[1], mesh, place, 1)
    idx = (slot - start).clamp(0, local.shape[1] - 1)
    own = (slot >= start) & (slot < start + local.shape[1])
    local.index_copy_(1, idx, torch.where(own, local_row, local.index_select(1, idx)))


def shard_start(size: int, mesh, place, dim: int) -> int:
    """Where this rank's shard of a tensor dim of ``size`` begins (DTensor's
    ``Shard`` split: chunks of ceil(size / n), mesh dims in order)."""
    coord = mesh.get_coordinate()
    start = 0
    for i, p in enumerate(place):
        if p == Shard(dim):
            chunk = -(-size // mesh.size(i))
            start += coord[i] * chunk
            size = chunk
    return start


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
    q = split_heads(x @ p["wq"], cfg.padded_n_heads, cfg.resolved_head_dim)
    k, v = memory_kv
    o = attend(q, k, v, causal=False, kv_len=kv_len)
    return o.reshape(b, tq, -1) @ p["wo"]


def encode_memory_kv(
    enc_out: torch.Tensor, p: Params, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, _ = enc_out.shape
    dh = cfg.resolved_head_dim
    k = split_heads(enc_out @ p["wk"], cfg.n_kv_heads, dh)
    v = split_heads(enc_out @ p["wv"], cfg.n_kv_heads, dh)
    return k, v
