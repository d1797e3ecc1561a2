"""Mixture-of-Experts layer: shared + routed top-k experts.  Port of
``repro.models.moe``.

Dispatch is per sequence row: top-k routing, a stable sort of the (T·k)
assignments by expert, a capacity-truncated gather into an (E, C, D)
expert batch, the expert SwiGLU as one stacked einsum, a weighted
scatter-combine.  ``expert_loads`` gives the router's expected per-expert
work, the malleable task lengths the PM planner reads.

Two rules of the reference are written out here, where PyTorch would
leave them to chance:

* top-k takes the lower expert index first among equal probabilities
  (``jax.lax.top_k``): a stable descending sort, not ``torch.topk``;
* the reference scatters every assignment past an expert's capacity c to
  slot c−1 with token −1 and gate 0, after the token kept there, and the
  last write wins: an expert with more than c assignments ends with slot
  c−1 empty.  ``index_put_`` with repeated indices has no defined order,
  so :func:`_dispatch` empties that slot explicitly.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.constraints import constrain, on_shards

from .common import Draw, Params, dense_init
from .config import ModelConfig, MoEConfig


def moe_params(draw: Draw, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    m = cfg.moe
    d, f = cfg.d_model, m.d_expert
    e_pad = cfg.padded_n_experts  # expert stacks padded for EP sharding
    p = {
        "router": dense_init(draw, (d, m.n_experts), scale=0.02),
        "w_gate": dense_init(draw, (e_pad, d, f)),
        "w_up": dense_init(draw, (e_pad, d, f)),
        "w_down": dense_init(draw, (e_pad, f, d), scale=f**-0.5),
    }
    if m.n_shared > 0:
        fs = m.n_shared * f
        p["shared_gate"] = dense_init(draw, (d, fs))
        p["shared_up"] = dense_init(draw, (d, fs))
        p["shared_down"] = dense_init(draw, (fs, d), scale=fs**-0.5)
    return p


def _capacity(t: int, m: MoEConfig) -> int:
    c = int(t * m.top_k * m.capacity_factor / m.n_experts) + 1
    return max(4, (c + 3) // 4 * 4)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, the lower index first on ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(idx: torch.Tensor, gate: torch.Tensor, e: int, c: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx, gate: (B, T, k) → table (B, E, C) of token ids (−1 empty) and
    gates (B, E, C), each row dispatched on its own.

    Tokens beyond an expert's capacity are dropped (GShard); the residual
    connection carries them unchanged.  Slot c−1 of an expert with more
    than c assignments is empty (the reference's last write)."""
    b, t, k = idx.shape
    n = t * k
    sorted_e, order = torch.sort(idx.reshape(b, n), dim=-1, stable=True)
    experts = torch.arange(e, device=idx.device)
    seg_start = (sorted_e[:, :, None] < experts).sum(1)  # (B, E)
    counts = (sorted_e[:, :, None] == experts).sum(1)  # (B, E)
    pos = torch.arange(n, device=idx.device) - seg_start.gather(1, sorted_e)
    keep = pos < c
    # kept assignments go to distinct slots; the dropped ones to a spare
    # slot c, sliced off (no kept slot is written twice)
    slot = torch.where(keep, pos, c)
    flat = ((torch.arange(b, device=idx.device)[:, None] * e + sorted_e) * (c + 1) + slot).reshape(-1)
    table = torch.full((b * e * (c + 1),), -1, dtype=torch.long, device=idx.device)
    table[flat] = (order // k).reshape(-1)
    gates = torch.zeros(b * e * (c + 1), dtype=gate.dtype, device=idx.device)
    gates[flat] = gate.reshape(b, n).gather(1, order).reshape(-1)
    table = table.reshape(b, e, c + 1)[..., :c].clone()
    gates = gates.reshape(b, e, c + 1)[..., :c].clone()
    over = counts > c
    table[..., c - 1] = torch.where(over, -1, table[..., c - 1])
    gates[..., c - 1] = torch.where(over, 0.0, gates[..., c - 1])
    return table, gates


def _dispatch_row(idx: torch.Tensor, gate: torch.Tensor, e: int, c: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx, gate: (T, k) → table (E, C) of token ids (−1 empty), gates (E, C)."""
    table, gates = _dispatch(idx[None], gate[None], e, c)
    return table[0], gates[0]


def _gather(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The expert batch (B, E, C, D): each slot's token row of x (B, T, D)
    by the dispatch table (B, E, C), zeros in empty slots."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[rows, table.clamp(min=0)] * (table >= 0)[..., None]


def _combine(y: torch.Tensor, table: torch.Tensor, t: int) -> torch.Tensor:
    """Scatter-combine y (B, E, C, D) back to (B, T, D) by the dispatch
    table (B, E, C); empty slots add nothing."""
    b, d = y.shape[0], y.shape[-1]
    rows = torch.arange(b, device=y.device)[:, None, None]
    out = torch.zeros(b * t, d, dtype=y.dtype, device=y.device)
    out.index_add_(0, (rows * t + table.clamp(min=0)).reshape(-1),
                   (y * (table >= 0)[..., None]).reshape(-1, d))
    return out.reshape(b, t, d)


def _expert_counts(idx: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments per expert (f32) of each row of idx (B, T, k): (B, E).
    A sum of ones, exact: ``bincount`` reads its input's max on the host,
    which a CUDA graph's capture (the server's decode) cannot do."""
    flat = idx.reshape(idx.shape[0], -1)
    ones = torch.ones(flat.shape, dtype=torch.float32, device=idx.device)
    return torch.zeros(flat.shape[0], e, dtype=torch.float32,
                       device=idx.device).scatter_add_(1, flat, ones)


def moe_apply(x: torch.Tensor, p: Params, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) → (out, aux_loss)."""
    m = cfg.moe
    t = x.shape[1]
    e, k = m.n_experts, m.top_k
    c = _capacity(t, m)
    e_pad = cfg.padded_n_experts  # == e unless "ep" sharding pads

    logits = (x @ p["router"]).float()  # (B, T, E) true experts
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)

    # dispatch, gather and combine are row-local, and DTensor has no
    # strategy for their index ops: each rank takes its own rows
    rows = (0, None)
    table, gates = on_shards(functools.partial(_dispatch, e=e_pad, c=c), (top_i, top_p),
                             (rows, rows), (rows, rows))
    e_axis = "model" if cfg.moe_sharding == "ep" else None  # experts sharded under EP
    table = constrain(table, ("pod", "data"), e_axis)
    gates = constrain(gates, ("pod", "data"), e_axis)
    xg = on_shards(_gather, (x, table), (rows, rows), (rows,))  # (B, E, C, D)
    xg = constrain(xg, ("pod", "data"), e_axis)

    h = torch.einsum("becd,edf->becf", xg, p["w_gate"])
    u = torch.einsum("becd,edf->becf", xg, p["w_up"])
    y = torch.einsum("becf,efd->becd", F.silu(h) * u, p["w_down"])
    y = constrain(y, ("pod", "data"), e_axis) * gates[..., None].to(y.dtype)

    out = on_shards(functools.partial(_combine, t=t), (y, table), (rows, rows), (rows,))

    if m.n_shared > 0:
        g = F.silu(x @ p["shared_gate"])
        out = out + (g * (x @ p["shared_up"])) @ p["shared_down"]

    # load-balancing aux loss (Switch): E · Σ_e f_e · P_e
    me = probs.mean(dim=(0, 1))  # mean router prob per expert
    counts = on_shards(functools.partial(_expert_counts, e=e), (top_i,), (rows,), (rows,)).sum(0)
    fe = counts / counts.sum()
    aux = e * (fe * me).sum() * m.aux_loss_weight
    return out.to(x.dtype), aux


def expert_loads(probs_mean: torch.Tensor, flops_per_token: float) -> torch.Tensor:
    """Expected per-expert work (malleable task lengths for the PM planner)."""
    return probs_mean * flops_per_token
