"""Mamba-2 (SSD, arXiv:2405.21060) block on the shared GLA core.  Port of
``repro.models.mamba2``.

State-space dual form: per head h with state size N and head dim P,
    S_t = exp(a_h·Δ_t) · S_{t−1} + (Δ_t x_t) B_tᵀ     (S: N×P)
    y_t = C_tᵀ S_t + D_h x_t
which is GLA "post" mode with scalar-per-head log-decay g_t = a_h·Δ_t,
k = B_t (shared across heads, n_groups = 1), q = C_t, v = Δ_t·x_t.  The
short causal conv (width 4) runs on the concatenated (x, B, C) projections.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import Draw, Params, dense_init, rmsnorm
from .config import ModelConfig
from .gla import gla_chunked, gla_decode_step


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    return d_inner, d_inner // ssm.head_dim, ssm.head_dim, ssm.d_state


def mamba2_params(draw: Draw, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    d_inner, nheads, hp, n = _dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        # separate in-projections (sharding-aligned boundaries)
        "w_z": dense_init(draw, (d, d_inner)),
        "w_x": dense_init(draw, (d, d_inner)),
        "w_b": dense_init(draw, (d, n)),
        "w_c": dense_init(draw, (d, n)),
        "w_dt": dense_init(draw, (d, nheads)),
        "conv_w": dense_init(draw, (cfg.ssm.conv_width, conv_dim), scale=0.5),
        "conv_b": draw.full((conv_dim,), 0.0),
        "a_log": draw.full((nheads,), 0.0),  # a = −exp(a_log)
        "dt_bias": draw.full((nheads,), 0.0),
        "d_skip": draw.full((nheads,), 1.0),
        "norm": draw.full((d_inner,), 1.0),
        "w_out": dense_init(draw, (d_inner, d)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time: x (B, T, C), w (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i : i + x.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b)


def _split(x: torch.Tensor, p: Params):
    return x @ p["w_z"], x @ p["w_x"], x @ p["w_b"], x @ p["w_c"], x @ p["w_dt"]


def _ssd_chunked(
    q: torch.Tensor,  # (B, T, N)   — C, shared across heads (n_groups = 1)
    k: torch.Tensor,  # (B, T, N)   — B, shared across heads
    v: torch.Tensor,  # (B, T, H, P)
    g: torch.Tensor,  # (B, T, H)   — scalar per-head log-decay
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head-shared SSD chunked scan: the (L, L) gram once per chunk, shared
    across heads; decays enter as per-(b, l, h) scalars."""
    b, t, n = q.shape
    h, p_dim = v.shape[2], v.shape[3]
    l = min(chunk, t)
    t_orig = t
    if t % l != 0:
        # inert padding steps: k = v = 0, g = 0 (decay 1) leave the state
        # untouched; padded outputs are sliced away below
        pad = l - t % l
        q, k, g = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, g))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        t = t + pad
    nc = t // l
    qc = q.float().reshape(b, nc, l, n)
    kc = k.float().reshape(b, nc, l, n)
    vc = v.float().reshape(b, nc, l, h, p_dim)
    gc = g.float().reshape(b, nc, l, h)
    cc = torch.cumsum(gc, dim=2)  # (B, nc, L, H)
    li = torch.arange(l, device=q.device)
    causal = (li[:, None] >= li[None, :])[None, :, :, None]

    s = torch.zeros(b, h, n, p_dim, dtype=torch.float32, device=q.device)
    outs = []
    for j in range(nc):
        qj, kj, vj, cj = qc[:, j], kc[:, j], vc[:, j], cc[:, j]
        cl = cj[:, -1]  # (B, H)
        # inter-chunk: o1 = exp(c)·(q · S)
        o1 = torch.einsum("blk,bhkv->blhv", qj, s) * torch.exp(cj)[..., None]
        # intra-chunk: shared gram × per-head decay matrix
        qk = torch.einsum("blk,bmk->blm", qj, kj)  # (B, L, L)
        delta = cj[:, :, None, :] - cj[:, None, :, :]  # (B, L, M, H)
        delta = torch.where(causal, delta, -torch.inf)
        o2 = torch.einsum("blmh,bmhv->blhv", qk[..., None] * torch.exp(delta), vj)
        # state carry: S' = exp(c_L)·S + Σ_l k_l · exp(c_L − c_l) · v_l
        decay_k = torch.exp(cl[:, None, :] - cj)  # (B, L, H)
        s = s * torch.exp(cl)[:, :, None, None] + torch.einsum(
            "blk,blh,blhv->bhkv", kj, decay_k, vj)
        outs.append(o1 + o2)
    out = torch.stack(outs, dim=1).reshape(b, t, h, p_dim)[:, :t_orig]
    return out.to(v.dtype), s


def mamba2_forward(
    x: torch.Tensor, p: Params, cfg: ModelConfig, chunk: int, return_state: bool = False,
):
    b, t, d = x.shape
    d_inner, nheads, hp, n = _dims(cfg)
    z, xin, bmat, cmat, dt = _split(x, p)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    conv_tail = conv_in[:, t - (cfg.ssm.conv_width - 1) :, :]
    xin = conv_out[..., :d_inner].reshape(b, t, nheads, hp)
    bmat = conv_out[..., d_inner : d_inner + n]
    cmat = conv_out[..., d_inner + n :]

    delta = F.softplus(dt.float() + p["dt_bias"])  # (B, T, H)
    a = -torch.exp(p["a_log"].float())  # (H,)
    g_scalar = delta * a  # (B, T, H)
    v = xin * delta[..., None]  # (B, T, H, P)

    if cfg.ssm.intra == "ssd":
        y, s_final = _ssd_chunked(cmat, bmat, v, g_scalar, chunk)
    else:
        g = g_scalar[..., None].expand(b, t, nheads, n)
        k = bmat[:, :, None, :].expand(b, t, nheads, n)
        q = cmat[:, :, None, :].expand(b, t, nheads, n)
        y, s_final = gla_chunked(q, k, v, g, mode="post", chunk=chunk, intra=cfg.ssm.intra)
    y = y.to(x.dtype) + (xin * p["d_skip"][None, None, :, None]).to(x.dtype)
    y = y.reshape(b, t, d_inner)
    y = rmsnorm(y, p["norm"], cfg.norm_eps) * F.silu(z.to(x.dtype))
    out = y @ p["w_out"]
    if return_state:
        return out, (conv_tail, s_final)
    return out


# ----------------------------------------------------------------------
# Decode: state = (conv tail (B, K−1, conv_dim), ssm state (B,H,N,P))
# ----------------------------------------------------------------------
def mamba2_state(batch: int, cfg: ModelConfig, dtype=torch.float32,
                 device=None) -> Dict[str, torch.Tensor]:
    d_inner, nheads, hp, n = _dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        "conv": torch.zeros(batch, cfg.ssm.conv_width - 1, conv_dim, dtype=dtype, device=device),
        "s": torch.zeros(batch, nheads, n, hp, dtype=torch.float32, device=device),
    }


def mamba2_step(
    x: torch.Tensor, st: Dict[str, torch.Tensor], p: Params, cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, D) one token."""
    b, d = x.shape
    d_inner, nheads, hp, n = _dims(cfg)
    z, xin, bmat, cmat, dt = _split(x, p)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)  # (B, conv_dim)
    hist = torch.cat([st["conv"], conv_in[:, None, :]], dim=1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"])
    xin = conv_out[..., :d_inner].reshape(b, nheads, hp)
    bmat = conv_out[..., d_inner : d_inner + n]
    cmat = conv_out[..., d_inner + n :]

    delta = F.softplus(dt.float() + p["dt_bias"])  # (B, H)
    a = -torch.exp(p["a_log"].float())
    g = (delta * a)[..., None].expand(b, nheads, n)
    k = bmat[:, None, :].expand(b, nheads, n)
    q = cmat[:, None, :].expand(b, nheads, n)
    v = xin * delta[..., None]

    y, s_new = gla_decode_step(q, k, v, g, st["s"], mode="post")
    y = y + xin * p["d_skip"][None, :, None]
    y = y.reshape(b, d_inner)
    y = rmsnorm(y, p["norm"], cfg.norm_eps) * F.silu(z)
    return y @ p["w_out"], {"conv": hist[:, 1:], "s": s_new}
