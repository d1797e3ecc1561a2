"""RWKV-6 "Finch" block (arXiv:2404.05892) — attention-free time mixing with
data-dependent decay, on the shared GLA core.  Port of
``repro.models.rwkv6``, with the reference's simplifications: static
token-shift interpolation factors, the decay LoRA kept, the per-head
GroupNorm on the wkv output an RMS norm per head.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import Draw, Params, dense_init, rmsnorm
from .config import ModelConfig
from .gla import gla_chunked, gla_decode_step


def rwkv6_params(draw: Draw, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    h = d // hd
    lora = max(32, d // 32)
    return {
        # time-mix interpolation factors (static simplification)
        "mu_r": draw.full((d,), 0.5),
        "mu_k": draw.full((d,), 0.5),
        "mu_v": draw.full((d,), 0.5),
        "mu_w": draw.full((d,), 0.5),
        "mu_g": draw.full((d,), 0.5),
        "w_r": dense_init(draw, (d, d)),
        "w_k": dense_init(draw, (d, d)),
        "w_v": dense_init(draw, (d, d)),
        "w_g": dense_init(draw, (d, d)),
        "w_o": dense_init(draw, (d, d)),
        # data-dependent decay LoRA: w = exp(−exp(w0 + tanh(x A) B))
        "w0": draw.full((d,), -1.0),
        "w_lora_a": dense_init(draw, (d, lora)),
        "w_lora_b": dense_init(draw, (lora, d), scale=0.01),
        "u": draw.full((h, hd), 0.0),  # per-head bonus
        "ln_x": draw.full((hd,), 1.0),  # per-head output norm
        # channel mix
        "cm_mu_k": draw.full((d,), 0.5),
        "cm_mu_r": draw.full((d,), 0.5),
        "cm_k": dense_init(draw, (d, cfg.d_ff)),
        "cm_v": dense_init(draw, (cfg.d_ff, d)),
        "cm_r": dense_init(draw, (d, d)),
    }


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros or ``last`` for the first position)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _decay(xw: torch.Tensor, p: Params) -> torch.Tensor:
    """log-decay g = −exp(w0 + tanh(x A) B) ≤ 0 (data-dependent)."""
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    return -torch.exp(p["w0"].float() + lora.float())


def time_mix(
    x: torch.Tensor, p: Params, cfg: ModelConfig, chunk: int, return_state: bool = False
):
    """x (B, T, D) → out, and with ``return_state`` the final GLA state."""
    b, t, d = x.shape
    hd = cfg.ssm.head_dim
    h = d // hd
    xx = _shift(x)

    def lerp(mu):
        return x + (xx - x) * mu

    r = (lerp(p["mu_r"]) @ p["w_r"]).reshape(b, t, h, hd)
    k = (lerp(p["mu_k"]) @ p["w_k"]).reshape(b, t, h, hd)
    v = (lerp(p["mu_v"]) @ p["w_v"]).reshape(b, t, h, hd)
    g = F.silu(lerp(p["mu_g"]) @ p["w_g"])
    w = _decay(lerp(p["mu_w"]), p).reshape(b, t, h, hd)

    o, s = gla_chunked(r, k, v, w, u=p["u"], mode="pre", chunk=chunk)
    o = rmsnorm(o, p["ln_x"], cfg.norm_eps)  # per-head norm
    out = (o.reshape(b, t, d) * g) @ p["w_o"]
    return (out, s) if return_state else out


def channel_mix(x: torch.Tensor, p: Params) -> torch.Tensor:
    xx = _shift(x)
    xk = x + (xx - x) * p["cm_mu_k"]
    xr = x + (xx - x) * p["cm_mu_r"]
    k = torch.square(torch.relu(xk @ p["cm_k"]))
    return torch.sigmoid(xr @ p["cm_r"]) * (k @ p["cm_v"])


# ----------------------------------------------------------------------
# Decode (recurrent) — state: (tm_last, cm_last, S)
# ----------------------------------------------------------------------
def rwkv6_state(batch: int, cfg: ModelConfig, dtype=torch.float32,
                device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    h = d // hd
    return {
        "tm_last": torch.zeros(batch, d, dtype=dtype, device=device),
        "cm_last": torch.zeros(batch, d, dtype=dtype, device=device),
        "s": torch.zeros(batch, h, hd, hd, dtype=torch.float32, device=device),
    }


def time_mix_step(
    x: torch.Tensor, st: Dict[str, torch.Tensor], p: Params, cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, D) single token."""
    b, d = x.shape
    hd = cfg.ssm.head_dim
    h = d // hd
    xx = st["tm_last"]

    def lerp(mu):
        return x + (xx - x) * mu

    r = (lerp(p["mu_r"]) @ p["w_r"]).reshape(b, h, hd)
    k = (lerp(p["mu_k"]) @ p["w_k"]).reshape(b, h, hd)
    v = (lerp(p["mu_v"]) @ p["w_v"]).reshape(b, h, hd)
    g = F.silu(lerp(p["mu_g"]) @ p["w_g"])
    w = _decay(lerp(p["mu_w"]), p).reshape(b, h, hd)
    o, s_new = gla_decode_step(r, k, v, w, st["s"], u=p["u"], mode="pre")
    o = rmsnorm(o, p["ln_x"], cfg.norm_eps).reshape(b, d) * g
    return o @ p["w_o"], {"tm_last": x, "cm_last": st["cm_last"], "s": s_new}


def channel_mix_step(
    x: torch.Tensor, st: Dict[str, torch.Tensor], p: Params
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    xx = st["cm_last"]
    xk = x + (xx - x) * p["cm_mu_k"]
    xr = x + (xx - x) * p["cm_mu_r"]
    k = torch.square(torch.relu(xk @ p["cm_k"]))
    out = torch.sigmoid(xr @ p["cm_r"]) * (k @ p["cm_v"])
    st = dict(st)
    st["cm_last"] = x
    return out, st
