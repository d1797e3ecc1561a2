"""Serving: prefill (prompt → cache) and decode_step (one token, cached).
Port of ``repro.models.decode``.

Cache layouts (stacked on a leading layer axis, the reference's keys):

  dense / vlm / moe : k, v           (L, B, S, Hkv, Dh)
  ssm (rwkv6)       : tm_last, cm_last (L, B, D); s (L, B, H, dk, dv)
  hybrid (zamba2)   : conv (L, B, K−1, C); s (L, B, H, N, P);
                      shared-attn ak, av (G, B, S, H, Dh) — one per group
                      (weights shared, caches distinct)
  audio (enc-dec)   : self k, v (L, B, S, Hkv, Dh);
                      cross xk, xv (L, B, S_src, Hkv, Dh) — precomputed;
                      src_len (0-d int32)

and ``pos``, a 0-d int32 tensor on the cache's device.  ``decode_step``
writes each new K/V row into the attention caches in place (the reference
returns new arrays; here a cache of ``S`` slots is never copied per
token) and replaces the recurrent states with new tensors, as the
reference does (their dtype may change as the reference's does).  Both
run without autograd.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import attention as attn
from . import mamba2 as m2
from . import moe as moe_mod
from . import rwkv6 as r6
from .common import Params, apply_norm, mlp_apply, tree_index
from .config import ModelConfig
from .transformer import encode, hybrid_groups, lm_logits, resolve_device

Cache = Dict[str, torch.Tensor]


# ======================================================================
# Cache initializers (zeros)
# ======================================================================
def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16,
               device=None) -> Cache:
    device = resolve_device(device)
    l = cfg.n_layers
    dh = cfg.resolved_head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    pos = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.family in ("dense", "vlm", "moe"):
        shape = (l, batch, s_max, cfg.n_kv_heads, dh)
        return {"k": zeros(*shape), "v": zeros(*shape), "pos": pos}
    if cfg.family == "ssm":  # rwkv6
        d, hd = cfg.d_model, cfg.ssm.head_dim
        return {
            "tm_last": zeros(l, batch, d),
            "cm_last": zeros(l, batch, d),
            "s": zeros(l, batch, d // hd, hd, hd, dt=torch.float32),
            "pos": pos,
        }
    if cfg.family == "hybrid":
        d_inner = cfg.ssm.expand * cfg.d_model
        conv_dim = d_inner + 2 * cfg.ssm.d_state
        g, _ = hybrid_groups(cfg)
        s_attn = min(cfg.sliding_window or s_max, s_max)
        return {
            "conv": zeros(l, batch, cfg.ssm.conv_width - 1, conv_dim),
            "s": zeros(l, batch, d_inner // cfg.ssm.head_dim, cfg.ssm.d_state,
                       cfg.ssm.head_dim, dt=torch.float32),
            "ak": zeros(g, batch, s_attn, cfg.n_kv_heads, dh),
            "av": zeros(g, batch, s_attn, cfg.n_kv_heads, dh),
            "pos": pos,
        }
    if cfg.family == "audio":
        shape = (l, batch, s_max, cfg.n_kv_heads, dh)
        return {
            "k": zeros(*shape), "v": zeros(*shape), "xk": zeros(*shape), "xv": zeros(*shape),
            "src_len": torch.tensor(s_max, dtype=torch.int32, device=device),
            "pos": pos,
        }
    raise ValueError(cfg.family)


# ======================================================================
# Decode step
# ======================================================================
@torch.no_grad()
def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: Cache,
    token: torch.Tensor,  # (B, 1) int
) -> Tuple[torch.Tensor, Cache]:
    """One autoregressive step.  Returns (logits (B, 1, Vp), the cache)."""
    pos = cache["pos"]
    x = params["embed"][token]  # (B, 1, D)

    if cfg.family in ("dense", "vlm", "moe"):
        x = _attn_decode_stack(cfg, params, cache, x, pos)
    elif cfg.family == "ssm":
        x = _rwkv_decode_stack(cfg, params, cache, x)
    elif cfg.family == "hybrid":
        x = _hybrid_decode_stack(cfg, params, cache, x, pos)
    elif cfg.family == "audio":
        x = _audio_decode_stack(cfg, params, cache, x, pos)
    else:
        raise ValueError(cfg.family)

    x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    cache["pos"] = pos + 1
    return lm_logits(params, x), cache


def _attn_decode_stack(cfg, params, cache, x, pos):
    for i in range(cfg.n_layers):
        lp = tree_index(params["layers"], i)
        h = apply_norm(x, lp["attn_norm"], cfg.norm, cfg.norm_eps)
        out, _ = attn.decode_attention(h, lp["attn"], cfg,
                                       {"k": cache["k"][i], "v": cache["v"][i]}, pos)
        x = x + out
        h = apply_norm(x, lp["mlp_norm"], cfg.norm, cfg.norm_eps)
        if cfg.family == "moe":
            x = x + moe_mod.moe_apply(h, lp["moe"], cfg)[0]
        else:
            x = x + mlp_apply(h, lp["mlp"], cfg.mlp)
    return x


def _rwkv_decode_stack(cfg, params, cache, x):
    x = x[:, 0]  # (B, D)
    tms, cms, ss = [], [], []
    for i in range(cfg.n_layers):
        lp = tree_index(params["layers"], i)
        st = {"tm_last": cache["tm_last"][i], "cm_last": cache["cm_last"][i],
              "s": cache["s"][i]}
        h = apply_norm(x, lp["tm_norm"], cfg.norm, cfg.norm_eps)
        out, st = r6.time_mix_step(h, st, lp["rwkv"], cfg)
        x = x + out
        h = apply_norm(x, lp["cm_norm"], cfg.norm, cfg.norm_eps)
        out, st = r6.channel_mix_step(h, st, lp["rwkv"])
        x = x + out
        tms.append(st["tm_last"])
        cms.append(st["cm_last"])
        ss.append(st["s"])
    cache["tm_last"], cache["cm_last"], cache["s"] = (torch.stack(a) for a in (tms, cms, ss))
    return x[:, None, :]


def _serving_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """zamba2's groups for prefill and decode, which (as the reference's
    reshape of the stack into groups) need them to cover every layer."""
    n_groups, every = hybrid_groups(cfg)
    if n_groups * every != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not groups of {every}")
    return n_groups, every


def _hybrid_decode_stack(cfg, params, cache, x, pos):
    n_groups, every = _serving_groups(cfg)
    x = x[:, 0]
    sp = params["shared_attn"]
    # ring-buffer slot for the sliding-window cache (wraps at long context)
    slot = torch.remainder(pos, cache["ak"].shape[2])
    convs, ss = [], []
    for g in range(n_groups):
        for i in range(g * every, (g + 1) * every):
            lp = tree_index(params["layers"], i)
            h = apply_norm(x, lp["norm"], cfg.norm, cfg.norm_eps)
            out, st = m2.mamba2_step(h, {"conv": cache["conv"][i], "s": cache["s"][i]},
                                     lp["mamba"], cfg)
            x = x + out
            convs.append(st["conv"])
            ss.append(st["s"])
        h = apply_norm(x[:, None], sp["attn_norm"], cfg.norm, cfg.norm_eps)
        out, _ = attn.decode_attention(h, sp["attn"], cfg,
                                       {"k": cache["ak"][g], "v": cache["av"][g]}, pos,
                                       write_slot=slot)
        x = x + out[:, 0]
        h = apply_norm(x[:, None], sp["mlp_norm"], cfg.norm, cfg.norm_eps)
        x = x + mlp_apply(h, sp["mlp"], cfg.mlp)[:, 0]
    cache["conv"], cache["s"] = torch.stack(convs), torch.stack(ss)
    return x[:, None, :]


def _audio_decode_stack(cfg, params, cache, x, pos):
    src_len = cache.get("src_len")
    for i in range(cfg.n_layers):
        lp = tree_index(params["layers"], i)
        h = apply_norm(x, lp["attn_norm"], cfg.norm, cfg.norm_eps)
        out, _ = attn.decode_attention(h, lp["attn"], cfg,
                                       {"k": cache["k"][i], "v": cache["v"][i]}, pos)
        x = x + out
        h = apply_norm(x, lp["cross_norm"], cfg.norm, cfg.norm_eps)
        x = x + attn.cross_attention(h, (cache["xk"][i], cache["xv"][i]), lp["cross"], cfg,
                                     kv_len=src_len)
        h = apply_norm(x, lp["mlp_norm"], cfg.norm, cfg.norm_eps)
        x = x + mlp_apply(h, lp["mlp"], cfg.mlp)
    return x


# ======================================================================
# Prefill: prompt → (last-token logits, filled cache)
# ======================================================================
@torch.no_grad()
def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    *,
    extra: Optional[Dict[str, torch.Tensor]] = None,
    remat: bool = True,
    attn_block: int = 512,
    cache_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Cache]:
    """``remat`` is accepted for the reference's signature: prefill runs
    without autograd, where it changes nothing."""
    b, t = tokens.shape
    x = params["embed"][tokens]
    if cfg.family == "vlm":
        patches = extra["patches"] @ params["frontend_proj"]
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    dev = x.device
    positions = torch.arange(x.shape[1], device=dev)[None, :]

    def self_attn(x, p, causal=True):
        """Self-attention of a normed x: (output added to the residual, k, v)."""
        q, k, v = attn._project_qkv(x, p, cfg, positions)
        o = attn.attend(q, k, v, causal=causal, block=attn_block)
        return o.reshape(x.shape[0], x.shape[1], -1) @ p["wo"], k, v

    def as_cache(*a):
        return (torch.stack(z).to(cache_dtype) for z in a)

    if cfg.family in ("dense", "vlm", "moe"):
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = tree_index(params["layers"], i)
            h = apply_norm(x, lp["attn_norm"], cfg.norm, cfg.norm_eps)
            o, k, v = self_attn(h, lp["attn"])
            x = x + o
            h = apply_norm(x, lp["mlp_norm"], cfg.norm, cfg.norm_eps)
            if cfg.family == "moe":
                x = x + moe_mod.moe_apply(h, lp["moe"], cfg)[0]
            else:
                x = x + mlp_apply(h, lp["mlp"], cfg.mlp)
            ks.append(k)
            vs.append(v)
        k, v = as_cache(ks, vs)
        cache = {"k": k, "v": v, "pos": torch.tensor(x.shape[1], dtype=torch.int32, device=dev)}

    elif cfg.family == "ssm":
        tms, cms, ss = [], [], []
        for i in range(cfg.n_layers):
            lp = tree_index(params["layers"], i)
            p = lp["rwkv"]
            h = apply_norm(x, lp["tm_norm"], cfg.norm, cfg.norm_eps)
            o, s = r6.time_mix(h, p, cfg, cfg.ssm.chunk, return_state=True)
            x = x + o
            h2 = apply_norm(x, lp["cm_norm"], cfg.norm, cfg.norm_eps)
            x = x + r6.channel_mix(h2, p)
            tms.append(h[:, -1])
            cms.append(h2[:, -1])
            ss.append(s)
        tm, cm = as_cache(tms, cms)
        cache = {"tm_last": tm, "cm_last": cm, "s": torch.stack(ss),
                 "pos": torch.tensor(t, dtype=torch.int32, device=dev)}

    elif cfg.family == "hybrid":
        n_groups, every = _serving_groups(cfg)
        sp = params["shared_attn"]
        convs, ss, aks, avs = [], [], [], []
        for g in range(n_groups):
            for i in range(g * every, (g + 1) * every):
                lp = tree_index(params["layers"], i)
                h = apply_norm(x, lp["norm"], cfg.norm, cfg.norm_eps)
                out, (conv_tail, s) = m2.mamba2_forward(h, lp["mamba"], cfg, cfg.ssm.chunk,
                                                        return_state=True)
                x = x + out
                convs.append(conv_tail)
                ss.append(s)
            h = apply_norm(x, sp["attn_norm"], cfg.norm, cfg.norm_eps)
            o, k, v = self_attn(h, sp["attn"])
            x = x + o
            h = apply_norm(x, sp["mlp_norm"], cfg.norm, cfg.norm_eps)
            x = x + mlp_apply(h, sp["mlp"], cfg.mlp)
            aks.append(k)
            avs.append(v)
        conv, ak, av = as_cache(convs, aks, avs)
        cache = {"conv": conv, "s": torch.stack(ss), "ak": ak, "av": av,
                 "pos": torch.tensor(t, dtype=torch.int32, device=dev)}

    elif cfg.family == "audio":
        memory = encode(cfg, params, extra["frames"], False, attn_block)
        ks, vs, xks, xvs = [], [], [], []
        for i in range(cfg.n_layers):
            lp = tree_index(params["layers"], i)
            h = apply_norm(x, lp["attn_norm"], cfg.norm, cfg.norm_eps)
            o, k, v = self_attn(h, lp["attn"])
            x = x + o
            h = apply_norm(x, lp["cross_norm"], cfg.norm, cfg.norm_eps)
            xk, xv = attn.encode_memory_kv(memory, lp["cross"], cfg)
            x = x + attn.cross_attention(h, (xk, xv), lp["cross"], cfg)
            h = apply_norm(x, lp["mlp_norm"], cfg.norm, cfg.norm_eps)
            x = x + mlp_apply(h, lp["mlp"], cfg.mlp)
            ks.append(k)
            vs.append(v)
            xks.append(xk)
            xvs.append(xv)
        k, v, xk, xv = as_cache(ks, vs, xks, xvs)
        cache = {"k": k, "v": v, "xk": xk, "xv": xv,
                 "src_len": torch.tensor(memory.shape[1], dtype=torch.int32, device=dev),
                 "pos": torch.tensor(t, dtype=torch.int32, device=dev)}

    else:
        raise NotImplementedError(cfg.family)

    x = apply_norm(x[:, -1:], params["final_norm"], cfg.norm, cfg.norm_eps)
    return lm_logits(params, x), cache
