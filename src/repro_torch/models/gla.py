"""Chunked gated linear attention — the shared sequence-mixing core of
RWKV-6 ("pre" read + bonus) and Mamba-2/SSD ("post" read).  Port of
``repro.models.gla``.

Recurrence per head (state S: dk×dv):
    S_t = diag(exp(g_t)) · S_{t−1} + k_t v_tᵀ          g_t ≤ 0 (log-decay)
    post:  o_t = q_tᵀ S_t                               (Mamba-2 / GLA)
    pre :  o_t = q_tᵀ S_{t−1} + (q_t ⊙ u) · k_t v_t     (RWKV-6, u = bonus)

Chunked evaluation (chunk length L): the inter-chunk terms are matmuls
whose decay factors exp(c_t) and exp(c_L − c_s) are ≤ 1 (the cumulative
log-decay c is non-increasing).  The intra-chunk term runs as an exact
short loop of length L (``intra="scan"``, any per-channel decay) or, for a
decay that is scalar per head, as a masked (L, L) gram (``"matmul"``).

All shapes: q, k, g: (B, T, H, dk); v: (B, T, H, dv).  Returns the output
(B, T, H, dv) and the final state (B, H, dk, dv) for decode continuation.
The reference's ``lax.scan`` over chunks is a Python loop here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def gla_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    u: Optional[torch.Tensor] = None,
    mode: str = "post",
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
    intra: str = "scan",
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    l = min(chunk, t)
    t_orig = t
    if t % l != 0:
        # inert padding steps: k = v = 0 and g = 0 (decay 1) leave the
        # state untouched; padded outputs are sliced away below
        pad = (0, 0, 0, 0, 0, l - t % l)
        q, k, v, g = (F.pad(a, pad) for a in (q, k, v, g))
        t = q.shape[1]
    nc = t // l

    qc = q.float().reshape(b, nc, l, h, dk)
    kc = k.float().reshape(b, nc, l, h, dk)
    vc = v.float().reshape(b, nc, l, h, dv)
    gc = g.float().reshape(b, nc, l, h, dk)
    cc = torch.cumsum(gc, dim=2)  # inclusive cumulative log-decay
    s = (torch.zeros(b, h, dk, dv, dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float())
    bonus = u if u is not None else 1.0
    li = torch.arange(l, device=q.device)

    outs = []
    for j in range(nc):
        qj, kj, vj, gj, cj = qc[:, j], kc[:, j], vc[:, j], gc[:, j], cc[:, j]
        cl = cj[:, -1:]  # (B, 1, H, dk)
        # ---- inter-chunk: contribution of the carried state
        qe = qj * torch.exp(cj if mode == "post" else cj - gj)
        o_inter = torch.einsum("blhk,bhkv->blhv", qe, s)

        if intra == "matmul":
            # masked gram (scalar-per-head decay): A[t,s] = (q_t·k_s)·exp(c_t − c_s),
            # the decay from differences masked in log space before exp
            cs = cj[..., 0]  # (B, L, H)
            qk = torch.einsum("blhk,bmhk->bhlm", qj, kj)
            ld_k = cs.transpose(1, 2)  # (B, H, L)
            ld_q = ld_k if mode == "post" else (cs - gj[..., 0]).transpose(1, 2)
            causal = li[:, None] >= li[None, :] if mode == "post" else li[:, None] > li[None, :]
            delta = ld_q[:, :, :, None] - ld_k[:, :, None, :]
            delta = torch.where(causal, delta, -torch.inf)
            o_intra = torch.einsum("bhlm,bmhv->blhv", qk * torch.exp(delta), vj)
            if mode == "pre":  # bonus diagonal term
                diag_w = torch.einsum("blhk,blhk->blh", qj * bonus, kj)
                o_intra = o_intra + diag_w[..., None] * vj
        else:
            # exact short loop (any per-channel decay)
            st = torch.zeros(b, h, dk, dv, dtype=torch.float32, device=q.device)
            steps = []
            for i in range(l):
                qt, kt, vt, gt = qj[:, i], kj[:, i], vj[:, i], gj[:, i]
                st_new = st * torch.exp(gt)[..., None] + kt[..., None] * vt[..., None, :]
                if mode == "post":
                    ot = torch.einsum("bhk,bhkv->bhv", qt, st_new)
                else:
                    ot = torch.einsum("bhk,bhkv->bhv", qt, st)
                    ot = ot + torch.einsum("bhk,bhk,bhv->bhv", qt * bonus, kt, vt)
                steps.append(ot)
                st = st_new
            o_intra = torch.stack(steps, dim=1)  # (B, L, H, dv)

        # ---- state carry: S' = diag(exp(c_L))·S + Σ_s (k_s ⊙ exp(c_L−c_s)) v_sᵀ
        kd = kj * torch.exp(cl - cj)
        s = s * torch.exp(cl[:, 0])[..., None] + torch.einsum("blhk,blhv->bhkv", kd, vj)
        outs.append(o_inter + o_intra)

    out = torch.stack(outs, dim=1).reshape(b, t, h, dv)[:, :t_orig]
    return out.to(q.dtype), s


def gla_decode_step(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    state: torch.Tensor,
    u: Optional[torch.Tensor] = None,
    mode: str = "post",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence: q,k,g (B,H,dk), v (B,H,dv), state (B,H,dk,dv)."""
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    st = state.float()
    st_new = st * torch.exp(gf)[..., None] + kf[..., None] * vf[..., None, :]
    if mode == "post":
        o = torch.einsum("bhk,bhkv->bhv", qf, st_new)
    else:
        o = torch.einsum("bhk,bhkv->bhv", qf, st)
        o = o + torch.einsum("bhk,bhk,bhv->bhv", qf * (u if u is not None else 1.0), kf, vf)
    return o.to(q.dtype), st_new
