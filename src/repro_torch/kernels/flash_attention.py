"""Forward flash attention: the hand-written Hopper kernel, its plain
PyTorch version and launch counters.

Counterpart of the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``): online-softmax attention over (B, T, H, Dh) tensors,
K and V already repeated to the query head count, scale ``Dh**-0.5`` on q,
optional causal mask (key ≤ query; masked logits ``-1e30``), f32 math, the
output in q's dtype.  No logsumexp and no backward pass.

The CUDA source is ``repro_torch/csrc/flash_attention.cu`` (its design and
what bounds it on the card are noted there), built into the port's kernel
library by :mod:`repro_torch.kernels._build`.  Nothing in the port calls
this function on its main path, as nothing in ``repro`` calls the TPU
kernel: it is a public kernel entry point.

The wrapper takes the plain version when q, k and v lie on the CPU and
launches the kernel for CUDA tensors (f32 or bf16, 8 ≤ Dh ≤ 256 in steps
of 8, any strides); it raises on anything else.  ``LAUNCHES`` counts kernel
launches and ``PLAIN_RUNS`` runs of the plain version.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from ._build import launch

NEG_INF = -1e30
DH_MAX = 256

KERNELS = ("flash_attention",)
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
PLAIN_RUNS: Dict[str, int] = {k: 0 for k in KERNELS}
_COUNT_LOCK = threading.Lock()

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_counters() -> None:
    """Set the launch and plain-run counts to 0."""
    with _COUNT_LOCK:
        for k in KERNELS:
            LAUNCHES[k] = 0
            PLAIN_RUNS[k] = 0


def _count(table: Dict[str, int]) -> None:
    with _COUNT_LOCK:
        table["flash_attention"] += 1


def _blocks(q, k, v, block_q: int, block_kv: int) -> Tuple[int, int]:
    """The reference's shape contract: (bq, bkv) = (min(block, T), ...),
    both dividing T."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention: q, k, v must share a (B, T, H, Dh) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    t = q.shape[1]
    bq, bkv = min(block_q, t), min(block_kv, t)
    if bq <= 0 or bkv <= 0 or t % bq or t % bkv:
        raise ValueError(f"flash_attention: T={t} must be a multiple of bq={bq} and bkv={bkv}")
    return bq, bkv


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = 256,
    block_kv: int = 256,
) -> torch.Tensor:
    """Plain version of :func:`flash_attention`: the TPU kernel's blocked
    online softmax, (bq, bkv) tile by tile in f32, tiles wholly in the
    future skipped; one rounding to q's dtype at the end."""
    bq, bkv = _blocks(q, k, v, block_q, block_kv)
    _count(PLAIN_RUNS)
    b, t, h, dh = q.shape
    scale = dh**-0.5
    qh = q.transpose(1, 2).float() * scale  # (B, H, T, Dh) views
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2).float()
    out = torch.empty(b, h, t, dh, dtype=torch.float32, device=q.device)
    rows = torch.arange(bq, device=q.device)
    cols = torch.arange(bkv, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    for q0 in range(0, t, bq):
        qi = qh[:, :, q0 : q0 + bq]
        m = torch.full((b, h, bq), NEG_INF, **f32)
        l = torch.zeros(b, h, bq, **f32)
        acc = torch.zeros(b, h, bq, dh, **f32)
        for k0 in range(0, t, bkv):
            if causal and k0 > q0 + bq - 1:
                break  # this tile and every later one lie in the future
            s = qi @ kh[:, :, k0 : k0 + bkv].transpose(-1, -2)
            if causal:
                s = torch.where((k0 + cols)[None, :] <= (q0 + rows)[:, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vh[:, :, k0 : k0 + bkv]
            m = m_new
        out[:, :, q0 : q0 + bq] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype).contiguous()


def flash_attention(
    q: torch.Tensor,  # (B, T, H, Dh)
    k: torch.Tensor,  # (B, T, H, Dh) — pre-repeated to the q head count
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = 256,
    block_kv: int = 256,
) -> torch.Tensor:
    """Forward attention ``softmax(q kᵀ · Dh^-0.5 [causal]) v`` per head.

    ``block_q``/``block_kv`` are the reference kernel's tiles: they set the
    plain version's blocking and the reference's rule that they divide T
    (``ValueError`` otherwise); the CUDA kernel tiles by 64 on its own and
    masks the ragged edge."""
    _blocks(q, k, v, block_q, block_kv)
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return flash_attention_plain(q, k, v, causal, block_q, block_kv)
    dev, dtype = q.device, q.dtype
    for x in (k, v):
        if x.device != dev:
            raise ValueError(f"flash_attention: tensors on {dev} and {x.device}")
        if x.dtype != dtype:
            raise TypeError(f"flash_attention: mixed dtypes {dtype} and {x.dtype}")
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    if dtype not in _SUFFIX:
        raise TypeError(f"flash_attention: kernel takes float32 or bfloat16, got {dtype}")
    b, t, h, dh = q.shape
    if dh > DH_MAX or dh % 8:
        raise ValueError(f"flash_attention: Dh={dh} must be a multiple of 8 and <= {DH_MAX}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H={b * h} exceeds the grid's 65535")
    out = torch.empty((b, t, h, dh), dtype=dtype, device=dev)
    if out.numel():
        launch(
            f"flash_attention_{_SUFFIX[dtype]}", dev,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, h, dh, int(bool(causal)), dh**-0.5,
            *q.stride(), *k.stride(), *v.stride(),
        )
        _count(LAUNCHES)
    return out
