"""Forward flash attention: the hand-written Hopper kernels, their plain
PyTorch version and launch counters.

Counterpart of the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``): online-softmax attention over (B, T, H, Dh) tensors,
K and V already repeated to the query head count, scale ``Dh**-0.5`` on q,
optional causal mask (key ≤ query; masked logits ``-1e30``), f32 math, the
output in q's dtype.  No logsumexp and no backward pass.

The CUDA source is ``repro_torch/csrc/flash_attention.cu`` (its design and
what bounds it on the card are noted there), built into the port's kernel
library by :mod:`repro_torch.kernels._build`.  The models' full-sequence
attention calls it on the card (:func:`repro_torch.models.attention.attend`:
causal self-attention in prefill and forward, the audio encoder's
non-causal layers), where the reference runs its XLA blocked attention;
it is also a public kernel entry point, as the TPU kernel is.

The wrapper takes the plain version when q, k and v lie on the CPU and
launches a kernel for CUDA tensors of any Dh, any B·H and any strides, in
f32, bf16, f16 or f64; it raises on anything else.  As the reference
does, f16 and f64 are computed in f32: they are converted to f32 on the
way in and the f32 kernel's output is rounded once to q's dtype on the
way out.  A Dh that is not a multiple of 8 is padded with zero columns to
the next one (exact: they add 0 to every dot product and to the padded
output columns, which are sliced off), with the true Dh's scale.  Which
kernel runs is a pure function of the dtype and Dh (:func:`route`):

* ``"wgmma_tma"``: bf16 with Dh ≤ 256, warpgroup MMA fed by TMA;
* ``"mma_3xtf32"``: f32 (f16, f64) with Dh ≤ 256, ``mma.sync`` in TF32
  with the three-product split (about f32 accuracy);
* ``"tc_cluster"``: Dh 264 to 4096 (``CLUSTER_DH_MAX``), bf16 on the
  ``wgmma_tma`` kernel and f32 (f16, f64) on the ``mma_3xtf32`` one, the
  head dim split over a thread-block cluster of ⌈Dh / 256⌉ blocks
  (:func:`cluster_shape`): each holds 192 or 256 of the columns of q, k, v
  and the output, and the cluster adds the blocks' partial scores in a
  fixed order through distributed shared memory, so S is computed once;
* ``"simt"``: Dh past 4096, the first kernel (f32 math on the CUDA
  cores): each block computes one 128-column chunk of the output and
  recomputes S for it.

The tensor-core kernels are built for tiles of 64, 128, 192 and 256
Dh-columns (fewer keys per K/V tile past 128, so that a block's shared
memory holds them); a Dh between two of them runs in the wider one,
padded with zero columns in shared memory (exact: they add 0 to every dot
product, and the output's padding columns are not stored), with the scale
of the true Dh.

The tensor-core routes (the cluster's too) read q, k and v by TMA or
16-byte ``cp.async``:
a tensor whose innermost stride is not 1, whose other strides are not
positive multiples of 16 bytes or whose data is not 16-byte aligned
(:func:`tma_ready`) is first copied contiguous by the wrapper.  A failed
build or launch raises; no route stands in for another.

``LAUNCHES`` counts kernel launches (all routes), ``ROUTE_LAUNCHES`` the
launches of each route and ``PLAIN_RUNS`` runs of the plain version.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from ._build import launch

NEG_INF = -1e30

KERNELS = ("flash_attention",)
ROUTES = ("wgmma_tma", "mma_3xtf32", "tc_cluster", "simt")
TC_DH_MAX = 256  # the widest Dh the tensor-core kernels' tiles hold
CLUSTER_SHARE_MAX = 256  # the widest share of Dh a cluster's block holds
CLUSTER_MAX = 16  # the H100's largest cluster (non-portable past 8 blocks)
CLUSTER_DH_MAX = CLUSTER_SHARE_MAX * CLUSTER_MAX  # the cluster route's reach
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
ROUTE_LAUNCHES: Dict[str, int] = {r: 0 for r in ROUTES}
PLAIN_RUNS: Dict[str, int] = {k: 0 for k in KERNELS}
_COUNT_LOCK = threading.Lock()

# route -> dtype -> C entry point (``csrc/flash_attention.cu``: the
# tensor-core entries take padded Dh 8..256, the cluster ones 264..4096,
# the simt ones Dh past 4096)
_ENTRY = {
    "wgmma_tma": {torch.bfloat16: "flash_attention_wgmma_bf16"},
    "mma_3xtf32": {torch.float32: "flash_attention_3xtf32_f32"},
    "tc_cluster": {torch.float32: "flash_attention_cluster_f32",
                   torch.bfloat16: "flash_attention_cluster_bf16"},
    "simt": {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"},
}
_ROOM = {torch.float32: "flash_cluster_room_f32", torch.bfloat16: "flash_cluster_room_bf16"}


def reset_counters() -> None:
    """Set the launch, per-route launch and plain-run counts to 0."""
    with _COUNT_LOCK:
        for k in KERNELS:
            LAUNCHES[k] = 0
            PLAIN_RUNS[k] = 0
        for r in ROUTES:
            ROUTE_LAUNCHES[r] = 0


def _count(table: Dict[str, int], route: str = "") -> None:
    with _COUNT_LOCK:
        table["flash_attention"] += 1
        if route:
            ROUTE_LAUNCHES[route] += 1


# the type each input type is computed in on the card (the reference
# computes in f32 and rounds once to q's type)
KERNEL_DTYPE = {torch.float32: torch.float32, torch.bfloat16: torch.bfloat16,
                torch.float16: torch.float32, torch.float64: torch.float32}


def padded_dh(dh: int) -> int:
    """The Dh the kernels run: ``dh`` rounded up to a multiple of 8."""
    return -(-dh // 8) * 8


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel that takes (dtype, Dh) on the card, by the padded Dh:
    up to ``TC_DH_MAX`` (256) ``"wgmma_tma"`` for bf16 and ``"mma_3xtf32"``
    for f32, f16 and f64 (run in f32); from 264 up to the cluster's reach
    ``CLUSTER_DH_MAX`` (4096: 16 blocks of 256 columns) ``"tc_cluster"``
    in every type; past it ``"simt"``."""
    if dtype not in KERNEL_DTYPE:
        raise TypeError(
            f"flash_attention: takes float32, bfloat16, float16 or float64, got {dtype}"
        )
    p = padded_dh(dh)
    if p <= TC_DH_MAX:
        return "wgmma_tma" if KERNEL_DTYPE[dtype] == torch.bfloat16 else "mma_3xtf32"
    return "tc_cluster" if p <= CLUSTER_DH_MAX else "simt"


def cluster_shape(dh: int) -> Tuple[int, int]:
    """(blocks per cluster, columns per block) of the cluster route for a
    Dh: ⌈padded Dh / 256⌉ blocks, each holding an equal share rounded up to
    a multiple of 64 (192 or 256; the last block's columns past Dh are
    zeros).  Dh 320: 2 of 192; 512: 2 of 256; 1000: 4 of 256."""
    p = padded_dh(dh)
    if not TC_DH_MAX < p <= CLUSTER_DH_MAX:
        raise ValueError(f"cluster_shape: padded Dh {p} is not on the cluster route")
    nc = -(-p // CLUSTER_SHARE_MAX)
    return nc, -(-(-(-p // nc)) // 64) * 64


def cluster_room(dtype: torch.dtype, dh: int, device: torch.device) -> Tuple[int, int]:
    """(blocks per cluster, clusters the card holds at once) of the cluster
    route for (dtype, Dh), by the kernel's own launch query; launches
    nothing and counts nothing; raises where the card cannot place such a
    cluster."""
    if route(dtype, dh) != "tc_cluster":
        raise ValueError(f"cluster_room: Dh {dh} is not on the cluster route")
    ctas, room = ctypes.c_int(0), ctypes.c_int(0)
    launch(_ROOM[KERNEL_DTYPE[dtype]], torch.device(device), padded_dh(dh),
           ctypes.byref(ctas), ctypes.byref(room))
    return ctas.value, room.value


def tma_ready(x: torch.Tensor) -> bool:
    """Whether the tensor-core routes can read ``x`` in place: innermost
    stride 1, every other stride a positive multiple of 16 bytes, data
    16-byte aligned."""
    size = x.element_size()
    return (
        x.stride(-1) == 1
        and all(s > 0 and s * size % 16 == 0 for s in x.stride()[:-1])
        and x.data_ptr() % 16 == 0
    )


def kernel_inputs(q, k, v, rt: str):
    """q, k, v as the kernel of route ``rt`` reads them: the tensor-core
    routes (``tc_cluster`` too) get a contiguous copy (fresh, so aligned)
    of each tensor that is not :func:`tma_ready`; the simt kernel takes
    any strides."""
    if rt == "simt":
        return q, k, v
    return tuple(x if tma_ready(x) else x.clone(memory_format=torch.contiguous_format)
                 for x in (q, k, v))


def kernel_operands(q, k, v):
    """(q, k, v, scale) as the kernels take them: in :data:`KERNEL_DTYPE`
    of q's type, Dh padded with zero columns to :func:`padded_dh` (new
    tensors where either changes), and the scale of the true Dh.  Any
    device: the CPU tests hold it against the plain version."""
    dh = q.shape[-1]
    kdtype, dhp = KERNEL_DTYPE[q.dtype], padded_dh(dh)

    def operand(x):
        if dhp == dh:
            return x.to(kdtype)  # x itself when the type is already right
        out = x.new_zeros((*x.shape[:-1], dhp), dtype=kdtype)
        out[..., :dh] = x  # converted and padded in one copy
        return out

    return operand(q), operand(k), operand(v), dh**-0.5


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
    (``ValueError`` otherwise); the CUDA kernels tile by their own sizes
    and mask the ragged edge.  On the card the route is :func:`route`'s;
    f16 and f64 run in f32, and Dh is padded to :func:`padded_dh`."""
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
    dh = q.shape[-1]
    rt = route(dtype, dh)
    q, k, v, scale = kernel_operands(q, k, v)
    b, t, h, dhp = q.shape
    out = torch.empty((b, t, h, dhp), dtype=q.dtype, device=dev)
    if out.numel():
        q, k, v = kernel_inputs(q, k, v, rt)
        launch(
            _ENTRY[rt][q.dtype], dev,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, h, dhp, int(bool(causal)), scale,
            *q.stride(), *k.stride(), *v.stride(),
        )
        _count(LAUNCHES, rt)
    # the padding columns off, one rounding to the input type
    return out[..., :dh].to(dtype).contiguous()
