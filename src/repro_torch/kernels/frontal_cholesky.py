"""Blocked partial Cholesky of frontal matrices: the hand-written Hopper
kernels, their plain PyTorch versions, launch counters and the build.

Counterparts of the Pallas TPU kernels in ``repro/kernels/frontal_cholesky.py``:

* ``front_factor``  ← ``front_factor_vmem`` (batched there by ``vmap``): the
  partial factorization of the leading ``nbp`` columns of a (B, mp, mp) stack
  of padded fronts, one thread-block cluster per front.
* ``panel_factor``  ← ``panel_factor``: ``[L11; A21·L11⁻ᵀ]`` of an (mp, nb)
  slab, for the large-front path (one cluster, the same device routine).
* ``syrk_downdate`` ← ``syrk_downdate``: ``C − A·Aᵀ``, the full result by
  default, as the reference returns it; ``uplo='L'`` is BLAS ``syrk``: the
  lower triangle holds ``C − A·Aᵀ``, the strictly-upper part holds C
  unchanged (what the large-front route reads: ``tril`` only).
* ``extend_add`` ← none: the TPU executor extend-adds on the host.  It adds
  a child's Schur block, read from its lower triangle and upcast to
  float64, into its parent's float64 front at the child's positions there,
  mirrored, in place: the large-front route assembles on the card.  At a
  separator chain link's shape (a 3,794² f64 block into a 4,096² front)
  it takes 0.16 ms on an H100 (bytes bound 0.086 ms), the plain version
  1.05 ms and torch's ``index_put_(accumulate=True)`` of the mirrored
  block 5.3 ms; it needs no n² temporaries (the plain version makes four).

The CUDA source is ``repro_torch/csrc/frontal_cholesky.cu`` (design notes
and what bounds each kernel on the card are there).  It is built into the
port's one kernel library by :mod:`repro_torch.kernels._build` (one ``nvcc``
call for every source, ``sm_90a``, plain C interface, ``ctypes``).  The
cluster that factors a front has a size set by the front's order alone
(:func:`cluster_room` reports it and how many fit on the card), so a
front's bits never depend on its batch; a launch the card cannot place
raises.  :mod:`repro_torch.kernels.frontal_split` times the kernels'
phases on the card.

Each wrapper takes the plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor, after checking device, dtype, shape, the
multiple-of-128 constraints and contiguity; it raises on anything else.
``LAUNCHES`` counts kernel launches and ``PLAIN_RUNS`` runs of the plain
versions, so a run can show which path it took; ``DEVICE_LAUNCHES``
counts the launches by (kernel, CUDA device index), so a run split over
cards can show that each card launched.

Conventions (shared with the TPU kernels): fronts are symmetric, only the
lower triangle is kept correct, factored columns end with zeros above the
diagonal, and fronts are padded with a unit diagonal so padded pivots factor
to no-ops.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from ._build import launch

TILE = 128  # pivot block width of every kernel
VMEM_FRONT_MAX = 1024  # fronts up to this padded order take front_factor

KERNELS = ("front_factor", "panel_factor", "syrk_downdate", "extend_add")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
PLAIN_RUNS: Dict[str, int] = {k: 0 for k in KERNELS}
DEVICE_LAUNCHES: Dict[Tuple[str, int], int] = {}
_COUNT_LOCK = threading.Lock()


def reset_counters() -> None:
    """Set every launch and plain-run count to 0."""
    with _COUNT_LOCK:
        for k in KERNELS:
            LAUNCHES[k] = 0
            PLAIN_RUNS[k] = 0
        DEVICE_LAUNCHES.clear()


def _count(table: Dict[str, int], name: str) -> None:
    with _COUNT_LOCK:
        table[name] += 1


# ----------------------------------------------------------------------
# Launch
# ----------------------------------------------------------------------
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_cuda(name: str, *tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    dtype = tensors[0].dtype
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: kernel takes float32 or float64, got {dtype}")
    return _SUFFIX[dtype]


def _launch(name: str, suffix: str, device: torch.device, *args) -> None:
    launch(f"{name}_{suffix}", device, *args)
    key = (name, device.index)  # a CUDA tensor's device always has its index
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        DEVICE_LAUNCHES[key] = DEVICE_LAUNCHES.get(key, 0) + 1


def cluster_room(mp: int, dtype: torch.dtype, device: torch.device) -> Tuple[int, int]:
    """(CTAs per cluster, clusters the card holds at once) for the cluster
    that factors an (mp, mp) front, or an mp-row panel, in ``dtype``.  The
    cluster's size depends on ``mp`` only.  Launches nothing and counts
    nothing; raises where the card cannot place such a cluster."""
    if dtype not in _SUFFIX:
        raise TypeError(f"cluster_room: kernel takes float32 or float64, got {dtype}")
    size, room = ctypes.c_int(0), ctypes.c_int(0)
    launch(f"front_cluster_room_{_SUFFIX[dtype]}", torch.device(device), mp,
           ctypes.byref(size), ctypes.byref(room))
    return size.value, room.value


# ----------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ----------------------------------------------------------------------
def _factor_slab_plain(a: torch.Tensor, nfac: int) -> None:
    """In place: the blocked column algorithm of the TPU kernels on one
    (mp, ncols) slab whose row i aligns with column i.  Per 128-column
    block, each column is scaled by the square root of its pivot (zeros
    above the diagonal) and downdates the block's later columns; then one
    product downdates every column right of the block."""
    mp, ncols = a.shape
    for off in range(0, nfac, TILE):
        hi = min(off + TILE, ncols)
        for idx in range(off, off + TILE):
            dsq = torch.sqrt(a[idx, idx])
            below = a[idx + 1 :, idx] / dsq
            a[:idx, idx] = 0
            a[idx, idx] = dsq
            a[idx + 1 :, idx] = below
            a[idx + 1 :, idx + 1 : hi] -= below[:, None] * below[: hi - idx - 1][None, :]
        if hi < ncols:
            panel = a[:, off:hi].clone()
            panel[off + torch.arange(TILE), torch.arange(TILE)] = 0  # strictly lower
            a[:, hi:] -= panel @ panel[hi:ncols].T


def front_factor_plain(fronts: torch.Tensor, nbp: int) -> torch.Tensor:
    """Plain version of :func:`front_factor`: one front at a time, so a
    front's bits never depend on the batch it rides in."""
    _count(PLAIN_RUNS, "front_factor")
    out = fronts.clone()
    for f in out:
        _factor_slab_plain(f, nbp)
    return out


def panel_factor_plain(slab: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`panel_factor`."""
    _count(PLAIN_RUNS, "panel_factor")
    out = slab.clone()
    _factor_slab_plain(out, slab.shape[1])
    return out


def syrk_downdate_plain(
    c: torch.Tensor, a: torch.Tensor, uplo: Optional[str] = None
) -> torch.Tensor:
    """Plain version of :func:`syrk_downdate` (the same ``uplo`` rule)."""
    _check_uplo(uplo)
    _count(PLAIN_RUNS, "syrk_downdate")
    out = c - a @ a.T
    if uplo == "L":
        out = torch.tril(out) + torch.triu(c, 1)
    return out


def extend_add_plain(dst: torch.Tensor, src: torch.Tensor, pos: torch.Tensor) -> None:
    """Plain version of :func:`extend_add`: the child's block mirrored
    from its lower triangle (``x + 0.0`` turns -0 into +0, as the host's
    ``low + low.T − diag`` does), added at ``pos`` × ``pos``."""
    _count(PLAIN_RUNS, "extend_add")
    n = pos.shape[0]
    low = torch.tril(src[:n, :n].to(torch.float64)) + 0.0
    below = torch.ones(n, n, dtype=torch.bool, device=low.device).tril()
    p = pos.long()
    dst[p[:, None], p[None, :]] += torch.where(below, low, low.T)


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------
def front_factor(fronts: torch.Tensor, nbp: int) -> torch.Tensor:
    """Factor the leading ``nbp`` columns of each padded front of a
    (B, mp, mp) stack.  Returns a new stack: L in columns [0, nbp) (zeros
    above the diagonal) and the Schur complement in the trailing block,
    lower triangle."""
    if fronts.ndim != 3 or fronts.shape[1] != fronts.shape[2]:
        raise ValueError(f"front_factor: need (B, mp, mp), got {tuple(fronts.shape)}")
    b, mp, _ = fronts.shape
    if mp % TILE or nbp % TILE or not 0 < nbp <= mp:
        raise ValueError(f"front_factor: mp={mp}, nbp={nbp} must be multiples of {TILE}, nbp <= mp")
    if fronts.device.type == "cpu":
        return front_factor_plain(fronts, nbp)
    suffix = _check_cuda("front_factor", fronts)
    out = torch.empty_like(fronts)
    out.copy_(fronts)
    if b:
        _launch("front_factor", suffix, fronts.device, out.data_ptr(), b, mp, nbp)
    return out


def panel_factor(slab: torch.Tensor) -> torch.Tensor:
    """Factor an (mp, nb) slab (mp ≥ nb, both multiples of 128): Cholesky of
    the leading nb×nb block and the solve of the rows below it."""
    if slab.ndim != 2:
        raise ValueError(f"panel_factor: need (mp, nb), got {tuple(slab.shape)}")
    mp, nb = slab.shape
    if mp % TILE or nb % TILE or not 0 < nb <= mp:
        raise ValueError(f"panel_factor: mp={mp}, nb={nb} must be multiples of {TILE}, nb <= mp")
    if slab.device.type == "cpu":
        return panel_factor_plain(slab)
    suffix = _check_cuda("panel_factor", slab)
    out = torch.empty_like(slab)
    out.copy_(slab)
    _launch("panel_factor", suffix, slab.device, out.data_ptr(), mp, nb)
    return out


def syrk_operand(a: torch.Tensor) -> torch.Tensor:
    """A as the SYRK kernel reads it, 32 columns at a time: K padded with
    zero columns (which add nothing to A·Aᵀ) to a multiple of 32, at least
    one chunk (a new tensor where K changes).  Any device."""
    k = a.shape[1]
    kp = max(32, -(-k // 32) * 32)
    return a if kp == k else torch.nn.functional.pad(a, (0, kp - k))


def _check_uplo(uplo: Optional[str]) -> None:
    if uplo not in (None, "L"):
        raise ValueError(f"syrk_downdate: uplo must be None or 'L', got {uplo!r}")


def syrk_downdate(
    c: torch.Tensor, a: torch.Tensor, tile: int = 256, uplo: Optional[str] = None
) -> torch.Tensor:
    """C − A·Aᵀ with C (M, M), A (M, K), any K.

    ``uplo=None`` returns the full result, as the reference kernel does.
    ``uplo='L'`` (BLAS ``syrk``) computes the lower triangle only, and the
    entries above the diagonal are C's, copied through: what the
    large-front route reads, at half the products.  On the card A is
    padded by :func:`syrk_operand` (exact).

    ``tile`` (128 or 256) is the reference kernel's C tile.  It is only
    checked, for the reference's rule that M be a multiple of it; neither
    version reads it otherwise (the CUDA kernel always tiles C by 64)."""
    if a.ndim != 2 or c.shape != (a.shape[0], a.shape[0]):
        raise ValueError(f"syrk_downdate: C {tuple(c.shape)} and A {tuple(a.shape)}")
    m, k = a.shape
    if tile % TILE or m % tile:
        raise ValueError(f"syrk_downdate: M={m} is not a multiple of tile={tile}")
    _check_uplo(uplo)
    if c.device.type == "cpu" and a.device.type == "cpu":
        return syrk_downdate_plain(c, a, uplo)
    suffix = _check_cuda("syrk_downdate", c, a)
    # the kernel reads rows by 16-byte copies: a view off that alignment is
    # copied first
    a = syrk_operand(a)
    c, a = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (c, a))
    out = torch.empty_like(c)
    if m:
        _launch("syrk_downdate", suffix, c.device, c.data_ptr(), a.data_ptr(), out.data_ptr(),
                m, a.shape[1], int(uplo == "L"))
    return out


def extend_add(dst: torch.Tensor, src: torch.Tensor, pos: torch.Tensor) -> None:
    """In place: ``dst[pos[i], pos[j]] += src[i, j]`` and, for j < i,
    ``dst[pos[j], pos[i]] += src[i, j]``, over 0 ≤ j ≤ i < n = len(pos).

    ``dst`` is a contiguous square float64 front; ``src`` a child's Schur
    block in float32 or float64 whose lower triangle is read (a view of a
    factored padded front will do: its rows need a unit stride only),
    upcast to float64; ``pos`` (int32) the child's rows in ``dst``,
    strictly increasing, so no two entries meet and the sums are the
    host's ``f[ix_(pos, pos)] += block`` bit for bit."""
    n = pos.shape[0]
    if (dst.ndim != 2 or dst.shape[0] != dst.shape[1] or dst.dtype != torch.float64
            or not dst.is_contiguous()):
        raise ValueError(f"extend_add: dst must be a contiguous square float64 matrix, got "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if src.ndim != 2 or src.shape[0] < n or src.shape[1] < n or (n and src.stride(1) != 1):
        raise ValueError(f"extend_add: src {tuple(src.shape)} (strides {src.stride()}) "
                         f"for {n} positions")
    if pos.ndim != 1 or pos.dtype != torch.int32 or not pos.is_contiguous():
        raise ValueError(f"extend_add: pos must be a contiguous int32 vector, got {pos.dtype}")
    if len({dst.device, src.device, pos.device}) != 1:
        raise ValueError(f"extend_add: tensors on {dst.device}, {src.device}, {pos.device}")
    if dst.device.type == "cpu":
        return extend_add_plain(dst, src, pos)
    if src.dtype not in _SUFFIX:
        raise TypeError(f"extend_add: kernel takes float32 or float64, got {src.dtype}")
    if n:
        _launch("extend_add", _SUFFIX[src.dtype], dst.device, src.data_ptr(), src.stride(0),
                dst.data_ptr(), dst.shape[0], pos.data_ptr(), n)
