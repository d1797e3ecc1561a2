"""Public wrappers around the frontal-factorization kernels.

``partial_cholesky(front, nb)`` matches ``ref.partial_cholesky_ref`` up to
dtype roundoff: it pads the front to 128-multiples with a unit diagonal
(``pad_front``: padded pivots factor to no-ops), takes ``front_factor``
for fronts ≤ VMEM_FRONT_MAX and the panel + SYRK pipeline above that
(``factor_padded``), and slices the (panel, schur) outputs back to the
caller's shapes (``panel_of``, ``schur_of``).  A caller that builds the
padded front itself enters at ``factor_padded``.

Which backend runs follows from the tensor's device: the CUDA kernels for a
CUDA tensor, their plain PyTorch versions for a CPU tensor.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .frontal_cholesky import (
    TILE,
    VMEM_FRONT_MAX,
    front_factor,
    panel_factor,
    syrk_downdate,
)

OUTER_PANEL = 512  # large-front pivot panel width


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad_front(front: torch.Tensor, nb: int) -> torch.Tensor:
    """An (m, m) front padded to its (mp, mp) shape class with a unit
    diagonal, on the front's device and in its dtype: pivots occupy
    [0, nb) and the border [nbp, nbp + mb)."""
    m = front.shape[0]
    mb = m - nb  # border size
    mp, nbp = padded_shape(m, nb)
    f = torch.eye(mp, dtype=front.dtype, device=front.device)
    f[:nb, :nb] = front[:nb, :nb]
    if mb > 0:
        f[nbp : nbp + mb, :nb] = front[nb:, :nb]
        f[:nb, nbp : nbp + mb] = front[:nb, nb:]
        f[nbp : nbp + mb, nbp : nbp + mb] = front[nb:, nb:]
    return f


def factor_padded(f: torch.Tensor, nbp: int) -> torch.Tensor:
    """Factor the leading ``nbp`` columns of a padded (mp, mp) front:
    ``front_factor`` up to VMEM_FRONT_MAX, above it the panel + SYRK
    pipeline, in place.  Only the lower triangle of the result is kept
    correct: L in columns [0, nbp), the Schur complement below and to the
    right."""
    mp = f.shape[0]
    if mp <= VMEM_FRONT_MAX:
        return front_factor(f[None], nbp)[0]
    out = f
    for k in range(0, nbp, OUTER_PANEL):
        pw = min(OUTER_PANEL, nbp - k)
        lp = panel_factor(out[k:, k : k + pw].contiguous())
        out[k:, k : k + pw] = lp
        trail = mp - k - pw
        if trail > 0:
            # the reference's tile rule: syrk_downdate checks M % tile
            # and otherwise ignores it (its CUDA kernel tiles C by 64);
            # only the lower triangle is read, so uplo='L'
            tile = 256 if trail % 256 == 0 else TILE
            c = syrk_downdate(
                out[k + pw :, k + pw :].contiguous(),
                lp[pw:].contiguous(),
                tile=tile,
                uplo="L",
            )
            out[k + pw :, k + pw :] = c
    return out


def panel_of(out: torch.Tensor, m: int, nb: int) -> torch.Tensor:
    """The (m, nb) panel [L11; L21] of a factored padded front, zero above
    L11's diagonal."""
    _, nbp = padded_shape(m, nb)
    top = torch.tril(out[:nb, :nb])
    if m == nb:
        return top
    return torch.cat([top, out[nbp : nbp + m - nb, :nb]], dim=0)


def schur_of(out: torch.Tensor, m: int, nb: int) -> torch.Tensor:
    """The (m−nb)² Schur block of a factored padded front, symmetrized
    from its lower triangle."""
    mb = m - nb
    _, nbp = padded_shape(m, nb)
    if mb == 0:
        return torch.zeros((0, 0), dtype=out.dtype, device=out.device)
    low = torch.tril(out[nbp : nbp + mb, nbp : nbp + mb])
    return low + low.T - torch.diag(torch.diag(low))


def partial_cholesky(front: torch.Tensor, nb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel-backed partial Cholesky: (panel (m, nb), schur (m−nb, m−nb)),
    on the front's device and in its dtype."""
    m = front.shape[0]
    _, nbp = padded_shape(m, nb)
    out = factor_padded(pad_front(front, nb), nbp)
    return panel_of(out, m, nb), schur_of(out, m, nb)


def factor_fn():
    """A FactorFn (front, nb) → (panel, schur) for ``sparse.factorize``."""

    def fn(front: torch.Tensor, nb: int):
        return partial_cholesky(front, nb)

    return fn


# ----------------------------------------------------------------------
# Batched dispatch (the plan executor's path).
#
# Fronts of one dispatch are padded to a common 128-aligned (mp, mp) shape
# class and factored in ONE launch (one cluster per front): on the lane by
# the plan executor, on the host by ``pad_front_np`` for the cluster's
# workers.  Padding follows the same unit-diagonal convention as
# ``partial_cholesky``: padded pivot columns factor to e_j no-ops, so
# fronts with different true (m, nb) can share a class as long as they
# round to the same (mp, nbp).
# ----------------------------------------------------------------------
def padded_shape(m: int, nb: int) -> Tuple[int, int]:
    """(mp, nbp): the 128-aligned padded front order and pivot width."""
    mb = m - nb
    nbp = _round_up(max(nb, 1), TILE)
    mbp = _round_up(mb, TILE) if mb > 0 else 0
    return nbp + mbp, nbp


def pad_front_np(front: np.ndarray, nb: int, dtype=None) -> np.ndarray:
    """Host-side padding of an (m, m) front to its (mp, mp) shape class.

    Pivots land in [0, nb), the border in [nbp, nbp+mb); everything else is
    a unit diagonal.  Mirrors the padding of ``partial_cholesky`` so the
    two paths are interchangeable.
    """
    m = front.shape[0]
    mb = m - nb
    mp, nbp = padded_shape(m, nb)
    f = np.eye(mp, dtype=dtype or front.dtype)
    f[:nb, :nb] = front[:nb, :nb]
    if mb > 0:
        f[nbp : nbp + mb, :nb] = front[nb:, :nb]
        f[:nb, nbp : nbp + mb] = front[:nb, nb:]
        f[nbp : nbp + mb, nbp : nbp + mb] = front[nb:, nb:]
    return f


def extract_panel_schur(
    out: np.ndarray, m: int, nb: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Slice a factored padded front back to ((m, nb) panel, (m−nb)² schur).

    Host-side analogue of the output gather in partial_cholesky: zero the
    garbage above L11's diagonal, symmetrize the Schur block.
    """
    mb = m - nb
    _, nbp = padded_shape(m, nb)
    top = np.tril(out[:nb, :nb])
    if mb > 0:
        panel = np.concatenate([top, out[nbp : nbp + mb, :nb]], axis=0)
        low = np.tril(out[nbp : nbp + mb, nbp : nbp + mb])
        schur = low + low.T - np.diag(np.diag(low))
    else:
        panel = top
        schur = np.zeros((0, 0), dtype=out.dtype)
    return panel, schur


def batched_front_factor(fronts: torch.Tensor, nbp: int) -> torch.Tensor:
    """Factor a (B, mp, mp) stack of padded fronts in one launch.

    Requires mp ≤ VMEM_FRONT_MAX (the executor routes larger fronts through
    the per-front panel pipeline of ``partial_cholesky``).
    """
    b, mp, mp2 = fronts.shape
    if mp != mp2 or mp > VMEM_FRONT_MAX or nbp % TILE:
        raise ValueError(
            f"batched_front_factor: shape {tuple(fronts.shape)}, nbp={nbp} "
            f"(need square fronts of order <= {VMEM_FRONT_MAX}, nbp a multiple of {TILE})"
        )
    return front_factor(fronts, nbp)
