"""PyTorch oracles for the frontal factorization kernels.

They define the semantics the kernels must match (``torch.linalg`` only;
tests/test_torch_kernels.py holds the kernels against them).
"""
from __future__ import annotations

from typing import Tuple

import torch


def partial_cholesky_ref(front: torch.Tensor, nb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial Cholesky of the leading nb columns of a symmetric m×m front.

    Returns (panel, schur): panel (m, nb) = [L11; L21] with L11 lower
    triangular; schur (m−nb, m−nb) = A22 − L21·L21ᵀ.
    """
    a11 = front[:nb, :nb]
    a21 = front[nb:, :nb]
    a22 = front[nb:, nb:]
    l11 = torch.linalg.cholesky(a11)
    l21 = torch.linalg.solve_triangular(l11, a21.T, upper=False).T
    schur = a22 - l21 @ l21.T
    return torch.cat([l11, l21], dim=0), schur


def panel_factor_ref(slab: torch.Tensor) -> torch.Tensor:
    """Factor an (M, NB) slab whose leading NB×NB block is SPD:
    [L11; A21·L11⁻ᵀ], partial_cholesky restricted to the panel."""
    nb = slab.shape[1]
    l11 = torch.linalg.cholesky(slab[:nb, :])
    l21 = torch.linalg.solve_triangular(l11, slab[nb:, :].T, upper=False).T
    return torch.cat([l11, l21], dim=0)


def syrk_update_ref(c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """C − A·Aᵀ (symmetric rank-K downdate of the trailing submatrix)."""
    return c - a @ a.T
