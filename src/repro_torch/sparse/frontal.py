"""Frontal matrix numeric kernels — PyTorch reference implementations.

The multifrontal method factors A = LLᵀ by walking the assembly tree; at
each supernode it (1) *assembles* a dense m×m frontal matrix from original
matrix entries and the children's Schur complements (extend-add), then
(2) *partially factorizes* the leading nb pivot columns, producing the
factor panel and the front's own Schur complement passed to its parent.

Step (2) is the malleable task whose p^α scaling the paper measures (§3);
its CUDA implementation lives in repro_torch.kernels; here is the
``torch.linalg`` oracle used by ``factorize`` by default and by the tests.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def partial_cholesky_ref(front: torch.Tensor, nb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial Cholesky of the leading nb columns of a symmetric front.

    Returns (panel, schur): panel is m×nb with L11 (lower-triangular) on top
    of L21; schur is the (m−nb)×(m−nb) update matrix A22 − L21·L21ᵀ.
    """
    a11 = front[:nb, :nb]
    a21 = front[nb:, :nb]
    a22 = front[nb:, nb:]
    l11 = torch.linalg.cholesky(a11)
    # L21 = A21 · L11^{-T}  ⇔  L11 · L21ᵀ = A21ᵀ
    l21 = torch.linalg.solve_triangular(l11, a21.T, upper=False).T
    schur = a22 - l21 @ l21.T
    return torch.cat([l11, l21], dim=0), schur


def assemble_front(
    n_front: int,
    a_block: np.ndarray,
    child_updates,
) -> torch.Tensor:
    """Assemble a front: original entries + extend-add of children updates.

    ``a_block``: dense (m, m) with the original-matrix entries already
    scattered (host-side gather — index plumbing, not flops).
    ``child_updates``: list of (local_idx, update) where ``local_idx`` maps
    the child's border rows into this front's local indices.
    """
    f = torch.tensor(a_block)
    for local_idx, upd in child_updates:
        idx = torch.as_tensor(np.asarray(local_idx), dtype=torch.long)
        f.index_put_(
            (idx[:, None], idx[None, :]),
            torch.as_tensor(upd, dtype=f.dtype),
            accumulate=True,
        )
    return f


def full_cholesky_ref(a_dense: np.ndarray) -> np.ndarray:
    """Dense reference for validation."""
    return torch.linalg.cholesky(torch.as_tensor(a_dense)).numpy()
