"""The judge of a factor: how far L L^T is from the matrix it factors.

Plain NumPy.  The matrix A is rebuilt from the seed by the configuration's
family; the factor L is what the program returned, read only to be judged.
L comes as supernodal panels: a panel holds the rows ``rows`` of the
columns ``cols`` of L, and only its entries on or below the diagonal
(row >= column) belong to L, whatever it holds above.

The number compared is a normwise backward error, read through random
probes X (n x k, standard normal, from the seed):

    residual = max |A X - L (L^T X)| / (||A||_inf * max |X|)

which bounds ||L L^T - A||_inf / ||A||_inf from below.  A backward-stable
factorization in float64 reads about 1e-16 times a small multiple of the
column counts; one computed in float32 reads about 1e-7.  A panel that is
stale, left out, unfactored or altered in one entry reads far above both.
A factor whose columns are not each held by exactly one panel of the
right shape reads infinity.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import scipy.sparse as sp

Panel = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (rows, cols, values)


def probes(n: int, k: int, g: np.random.Generator) -> np.ndarray:
    return g.standard_normal((n, k))


def _lower(rows: np.ndarray, cols: np.ndarray, p: np.ndarray) -> np.ndarray:
    return np.where(rows[:, None] >= cols[None, :], p, 0.0)


def residual(panels: Iterable[Panel], a: sp.spmatrix, x: np.ndarray) -> float:
    """The backward error of ``panels`` as a factor of ``a`` (see above)."""
    n = a.shape[0]
    panels = list(panels)
    seen = np.zeros(n, dtype=np.int64)
    for rows, cols, p in panels:
        rows, cols = np.asarray(rows), np.asarray(cols)
        if p.shape != (len(rows), len(cols)) or not np.isin(cols, rows).all():
            return float("inf")
        if len(rows) and (rows.min() < 0 or rows.max() >= n):
            return float("inf")
        seen[cols] += 1
    if not (seen == 1).all():
        return float("inf")
    y = np.zeros((n, x.shape[1]))  # L^T X
    for rows, cols, p in panels:
        y[cols] = _lower(rows, cols, p.astype(np.float64)).T @ x[rows]
    z = np.zeros_like(y)  # L (L^T X)
    for rows, cols, p in panels:
        z[rows] += _lower(rows, cols, p.astype(np.float64)) @ y[cols]
    r = np.abs(a @ x - z).max()
    scale = np.abs(a).sum(axis=1).max() * np.abs(x).max()
    out = float(r / scale)
    return out if np.isfinite(out) else float("inf")
