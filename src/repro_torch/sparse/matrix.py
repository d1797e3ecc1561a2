"""Sparse SPD test matrices (the paper's §3/§7 application domain).

The paper's data set is assembly trees of University of Florida collection
matrices; offline we generate the two standard families whose elimination
trees span the same regimes: k-point grid Laplacians (geometric, deep
balanced trees under nested dissection) and random SPD matrices (irregular
trees).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


def grid_laplacian_2d(nx: int, ny: Optional[int] = None) -> sp.csr_matrix:
    """5-point Laplacian on an nx×ny grid with Dirichlet boundary (SPD)."""
    ny = ny or nx
    n = nx * ny

    def idx(i, j):
        return i * ny + j

    rows, cols, vals = [], [], []
    for i in range(nx):
        for j in range(ny):
            k = idx(i, j)
            rows.append(k)
            cols.append(k)
            vals.append(4.0)
            for di, dj in ((1, 0), (0, 1)):
                ii, jj = i + di, j + dj
                if ii < nx and jj < ny:
                    kk = idx(ii, jj)
                    rows += [k, kk]
                    cols += [kk, k]
                    vals += [-1.0, -1.0]
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def grid_laplacian_3d(nx: int, ny: Optional[int] = None, nz: Optional[int] = None) -> sp.csr_matrix:
    """7-point Laplacian on an nx×ny×nz grid (SPD)."""
    ny = ny or nx
    nz = nz or nx
    n = nx * ny * nz

    def idx(i, j, k):
        return (i * ny + j) * nz + k

    rows, cols, vals = [], [], []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                a = idx(i, j, k)
                rows.append(a)
                cols.append(a)
                vals.append(6.0)
                for di, dj, dk in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
                    ii, jj, kk = i + di, j + dj, k + dk
                    if ii < nx and jj < ny and kk < nz:
                        b = idx(ii, jj, kk)
                        rows += [a, b]
                        cols += [b, a]
                        vals += [-1.0, -1.0]
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def random_spd(
    n: int, avg_nnz_per_row: float, rng: np.random.Generator
) -> sp.csr_matrix:
    """Random sparse SPD: symmetric pattern + diagonal dominance."""
    m = int(n * avg_nnz_per_row / 2)
    rows = rng.integers(0, n, size=m)
    cols = rng.integers(0, n, size=m)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(-1.0, 1.0, size=len(rows))
    a = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    a = a + a.T
    # diagonal dominance => SPD
    d = np.abs(a).sum(axis=1).A1 + 1.0
    return (a + sp.diags(d)).tocsr()


def first_at_least(indptr: np.ndarray, indices: np.ndarray, value: np.ndarray) -> np.ndarray:
    """In each sorted row, the position of the first entry >= ``value``
    of that row (the row's end if none): a bisection of all rows at once."""
    lo, hi = indptr[:-1].astype(np.int64), indptr[1:].astype(np.int64)
    top = max(len(indices) - 1, 0)
    for _ in range(int(np.max(hi - lo, initial=0)).bit_length()):
        mid = (lo + hi) >> 1
        go = (lo < hi) & (indices[np.minimum(mid, top)] < value)
        lo = np.where(go, mid + 1, lo)
        hi = np.where((lo < hi) & ~go, mid, hi)
    return lo


def permute_symmetric(a: sp.csr_matrix, perm: np.ndarray) -> sp.csr_matrix:
    """P A Pᵀ for a permutation given as new-order-of-old-indices: entry
    (i, j) is ``a[perm[i], perm[j]]``, in canonical CSR (sorted, duplicates
    summed).  Every stored entry keeps its place, explicit zeros included:
    a product of sparse matrices would drop them, and with them the
    pattern the analysis reads."""
    perm = np.asarray(perm)
    inv = np.empty(len(perm), dtype=np.int64)
    inv[perm] = np.arange(len(perm))
    out = sp.csr_matrix(a, dtype=np.result_type(a.dtype, np.float64))[perm]
    out.indices = inv[out.indices].astype(out.indices.dtype)
    out.has_sorted_indices = False
    out.sum_duplicates()
    return out


def lower_pattern(a: sp.csr_matrix) -> Tuple[np.ndarray, np.ndarray]:
    """(indptr, indices) of the strictly-lower + diagonal pattern, sorted."""
    al = sp.tril(a).tocsc()
    al.sort_indices()
    return al.indptr, al.indices
