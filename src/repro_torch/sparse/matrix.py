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


def permute_symmetric(a: sp.csr_matrix, perm: np.ndarray) -> sp.csr_matrix:
    """P A Pᵀ for a permutation given as new-order-of-old-indices."""
    p = sp.csr_matrix(
        (np.ones(len(perm)), (np.arange(len(perm)), perm)), shape=a.shape
    )
    return (p @ a @ p.T).tocsr()


def lower_pattern(a: sp.csr_matrix) -> Tuple[np.ndarray, np.ndarray]:
    """(indptr, indices) of the strictly-lower + diagonal pattern, sorted."""
    al = sp.tril(a).tocsc()
    al.sort_indices()
    return al.indptr, al.indices
