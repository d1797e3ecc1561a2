"""The least work of a factorization, counted from the matrix's pattern.

Plain column counts of the exact (unrelaxed) Cholesky factor L of a matrix
already in elimination order: the elimination tree by Liu's algorithm, then
each row's subtree (the paths from the row's entries up the tree), which
holds exactly the row's nonzeros in L.  From them:

* F, the operations: the sum over the columns of L of c^2 + c + 1, where c
  counts the column's nonzeros on and below the diagonal (one square root,
  c divisions and the rank-1 update of the trailing c-by-c triangle);
* B, the bytes: 8 x (nnz(tril A) read once + nnz(L) written once).

Whatever implements the factorization, these are its work; padding,
relaxed amalgamation and copies show as waste beside them.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def etree(a: sp.spmatrix) -> np.ndarray:
    """Parent of each column in the elimination tree (-1 at a root)."""
    n = a.shape[0]
    up = sp.triu(a, k=1).tocsc()  # column j: the rows i < j of A[:, j]
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        for i in up.indices[up.indptr[j]:up.indptr[j + 1]]:
            k = int(i)
            while ancestor[k] != -1 and ancestor[k] != j:
                nxt = int(ancestor[k])
                ancestor[k] = j
                k = nxt
            if ancestor[k] == -1:
                ancestor[k] = j
                parent[k] = j
    return parent


def column_counts(a: sp.spmatrix) -> np.ndarray:
    """Nonzeros of each column of L, the diagonal included."""
    n = a.shape[0]
    parent = etree(a).tolist()
    low = sp.tril(a, k=-1).tocsr()  # row i: the columns k < i of A[i, :]
    counts = [1] * n
    mark = [-1] * n
    for i in range(n):
        mark[i] = i
        for k in low.indices[low.indptr[i]:low.indptr[i + 1]].tolist():
            while mark[k] != i:  # climb row i's subtree: L[i, k] != 0
                mark[k] = i
                counts[k] += 1
                k = parent[k]
    return np.asarray(counts, dtype=np.int64)


def least_work(a: sp.spmatrix, itemsize: int = 8) -> dict:
    """F, B and the counts they come from, for ``a`` in elimination order."""
    c = column_counts(a).astype(np.float64)
    nnz_l = int(c.sum())
    nnz_a = int(sp.tril(a).nnz)
    return {
        "flops": float(np.sum(c * c + c + 1.0)),
        "bytes": float(itemsize * (nnz_a + nnz_l)),
        "nnz_l": nnz_l,
        "nnz_tril_a": nnz_a,
    }
