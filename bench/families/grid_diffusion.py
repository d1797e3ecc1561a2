"""Finite-difference operators of -div(c grad u) on a 2-D or 3-D grid.

The 5-point (2-D) or 7-point (3-D) stencil with Dirichlet boundaries: one
coefficient per face of the grid's cells, faces on the boundary included,
drawn from a lognormal law (a heterogeneous medium).  Off the diagonal
``A[p, q] = -c`` for the face between neighbours p and q; the diagonal is
the sum of the coefficients of a point's faces, so A is SPD with the
Laplacian's pattern (c = 1 everywhere gives the plain Laplacian).

The ordering is geometric nested dissection: bisect the box along its
longest axis (the first such axis on a tie), order the two halves, then
the separator plane; a box of at most ``leaf`` points is ordered row-major.

Every matrix comes out already permuted (row ``k`` is the ``k``-th point
eliminated), from ``(seed, index)`` alone; the pattern depends on the
configuration only.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.sparse as sp


def rng(seed: int, index: int, stream: int) -> np.random.Generator:
    """The generator of draw ``stream`` for factorization ``index``."""
    return np.random.default_rng([seed % (1 << 64), index, stream])


def nested_dissection(dims: Tuple[int, ...], leaf: int) -> np.ndarray:
    """``perm[k]`` = row-major index of the ``k``-th point eliminated."""
    dims = tuple(int(d) for d in dims)
    strides = np.cumprod((1,) + dims[::-1])[:-1][::-1]
    out: List[np.ndarray] = []
    # ("box", lo, hi) orders a box; ("sep", ...) emits a finished separator
    stack = [("box", (0,) * len(dims), dims)]
    while stack:
        kind, lo, hi = stack.pop()
        ext = [h - l for l, h in zip(lo, hi)]
        if min(ext) <= 0:
            continue
        if kind == "sep" or int(np.prod(ext)) <= leaf:
            axes = np.meshgrid(*[np.arange(l, h) for l, h in zip(lo, hi)], indexing="ij")
            out.append(sum(a.ravel() * s for a, s in zip(axes, strides)))
            continue
        ax = int(np.argmax(ext))
        mid = lo[ax] + ext[ax] // 2
        low_hi = hi[:ax] + (mid,) + hi[ax + 1:]
        high_lo = lo[:ax] + (mid + 1,) + lo[ax + 1:]
        sep_lo = lo[:ax] + (mid,) + lo[ax + 1:]
        sep_hi = hi[:ax] + (mid + 1,) + hi[ax + 1:]
        # popped in reverse: the low half, the high half, then the separator
        stack += [("sep", sep_lo, sep_hi), ("box", high_lo, hi), ("box", lo, low_hi)]
    perm = np.concatenate(out).astype(np.int64)
    if len(perm) != int(np.prod(dims)):
        raise AssertionError("nested dissection lost points")
    return perm


class Operator:
    """The configuration's operator: its pattern once, its values per draw."""

    def __init__(self, cfg: dict) -> None:
        self.dims = tuple(int(d) for d in cfg["grid"])
        if len(self.dims) not in (2, 3):
            raise ValueError(f"grid must have 2 or 3 axes, got {self.dims}")
        coef = cfg["coefficients"]
        if coef["law"] != "lognormal" or coef["per"] != "face":
            raise ValueError(f"unsupported coefficient law {coef}")
        self.mu, self.sigma = float(coef["mu"]), float(coef["sigma"])
        self.n = int(np.prod(self.dims))
        self.perm = nested_dissection(self.dims, int(cfg["ordering"]["leaf"]))
        self.iperm = np.empty_like(self.perm)
        self.iperm[self.perm] = np.arange(self.n)
        # off-diagonal pairs (in elimination order) per axis, as the face draws
        # of that axis are laid out
        self._pairs = []
        idx = np.arange(self.n).reshape(self.dims)
        for ax in range(len(self.dims)):
            p = np.take(idx, np.arange(self.dims[ax] - 1), axis=ax).ravel()
            q = np.take(idx, np.arange(1, self.dims[ax]), axis=ax).ravel()
            self._pairs.append((self.iperm[p], self.iperm[q]))

    def faces(self, seed: int, index: int) -> List[np.ndarray]:
        """Per axis, the coefficients of the faces across it: shape ``dims``
        with that axis one longer (its two boundary faces included)."""
        g = rng(seed, index, 0)
        out = []
        for ax in range(len(self.dims)):
            shape = list(self.dims)
            shape[ax] += 1
            out.append(g.lognormal(self.mu, self.sigma, size=shape))
        return out

    def matrix(self, seed: int, index: int, original_order: bool = False) -> sp.csr_matrix:
        """The ``index``-th matrix of ``seed``, in elimination order (or in
        the grid's row-major order with ``original_order``)."""
        faces = self.faces(seed, index)
        diag = np.zeros(self.dims)
        rows, cols, vals = [], [], []
        for ax, c in enumerate(faces):
            na = self.dims[ax]
            diag += np.take(c, np.arange(na), axis=ax) + np.take(c, np.arange(1, na + 1), axis=ax)
            inner = -np.take(c, np.arange(1, na), axis=ax).ravel()
            p, q = self._pairs[ax]
            rows += [p, q]
            cols += [q, p]
            vals += [inner, inner]
        d = np.arange(self.n)
        rows.append(d)
        cols.append(d)
        vals.append(diag.ravel()[self.perm])
        r, c, v = (np.concatenate(x) for x in (rows, cols, vals))
        if original_order:
            r, c = self.perm[r], self.perm[c]
        return sp.csr_matrix((v, (r, c)), shape=(self.n, self.n))
