"""Symbolic multifrontal analysis: elimination tree → assembly-tree of tasks.

Liu [3]: the dependencies of sparse Cholesky are the *elimination tree*
``etree(j) = min{i > j : L_ij ≠ 0}``.  Grouping columns into (relaxed)
supernodes yields the assembly tree whose nodes are partial dense
factorizations of frontal matrices — exactly the malleable tasks the paper
schedules.  Task lengths are the frontal factorization flop counts, the same
quantity the paper's §3 calibrates the p^α model on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from repro_torch.core.graph import TaskTree


# ----------------------------------------------------------------------
def etree(a: sp.csr_matrix) -> np.ndarray:
    """Elimination tree of a symmetric matrix (Liu's algorithm, O(nnz·α))."""
    n = a.shape[0]
    al = sp.tril(a, k=-1).tocsr()
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        for i in al.indices[al.indptr[j] : al.indptr[j + 1]]:
            # path compression from row index i (i < j) up to the root
            k = int(i)
            while ancestor[k] != -1 and ancestor[k] != j:
                nxt = ancestor[k]
                ancestor[k] = j
                k = nxt
            if ancestor[k] == -1:
                ancestor[k] = j
                parent[k] = j
    return parent


def col_patterns(a: sp.csr_matrix, parent: np.ndarray) -> List[np.ndarray]:
    """struct(L_{:,j}) (diagonal included) for each column.

    struct(L_j) = struct(A_{j:,j}) ∪ ⋃_{c:parent(c)=j} (struct(L_c) \\ {c}).
    """
    n = a.shape[0]
    al = sp.tril(a).tocsc()
    al.sort_indices()
    children: List[List[int]] = [[] for _ in range(n)]
    for c, p in enumerate(parent):
        if p >= 0:
            children[int(p)].append(c)
    pats: List[Optional[set]] = [None] * n
    out: List[np.ndarray] = [np.empty(0, dtype=np.int64)] * n
    for j in range(n):  # children have smaller indices: natural order works
        s = set(int(i) for i in al.indices[al.indptr[j] : al.indptr[j + 1]])
        s.add(j)
        for c in children[j]:
            cs = pats[c]
            assert cs is not None
            s.update(i for i in cs if i > c)
            pats[c] = None  # free
        pats[j] = s
        out[j] = np.array(sorted(s), dtype=np.int64)
    return out


# ----------------------------------------------------------------------
@dataclass
class Supernode:
    cols: np.ndarray  # pivot columns (contiguous)
    rows: np.ndarray  # full front row structure (includes cols)
    parent: int = -1  # parent supernode id
    flops: float = 0.0

    @property
    def nb(self) -> int:  # number of pivots
        return len(self.cols)

    @property
    def m(self) -> int:  # front order
        return len(self.rows)


@dataclass
class SymbolicFactorization:
    n: int
    supernodes: List[Supernode]
    col_to_sn: np.ndarray
    parent_col: np.ndarray  # etree over columns

    @property
    def n_supernodes(self) -> int:
        return len(self.supernodes)

    def task_tree(self, flop_rate: float = 1.0) -> TaskTree:
        """Assembly tree as a malleable TaskTree (lengths = flops/rate).

        Multiple etree roots (reducible matrices) hang under a zero-length
        virtual root.
        """
        ns = len(self.supernodes)
        parents = np.array([s.parent for s in self.supernodes], dtype=np.int64)
        lengths = np.array([s.flops / flop_rate for s in self.supernodes])
        labels = np.arange(ns, dtype=np.int64)
        n_roots = int((parents < 0).sum())
        if n_roots == 1:
            return TaskTree(parent=parents, lengths=lengths, labels=labels)
        parents = np.where(parents < 0, ns, parents)
        return TaskTree(
            parent=np.concatenate([parents, [-1]]),
            lengths=np.concatenate([lengths, [0.0]]),
            labels=np.concatenate([labels, [-1]]),
        )

    def footprints(self, itemsize: int = 8):
        """Per-supernode :class:`~repro_torch.core.memory.Footprints` in bytes.

        One entry per supernode (same order as :meth:`task_tree`; pad
        with :meth:`Footprints.padded` when the tree gained a virtual
        root).  ``itemsize`` is the factor dtype width — 8 for float64,
        4 for float32.
        """
        from repro_torch.core.memory import footprints_from_fronts

        return footprints_from_fronts(
            [s.m for s in self.supernodes],
            [s.nb for s in self.supernodes],
            itemsize=itemsize,
        )


def partial_factor_flops(m: int, nb: int) -> float:
    """Flops of eliminating nb pivots from an m×m symmetric front.

    Column i (size m_i = m − i): 1 sqrt + (m_i) divisions + rank-1 update of
    the trailing (m_i)² /2 entries × 2 flops ⇒ Σ_{i<nb} (m−i)² + (m−i) + 1.
    """
    i = np.arange(nb, dtype=np.float64)
    mi = m - i
    return float(np.sum(mi**2 + mi + 1.0))


def analyze(
    a: sp.csr_matrix,
    relax: int = 0,
    max_supernode: int = 256,
) -> SymbolicFactorization:
    """Full symbolic phase: etree → patterns → (relaxed) supernodes → flops.

    ``relax``: merge a child into its parent when doing so adds at most
    ``relax`` extra fill rows per pivot (classic amalgamation — larger fronts
    mean larger, better-parallelizing malleable tasks, the paper's trade-off).
    """
    n = a.shape[0]
    parent = etree(a)
    pats = col_patterns(a, parent)

    # fundamental supernodes: consecutive cols, parent chain, nested patterns
    sn_of = np.full(n, -1, dtype=np.int64)
    starts: List[int] = []
    for j in range(n):
        if j == 0:
            starts.append(0)
            sn_of[j] = 0
            continue
        prev = j - 1
        fundamental = (
            parent[prev] == j
            and len(pats[prev]) == len(pats[j]) + 1
            and (j - starts[-1]) < max_supernode
        )
        if relax > 0 and not fundamental and parent[prev] == j:
            extra = len(pats[j]) + 1 - len(pats[prev])
            fundamental = abs(extra) <= relax and (j - starts[-1]) < max_supernode
        if fundamental:
            sn_of[j] = len(starts) - 1
        else:
            starts.append(j)
            sn_of[j] = len(starts) - 1

    n_sn = len(starts)
    bounds = starts + [n]
    supernodes: List[Supernode] = []
    for s in range(n_sn):
        lo, hi = bounds[s], bounds[s + 1]
        cols = np.arange(lo, hi, dtype=np.int64)
        # front rows: union of patterns of pivot cols (= pattern of first col
        # for fundamental supernodes, union for relaxed)
        rows = set()
        for j in range(lo, hi):
            rows.update(int(i) for i in pats[j])
        rows.update(int(c) for c in cols)
        rows_arr = np.array(sorted(rows), dtype=np.int64)
        sn = Supernode(cols=cols, rows=rows_arr)
        sn.flops = partial_factor_flops(sn.m, sn.nb)
        supernodes.append(sn)

    # supernode parents via etree of last pivot column
    for s, sn in enumerate(supernodes):
        last = int(sn.cols[-1])
        p = int(parent[last])
        sn.parent = int(sn_of[p]) if p >= 0 else -1

    return SymbolicFactorization(
        n=n, supernodes=supernodes, col_to_sn=sn_of, parent_col=parent
    )
