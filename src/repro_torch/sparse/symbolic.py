"""Symbolic multifrontal analysis: elimination tree → assembly-tree of tasks.

Liu [3]: the dependencies of sparse Cholesky are the *elimination tree*
``etree(j) = min{i > j : L_ij ≠ 0}``.  Grouping columns into (relaxed)
supernodes yields the assembly tree whose nodes are partial dense
factorizations of frontal matrices — exactly the malleable tasks the paper
schedules.  Task lengths are the frontal factorization flop counts, the same
quantity the paper's §3 calibrates the p^α model on.

Vector unknowns (three displacements a node in elasticity) give runs of
consecutive columns with identical structure: Ashcraft's supervariables,
or indistinguishable vertices.  They stay indistinguishable under
elimination, so :func:`analyze` runs the etree and the column patterns on
the compressed graph of supervariables and expands the result to
unknowns; the :class:`SymbolicFactorization` is the one the scalar path
gives.  The pattern is read once (the strict lower triangle by rows,
:func:`_lower_rows`): the runs are found there, and the compressed graph
is built from one column of each run.  A matrix without such runs takes
the scalar path.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from repro_torch.core.graph import TaskTree
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.sparse.matrix import first_at_least

# the stages of ``analyze``, each a bus span ``analyze/<stage>`` and a
# label of ``repro_sparse_analyze_seconds_total``
ANALYZE_STAGES = ("compress", "etree", "patterns", "supernodes")


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


def _lower_rows(a: sp.spmatrix) -> sp.csr_matrix:
    """The pattern the analysis reads, from one pass over ``a``: its
    strict lower triangle by rows (boolean, sorted, duplicates merged,
    explicit zeros kept).  Column j of the mirrored pattern with the
    diagonal added is its row j, then j, then the rows that hold j."""
    n = a.shape[0]
    if sp.issparse(a) and a.format == "csr" and a.has_canonical_format:
        # sorted rows: row i's entries left of i are its head, copied a
        # block of rows at a time
        start = a.indptr[:-1].astype(np.int64)
        head = first_at_least(a.indptr, a.indices, np.arange(n)) - start
        indptr = np.concatenate([[0], np.cumsum(head)])
        ind = np.empty(int(indptr[-1]), dtype=a.indices.dtype)
        for r0, r1 in _blocks(indptr):
            take = np.repeat(start[r0:r1] - indptr[r0:r1], head[r0:r1])
            take += np.arange(indptr[r0], indptr[r1])
            ind[indptr[r0]:indptr[r1]] = a.indices[take]
        return sp.csr_matrix((np.ones(len(ind), dtype=bool), ind, indptr), shape=(n, n))
    lo = sp.csr_matrix(sp.tril(a, k=-1), dtype=bool)
    lo.sum_duplicates()
    return lo


_BLOCK = 1 << 19  # entries of a block of rows that the pattern's passes take at once


def _blocks(indptr: np.ndarray) -> List[Tuple[int, int]]:
    """Consecutive ranges of whole rows of about ``_BLOCK`` entries each
    (a longer row alone), covering every row: the passes over the pattern
    keep their temporaries small this way."""
    n = len(indptr) - 1
    cuts = np.searchsorted(indptr, np.arange(0, int(indptr[-1]), _BLOCK), side="right") - 1
    cuts = np.unique(np.concatenate([[0], cuts[cuts > 0], [n]]))
    return list(zip(cuts[:-1].tolist(), cuts[1:].tolist()))


def _runs(lo: sp.csr_matrix) -> np.ndarray:
    """Start columns of the maximal runs of consecutive columns with one
    mirrored structure (diagonal included), and ``n`` last.

    Column j + 1 joins j's run when (j + 1, j) is an entry and the two
    agree on both sides of the pair: row j + 1 of ``lo`` is row j and
    then j (compared entry by entry), and every row below j + 1 that
    holds j holds j + 1 right after it, and every row that holds j + 1
    holds j right before it.  A few vectorised passes over ``lo`` (see
    :func:`_lower_rows`), a block of rows at a time."""
    n = lo.shape[0]
    if n < 2:
        return np.append(np.zeros(n, dtype=np.int64), n)
    indptr, ind = lo.indptr.astype(np.int64), lo.indices
    length = np.diff(indptr)
    ok = length[1:] == length[:-1] + 1
    ok[ok] = ind[indptr[2:][ok] - 1] == np.flatnonzero(ok)  # the entry (j + 1, j)
    okx = np.append(ok, False)
    full = length > 0
    # lone[c + 1] marks a c seen without c + 1 right after it, or a c + 1
    # without c right before it (a row's first entry follows nothing)
    lone = np.zeros(n + 1, dtype=bool)
    lone[ind[indptr[:-1][full]]] = True
    for r0, r1 in _blocks(indptr):
        p0, e = indptr[r0], int(indptr[r1] - indptr[r0])
        blk = ind[p0:indptr[min(r1 + 1, n)]]  # and row r1, to look ahead
        if e == 0:
            continue
        # row j against the head of row j + 1: entry p against p + length[j]
        # (p itself elsewhere, so it differs nowhere else)
        to = np.repeat(np.where(okx[r0:r1], length[r0:r1], 0), length[r0:r1])
        to += np.arange(e)
        at = np.flatnonzero(blk[:e] != blk[to])
        ok[r0 + np.searchsorted(indptr[r0:r1 + 1] - p0, at, side="right") - 1] = False
        # the rows below j + 1
        nxt = np.zeros(e, dtype=bool)  # entry p is followed by blk[p] + 1
        k = min(e, len(blk) - 1)
        np.equal(blk[1:k + 1], blk[:k] + 1, out=nxt[:k])
        f = full[r0:r1]
        ends = indptr[r0 + 1:r1 + 1][f] - 1 - p0
        nxt[ends] = blk[ends] == np.arange(r0, r1)[f] - 1  # (j + 1, j) ends its row
        bad = np.flatnonzero(~nxt)
        lone[blk[bad] + 1] = True
        bad += 1
        lone[blk[bad[bad < e]]] = True
    ok &= ~lone[1:n]
    return np.append(np.flatnonzero(np.append(True, ~ok)), n).astype(np.int64)


def supervariables(a: sp.csr_matrix) -> np.ndarray:
    """Start columns of the maximal runs of consecutive columns with
    identical structure, and ``n`` last.

    The structure is the one the analysis reads: the lower triangle of
    ``a`` mirrored, with the diagonal added, so columns j and j+1 of one
    run are adjacent (the diagonal block is full).  One vectorised pass
    over the pattern (:func:`_runs`)."""
    return _runs(_lower_rows(a))


def _quotient(m: sp.csr_matrix, starts: np.ndarray) -> sp.csr_matrix:
    """The mirrored pattern of the runs that start at ``starts``, diagonal
    included (sorted indices, symmetric): the runs left of each run are
    the runs of its first column's row of ``m`` (:func:`_lower_rows`).
    Every column of a run has that structure, so the other columns are
    not read."""
    nv = len(starts) - 1
    node_of = np.repeat(np.arange(nv), np.diff(starts))
    first = starts[:-1]
    lo, cnt = m.indptr[first], m.indptr[first + 1] - m.indptr[first]
    idx = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt) + np.arange(int(cnt.sum()))
    col = node_of[m.indices[idx]]
    row = np.repeat(np.arange(nv), cnt)
    # a run left of it shows once for each of its columns: keep one
    keep = np.ones(len(col), dtype=bool)
    keep[1:] = (col[1:] != col[:-1]) | (row[1:] != row[:-1])
    ptr = np.concatenate([[0], np.cumsum(np.bincount(row[keep], minlength=nv))])
    low = sp.csr_matrix(  # the runs left of each run, sorted
        (np.ones(int(ptr[-1]), dtype=bool), col[keep], ptr), shape=(nv, nv))
    up = low.tocsc()  # the runs right of each run: counting sort, sorted
    # each run's column: the runs left of it, itself, the runs right of it
    lcnt, ucnt = np.diff(low.indptr), np.diff(up.indptr)
    ptr = np.concatenate([[0], np.cumsum(lcnt + 1 + ucnt)])
    out = np.empty(int(ptr[-1]), dtype=low.indices.dtype)
    mine = np.zeros(len(out), dtype=bool)
    mine[np.repeat(ptr[:-1], lcnt) + np.arange(low.nnz) - np.repeat(low.indptr[:-1], lcnt)] = True
    out[mine] = low.indices
    out[ptr[:-1] + lcnt] = np.arange(nv)
    mine[ptr[:-1] + lcnt] = True
    out[~mine] = up.indices
    return sp.csr_matrix((np.ones(len(out), dtype=bool), out, ptr), shape=(nv, nv))


def _partition(
    parent: np.ndarray, pat_len: np.ndarray, relax: int, max_supernode: int
) -> Tuple[np.ndarray, List[int]]:
    """Fundamental (and, with ``relax``, relaxed) supernodes over the
    columns: (supernode of each column, first column of each)."""
    n = len(parent)
    parent_l = parent.tolist()
    pat_l = pat_len.tolist()
    sn_of = np.full(n, -1, dtype=np.int64)
    starts: List[int] = []
    for j in range(n):
        if j == 0:
            starts.append(0)
            sn_of[j] = 0
            continue
        prev = j - 1
        fundamental = (
            parent_l[prev] == j
            and pat_l[prev] == pat_l[j] + 1
            and (j - starts[-1]) < max_supernode
        )
        if relax > 0 and not fundamental and parent_l[prev] == j:
            extra = pat_l[j] + 1 - pat_l[prev]
            fundamental = abs(extra) <= relax and (j - starts[-1]) < max_supernode
        if fundamental:
            sn_of[j] = len(starts) - 1
        else:
            starts.append(j)
            sn_of[j] = len(starts) - 1
    return sn_of, starts


def _expand(nodes: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """The columns of the supervariables ``nodes`` (sorted), in order."""
    width = starts[nodes + 1] - starts[nodes]
    first = starts[nodes] - (np.cumsum(width) - width)
    return np.repeat(first, width) + np.arange(int(width.sum()), dtype=np.int64)


class _AnalyzeClock:
    """Seconds of each of ``ANALYZE_STAGES`` in one ``analyze``, published
    as a bus span and a counter when telemetry is on."""

    def __init__(self) -> None:
        self.laps: List[Tuple[str, float, float]] = []
        self._t = time.perf_counter()

    def lap(self, stage: str) -> None:
        t = time.perf_counter()
        self.laps.append((stage, self._t, t))
        self._t = t

    def publish(self, starts: np.ndarray) -> None:
        """The stages' seconds and spans, the mean width of the runs that
        start at ``starts`` and their count by width."""
        if not obs_events.enabled():
            return
        reg = obs_metrics.REGISTRY
        seconds = reg.counter(
            "repro_sparse_analyze_seconds_total",
            "host seconds of sparse.symbolic.analyze by stage",
            unit="s",
        )
        epoch = obs_events.BUS.epoch
        for stage, t0, t1 in self.laps:
            seconds.inc(t1 - t0, stage=stage)
            obs_events.BUS.span(stage, t0 - epoch, t1 - epoch, cat="analyze")
        reg.gauge(
            "repro_sparse_supervariable_width",
            "columns per supervariable of the last analysed matrix",
        ).set((starts[-1] / (len(starts) - 1)) if len(starts) > 1 else 1.0)
        runs = reg.counter(
            "repro_sparse_supervariables_total",
            "supervariables (runs of columns with one structure) by width in columns",
        )
        for w, k in zip(*np.unique(np.diff(starts), return_counts=True)):
            runs.inc(int(k), width=str(int(w)))


def analyze(
    a: sp.csr_matrix,
    relax: int = 0,
    max_supernode: int = 256,
) -> SymbolicFactorization:
    """Full symbolic phase: etree → patterns → (relaxed) supernodes → flops.

    ``relax``: merge a child into its parent when doing so adds at most
    ``relax`` extra fill rows per pivot (classic amalgamation — larger fronts
    mean larger, better-parallelizing malleable tasks, the paper's trade-off).

    Where consecutive columns share their structure (:func:`supervariables`),
    the etree and the patterns are computed on the compressed graph and
    expanded: within a run the etree is the chain j → j+1, the last column's
    parent is the first column of the run's parent, and column i of a run
    of width w has the run's pattern less its first i columns.  The result
    equals the scalar path's.
    """
    clock = _AnalyzeClock()
    lo = _lower_rows(a)
    return _analyze_runs(a, _runs(lo), relax, max_supernode, clock, lo)


def _analyze_runs(
    a: sp.csr_matrix,
    starts: np.ndarray,
    relax: int,
    max_supernode: int,
    clock: _AnalyzeClock,
    lo: Optional[sp.csr_matrix] = None,
) -> SymbolicFactorization:
    """:func:`analyze` over the runs of columns that start at ``starts``
    (``np.arange(n + 1)``: the scalar path), the runs' graph read from
    ``lo`` (``a``'s :func:`_lower_rows`, read here when not given)."""
    n = a.shape[0]
    nv = len(starts) - 1
    if nv == n:
        clock.lap("compress")
        parent = etree(a)
        clock.lap("etree")
        pats = col_patterns(a, parent)
        clock.lap("patterns")
        pat_len = np.array([len(p) for p in pats], dtype=np.int64)
    else:
        # the graph of supervariables: within runs the pattern is all or
        # nothing
        width = np.diff(starts)
        node_of = np.repeat(np.arange(nv), width)
        c = _quotient(lo if lo is not None else _lower_rows(a), starts)
        clock.lap("compress")
        node_parent = etree(c)
        clock.lap("etree")
        node_pats = col_patterns(c, node_parent)
        clock.lap("patterns")
        pos = np.arange(n) - starts[node_of]
        # the run's pattern in columns, the run itself included
        flat = np.concatenate(node_pats)
        offsets = np.cumsum([0] + [len(p) for p in node_pats[:-1]])
        pat_len = np.add.reduceat(width[flat], offsets)[node_of] - pos
        parent = np.arange(1, n + 1, dtype=np.int64)
        last = np.flatnonzero(pos == width[node_of] - 1)
        up = node_parent[node_of[last]]
        parent[last] = np.where(up >= 0, starts[np.maximum(up, 0)], -1)

    sn_of, sn_starts = _partition(parent, pat_len, relax, max_supernode)
    bounds = sn_starts + [n]
    supernodes: List[Supernode] = []
    for s in range(len(sn_starts)):
        lo, hi = bounds[s], bounds[s + 1]
        cols = np.arange(lo, hi, dtype=np.int64)
        if nv == n:
            # front rows: union of patterns of pivot cols (= pattern of
            # first col for fundamental supernodes, union for relaxed)
            rows = set()
            for j in range(lo, hi):
                rows.update(int(i) for i in pats[j])
            rows.update(int(c) for c in cols)
            rows_arr = np.array(sorted(rows), dtype=np.int64)
        else:
            # the columns from lo to the end of the last run touched, then
            # the runs beyond it in the touched runs' patterns
            va, vb = int(node_of[lo]), int(node_of[hi - 1])
            beyond = np.unique(np.concatenate(node_pats[va : vb + 1]))
            beyond = beyond[beyond > vb]
            rows_arr = np.concatenate(
                [np.arange(lo, starts[vb + 1], dtype=np.int64), _expand(beyond, starts)]
            )
        sn = Supernode(cols=cols, rows=rows_arr)
        sn.flops = partial_factor_flops(sn.m, sn.nb)
        supernodes.append(sn)

    # supernode parents via etree of last pivot column
    for s, sn in enumerate(supernodes):
        last = int(sn.cols[-1])
        p = int(parent[last])
        sn.parent = int(sn_of[p]) if p >= 0 else -1
    clock.lap("supernodes")
    clock.publish(starts)

    return SymbolicFactorization(
        n=n, supernodes=supernodes, col_to_sn=sn_of, parent_col=parent
    )
