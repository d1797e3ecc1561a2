"""The multifrontal Cholesky factorization loop.

Walks the assembly tree in post-order (or in the PM plan's wave order),
assembling and partially factorizing one front per supernode.  The factor
kernel is pluggable: the ``torch.linalg`` reference or the hand-written
CUDA kernels (repro_torch.kernels.ops.partial_cholesky).  Assembly stays
host numpy; a FactorFn takes and returns torch tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .frontal import partial_cholesky_ref
from .matrix import first_at_least
from .symbolic import SymbolicFactorization, Supernode

FactorFn = Callable[[torch.Tensor, int], Tuple[torch.Tensor, torch.Tensor]]


@dataclass
class Factorization:
    """Sparse Cholesky factor in supernodal form."""

    symb: SymbolicFactorization
    panels: List[np.ndarray]  # per supernode: (m, nb) panel [L11; L21]

    def to_dense_l(self) -> np.ndarray:
        n = self.symb.n
        l = np.zeros((n, n))
        for sn, panel in zip(self.symb.supernodes, self.panels):
            for k, j in enumerate(sn.cols):
                rows = sn.rows[sn.rows >= j]
                pos = np.searchsorted(sn.rows, rows)
                l[rows, j] = panel[pos, k]
        return l


def gather_front_entries(a: sp.csc_matrix, sn: Supernode) -> np.ndarray:
    """Dense (m, m) block with original entries of the pivot columns/rows.

    Only entries A[i, j] with j a pivot column and i in the front structure
    are owned by this front (each entry of A is assembled exactly once).
    Symmetric mirror is filled so the reference kernel sees a full block.
    ``a`` must be the sorted CSC lower triangle (see ``lower_csc``).
    """
    m = sn.m
    f = np.zeros((m, m))
    rowpos = {int(r): k for k, r in enumerate(sn.rows)}
    for k, j in enumerate(sn.cols):
        jj = int(j)
        lo, hi = a.indptr[jj], a.indptr[jj + 1]
        for idx in range(lo, hi):
            i = int(a.indices[idx])
            if i < jj:
                continue  # lower triangle only
            p = rowpos.get(i)
            if p is None:
                continue
            f[p, k] = a.data[idx]
            f[k, p] = a.data[idx]
    return f


def lower_csc(a: sp.csr_matrix) -> sp.csc_matrix:
    """Sorted CSC lower triangle — the assembly-side view of A.  Of a
    canonical CSR matrix (sorted rows, no duplicates) the lower triangle
    is each row's head, cut by a bisection of all rows at once and turned
    by a counting sort: the same arrays, without the coordinate form."""
    if sp.issparse(a) and a.format == "csr" and a.has_canonical_format:
        n = a.shape[0]
        start = a.indptr[:-1].astype(np.int64)
        cnt = first_at_least(a.indptr, a.indices, np.arange(1, n + 1)) - start
        indptr = np.concatenate([[0], np.cumsum(cnt)])
        take = np.repeat(start - indptr[:-1], cnt) + np.arange(int(indptr[-1]))
        acsc = sp.csr_matrix((a.data[take], a.indices[take], indptr), shape=a.shape).tocsc()
    else:
        acsc = sp.tril(a).tocsc()
    acsc.sort_indices()
    return acsc


def extend_add_np(
    f: np.ndarray, sn: Supernode, rows_c: np.ndarray, upd: np.ndarray
) -> None:
    """In-place extend-add of one child Schur complement into a front.

    ``rows_c`` are the child's border rows in global indices; they are
    located in the parent's structure by binary search (the symbolic phase
    guarantees containment).
    """
    local = np.searchsorted(sn.rows, rows_c)
    assert np.all(sn.rows[local] == rows_c), "child border not in front"
    f[np.ix_(local, local)] += upd


def assemble_front_np(
    a: sp.csc_matrix,
    sn: Supernode,
    child_updates: List[Tuple[np.ndarray, np.ndarray]],
) -> np.ndarray:
    """Host-side front assembly: original entries + children's extend-add."""
    f = gather_front_entries(a, sn)
    for rows_c, upd in child_updates:
        extend_add_np(f, sn, rows_c, upd)
    return f


def default_device() -> torch.device:
    """The first CUDA device; raises when there is none (the CPU is only
    ever used when the caller passes it explicitly)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "factorize: no CUDA device; pass device='cpu' to run the plain"
            " PyTorch versions on the CPU"
        )
    return torch.device("cuda", 0)


def factorize(
    a: sp.csr_matrix,
    symb: SymbolicFactorization,
    factor_fn: Optional[FactorFn] = None,
    order: Optional[List[int]] = None,
    *,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Factorization:
    """Numeric multifrontal factorization.

    ``order``: supernode execution order (children before parents); defaults
    to natural order (supernodes are numbered in column order, which is a
    post-order of the assembly tree).  A PM plan's wave order can be passed
    to emulate scheduled execution.  Each front goes to ``factor_fn`` as a
    ``dtype`` tensor on ``device`` (default: the first CUDA device, see
    ``default_device``).
    """
    factor_fn = factor_fn or partial_cholesky_ref
    device = default_device() if device is None else torch.device(device)
    acsc = lower_csc(a)
    ns = symb.n_supernodes
    order = list(range(ns)) if order is None else order

    done = np.zeros(ns, dtype=bool)
    updates: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    children: List[List[int]] = [[] for _ in range(ns)]
    for s, sn in enumerate(symb.supernodes):
        if sn.parent >= 0:
            children[sn.parent].append(s)

    panels: List[Optional[np.ndarray]] = [None] * ns
    for s in order:
        sn = symb.supernodes[s]
        assert all(done[c] for c in children[s]), "order violates precedence"
        f_host = assemble_front_np(
            acsc, sn, [updates.pop(c) for c in children[s]]
        )
        f = torch.as_tensor(f_host, dtype=dtype, device=device)
        panel, schur = factor_fn(f, sn.nb)
        panels[s] = panel.cpu().numpy()
        if sn.m > sn.nb:
            updates[s] = (sn.rows[sn.nb :], schur.cpu().numpy())
        done[s] = True

    assert all(p is not None for p in panels)
    return Factorization(symb=symb, panels=panels)  # type: ignore[arg-type]


def solve(fact: Factorization, b: np.ndarray) -> np.ndarray:
    """Solve A x = b via the dense factor (validation-sized problems)."""
    l = fact.to_dense_l()
    y = np.linalg.solve(l, b)
    return np.linalg.solve(l.T, y)
