"""The yardstick on the CPU: generators, least work, the device-time reduction
and the judge."""
from __future__ import annotations

import json

import numpy as np
import pytest
import scipy.sparse as sp

import counts
import reference
import timeline
from families.grid_diffusion import Operator, nested_dissection

COEF = {"law": "lognormal", "per": "face", "mu": 0.0, "sigma": 1.0}


def operator(grid, sigma=1.0):
    return Operator({"grid": grid, "ordering": {"leaf": 4}, "coefficients": {**COEF, "sigma": sigma}})


@pytest.mark.parametrize("dims", [(1, 7), (5, 9), (8, 8), (3, 4, 5), (6, 6, 6), (2, 1, 9)])
def test_nested_dissection_is_a_permutation(dims):
    perm = nested_dissection(dims, 4)
    assert np.array_equal(np.sort(perm), np.arange(int(np.prod(dims))))


def test_nested_dissection_puts_the_top_separator_last():
    dims = (9, 7, 5)
    perm = nested_dissection(dims, 4)
    plane = [i * 35 + j * 5 + k for i in [4] for j in range(7) for k in range(5)]
    assert sorted(perm[-35:].tolist()) == plane


def laplacian(dims):
    """The plain 5- or 7-point Laplacian, Dirichlet, in row-major order."""
    n = int(np.prod(dims))
    idx = np.arange(n).reshape(dims)
    a = sp.lil_matrix((n, n))
    for p in range(n):
        a[p, p] = 2.0 * len(dims)
    for ax in range(len(dims)):
        lo = np.take(idx, np.arange(dims[ax] - 1), axis=ax).ravel()
        hi = np.take(idx, np.arange(1, dims[ax]), axis=ax).ravel()
        for p, q in zip(lo, hi):
            a[p, q] = a[q, p] = -1.0
    return a.tocsr()


@pytest.mark.parametrize("dims", [(6, 5), (4, 3, 5)])
def test_unit_coefficients_give_the_laplacian(dims):
    op = operator(dims, sigma=0.0)
    a = op.matrix(3, 0, original_order=True)
    assert abs(a - laplacian(dims)).max() == 0.0
    # the matrix in elimination order is P A P^T
    p = sp.csr_matrix((np.ones(op.n), (np.arange(op.n), op.perm)), shape=a.shape)
    assert abs(op.matrix(3, 0) - p @ a @ p.T).max() == 0.0


@pytest.mark.parametrize("dims", [(7, 6), (4, 4, 3)])
def test_matrices_are_spd_with_one_pattern_and_new_values(dims):
    op = operator(dims)
    mats = [op.matrix(seed, k) for seed in (5, 2**31 + 11, 2**40 + 3) for k in (0, 1, 2)]
    for a in mats:
        a.sort_indices()
        assert abs(a - a.T).max() == 0.0
        assert np.linalg.eigvalsh(a.toarray()).min() > 0
        assert np.array_equal(a.indptr, mats[0].indptr)
        assert np.array_equal(a.indices, mats[0].indices)
    assert all(not np.array_equal(a.data, b.data) for a, b in zip(mats, mats[1:]))
    again = op.matrix(2**31 + 11, 1)
    again.sort_indices()
    assert np.array_equal(again.data, mats[4].data)


def dense_counts(a):
    """Column counts of L by eliminating a dense boolean pattern."""
    f = a.toarray() != 0
    n = f.shape[0]
    for j in range(n):
        below = np.flatnonzero(f[j + 1:, j]) + j + 1
        f[np.ix_(below, below)] = True
    return np.tril(f).sum(axis=0)


@pytest.mark.parametrize("dims", [(9, 7), (12, 12), (4, 5, 3), (5, 5, 5)])
def test_least_work_against_a_dense_count(dims):
    a = operator(dims).matrix(1, 0)
    c = dense_counts(a).astype(float)
    work = counts.least_work(a)
    assert np.array_equal(counts.column_counts(a), c)
    assert work["flops"] == np.sum(c * c + c + 1)
    assert work["bytes"] == 8 * (sp.tril(a).nnz + c.sum())


def test_union_counts_overlap_once():
    assert timeline.union([(0.0, 2.0), (1.0, 3.0)]) == [(0.0, 3.0)]
    assert timeline.union([(4.0, 5.0), (0.0, 1.0), (1.0, 2.0)]) == [(0.0, 2.0), (4.0, 5.0)]
    assert timeline.gaps([(1.0, 2.0), (4.0, 5.0)], 0.0, 6.0) == [(0.0, 1.0), (2.0, 4.0), (5.0, 6.0)]


def test_chrome_trace_reduction(tmp_path):
    ev = lambda cat, name, ts, dur, tid=7: {  # noqa: E731
        "ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    events = [
        ev("user_annotation", timeline.WINDOW_RANGE, 1000.0, 10e6),
        ev("kernel", "k1", 1000.0 + 1e6, 3e6, tid=7),  # 1-4 s
        ev("kernel", "k2", 1000.0 + 3e6, 2e6, tid=8),  # 3-5 s, another stream
        ev("gpu_memcpy", "Memcpy HtoD", 1000.0 + 7e6, 1e6),  # 7-8 s
        ev("kernel", "before", 0.0, 500.0),  # outside the window
        ev("cpu_op", "aten::copy_", 1000.0 + 2e6, 1e6),  # host work: not device time
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = timeline.read_chrome_trace(path, 100.0, None)
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s == pytest.approx(5.0)  # 1-5 and 7-8: the overlap once
    assert t.kernel_s == pytest.approx(5.0)  # each kernel's own time
    assert t.copy_s == pytest.approx(1.0)
    assert dict(t.device_ops) == pytest.approx({"k1": 3.0, "k2": 2.0, "Memcpy HtoD": 1.0})


def test_idle_time_goes_to_the_busy_threads():
    s = timeline.HostSampler.__new__(timeline.HostSampler)
    s.samples = [(0.5, ("a.py:f", "b.py:g (wait)")), (1.5, ("b.py:g (wait)",)),
                 (2.5, ("a.py:f", "c.py:h")), (3.5, ("c.py:h",))]
    shares = s.attribute([(0.0, 2.0), (2.2, 3.0)])
    assert shares == pytest.approx({"a.py:f": 2.8 * 1.5 / 3, "b.py:g (wait)": 2.8 / 3,
                                    "c.py:h": 2.8 * 0.5 / 3})


def panels_of(l, blocks):
    """A dense lower-triangular L cut into supernodal panels."""
    out, lo = [], 0
    for hi in blocks:
        rows = np.arange(lo, l.shape[0])
        out.append((rows, np.arange(lo, hi), l[lo:, lo:hi].copy()))
        lo = hi
    return out


def test_judge_reads_round_off_for_a_true_factor_and_more_for_a_wrong_one():
    a = operator((9, 8)).matrix(4, 0)
    l = np.linalg.cholesky(a.toarray())
    x = reference.probes(a.shape[0], 8, np.random.default_rng(0))
    blocks = [10, 30, 50, 72]
    assert reference.residual(panels_of(l, blocks), a, x) < 1e-15
    # entries above the diagonal of a panel are not part of L
    junk = panels_of(l, blocks)
    junk[1][2][0, 5] = 1e3
    assert reference.residual(junk, a, x) < 1e-15
    low = np.linalg.cholesky(a.toarray().astype(np.float32)).astype(np.float64)
    assert reference.residual(panels_of(low, blocks), a, x) > 1e-9
    bad = panels_of(l, blocks)
    bad[2][2][-1, 0] *= 1 + 1e-6
    assert reference.residual(bad, a, x) > 1e-12
    assert reference.residual(panels_of(l, blocks)[1:], a, x) == float("inf")
