"""3-D linear elasticity on tricubic (Q3) hexahedra, MFEM's example 2 on a
cantilever beam: the plain references (``repro_torch.sparse.plain``), the
benchmark's generator of the operator
(``bench/families/lagrange_elasticity.py``, loaded by path), the analysis
on supervariables of mixed widths, the port's factor against a dense
Cholesky factor, and the counters of the analysis and of the executor's
entry maps.

Everything runs on CPU lanes (the kernels' plain versions) at a few hundred
unknowns, apart from one dense front of order 1,100 that takes the large
route.  No JAX is needed.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro_torch.obs as obs
import repro_torch.sparse.symbolic as symbolic
from repro_torch.api import DeviceMesh, Session
from repro_torch.kernels.frontal_cholesky import VMEM_FRONT_MAX
from repro_torch.kernels.ops import padded_shape
from repro_torch.runtime import PlanExecutor
from repro_torch.sparse import plain
from repro_torch.sparse.matrix import permute_symmetric

REPO = Path(__file__).resolve().parents[1]
CPU2 = [torch.device("cpu")] * 2
SEED = 2**33 + 34


def _load(name):
    path = REPO / "bench" / "families" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"family_{name}_for_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


family = _load("lagrange_elasticity")
q1 = _load("q1_elasticity")


def beam(elements=(4, 1, 1), leaf=2):
    """The benchmark's beam at order 3 with unit elements and ex2's two
    materials, split at half its length as ex2 splits its beam.  Leaf 2:
    with one element a leaf, a beam one element thick has runs of 3
    widths only (every node of a leaf lies in that element alone)."""
    return family.Operator({
        "order": 3, "elements": list(elements), "h": 1.0, "clamped": "x0",
        "materials": [{"attribute": 1, "x": [0.0, 2.0], "lambda": 50.0, "mu": 50.0},
                      {"attribute": 2, "x": [2.0, 8.0], "lambda": 1.0, "mu": 1.0}],
        "simp": {"E0": 1.0, "Emin": 1e-9, "penal": 3},
        "density": {"law": "uniform", "per": "element", "low": 0.3, "high": 1.0},
        "ordering": {"kind": "nested_dissection", "leaf": leaf},
    })


@pytest.fixture(scope="module")
def op():
    return beam()


@pytest.fixture(autouse=True)
def fresh_obs():
    obs.enable()
    obs.reset()
    yield
    obs.enable()
    obs.reset()


def counter(name, **labels):
    c = obs.REGISTRY.get(name)
    return None if c is None else c.value_of(**labels)


def scalar(a, relax, max_supernode):
    """The analysis with every column its own run: the scalar path."""
    starts = np.arange(a.shape[0] + 1)
    return symbolic._analyze_runs(a, starts, relax, max_supernode, symbolic._AnalyzeClock())


def assert_same(x, y):
    assert x.n == y.n and x.n_supernodes == y.n_supernodes
    np.testing.assert_array_equal(x.col_to_sn, y.col_to_sn)
    np.testing.assert_array_equal(x.parent_col, y.parent_col)
    for u, v in zip(x.supernodes, y.supernodes):
        np.testing.assert_array_equal(u.cols, v.cols)
        np.testing.assert_array_equal(u.rows, v.rows)
        assert u.rows.dtype == v.rows.dtype == np.int64
        assert (u.parent, u.flops) == (v.parent, v.flops)


# -- the plain references -------------------------------------------------
def test_order_one_is_the_trilinear_element():
    nu = 0.3
    lam, mu = nu / ((1 + nu) * (1 - 2 * nu)), 1 / (2 * (1 + nu))
    ke = plain.lagrange_hex_stiffness(1, lam, mu, 1.0)
    torch.testing.assert_close(ke, plain.q1_element_stiffness(nu), rtol=0, atol=1e-15)
    np.testing.assert_allclose(family.element_stiffness(1, lam, mu, 1.0), ke.numpy(),
                               rtol=0, atol=1e-15)


def test_order_three_element_is_symmetric_semidefinite_with_six_rigid_modes():
    ke = plain.lagrange_hex_stiffness(3, 50.0, 50.0, 0.125)
    assert ke.shape == (192, 192) and ke.dtype == torch.float64
    torch.testing.assert_close(ke, ke.T, rtol=0, atol=1e-13)
    ev = torch.linalg.eigvalsh(ke)
    tiny = 1e-12 * float(ev.max())
    assert int((ev.abs() < tiny).sum()) == 6 and float(ev.min()) > -tiny
    # the family's KE (another form of the same integral) is the same matrix
    ours = family.element_stiffness(3, 50.0, 50.0, 0.125)
    assert np.array_equal(ours, ours.T)
    assert np.abs(ours - ke.numpy()).max() <= 1e-14 * float(ke.abs().max())
    # some entries vanish in every element: they are stored zeros
    assert (ours == 0).any()


def test_family_equals_plain_assembly(op):
    a = op.matrix(SEED, 2)
    s = torch.from_numpy(op.moduli(SEED, 2))
    lame = torch.tensor([50.0, 1.0], dtype=torch.float64)[torch.from_numpy(op.material)]
    e = lame.reshape(op.dims) * s
    k = plain.assemble_beam(3, op.dims, e, e, 1.0).numpy()
    assert a.shape == k.shape == (576, 576) and op.n == 576
    nat = op.natural(a).toarray()
    assert np.abs(nat - k).max() <= 1e-14 * np.abs(k).max()
    # the pattern: node adjacency times full 3x3 blocks, stored zeros and all
    rows = np.repeat(np.arange(op.n), np.diff(a.indptr))
    blocks = sp.csr_matrix((np.ones(a.nnz), (rows // 3, a.indices // 3)))
    assert blocks.nnz * 9 == a.nnz and (a.data == 0).sum() == op.stored_zero.sum() > 0
    np.testing.assert_array_equal(a.toarray(), a.toarray().T)
    np.testing.assert_array_equal(op.elimination.reshape(-1, 3) % 3, np.tile(np.arange(3), (192, 1)))
    # the pattern is fixed, the values are not
    b = op.matrix(SEED, 3)
    np.testing.assert_array_equal(b.indptr, a.indptr)
    np.testing.assert_array_equal(b.indices, a.indices)
    assert not np.array_equal(b.data, a.data)


def test_permutation_keeps_stored_zeros(op):
    a = op.natural(op.matrix(SEED, 0))
    ap = permute_symmetric(a, op.elimination)
    want = op.matrix(SEED, 0)
    np.testing.assert_array_equal(ap.indptr, want.indptr)
    np.testing.assert_array_equal(ap.indices, want.indices)
    np.testing.assert_array_equal(ap.data, want.data)


# -- supervariables of mixed widths -----------------------------------------
@pytest.mark.parametrize("relax,max_supernode,block", [(2, 256, None), (0, 256, None), (2, 7, 97)])
def test_mixed_width_analysis_equals_scalar(op, relax, max_supernode, block, monkeypatch):
    if block:  # many blocks of rows in the pattern's passes
        monkeypatch.setattr(symbolic, "_BLOCK", block)
    a = op.matrix(SEED, 0)
    width = np.diff(symbolic.supervariables(a))
    assert len(set(width.tolist())) >= 4 and (width % 3 == 0).all()
    assert_same(symbolic.analyze(a, relax=relax, max_supernode=max_supernode),
                scalar(a, relax, max_supernode))


def test_the_pattern_is_read_once(op, monkeypatch):
    """The runs and their graph come from one read of the lower triangle:
    no matrix of the unknowns' order built during the analysis holds more
    entries than the strict lower triangle."""
    a = op.matrix(SEED, 0)
    real, built = sp.csr_matrix, []

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        built.append((out.shape, out.nnz))
        return out

    monkeypatch.setattr(symbolic.sp, "csr_matrix", spy)
    got = symbolic.analyze(a, relax=2)
    monkeypatch.undo()
    scalar_sized = [nnz for shape, nnz in built if shape == a.shape]
    assert sum(scalar_sized) <= sp.tril(a, k=-1).nnz
    assert_same(got, scalar(a, 2, 256))


def test_width_counter_sums_to_n(op):
    a = op.matrix(SEED, 0)
    symbolic.analyze(a, relax=2)
    snap = obs.REGISTRY.get("repro_sparse_supervariables_total").to_dict()["values"]
    widths = {int(k.split('"')[1]): v for k, v in snap.items() if k != "total"}
    assert len(widths) >= 4
    assert sum(w * k for w, k in widths.items()) == a.shape[0]
    starts = symbolic.supervariables(a)
    assert sum(widths.values()) == len(starts) - 1


# -- the port's factor -------------------------------------------------------
def executor(a):
    sess = Session(DeviceMesh(CPU2)).analyze(a, 0.9).plan("pm")
    return PlanExecutor(sess.problem.symb, sess.schedule.to_execution_plan(),
                        devices=sess.platform.devices(), dtype=torch.float64, mode="async")


def test_port_factor_equals_dense_cholesky(op):
    a = op.matrix(SEED, 1)
    ex = executor(a)
    fact, _ = ex.run(a)
    want = plain.dense_factor(torch.from_numpy(a.toarray())).numpy()
    got = fact.to_dense_l()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
    # the executor's maps: once a pattern, on every lane, one bus span
    maps = counter("repro_executor_setup_seconds_total", stage="maps")
    assert maps > 0 and len(obs.BUS.spans(cat="setup", name="maps")) == 1
    fact2, _ = ex.run(op.matrix(SEED, 2))
    assert counter("repro_executor_setup_seconds_total", stage="maps") == maps
    assert len(obs.BUS.spans(cat="setup", name="maps")) == 1
    # another pattern (the stored zeros dropped) builds them again
    b = op.matrix(SEED, 3)
    b.eliminate_zeros()
    fact3, _ = ex.run(b)
    assert len(obs.BUS.spans(cat="setup", name="maps")) == 2
    want3 = plain.dense_factor(torch.from_numpy(b.toarray())).numpy()
    assert np.abs(fact3.to_dense_l() - want3).max() / np.abs(want3).max() < 1e-12


# -- the entries gathered into fronts ----------------------------------------
def test_entry_bytes_count_each_entry_once_on_both_routes(op):
    """The beam (small fronts only) and one dense SPD block of order 1,100
    (a front padded past 1,024, then small ones): each factorization adds
    8 bytes per entry the maps keep."""
    g = np.random.default_rng(SEED)
    b = g.standard_normal((1100, 1100))
    dense = sp.csr_matrix(b @ b.T / 1100 + np.eye(1100))
    for a, large in ((op.matrix(SEED, 0), False), (dense, True)):
        ex = executor(a)
        obs.reset()
        shapes = [padded_shape(sn.m, sn.nb)[0] for sn in ex.symb.supernodes]
        assert any(m > VMEM_FRONT_MAX for m in shapes) == large
        before = 0.0
        for k in range(2):
            fact, _ = ex.run(a, warmup=False)
            now = counter("repro_executor_entry_bytes_total")
            assert now - before == 8 * len(ex._ent[0])
            before = now
        assert len(ex._ent[0]) == sp.tril(a).nnz  # every lower entry, none mirrored


def test_maps_counters_are_silent_when_telemetry_is_off(op):
    a = op.matrix(SEED, 0)
    ex = executor(a)
    obs.reset()
    obs.disable()
    try:
        ex.run(a, warmup=False)
        assert obs.REGISTRY.names() == [] and len(obs.BUS) == 0
    finally:
        obs.enable()


def test_values_of_a_known_pattern_come_by_one_gather(op):
    """After the first matrix of a pattern, the executor takes the lower
    triangle's values through the positions it kept; the factors are the
    ones a fresh executor makes, and a matrix in another form (unsorted
    rows, CSC) takes the lower CSC as before."""
    a, b = op.matrix(SEED, 4), op.matrix(SEED, 5)
    ex = executor(a)
    ex.run(a, warmup=False)
    assert ex._csr_key is not None
    got, _ = ex.run(b, warmup=False)
    want, _ = executor(b).run(b, warmup=False)
    unsorted = b.copy()
    for i in range(b.shape[0]):
        lo, hi = b.indptr[i], b.indptr[i + 1]
        unsorted.indices[lo:hi] = b.indices[lo:hi][::-1]
        unsorted.data[lo:hi] = b.data[lo:hi][::-1]
    unsorted.has_sorted_indices = False
    for other in (unsorted, b.tocsc()):
        again, _ = ex.run(other, warmup=False)
        assert ex._csr_key is None
        for p, q in zip(again.panels, want.panels):
            np.testing.assert_array_equal(p, q)
    for p, q in zip(got.panels, want.panels):
        np.testing.assert_array_equal(p, q)
