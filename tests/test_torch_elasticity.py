"""3-D linear elasticity on Q1 hexahedra: the plain references
(``repro_torch.sparse.plain``), the benchmark's generator of the operator
(``bench/families/q1_elasticity.py``, loaded by path), the analysis on
supervariables against the scalar analysis, the port's factor against a
dense Cholesky factor, and the counters of the analysis and of the large
route.

Everything runs on CPU lanes (the kernels' plain versions) at a few
hundred unknowns, apart from one dense front of order 1,100 that takes
the large route.  No JAX is needed.
"""
import importlib.util
import time
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

REPO = Path(__file__).resolve().parents[1]
CPU2 = [torch.device("cpu")] * 2
SEED = 2**33 + 30


def _load(name):
    path = REPO / "bench" / "families" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"family_{name}_for_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


q1 = _load("q1_elasticity")
grid_diffusion = _load("grid_diffusion")


def operator(nodes):
    """The benchmark's operator on ``nodes``³ free nodes."""
    return q1.Operator({
        "grid": [nodes + 1] * 3, "ordering": {"leaf": 4},
        "material": {"E0": 1.0, "Emin": 1e-9, "penal": 3, "nu": 0.3},
        "density": {"law": "uniform", "per": "element", "low": 0.3, "high": 1.0},
    })


@pytest.fixture(autouse=True)
def fresh_obs():
    obs.enable()
    obs.reset()
    yield
    obs.enable()
    obs.reset()


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
def test_element_stiffness_is_symmetric_semidefinite_with_six_rigid_modes():
    ke = plain.q1_element_stiffness(0.3)
    assert ke.shape == (24, 24) and ke.dtype == torch.float64
    torch.testing.assert_close(ke, ke.T, rtol=0, atol=1e-15)
    ev = torch.linalg.eigvalsh(ke)
    tiny = 1e-12 * float(ev.max())
    assert int((ev.abs() < tiny).sum()) == 6 and float(ev.min()) > -tiny
    assert bool((ke != 0).all())  # a full block pattern once assembled
    # the rigid modes: translations and rotations carry no energy
    xyz = torch.tensor(plain.CORNERS, dtype=torch.float64)
    for mode in (lambda p: (1.0, 0.0, 0.0), lambda p: (0.0, 0.0, 1.0),
                 lambda p: (-p[1], p[0], 0.0), lambda p: (0.0, -p[2], p[1])):
        u = torch.tensor([v for p in xyz for v in mode(p)], dtype=torch.float64)
        assert float((ke @ u).abs().max()) < 1e-14
    # the benchmark's own copy is the same matrix
    np.testing.assert_allclose(q1.element_stiffness(0.3), ke.numpy(), rtol=0, atol=1e-15)


def test_family_equals_plain_assembly():
    op = operator(4)
    a = op.matrix(SEED, 2, original_order=True)
    e = torch.from_numpy(op.moduli(SEED, 2))
    assert float(e.min()) >= 0.3**3 - 1e-12 and float(e.max()) <= 1.0
    k = plain.assemble_q1(op.dims, e).numpy()
    assert a.shape == k.shape == (192, 192)
    assert np.abs(a.toarray() - k).max() <= 1e-14 * np.abs(k).max()
    # in elimination order: the same matrix, permuted, with each node's
    # three unknowns consecutive
    ap = op.matrix(SEED, 2)
    np.testing.assert_array_equal(ap.toarray(), a.toarray()[np.ix_(op.perm, op.perm)])
    np.testing.assert_array_equal(op.perm.reshape(-1, 3) % 3, np.tile(np.arange(3), (64, 1)))
    # the pattern is fixed, the values are not
    b = op.matrix(SEED, 3)
    np.testing.assert_array_equal(b.indptr, ap.indptr)
    np.testing.assert_array_equal(b.indices, ap.indices)
    assert not np.array_equal(b.data, ap.data)


def test_symbolic_structure_is_the_factor_pattern():
    op = operator(3)
    a = torch.from_numpy(op.matrix(SEED, 0).toarray())
    s = plain.symbolic_structure(a != 0)
    l = plain.dense_factor(a)
    assert bool((s | (l == 0)).all())  # every entry of L lies in struct(L)
    assert bool(torch.equal(s, torch.tril(s)))


# -- supervariables against the scalar analysis ---------------------------
def blocked_random(seed, nodes=40):
    """A seeded random SPD matrix whose nodes carry 1, 2 or 3 unknowns,
    each node's unknowns consecutive after a random node order."""
    g = np.random.default_rng(seed)
    width = g.integers(1, 4, size=nodes)
    r, c = g.integers(0, nodes, size=(2, 3 * nodes))
    adj = sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(nodes, nodes))
    adj = ((adj + adj.T + sp.eye(nodes)) != 0).astype(float)
    expand = sp.csr_matrix((np.ones(width.sum()), (np.arange(width.sum()),
                            np.repeat(np.arange(nodes), width))))
    pat = (expand @ adj @ expand.T).tocsr()
    pat.data = g.uniform(-1.0, 1.0, pat.nnz)
    a = pat + pat.T
    a = a + sp.diags(np.abs(a).sum(axis=1).A1 + 1.0)
    return a.tocsr()


CASES = (
    [(f"elasticity{m}", relax, ms) for m in (3, 4, 5, 6) for relax in (0, 2, 4) for ms in (256, 7)]
    + [("diffusion8", 2, 256), ("random", 0, 256), ("random", 2, 7)]
)


def case_matrix(name):
    if name.startswith("elasticity"):
        return operator(int(name[len("elasticity"):])).matrix(SEED, 0)
    if name == "diffusion8":
        op = grid_diffusion.Operator({
            "grid": [8, 8, 8], "ordering": {"leaf": 4},
            "coefficients": {"law": "lognormal", "per": "face", "mu": 0.0, "sigma": 1.0}})
        return op.matrix(SEED, 0)
    return blocked_random(SEED)


@pytest.mark.parametrize("name,relax,max_supernode", CASES)
def test_supervariable_analysis_equals_scalar(name, relax, max_supernode):
    a = case_matrix(name)
    starts = symbolic.supervariables(a)
    if name.startswith("elasticity"):
        np.testing.assert_array_equal(starts, np.arange(0, a.shape[0] + 1, 3))
    if name == "diffusion8":
        np.testing.assert_array_equal(starts, np.arange(a.shape[0] + 1))
    if name == "random":
        assert len(starts) - 1 < a.shape[0]  # runs of 2 and 3 columns
    got = symbolic.analyze(a, relax=relax, max_supernode=max_supernode)
    assert_same(got, scalar(a, relax, max_supernode))
    if max_supernode == 7 and name.startswith("elasticity"):
        # the cap splits nodes: some supernode starts inside a node
        assert any(int(sn.cols[0]) % 3 for sn in got.supernodes)
    if name.startswith("elasticity"):
        struct = plain.symbolic_structure(torch.from_numpy(a.toarray() != 0))
        for sn in got.supernodes:
            rows = torch.nonzero(struct[:, torch.from_numpy(sn.cols)].any(dim=1)).flatten()
            np.testing.assert_array_equal(sn.rows, rows.numpy())


def test_supervariables_need_a_full_diagonal_block():
    # two columns with the same off-diagonal rows but not joined to each
    # other are not one run
    a = sp.csr_matrix(np.array([[2.0, 0, 1], [0, 2, 1], [1, 1, 3]]))
    np.testing.assert_array_equal(symbolic.supervariables(a), [0, 1, 2, 3])
    b = sp.csr_matrix(np.array([[2.0, 1, 1], [1, 2, 1], [1, 1, 3]]))
    np.testing.assert_array_equal(symbolic.supervariables(b), [0, 3])
    assert_same(symbolic.analyze(b), scalar(b, 0, 256))


# -- the port's factor ------------------------------------------------------
def factor(a, perm, mode):
    sess = Session(DeviceMesh(CPU2)).analyze(a, 0.9, ordering=perm).plan("pm")
    ex = PlanExecutor(sess.problem.symb, sess.schedule.to_execution_plan(),
                      devices=sess.platform.devices(), dtype=torch.float64, mode=mode)
    fact, _ = ex.run(sess.problem.matrix)
    return fact, sess.problem.matrix


def test_port_factor_equals_dense_cholesky():
    op = operator(5)
    a = op.matrix(SEED, 1, original_order=True)
    assert a.shape == (375, 375)
    fa, ap = factor(a, op.perm, "async")
    fw, _ = factor(a, op.perm, "waves")
    for p, q in zip(fa.panels, fw.panels):
        np.testing.assert_array_equal(p, q)  # async and waves bit for bit
    want = plain.dense_factor(torch.from_numpy(ap.toarray())).numpy()
    got = fa.to_dense_l()
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-11
    # the reference's own assembly, permuted, is the matrix the port factored
    k = plain.assemble_q1(op.dims, torch.from_numpy(op.moduli(SEED, 1))).numpy()
    assert np.abs(ap.toarray() - k[np.ix_(op.perm, op.perm)]).max() <= 1e-14 * np.abs(k).max()


# -- counters -----------------------------------------------------------------
def counter(name, **labels):
    c = obs.REGISTRY.get(name)
    return None if c is None else c.value_of(**labels)


def test_large_route_counters():
    """One dense SPD block of order 1,100: one run of 1,100 columns, a
    chain of fronts capped at 256 pivots, the first padded past 1,024."""
    g = np.random.default_rng(SEED)
    b = g.standard_normal((1100, 1100))
    a = sp.csr_matrix(b @ b.T / 1100 + np.eye(1100))
    symb = symbolic.analyze(a, relax=2)
    np.testing.assert_array_equal(symbolic.supervariables(a), [0, 1100])
    assert_same(symb, scalar(a, 2, 256))
    large = [sn for sn in symb.supernodes if padded_shape(sn.m, sn.nb)[0] > VMEM_FRONT_MAX]
    assert [(sn.m, padded_shape(sn.m, sn.nb)[0]) for sn in large] == [(1100, 1152)]
    sess = Session(DeviceMesh(CPU2)).analyze(a, 0.9).plan("pm")
    ex = PlanExecutor(sess.problem.symb, sess.schedule.to_execution_plan(),
                      devices=sess.platform.devices(), dtype=torch.float64, mode="async")
    obs.reset()
    fact, rep = ex.run(a, warmup=False)
    # assembled on the lane: the chain's leaf, from the run's values on
    # the lane, so only its panel comes out; its Schur block stays on the
    # lane for its small parent, which the large route's kept counters
    # leave out
    first = ex.symb.supernodes[0]
    assert (first.m, first.nb) == (large[0].m, large[0].nb)
    assert padded_shape(ex.symb.supernodes[first.parent].m,
                        ex.symb.supernodes[first.parent].nb)[0] <= VMEM_FRONT_MAX
    want = sum(sn.m * sn.nb * 8 for sn in large)
    assert counter("repro_executor_large_fronts_total") == len(large)
    assert counter("repro_executor_large_bytes_total") == want
    assert counter("repro_executor_kept_blocks_total") == 0
    assert counter("repro_executor_kept_bytes_total") == 0
    seconds = counter("repro_executor_large_seconds_total")
    assert 0 < seconds <= sum(rep.host.seconds.values())
    # a part of the bytes copied, which keeps its name and labels
    assert counter("repro_executor_copy_bytes_total", kind="copied") == rep.host.copied_bytes > want
    ref = np.linalg.cholesky(a.toarray())
    assert np.abs(fact.to_dense_l() - ref).max() / np.abs(ref).max() < 1e-11


def test_no_large_front_counts_zero_on_the_large_route():
    op = operator(4)
    fact, _ = factor(op.matrix(SEED, 0, original_order=True), op.perm, "async")
    assert counter("repro_executor_copy_bytes_total", kind="copied") > 0
    for name in ("repro_executor_large_fronts_total", "repro_executor_large_bytes_total",
                 "repro_executor_large_seconds_total"):
        assert counter(name) == 0


@pytest.mark.parametrize("name,width", [("elasticity5", 3.0), ("diffusion8", 1.0)])
def test_analysis_stages_lie_inside_the_host_clock(name, width):
    a = case_matrix(name)
    epoch = obs.BUS.epoch
    t0 = time.perf_counter()
    symbolic.analyze(a, relax=2)
    t1 = time.perf_counter()
    stages = {s: counter("repro_sparse_analyze_seconds_total", stage=s)
              for s in symbolic.ANALYZE_STAGES}
    assert all(v is not None and v >= 0 for v in stages.values())
    assert 0 < sum(stages.values()) <= t1 - t0
    spans = obs.BUS.spans(cat="analyze")
    assert [s.name for s in spans] == list(symbolic.ANALYZE_STAGES)
    for s in spans:
        assert t0 - epoch <= s.t0 <= s.t1 <= t1 - epoch
        assert s.t1 - s.t0 == pytest.approx(stages[s.name], abs=1e-9)
    assert obs.REGISTRY.get("repro_sparse_supervariable_width").value == width


def test_analysis_publishes_nothing_when_telemetry_is_off():
    a = case_matrix("elasticity3")
    on = symbolic.analyze(a, relax=2)
    obs.reset()
    obs.disable()
    try:
        off = symbolic.analyze(a, relax=2)
        assert obs.REGISTRY.names() == [] and len(obs.BUS) == 0
    finally:
        obs.enable()
    assert_same(on, off)
