"""The port's sparse substrate and scheduling model against the JAX package.

The numpy-only modules (generators, orderings, symbolic analysis, plans,
the core scheduling model, device groups) are copies in the port, so their
results must equal the reference's exactly.  The multifrontal factorization is a
port: it is held against the reference within tolerance, and against the
matrix by its residual.
"""
import dataclasses
import itertools
import math

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.core as rcore
import repro.core.memory as rmem
import repro.core.pm as rpm
import repro.distributed.device_groups as rdg
import repro.sparse as rsparse
import repro_torch.core as tcore
import repro_torch.distributed.device_groups as tdg
import repro_torch.sparse as tsparse
from repro.core.trees import random_assembly_tree
from repro.sparse.plan import make_plan as rmake_plan


def _same(a, b, path="") -> None:
    """Exact, recursive equality across the two packages' objects."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), path
    else:
        assert a == b, path


def _twin_tree(tree):
    """The reference TaskTree as the port's."""
    return tcore.TaskTree(
        parent=tree.parent.copy(), lengths=tree.lengths.copy(),
        labels=tree.labels.copy(),
    )


def _grid_nd(g):
    a = rsparse.grid_laplacian_2d(g)
    return rsparse.permute_symmetric(a, rsparse.nested_dissection_2d(g))


# ----------------------------------------------------------------------
# Copies: exact equality
# ----------------------------------------------------------------------
def test_generators_match():
    for g in (5, 12):
        assert (tsparse.grid_laplacian_2d(g) != rsparse.grid_laplacian_2d(g)).nnz == 0
        assert (tsparse.grid_laplacian_2d(g, g + 3) != rsparse.grid_laplacian_2d(g, g + 3)).nnz == 0
    assert (tsparse.grid_laplacian_3d(4) != rsparse.grid_laplacian_3d(4)).nnz == 0
    a = tsparse.random_spd(80, 5.0, np.random.default_rng(7))
    b = rsparse.random_spd(80, 5.0, np.random.default_rng(7))
    assert (a != b).nnz == 0


def test_orderings_match(rng):
    for g in (9, 16):
        np.testing.assert_array_equal(
            tsparse.nested_dissection_2d(g), rsparse.nested_dissection_2d(g)
        )
    a = rsparse.random_spd(120, 6.0, rng)
    p = tsparse.min_degree(a)
    np.testing.assert_array_equal(p, rsparse.min_degree(a))
    b = tsparse.permute_symmetric(a, p)
    assert (b != rsparse.permute_symmetric(a, p)).nnz == 0


@pytest.mark.parametrize("g,relax", [(9, 0), (15, 1), (20, 2)])
def test_analyze_matches(g, relax):
    ap = _grid_nd(g)
    ts, rs = tsparse.analyze(ap, relax=relax), rsparse.analyze(ap, relax=relax)
    assert ts.n == rs.n and ts.n_supernodes == rs.n_supernodes
    for a, b in zip(ts.supernodes, rs.supernodes):
        np.testing.assert_array_equal(a.cols, b.cols)
        np.testing.assert_array_equal(a.rows, b.rows)
        assert (a.parent, a.m, a.nb, a.flops) == (b.parent, b.m, b.nb, b.flops)
    np.testing.assert_array_equal(ts.col_to_sn, rs.col_to_sn)
    np.testing.assert_array_equal(ts.parent_col, rs.parent_col)
    _same(ts.task_tree(), rs.task_tree())
    _same(ts.footprints(itemsize=4), rs.footprints(itemsize=4))
    np.testing.assert_array_equal(tsparse.etree(ap), rsparse.etree(ap))
    assert tsparse.partial_factor_flops(300, 140) == rsparse.partial_factor_flops(300, 140)


def test_analyze_random_spd_matches(rng):
    a = rsparse.random_spd(200, 6.0, rng)
    ap = rsparse.permute_symmetric(a, rsparse.min_degree(a))
    ts, rs = tsparse.analyze(ap, relax=2), rsparse.analyze(ap, relax=2)
    for a_, b_ in zip(ts.supernodes, rs.supernodes):
        np.testing.assert_array_equal(a_.rows, b_.rows)
        assert (a_.parent, a_.m, a_.nb, a_.flops) == (b_.parent, b_.m, b_.nb, b_.flops)


@pytest.mark.parametrize("strategy", ["pm", "proportional"])
@pytest.mark.parametrize("devices,alpha", [(8, 0.9), (256, 0.9), (64, 0.75)])
def test_make_plan_matches(devices, alpha, strategy):
    symb = rsparse.analyze(_grid_nd(20), relax=2)
    tree = symb.task_tree()
    tp = tsparse.make_plan(_twin_tree(tree), devices, alpha, strategy=strategy)
    rp = rmake_plan(tree, devices, alpha, strategy=strategy)
    assert len(tp.tasks) == len(rp.tasks)
    for a, b in zip(tp.tasks, rp.tasks):
        assert (a.label, a.start, a.end, a.devices) == (b.label, b.start, b.end, b.devices)
    _same(tp, rp)
    assert [[t.task for t in w] for w in tp.waves()] == [[t.task for t in w] for w in rp.waves()]
    fp = symb.footprints(itemsize=8)
    _same(
        tsparse.plan.plan_memory_timeline(tp, _twin_tree(tree), fp.padded(tree.n)),
        rsparse.plan.plan_memory_timeline(rp, tree, fp.padded(tree.n)),
    )
    t_evt = rp.makespan * 0.4
    _same(
        tsparse.replan_elastic(_twin_tree(tree), tp, t_evt, devices // 2, alpha),
        rsparse.replan_elastic(tree, rp, t_evt, devices // 2, alpha),
    )


def _align_sp_ids() -> None:
    """Start both packages' SP-node id counters at one value past every id
    either has issued.  Ids come from a counter per package and process, so
    earlier tests in the same worker that built more SP trees in one package
    than in the other would give the same tree other ids; aligned, the
    comparison below stays exact, ids included, and ids stay unique."""
    import repro.core.graph as rgraph
    import repro_torch.core.graph as tgraph

    start = max(next(rgraph._fresh_id), next(tgraph._fresh_id))
    rgraph._fresh_id = itertools.count(start)
    tgraph._fresh_id = itertools.count(start)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_core_functions_match_on_random_trees(seed):
    _align_sp_ids()
    tree = random_assembly_tree(60, np.random.default_rng(seed))
    tt = _twin_tree(tree)
    alpha, p = 0.85, 16.0
    for name in ("tree_equivalent_lengths", "tree_pm_ratios", "tree_pm_windows"):
        _same(getattr(tcore, name)(tt, alpha), getattr(rcore, name)(tree, alpha), name)
    _same(tcore.subtree_weights(tt), rcore.subtree_weights(tree))
    _same(tcore.proportional_shares(tt, p), rcore.proportional_shares(tree, p))
    assert tcore.proportional_makespan(tt, alpha, p) == rcore.proportional_makespan(tree, alpha, p)
    assert tcore.divisible_makespan(tt, alpha, tcore.Profile.constant(p)) == (
        rcore.divisible_makespan(tree, alpha, rcore.Profile.constant(p))
    )
    ratios = rcore.tree_pm_ratios(tree, alpha)
    for total, enforce in ((8, False), (1024, True)):
        _same(
            tcore.discretize_shares_pow2(ratios, total, enforce_total=enforce),
            rcore.discretize_shares_pow2(ratios, total, enforce_total=enforce),
        )
    _same(tcore.k_node_greedy(tt, alpha, p, 3), rcore.k_node_greedy(tree, alpha, p, 3))
    assert tcore.k_node_lower_bound(tt, alpha, p, 3) == rcore.k_node_lower_bound(tree, alpha, p, 3)
    _same(
        tcore.from_pm(tt, alpha, tcore.Profile.constant(p)),
        rcore.from_pm(tree, alpha, rcore.Profile.constant(p)),
    )
    _same(tcore.pm_schedule(tt.to_sp(), alpha), rpm.pm_schedule(tree.to_sp(), alpha))
    m = np.arange(tree.n) % 7 + 3
    nb = np.minimum(m, np.arange(tree.n) % 3 + 1)
    tfp, rfp = tcore.footprints_from_fronts(m, nb, 8), rmem.footprints_from_fronts(m, nb, 8)
    _same(tfp, rfp)
    assert tcore.sequential_peak(tt, tfp) == rmem.sequential_peak(tree, rfp)
    assert tcore.pm_peak(tt, alpha, tfp) == rmem.pm_peak(tree, alpha, rfp)


def test_device_groups_match():
    req = {0: 4, 1: 2, 2: 2, 3: 1, 4: 8}
    for ndev in (4, 8, 16):
        _same(tdg.assign_wave_groups(req, ndev), rdg.assign_wave_groups(req, ndev))
        assert [tdg.scale_group(g, 64, ndev) for g in (1, 4, 64)] == [
            rdg.scale_group(g, 64, ndev) for g in (1, 4, 64)
        ]
    ta, ra = tdg.BuddyAllocator(8), rdg.BuddyAllocator(8)
    tg = [ta.alloc(s) for s in (4, 2, 3, 1)]
    rg = [ra.alloc(s) for s in (4, 2, 3, 1)]
    _same(tg, rg)
    ta.free(tg[1])
    ra.free(rg[1])
    assert (ta.n_free, ta.fragmentation) == (ra.n_free, ra.fragmentation)


# ----------------------------------------------------------------------
# Ports: the multifrontal factorization
# ----------------------------------------------------------------------
def test_multifrontal_with_kernel():
    """Twin of test_multifrontal_with_pallas_kernel (f32, as the reference
    runs it without x64), then the same factorization panel by panel
    against the reference's."""
    from repro.kernels.ops import factor_fn as jfactor_fn
    from repro_torch.kernels.ops import factor_fn

    ap = _grid_nd(13)
    symb = tsparse.analyze(ap, relax=2)
    fact = tsparse.factorize(ap, symb, factor_fn=factor_fn(), device="cpu")
    l = fact.to_dense_l()
    assert np.abs(l @ l.T - ap.toarray()).max() < 5e-4
    ref = rsparse.factorize(ap, rsparse.analyze(ap, relax=2), factor_fn=jfactor_fn())
    for a, b in zip(fact.panels, ref.panels):
        assert a.dtype == np.float32 and b.dtype == np.float32
        assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < 5e-5


@pytest.mark.parametrize("relax", [0, 2])
def test_factorize_oracle_matches_reference_f64(relax):
    ap = _grid_nd(11)
    symb = tsparse.analyze(ap, relax=relax)
    fact = tsparse.factorize(ap, symb, dtype=torch.float64, device="cpu")  # torch.linalg oracle
    jax.config.update("jax_enable_x64", True)
    try:
        ref = rsparse.factorize(ap, rsparse.analyze(ap, relax=relax))
    finally:
        jax.config.update("jax_enable_x64", False)
    for a, b in zip(fact.panels, ref.panels):
        assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < 1e-12
    l = fact.to_dense_l()
    assert np.abs(l @ l.T - ap.toarray()).max() < 1e-10
    b = np.arange(symb.n, dtype=float)
    x = tsparse.solve(fact, b)
    assert np.abs(ap @ x - b).max() < 1e-8


def test_factorize_device_and_dtype_defaults(monkeypatch):
    """Like PlanExecutor: the card unless the caller asks for the CPU, and
    float32 unless the caller asks for float64."""
    ap = _grid_nd(5)
    symb = tsparse.analyze(ap, relax=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsparse.factorize(ap, symb)
    fact = tsparse.factorize(ap, symb, device="cpu")
    assert all(p.dtype == np.float32 for p in fact.panels)


def test_frontal_helpers_match():
    rng = np.random.default_rng(3)
    block = rng.normal(size=(6, 6))
    block = block + block.T
    idx = np.array([1, 3, 4])
    upd = rng.normal(size=(3, 3))
    got = tsparse.assemble_front(6, block, [(idx, upd)]).numpy()
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(rsparse.assemble_front(6, block, [(idx, upd)]))
        spd = block @ block.T + 6 * np.eye(6)
        np.testing.assert_allclose(
            tsparse.full_cholesky_ref(spd), rsparse.full_cholesky_ref(spd), rtol=1e-13, atol=1e-13
        )
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_array_equal(got, want)
    a = sp.csr_matrix(block @ block.T + 6 * np.eye(6))
    symb = rsparse.analyze(a)
    sn = symb.supernodes[-1]
    np.testing.assert_array_equal(
        tsparse.gather_front_entries(tsparse.lower_csc(a), sn),
        rsparse.gather_front_entries(rsparse.lower_csc(a), sn),
    )
