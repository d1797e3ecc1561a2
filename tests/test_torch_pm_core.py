"""The port's scheduling theory (``repro_torch.core``: §4–§5 equivalent
lengths, the PM schedule, baselines, aggregation): the twin of
``tests/test_pm_core.py``.  Every case runs on both packages with the same
seeded or hypothesis-drawn inputs; the port's numbers equal the
reference's exactly, and the reference test's invariants hold for them."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis")  # property tests need it; skip if absent
from hypothesis import given, strategies as st

import repro.core as r
import repro_torch.core as t
from repro.core.baselines import subtree_weights as r_subtree_weights
from repro_torch.core.baselines import subtree_weights

alphas = st.floats(min_value=0.55, max_value=0.98)


@st.composite
def small_trees(draw, max_n=40):
    """(port tree, reference tree): one random tree in both packages."""
    n = draw(st.integers(min_value=1, max_value=max_n))
    seed = draw(st.integers(min_value=0, max_value=2**31))
    rng = np.random.default_rng(seed)
    parent = np.full(n, -1, dtype=np.int64)
    for i in range(1, n):
        parent[i] = int(rng.integers(0, i))
    lengths = rng.uniform(0.1, 10.0, size=n)
    return (t.TaskTree(parent=parent.copy(), lengths=lengths.copy()),
            r.TaskTree(parent=parent, lengths=lengths))


def _same_schedule(a, b):
    """Two packages' schedules: the same pieces, bit for bit."""
    assert a.makespan() == b.makespan()
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            assert all(repr(x[k]) == repr(y[k]) for k in x), f.name
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------------
# Definition 1 algebra
# ----------------------------------------------------------------------
@given(alphas, st.floats(0.1, 50), st.floats(0.1, 50))
def test_parallel_composition_formula(alpha, l1, l2):
    got = t.equivalent_length(t.parallel(t.task(l1), t.task(l2)), alpha)
    assert got == r.equivalent_length(r.parallel(r.task(l1), r.task(l2)), alpha)
    assert got == pytest.approx((l1 ** (1 / alpha) + l2 ** (1 / alpha)) ** alpha, rel=1e-9)


@given(alphas, st.floats(0.1, 50), st.floats(0.1, 50))
def test_series_additivity(alpha, l1, l2):
    got = t.equivalent_length(t.series(t.task(l1), t.task(l2)), alpha)
    assert got == r.equivalent_length(r.series(r.task(l1), r.task(l2)), alpha)
    assert got == pytest.approx(l1 + l2, rel=1e-12)


@given(alphas, st.floats(0.1, 20), st.floats(0.1, 20), st.floats(0.1, 20))
def test_parallel_associative(alpha, a, b, c):
    for pk in (t, r):
        x = pk.equivalent_length(pk.parallel(pk.parallel(pk.task(a), pk.task(b)), pk.task(c)),
                                 alpha)
        y = pk.equivalent_length(pk.parallel(pk.task(a), pk.parallel(pk.task(b), pk.task(c))),
                                 alpha)
        assert x == pytest.approx(y, rel=1e-9)
    assert t.equivalent_length(t.parallel(t.task(a), t.task(b), t.task(c)), alpha) == \
        r.equivalent_length(r.parallel(r.task(a), r.task(b), r.task(c)), alpha)


@given(alphas, st.floats(0.1, 20), st.floats(0.1, 20))
def test_parallel_bounds(alpha, a, b):
    got = t.equivalent_length(t.parallel(t.task(a), t.task(b)), alpha)
    assert got == r.equivalent_length(r.parallel(r.task(a), r.task(b)), alpha)
    assert max(a, b) - 1e-9 <= got <= a + b + 1e-9


# ----------------------------------------------------------------------
# Theorem 6, Lemma 4
# ----------------------------------------------------------------------
@given(small_trees(), alphas, st.floats(2.0, 100.0))
def test_pm_schedule_valid_and_optimal_makespan(trees, alpha, p):
    tt, rt = trees
    prof = t.Profile.constant(p)
    sched = t.from_pm(tt, alpha, prof)
    sched.validate(tt, prof)
    _same_schedule(sched, r.from_pm(rt, alpha, r.Profile.constant(p)))
    eq = t.tree_equivalent_lengths(tt, alpha)
    np.testing.assert_array_equal(eq, r.tree_equivalent_lengths(rt, alpha))
    assert sched.makespan() == pytest.approx(eq[tt.root] / p**alpha, rel=1e-9)


@given(small_trees(max_n=20), alphas)
def test_siblings_finish_simultaneously(trees, alpha):
    tt, rt = trees
    w_start, w_end, ratio = t.tree_pm_windows(tt, alpha)
    for x, y in zip((w_start, w_end, ratio), r.tree_pm_windows(rt, alpha)):
        np.testing.assert_array_equal(x, y)
    for kids in tt.children_lists():
        if len(kids) >= 2:
            ends = [w_end[c] for c in kids]
            assert max(ends) - min(ends) < 1e-9 * max(1.0, max(ends))


@given(small_trees(max_n=25), alphas, st.integers(0, 2**31))
def test_pm_beats_random_constant_share_schedules(trees, alpha, seed):
    tt, rt = trees
    p = 16.0
    m_pm = t.tree_equivalent_lengths(tt, alpha)[tt.root] / p**alpha
    w = np.random.default_rng(seed).uniform(0.1, 1.0, size=tt.n)
    sub = subtree_weights(tt) * w
    np.testing.assert_array_equal(sub, r_subtree_weights(rt) * w)
    ch = tt.children_lists()
    share = np.zeros(tt.n)
    share[tt.root] = p
    for i in tt.topo_order()[::-1]:
        kids = ch[i]
        if kids:
            denom = sum(sub[c] for c in kids)
            for c in kids:
                share[c] = share[i] * sub[c] / denom
    sched = t.simulate_constant_shares(tt, share, t.Profile.constant(p), alpha)
    sched.validate(tt, t.Profile.constant(p))
    _same_schedule(sched, r.simulate_constant_shares(rt, share, r.Profile.constant(p), alpha))
    assert sched.makespan() >= m_pm - 1e-9 * m_pm


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pm_under_step_profile_elastic(seed):
    tt = t.random_assembly_tree(100, np.random.default_rng(seed))
    rt = r.random_assembly_tree(100, np.random.default_rng(seed))
    steps = [(0.5, 40.0), (1.0, 24.0), (np.inf, 40.0)]
    prof = t.Profile.of(steps)
    sched = t.from_pm(tt, 0.9, prof)
    sched.validate(tt, prof)
    _same_schedule(sched, r.from_pm(rt, 0.9, r.Profile.of(steps)))
    eq = t.tree_equivalent_lengths(tt, 0.9)
    assert sched.makespan() == pytest.approx(prof.time_for_work(eq[tt.root], 0.9), rel=1e-9)


def test_profile_work_inversion_roundtrip():
    steps = [(1.0, 10.0), (2.0, 4.0), (np.inf, 8.0)]
    prof, ref = t.Profile.of(steps), r.Profile.of(steps)
    for alpha in (0.6, 0.85, 1.0):
        for x in (0.1, 0.9, 1.5, 3.5, 10.0):
            w = prof.work_until(x, alpha)
            assert w == ref.work_until(x, alpha)
            assert prof.time_for_work(w, alpha) == ref.time_for_work(w, alpha)
            assert prof.time_for_work(w, alpha) == pytest.approx(x, rel=1e-9)


# ----------------------------------------------------------------------
# §7 baselines + aggregation
# ----------------------------------------------------------------------
@given(small_trees(max_n=30), alphas)
def test_strategy_ordering(trees, alpha):
    tt, rt = trees
    got = t.strategies_comparison(tt, alpha, 40.0)
    assert tuple(got) == tuple(r.strategies_comparison(rt, alpha, 40.0))
    m_pm, m_prop, m_div = got
    assert m_pm <= m_prop + 1e-9 * m_prop
    assert m_pm <= m_div + 1e-9 * m_div


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_proportional_simulation_matches_recursion(seed):
    tt = t.random_assembly_tree(120, np.random.default_rng(seed))
    rt = r.random_assembly_tree(120, np.random.default_rng(seed))
    m = t.proportional_makespan(tt, 0.8, 40.0)
    assert m == r.proportional_makespan(rt, 0.8, 40.0)
    sched = t.proportional_schedule(tt, 0.8, 40.0)
    _same_schedule(sched, r.proportional_schedule(rt, 0.8, 40.0))
    assert sched.makespan() == pytest.approx(m, rel=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_divisible_is_total_work(seed):
    tt = t.random_assembly_tree(50, np.random.default_rng(seed))
    rt = r.random_assembly_tree(50, np.random.default_rng(seed))
    got = t.divisible_makespan(tt, 0.9, t.Profile.constant(10.0))
    assert got == r.divisible_makespan(rt, 0.9, r.Profile.constant(10.0))
    assert got == pytest.approx(tt.lengths.sum() / 10.0**0.9)


@given(small_trees(max_n=30), alphas)
def test_aggregation_invariants(trees, alpha):
    tt, rt = trees
    p = 40.0
    sp, rsp = tt.to_sp(), rt.to_sp()
    ag, rag = t.aggregate(sp, alpha, p), r.aggregate(rsp, alpha, p)
    assert t.min_task_share(ag, alpha, p) == r.min_task_share(rag, alpha, p)
    assert t.min_task_share(ag, alpha, p) >= 1.0 - 1e-9
    assert ag.total_length() == rag.total_length()
    assert ag.total_length() == pytest.approx(sp.total_length(), rel=1e-9)
    assert t.pm_makespan_constant_p(ag, alpha, p) == r.pm_makespan_constant_p(rag, alpha, p)
    assert t.pm_makespan_constant_p(ag, alpha, p) >= t.pm_makespan_constant_p(sp, alpha, p) - 1e-9


def test_pm_schedule_sp_graph_ratios():
    """Flow conservation (Lemma 4), both packages the same numbers."""
    alpha = 0.8
    out = []
    for pk in (t, r):
        g = pk.series(pk.parallel(pk.task(3.0, label=0), pk.task(5.0, label=1)),
                      pk.task(2.0, label=2))
        sched = pk.pm_schedule(g, alpha)
        out.append({iv.label: (iv.ratio, iv.w_start, iv.w_end) for iv in sched.intervals})
    assert out[0] == out[1]
    ratios = {k: v[0] for k, v in out[0].items()}
    assert ratios[2] == pytest.approx(1.0)
    l3, l5 = 3 ** (1 / alpha), 5 ** (1 / alpha)
    assert ratios[0] == pytest.approx(l3 / (l3 + l5), rel=1e-9)
    assert ratios[1] == pytest.approx(l5 / (l3 + l5), rel=1e-9)
    assert out[0][0][2] == pytest.approx(out[0][1][2], rel=1e-12)
