"""The port's memory model (``repro_torch.core.memory``: resident-bytes
timelines, Liu's traversal, the budget-bounded PM schedule): the twin of
``tests/test_memory.py``.  Every case runs on both packages with the same
seeded inputs; the port's numbers equal the reference's exactly, and the
reference test's invariants hold for them."""
import math

import numpy as np
import pytest

import repro.core.memory as rmem
import repro.core.trees as rtrees
from repro.core.graph import TaskTree as RTaskTree
from repro.core.pm import tree_equivalent_lengths as r_tree_equivalent_lengths
from repro_torch.core.graph import TaskTree
from repro_torch.core.memory import (
    Footprints,
    MemoryTimeline,
    footprints_from_fronts,
    memory_timeline,
    pm_bounded_schedule,
    pm_peak,
    sequential_peak,
    sequential_traversal,
    zero_footprints,
)
from repro_torch.core.pm import tree_equivalent_lengths
from repro_torch.core.profiles import Profile
from repro_torch.core.trees import random_assembly_tree

ALPHA = 0.9


def _trees(n, seed):
    return (random_assembly_tree(n, np.random.default_rng(seed)),
            rtrees.random_assembly_tree(n, np.random.default_rng(seed)))


def _footprints(n, rng):
    """(port, reference) footprints of the same draw."""
    front = rng.uniform(4.0, 40.0, n)
    nbfrac = rng.uniform(0.2, 0.9, n)
    factor = front * nbfrac * 0.5
    cb = front * (1 - nbfrac) ** 2
    return Footprints(front, factor, cb), rmem.Footprints(front, factor, cb)


def _same_timeline(a, b):
    assert a.peak == b.peak and a.steps == b.steps and a.node_peaks == b.node_peaks
    assert a.budget == b.budget
    assert a.to_dict() == b.to_dict()


def _spans(es, n):
    return {i: (es.start_time(i), es.completion_time(i)) for i in range(n) if es.pieces.get(i)}


# ----------------------------------------------------------------------
# Timeline semantics
# ----------------------------------------------------------------------
def test_timeline_hand_example():
    parent = np.array([-1, 0, 0])
    args = (np.array([10.0, 4.0, 6.0]), np.array([3.0, 1.0, 2.0]), np.array([0.0, 2.0, 3.0]))
    spans = {1: (0.0, 1.0), 2: (0.0, 2.0), 0: (2.0, 3.0)}
    tl = memory_timeline(TaskTree(parent=parent, lengths=np.ones(3)).parent, spans,
                         Footprints(*args))
    _same_timeline(tl, rmem.memory_timeline(RTaskTree(parent=parent, lengths=np.ones(3)).parent,
                                            spans, rmem.Footprints(*args)))
    assert [tl.usage_at(x) for x in (0.5, 1.5, 2.5, 3.5)] == [10.0, 9.0, 13.0, 6.0]
    assert tl.peak == 18.0 and tl.node_peaks == {0: 18.0}


@pytest.mark.parametrize("seed", [0, 1])
def test_timeline_invariant_under_reparameterization(seed):
    rng = np.random.default_rng(seed)
    tt, rt = _trees(40, seed)
    fp, rfp = _footprints(tt.n, rng)
    spans = {int(x): (float(k), float(k + 1)) for k, x in enumerate(tt.topo_order())}
    warped = {x: (math.sqrt(1 + a) - 1, math.sqrt(1 + b) - 1) for x, (a, b) in spans.items()}
    a = memory_timeline(tt.parent, spans, fp)
    b = memory_timeline(tt.parent, warped, fp)
    _same_timeline(a, rmem.memory_timeline(rt.parent, spans, rfp))
    _same_timeline(b, rmem.memory_timeline(rt.parent, warped, rfp))
    assert a.peak == pytest.approx(b.peak, rel=1e-12)


def test_empty_and_zero_footprints():
    tt, rt = _trees(10, 0)
    assert memory_timeline(tt.parent, {}, zero_footprints(tt.n)).peak == 0.0
    spans = {i: (0.0, 1.0) for i in range(tt.n)}
    tl = memory_timeline(tt.parent, spans, zero_footprints(tt.n))
    _same_timeline(tl, rmem.memory_timeline(rt.parent, spans, rmem.zero_footprints(rt.n)))
    assert tl.peak == 0.0


def test_footprints_helpers():
    fp = footprints_from_fronts([4, 10], [4, 3], itemsize=8)
    ref = rmem.footprints_from_fronts([4, 10], [4, 3], itemsize=8)
    for f in ("front_bytes", "factor_bytes", "cb_bytes"):
        np.testing.assert_array_equal(getattr(fp, f), getattr(ref, f))
    assert fp.front_bytes.tolist() == [128.0, 800.0]
    assert fp.factor_bytes.tolist() == [128.0, 240.0]
    assert fp.cb_bytes.tolist() == [0.0, 392.0]
    assert fp.padded(3).n == 3 and fp.padded(3).front_bytes[2] == 0.0
    assert fp.take([1]).front_bytes.tolist() == [800.0]
    with pytest.raises(ValueError):
        fp.padded(1)
    with pytest.raises(ValueError):
        Footprints(np.array([1.0]), np.array([-1.0]), np.array([0.0]))


# ----------------------------------------------------------------------
# Liu's sequential traversal
# ----------------------------------------------------------------------
def _postorder_spans(tree, child_order):
    order, stack = [], [(tree.root, False)]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            order.append(node)
        else:
            stack.append((node, True))
            for c in reversed(child_order[node]):
                stack.append((c, False))
    return {int(x): (float(k), float(k + 1)) for k, x in enumerate(order)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_liu_traversal_matches_its_own_timeline(seed):
    rng = np.random.default_rng(seed)
    for _ in range(3):
        n = int(rng.integers(10, 80))
        tt, rt = _trees(n, int(rng.integers(1 << 30)))
        fp, rfp = _footprints(tt.n, rng)
        seq, rseq = sequential_traversal(tt, fp), rmem.sequential_traversal(rt, rfp)
        assert seq.child_order == rseq.child_order
        assert seq.min_peak(tt.root) == rseq.min_peak(rt.root)
        tl = memory_timeline(tt.parent, _postorder_spans(tt, seq.child_order), fp)
        assert tl.peak == pytest.approx(seq.min_peak(tt.root), rel=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_liu_order_beats_random_postorders(seed):
    rng = np.random.default_rng(seed)
    tt, rt = _trees(30, seed)
    fp, rfp = _footprints(tt.n, rng)
    best = sequential_peak(tt, fp)
    assert best == rmem.sequential_peak(rt, rfp)
    ch = tt.children_lists()
    for _ in range(20):
        order = {i: list(ch[i]) for i in range(tt.n)}
        for kids in order.values():
            rng.shuffle(kids)
        tl = memory_timeline(tt.parent, _postorder_spans(tt, order), fp)
        assert tl.peak >= best * (1 - 1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pm_peak_at_least_sequential_min(seed):
    rng = np.random.default_rng(seed)
    tt, rt = _trees(int(rng.integers(10, 120)), seed)
    fp, rfp = _footprints(tt.n, rng)
    assert pm_peak(tt, ALPHA, fp) == rmem.pm_peak(rt, ALPHA, rfp)
    assert pm_peak(tt, ALPHA, fp) >= sequential_peak(tt, fp) * (1 - 1e-9)


# ----------------------------------------------------------------------
# Budget-bounded PM
# ----------------------------------------------------------------------
def test_pm_bounded_budget_sweep():
    rng = np.random.default_rng(0)
    tt, rt = _trees(60, 0)
    fp, rfp = _footprints(tt.n, rng)
    p = 16.0
    lo = sequential_peak(tt, fp)
    hi = max(pm_peak(tt, ALPHA, fp), lo * 1.01)
    prev = None
    for frac in (1.0, 0.7, 0.4, 0.1, 0.0):
        budget = lo + frac * (hi - lo)
        es, info = pm_bounded_schedule(tt, ALPHA, p, fp, budget)
        res, rinfo = rmem.pm_bounded_schedule(rt, ALPHA, p, rfp, budget)
        assert es.makespan() == res.makespan() and info == rinfo
        assert _spans(es, tt.n) == _spans(res, rt.n)
        es.validate(tt, Profile.constant(p))
        tl = memory_timeline(tt.parent, _spans(es, tt.n), fp)
        assert tl.peak <= budget * (1 + 1e-9)
        if prev is not None:
            assert es.makespan() >= prev * (1 - 1e-9)
        prev = es.makespan()
    es, info = pm_bounded_schedule(tt, ALPHA, p, fp, math.inf)
    fluid = tree_equivalent_lengths(tt, ALPHA)[tt.root] / p**ALPHA
    assert fluid == r_tree_equivalent_lengths(rt, ALPHA)[rt.root] / p**ALPHA
    assert es.makespan() == pytest.approx(fluid, rel=1e-12) and info["segments"] == 1


def test_pm_bounded_respects_budget_with_heavy_outputs():
    rng = np.random.default_rng(1)
    for k in range(3):
        tt, rt = _trees(40, k)
        n = tt.n
        args = (np.full(n, 1.0), rng.uniform(5.0, 15.0, n), rng.uniform(0.0, 3.0, n))
        fp, rfp = Footprints(*args), rmem.Footprints(*args)
        lo = sequential_peak(tt, fp)
        assert lo == rmem.sequential_peak(rt, rfp) and lo >= fp.total_factor()
        for frac in (1.0, 0.3, 0.0):
            budget = lo + frac * (max(pm_peak(tt, ALPHA, fp), lo * 1.01) - lo)
            es, _ = pm_bounded_schedule(tt, ALPHA, 8.0, fp, budget)
            res, _ = rmem.pm_bounded_schedule(rt, ALPHA, 8.0, rfp, budget)
            assert _spans(es, n) == _spans(res, n)
            assert memory_timeline(tt.parent, _spans(es, n), fp).peak <= budget * (1 + 1e-9)


def test_pm_bounded_infeasible_budget_raises():
    rng = np.random.default_rng(2)
    tt, rt = _trees(25, 2)
    fp, rfp = _footprints(tt.n, rng)
    with pytest.raises(ValueError):
        pm_bounded_schedule(tt, ALPHA, 8.0, fp, 0.5 * sequential_peak(tt, fp))
    with pytest.raises(ValueError):
        rmem.pm_bounded_schedule(rt, ALPHA, 8.0, rfp, 0.5 * rmem.sequential_peak(rt, rfp))


def test_timeline_json_roundtrip():
    rng = np.random.default_rng(3)
    tt, rt = _trees(20, 3)
    fp, rfp = _footprints(tt.n, rng)
    spans = {int(x): (float(k), float(k + 1)) for k, x in enumerate(tt.topo_order())}
    tl = memory_timeline(tt.parent, spans, fp, budget=123.0)
    assert tl.to_dict() == rmem.memory_timeline(rt.parent, spans, rfp, budget=123.0).to_dict()
    back = MemoryTimeline.from_dict(tl.to_dict())
    assert back.peak == tl.peak and back.budget == 123.0
    assert back.steps == tl.steps and back.node_peaks == tl.node_peaks
    # the reference reads the port's JSON the same
    assert rmem.MemoryTimeline.from_dict(tl.to_dict()).to_dict() == back.to_dict()
    assert MemoryTimeline.from_dict(memory_timeline(tt.parent, spans, fp).to_dict()).budget \
        == math.inf
