"""The port's Algorithm 11 (``repro_torch.core.two_node``, two homogeneous
nodes, paper §6.1): twins of ``tests/test_two_node.py``.  The module is a
copy, so each twin runs the reference and the port on the same drawn tree
(numpy arrays built once, a ``TaskTree`` of each package around them) and
holds the port's results equal to the reference's exactly — makespans,
placements, bounds and case traces through the ``repr`` of the result,
split trees array for array — besides the reference test's invariants."""
import numpy as np
import pytest

pytest.importorskip("hypothesis")  # property tests need it; skip if absent
from hypothesis import given, strategies as st  # noqa: E402

import repro.core as rcore  # noqa: E402
from repro_torch.core import (  # noqa: E402
    TaskTree,
    hetero_exact,
    homogeneous_two_node,
    split_tree,
    star_tree,
    tree_equivalent_lengths,
    two_node_lower_bound,
)


@st.composite
def trees(draw, max_n=30):
    """(port tree, reference tree) of one random in-tree."""
    n = draw(st.integers(min_value=1, max_value=max_n))
    seed = draw(st.integers(min_value=0, max_value=2**31))
    rng = np.random.default_rng(seed)
    parent = np.full(n, -1, dtype=np.int64)
    for i in range(1, n):
        parent[i] = int(rng.integers(0, i))
    lengths = rng.uniform(0.2, 10.0, size=n)
    return (TaskTree(parent=parent.copy(), lengths=lengths.copy()),
            rcore.TaskTree(parent=parent.copy(), lengths=lengths.copy()))


alphas = st.floats(min_value=0.6, max_value=0.95)


def same_tree(port, ref) -> None:
    assert (port is None) == (ref is None)
    if port is not None:
        for f in ("parent", "lengths", "labels"):
            np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))


@given(trees(), alphas, st.floats(4.0, 64.0))
def test_alg11_basic_invariants(both, alpha, p):
    tree, rtree = both
    res = homogeneous_two_node(tree, alpha, p)
    assert repr(res) == repr(rcore.homogeneous_two_node(rtree, alpha, p))
    lb = two_node_lower_bound(tree, alpha, p)
    assert lb == rcore.two_node_lower_bound(rtree, alpha, p)
    assert res.makespan >= lb - 1e-9 * lb
    placed = set(res.placement)
    assert placed == {int(l) for l in tree.labels if l >= 0}
    assert set(res.placement.values()) <= {0, 1}


@given(trees(), alphas, st.floats(4.0, 64.0))
def test_alg11_fluid_respects_proof_bound(both, alpha, p):
    """The reference's sound empirical invariant (its docstring tells the
    reproduction finding): never above both the (4/3)^α proof bound and
    the single-node PM fallback."""
    tree, rtree = both
    res = homogeneous_two_node(tree, alpha, p, snap=False)
    assert repr(res) == repr(rcore.homogeneous_two_node(rtree, alpha, p, snap=False))
    eq = tree_equivalent_lengths(tree, alpha)[tree.root]
    m_single = eq / p**alpha
    bound = max((4.0 / 3.0) ** alpha * res.m_p_lb, m_single)
    assert res.makespan <= bound * (1 + 1e-9)


@given(
    st.lists(st.floats(0.5, 20.0), min_size=2, max_size=10),
    alphas,
    st.floats(4.0, 32.0),
)
def test_alg11_vs_bruteforce_independent(lengths, alpha, p):
    tree = star_tree(lengths)
    res = homogeneous_two_node(tree, alpha, p)
    assert repr(res) == repr(rcore.homogeneous_two_node(rcore.star_tree(lengths), alpha, p))
    opt, part = hetero_exact(lengths, p, p, alpha)
    assert (opt, part) == rcore.hetero_exact(lengths, p, p, alpha)
    assert res.makespan <= (4.0 / 3.0) ** alpha * opt * (1 + 1e-9)
    assert res.makespan >= opt - 1e-9 * opt


def test_theorem7_partition_instance():
    alpha = 0.8
    a = [3.0, 1.0, 2.0, 2.0, 3.0, 1.0]
    p = sum(a) / 2.0 / 1.0
    lengths = [x**alpha for x in a]
    res = homogeneous_two_node(star_tree(lengths), alpha, p / 1.0)
    assert repr(res) == repr(rcore.homogeneous_two_node(rcore.star_tree(lengths), alpha, p))
    opt, _ = hetero_exact(lengths, p, p, alpha)
    assert opt == pytest.approx((max(6.0, 6.0) / p) ** alpha, rel=1e-9)
    assert res.makespan <= (4.0 / 3.0) ** alpha * opt + 1e-9


def test_chain_tree_single_node():
    parent, lengths = np.array([-1, 0, 1, 2]), np.ones(4)
    res = homogeneous_two_node(TaskTree(parent=parent, lengths=lengths), 0.9, 8.0)
    ref = rcore.homogeneous_two_node(rcore.TaskTree(parent=parent, lengths=lengths), 0.9, 8.0)
    assert repr(res) == repr(ref)
    assert res.makespan == pytest.approx(4.0 / 8.0**0.9)
    assert set(res.placement.values()) == {0}


# ----------------------------------------------------------------------
@given(trees(max_n=20), alphas, st.floats(0.05, 0.95))
def test_split_tree_conserves_equivalent_length_fluid(both, alpha, frac):
    tree, rtree = both
    eq = tree_equivalent_lengths(tree, alpha)[tree.root]
    assert eq == rcore.tree_equivalent_lengths(rtree, alpha)[rtree.root]
    cut = frac * eq
    pre, suf = split_tree(tree, cut, alpha, snap=False)
    rpre, rsuf = rcore.split_tree(rtree, cut, alpha, snap=False)
    same_tree(pre, rpre)
    same_tree(suf, rsuf)
    eq_pre = tree_equivalent_lengths(pre, alpha)[pre.root] if pre else 0.0
    eq_suf = tree_equivalent_lengths(suf, alpha)[suf.root] if suf else 0.0
    assert eq_pre + eq_suf == pytest.approx(eq, rel=1e-6)
    assert eq_suf == pytest.approx(cut, rel=1e-6)


@given(trees(max_n=20), alphas, st.floats(0.05, 0.95))
def test_split_tree_snap_conserves_work(both, alpha, frac):
    tree, rtree = both
    eq = tree_equivalent_lengths(tree, alpha)[tree.root]
    pre, suf = split_tree(tree, frac * eq, alpha, snap=True)
    rpre, rsuf = rcore.split_tree(rtree, frac * eq, alpha, snap=True)
    same_tree(pre, rpre)
    same_tree(suf, rsuf)
    total = tree.lengths.sum()
    w_pre = pre.lengths.sum() if pre else 0.0
    w_suf = suf.lengths.sum() if suf else 0.0
    assert w_pre + w_suf == pytest.approx(total, rel=1e-9)
