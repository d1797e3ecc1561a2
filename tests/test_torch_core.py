"""The scheduling-theory copies added to the port (``core.{two_node,
hetero,subset_sum,trees,aggregate}``, ``online.events``): exact equality
with the reference on seeded random inputs."""
import numpy as np
import pytest

import repro.core as rcore
import repro.core.hetero as rhetero
import repro.core.trees as rtrees
import repro.online.events as revents
import repro_torch.core as tcore
import repro_torch.core.hetero as thetero
import repro_torch.core.trees as ttrees
import repro_torch.online.events as tevents

from test_torch_sparse import _same, _twin_tree


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tree_generators_and_quotient_match(seed):
    for n in (1, 2, 17, 80):
        _same(ttrees.random_assembly_tree(n, np.random.default_rng(seed)),
              rtrees.random_assembly_tree(n, np.random.default_rng(seed)))
    _same(ttrees.balanced_tree(3, 3), rtrees.balanced_tree(3, 3))
    _same(ttrees.chain_tree(7), rtrees.chain_tree(7))
    lengths = np.random.default_rng(seed).uniform(0.5, 4.0, 9)
    _same(ttrees.star_tree(lengths), rtrees.star_tree(lengths))
    # quotient by a matching of (child, parent) edges: always a tree
    tree = rtrees.random_assembly_tree(40, np.random.default_rng(seed))
    owner = {}
    for v in range(tree.n):
        p = int(tree.parent[v])
        if v not in owner and p >= 0 and p not in owner:
            owner[v] = owner[p] = v
    groups = {}
    for v in range(tree.n):
        groups.setdefault(owner.get(v, v), []).append(v)
    groups = sorted(groups.values())
    assert len(groups) < tree.n
    _same(ttrees.quotient_tree(_twin_tree(tree), groups), rtrees.quotient_tree(tree, groups))
    culled = [v for v in range(tree.n) if v not in tree.parent and v not in owner][:2]
    kept = [g for g in groups if g[0] not in culled]
    _same(ttrees.quotient_tree(_twin_tree(tree), kept, culled),
          rtrees.quotient_tree(tree, kept, culled))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_node_matches(seed):
    tree = rtrees.random_assembly_tree(50, np.random.default_rng(seed))
    tt = _twin_tree(tree)
    for alpha, p, snap in ((0.9, 16.0, True), (0.7, 5.0, False)):
        _same(tcore.homogeneous_two_node(tt, alpha, p, snap=snap),
              rcore.homogeneous_two_node(tree, alpha, p, snap=snap))
        assert tcore.two_node_lower_bound(tt, alpha, p) == rcore.two_node_lower_bound(tree, alpha, p)
        eq = rcore.tree_equivalent_lengths(tree, alpha)[tree.root]
        for frac in (0.2, 0.5):
            _same(tcore.split_tree(tt, frac * eq, alpha, snap=snap),
                  rcore.split_tree(tree, frac * eq, alpha, snap=snap))
    _same(tcore.subtree_of(tt, int(np.argmax(tree.parent))),
          rcore.subtree_of(tree, int(np.argmax(tree.parent))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hetero_and_subset_sum_match(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.uniform(0.5, 12.0, 14)
    for p, q, alpha, lam in ((24.0, 10.0, 0.9, 1.05), (7.0, 31.0, 0.6, 1.2), (16.0, 16.0, 0.8, 3.0)):
        _same(tcore.hetero_fptas(lengths, p, q, alpha, lam),
              rcore.hetero_fptas(lengths, p, q, alpha, lam))
        _same(tcore.hetero_exact(lengths[:10], p, q, alpha),
              rcore.hetero_exact(lengths[:10], p, q, alpha))
        on_p = list(range(0, 14, 3))
        assert tcore.partition_makespan(lengths, on_p, p, q, alpha) == (
            rcore.partition_makespan(lengths, on_p, p, q, alpha))
    node = (thetero.NodeSpec(24.0, 0.85, 1.0), thetero.NodeSpec(10.0, 0.95, 3.0))
    rnode = (rhetero.NodeSpec(24.0, 0.85, 1.0), rhetero.NodeSpec(10.0, 0.95, 3.0))
    _same(thetero.mixed_hetero_fptas(lengths, *node, lam=1.05),
          rhetero.mixed_hetero_fptas(lengths, *rnode, lam=1.05))
    assert thetero.mixed_lower_bound(lengths, *node) == rhetero.mixed_lower_bound(lengths, *rnode)
    xs = list(rng.uniform(1.0, 50.0, 20))
    target = 0.4 * sum(xs)
    for eps in (0.5, 0.05):
        _same(tcore.subset_sum_fptas(xs, target, eps), rcore.subset_sum_fptas(xs, target, eps))
    _same(tcore.subset_sum_exact(xs[:12], target / 2), rcore.subset_sum_exact(xs[:12], target / 2))


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_matches(seed):
    tree = rtrees.random_assembly_tree(30, np.random.default_rng(seed))
    sp_ref, sp_port = tree.to_sp(), _twin_tree(tree).to_sp()
    for p in (4.0, 64.0):
        assert tcore.min_task_share(sp_port, 0.9, p) == rcore.min_task_share(sp_ref, 0.9, p)
        agg_t = tcore.aggregate(sp_port, 0.9, p)
        agg_r = rcore.aggregate(sp_ref, 0.9, p)
        assert repr(agg_t) == repr(agg_r)
        assert tcore.equivalent_length(agg_t, 0.9) == rcore.equivalent_length(agg_r, 0.9)


def test_online_events_match():
    """The discrete-event core the straggler module and platforms use."""
    tq, rq = tevents.EventQueue(), revents.EventQueue()
    for t, payload in ((2.0, "b"), (1.0, "a"), (2.0, "c"), (0.5, "z")):
        tq.push(t, payload)
        rq.push(t, payload)
    order = []
    while tq:
        e, f = tq.pop(), rq.pop()
        assert (e.time, e.seq, e.payload) == (f.time, f.seq, f.payload)
        order.append(e.payload)
    assert order == ["z", "a", "b", "c"] and not rq
    tp, rp = tevents.ProcessorPool(4), revents.ProcessorPool(4)
    for tev, rev in ((tevents.SetNodeSpeed(1, 0.25), revents.SetNodeSpeed(1, 0.25)),
                     (tevents.SetCapacity(6.0), revents.SetCapacity(6.0))):
        assert tp.capacity() == rp.capacity()
        tp.apply(tev)
        rp.apply(rev)
        np.testing.assert_array_equal(tp.speeds, rp.speeds)
    for cls, kw in (("LognormalNoise", {"sigma": 0.4, "seed": 3}),
                    ("UniformNoise", {"seed": 5}), ("NoNoise", {})):
        nt, nr = getattr(tevents, cls)(**kw), getattr(revents, cls)(**kw)
        assert [nt.factor(0, i) for i in range(6)] == [nr.factor(0, i) for i in range(6)]
