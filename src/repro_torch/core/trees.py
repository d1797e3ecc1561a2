"""Tree generators for the §7-style simulation campaign.

The paper evaluates on >600 assembly trees of sparse matrices from the
University of Florida collection (2k–1e6 nodes, depth 12–75k).  The
collection is not available offline, so we use two sources with the same
statistics family:

* ``elimination_tree_of_grid`` — *real* assembly trees produced by this
  repo's own symbolic multifrontal analysis of 2D/3D grid Laplacians
  (see repro_torch.sparse); these are the exact object the paper schedules.
* ``random_assembly_tree`` — synthetic trees matching the qualitative shape
  of assembly trees: many small leaves, heavy near-root tasks (task length
  grows with subtree size, like frontal flops ~ (front size)^3), long chains.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .graph import TaskTree


def random_assembly_tree(
    n: int,
    rng: np.random.Generator,
    chain_fraction: float = 0.3,
    length_exponent: float = 1.5,
) -> TaskTree:
    """Random in-tree with assembly-tree-like length distribution.

    Construction: nodes 0..n-1; node i attaches to a random earlier node,
    biased toward recent nodes to create chains (probability
    ``chain_fraction`` of attaching to i-1).  Task lengths grow with the
    number of descendants^``length_exponent`` — mimicking frontal
    factorization flops that grow polynomially with front order — times a
    lognormal jitter.
    """
    if n < 1:
        raise ValueError("n >= 1")
    parent = np.full(n, -1, dtype=np.int64)
    # build top-down: node 0 is the root; i >= 1 attaches to some j < i
    for i in range(1, n):
        if rng.random() < chain_fraction:
            parent[i] = i - 1
        else:
            parent[i] = int(rng.integers(0, i))
    # subtree sizes
    size = np.ones(n, dtype=np.int64)
    for i in range(n - 1, 0, -1):
        size[parent[i]] += size[i]
    jitter = rng.lognormal(mean=0.0, sigma=0.5, size=n)
    lengths = (size.astype(np.float64) ** length_exponent) * jitter
    lengths = lengths / lengths.sum() * n  # normalize total work ~ n
    return TaskTree(parent=parent, lengths=lengths)


def balanced_tree(depth: int, arity: int, leaf_length: float = 1.0, inner_growth: float = 2.0) -> TaskTree:
    """Perfect ``arity``-ary tree; task length multiplies by inner_growth per
    level toward the root (roughly nested-dissection-like)."""
    parents = [-1]
    lengths = [leaf_length * inner_growth**depth]
    frontier = [0]
    for d in range(depth):
        new_frontier = []
        for f in frontier:
            for _ in range(arity):
                parents.append(f)
                lengths.append(leaf_length * inner_growth ** (depth - d - 1))
                new_frontier.append(len(parents) - 1)
        frontier = new_frontier
    return TaskTree(parent=np.array(parents), lengths=np.array(lengths))


def chain_tree(n: int, lengths=None) -> TaskTree:
    """Pure chain (series composition) — PM degenerates to whole-machine."""
    parent = np.arange(-1, n - 1, dtype=np.int64)
    if lengths is None:
        lengths = np.ones(n)
    return TaskTree(parent=parent, lengths=np.asarray(lengths, dtype=np.float64))


def star_tree(lengths) -> TaskTree:
    """Zero-length root over independent tasks (the §6 instances as a tree)."""
    lengths = np.asarray(lengths, dtype=np.float64)
    n = len(lengths)
    parent = np.concatenate([[-1], np.zeros(n, dtype=np.int64)])
    return TaskTree(parent=parent, lengths=np.concatenate([[0.0], lengths]))


def quotient_tree(
    tree: TaskTree,
    groups: Sequence[Sequence[int]],
    culled: Sequence[int] = (),
) -> TaskTree:
    """Contract node groups of an in-tree into a quotient :class:`TaskTree`.

    ``groups`` and ``culled`` must partition ``range(tree.n)``.  Every
    edge leaving a group must land in one single other group (so the
    contraction is again a tree — the invariant the amalgamation rewrites
    in ``repro_torch.sparse.optimize`` rely on) and no retained node may hang
    under a culled one.  Quotient lengths are the member sums, so total
    work is conserved up to the culled (zero-length) nodes.  The quotient
    label of group ``g`` is ``g`` when any member carries a non-negative
    label, else ``-1`` (all-virtual groups, e.g. a lone virtual root).
    """
    n = tree.n
    group_of = np.full(n, -2, dtype=np.int64)  # -2 unassigned, -1 culled
    for g, mem in enumerate(groups):
        for m in mem:
            m = int(m)
            if not 0 <= m < n:
                raise ValueError(f"group {g} member {m} outside [0, {n})")
            if group_of[m] != -2:
                raise ValueError(f"node {m} assigned twice")
            group_of[m] = g
    for m in culled:
        m = int(m)
        if group_of[m] != -2:
            raise ValueError(f"culled node {m} also grouped")
        group_of[m] = -1
    if (group_of == -2).any():
        missing = np.flatnonzero(group_of == -2)[:5].tolist()
        raise ValueError(f"groups+culled do not cover the tree: {missing}...")

    ng = len(groups)
    qparent = np.full(ng, -2, dtype=np.int64)
    for g, mem in enumerate(groups):
        if not len(mem):
            raise ValueError(f"group {g} is empty")
        for m in mem:
            p = int(tree.parent[m])
            if p < 0:
                gp = -1
            else:
                gp = int(group_of[p])
                if gp == -1:
                    raise ValueError(
                        f"retained node {m} hangs under culled node {p}"
                    )
                if gp == g:
                    continue  # internal edge
            if qparent[g] not in (-2, gp):
                raise ValueError(
                    f"group {g} has edges into two groups "
                    f"({qparent[g]} and {gp}); contraction is not a tree"
                )
            qparent[g] = gp
    if (qparent == -2).any():
        raise ValueError("a group has no outgoing edge and is not the root")
    # acyclicity: walking parents from any group must reach a root
    depth = np.full(ng, -1, dtype=np.int64)
    for g in range(ng):
        path = []
        cur = g
        while cur >= 0 and depth[cur] < 0:
            path.append(cur)
            cur = int(qparent[cur])
            if len(path) > ng:
                raise ValueError("group contraction created a cycle")
        base = 0 if cur < 0 else int(depth[cur]) + 1
        for k, node in enumerate(reversed(path)):
            depth[node] = base + k

    qlengths = np.array(
        [float(tree.lengths[list(mem)].sum()) for mem in groups]
    )
    qlabels = np.array(
        [
            g if any(int(tree.labels[m]) >= 0 for m in mem) else -1
            for g, mem in enumerate(groups)
        ],
        dtype=np.int64,
    )
    return TaskTree(parent=qparent, lengths=qlengths, labels=qlabels)
