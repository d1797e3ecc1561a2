"""Beyond-paper extensions: k ≥ 2 nodes and mesh discretization.

The paper proves hardness at k = 2 and leaves k > 2 open (§8 perspectives).
For the TPU runtime we need (a) a k-node partitioner with the same structure
as Lemma 10's greedy, and (b) a *discretizer* that turns PM's fractional
shares into power-of-two device groups on a mesh — the analogue of the §7
"at least one processor" aggregation, quantified in the benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .graph import TaskTree
from .pm import tree_equivalent_lengths, tree_pm_ratios


# ----------------------------------------------------------------------
# k homogeneous nodes: greedy share-packing generalization of Lemma 10.
# ----------------------------------------------------------------------
@dataclass
class MultiNodeResult:
    makespan: float
    placement: Dict[int, int] = field(default_factory=dict)
    node_eq: List[float] = field(default_factory=list)  # per-node 𝓛 of its set


def k_node_greedy(
    tree: TaskTree, alpha: float, p: float, k: int
) -> MultiNodeResult:
    """Partition the root's children subtrees over k nodes of p processors.

    PM shares are computed on k·p processors; subtrees are packed
    largest-share-first into the least-loaded node (LPT on the x = 𝓛^{1/α}
    scale, which is the additive scale of the problem); each node then runs
    its set with a PM schedule on p processors.  Subtrees whose PM share
    exceeds p are capped at p (they dominate the makespan like the paper's
    x ≥ 1 case).  The root chain (Lemma 9) runs last on one node.
    """
    eq = tree_equivalent_lengths(tree, alpha)
    ch = tree.children_lists()
    inv = 1.0 / alpha

    chain: List[int] = []
    r = tree.root
    while len(ch[r]) == 1:
        chain.append(r)
        r = ch[r][0]
    if len(ch[r]) == 0:
        res = MultiNodeResult(makespan=float(tree.lengths.sum()) / p**alpha)
        for i in range(tree.n):
            if tree.labels[i] >= 0:
                res.placement[int(tree.labels[i])] = 0
        return res
    chain_time = (
        float(sum(tree.lengths[c] for c in chain)) + float(tree.lengths[r])
    ) / p**alpha

    kids = sorted(ch[r], key=lambda c: -eq[c])
    loads = np.zeros(k)  # on the x-scale: Σ 𝓛^{1/α}
    assign: List[List[int]] = [[] for _ in range(k)]
    for c in kids:
        b = int(np.argmin(loads))
        assign[b].append(c)
        loads[b] += eq[c] ** inv

    node_eq = [float(l**alpha) for l in loads]
    makespan = max(node_eq) / p**alpha + chain_time

    res = MultiNodeResult(makespan=makespan, node_eq=node_eq)
    stack: List[Tuple[int, int]] = []
    for b, subtree_roots in enumerate(assign):
        stack.extend((c, b) for c in subtree_roots)
    while stack:
        i, b = stack.pop()
        if tree.labels[i] >= 0:
            res.placement[int(tree.labels[i])] = b
        stack.extend((c, b) for c in ch[i])
    for c in chain + [r]:
        if tree.labels[c] >= 0:
            res.placement[int(tree.labels[c])] = 0
    return res


def k_node_lower_bound(tree: TaskTree, alpha: float, p: float, k: int) -> float:
    eq = tree_equivalent_lengths(tree, alpha)
    return max(
        eq[tree.root] / (k * p) ** alpha, float(tree.lengths.max()) / p**alpha
    )


# ----------------------------------------------------------------------
# Mesh discretization of PM fractional shares.
# ----------------------------------------------------------------------
def discretize_shares_pow2(
    ratios: Sequence[float],
    total_devices: int,
    min_devices: int = 1,
    enforce_total: bool = True,
) -> np.ndarray:
    """Round fractional PM shares (ratios of the whole mesh) to power-of-two
    device-group sizes.

    ``enforce_total=True`` (independent/concurrent task sets): Σ groups ≤
    total — floor-to-pow2, shrink the least-starved group while
    oversubscribed, then grow the most-starved while capacity remains.

    ``enforce_total=False`` (tree schedules): per-task rounding only —
    tasks run at different times, so capacity is the *list scheduler's*
    constraint, not a static one.  Floor-to-pow2 keeps any concurrent set
    feasible (Σ of floors ≤ Σ ratio·total ≤ total) except for the
    min_devices bump, which the scheduler resolves by queueing (the §7
    aggregation analogue).
    """
    ratios = np.asarray(ratios, dtype=np.float64)
    n = len(ratios)
    groups = np.zeros(n, dtype=np.int64)
    for i, r in enumerate(ratios):
        if r <= 0:
            continue
        want = max(r * total_devices, min_devices)
        g = 1 << int(np.floor(np.log2(want)))
        groups[i] = min(max(g, min_devices), total_devices)
    if not enforce_total:
        return groups
    # shrink if oversubscribed (halve the least-starved largest groups)
    while groups.sum() > total_devices:
        cand = np.argsort(-(groups / np.maximum(ratios * total_devices, 1e-12)))
        hit = next((i for i in cand if groups[i] > min_devices), None)
        if hit is None:
            raise ValueError("cannot fit min_devices per task in the mesh")
        groups[hit] //= 2
    # grow while capacity remains
    while True:
        spare = total_devices - groups.sum()
        starved = np.where(groups > 0, ratios * total_devices / np.maximum(groups, 1), 0)
        order = np.argsort(-starved)
        grew = False
        for i in order:
            if groups[i] > 0 and groups[i] <= spare:
                groups[i] *= 2
                grew = True
                break
        if not grew:
            return groups


def discretization_overhead(
    tree: TaskTree, alpha: float, total_devices: int
) -> Tuple[float, float]:
    """(fluid_makespan, discretized_makespan) of the root's children waves.

    Fluid = PM optimal on ``total_devices``.  Discretized = each task runs on
    its power-of-two group; within a sibling group tasks still finish at
    different times, so we take the per-wave max — an upper bound on the real
    discretized runtime, matching how the TPU plan executes (wave barriers).
    """
    eq = tree_equivalent_lengths(tree, alpha)
    ratios = tree_pm_ratios(tree, alpha)
    fluid = eq[tree.root] / total_devices**alpha

    # waves = levels of the tree (children before parents); each task runs on
    # its discretized group; wave time = max task time in the wave.
    depth = np.zeros(tree.n, dtype=np.int64)
    order = tree.topo_order()[::-1]
    for i in order:
        p_ = tree.parent[i]
        depth[i] = depth[p_] + 1 if p_ >= 0 else 0
    groups = discretize_shares_pow2(ratios, total_devices)
    max_d = int(depth.max())
    total = 0.0
    for d in range(max_d, -1, -1):
        sel = np.where(depth == d)[0]
        times = [
            tree.lengths[i] / max(groups[i], 1) ** alpha
            for i in sel
            if tree.lengths[i] > 0
        ]
        if times:
            total += max(times)
    return float(fluid), float(total)
