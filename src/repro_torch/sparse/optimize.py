"""Tree amalgamation: cull / fuse / merge rewrites over a scheduling Problem.

Real multifrontal codes amalgamate: tiny fronts drown in dispatch
overhead, so production solvers fuse parent–child chains and merge small
sibling fronts into supernode batches, trading extra padding and memory
for fewer, larger tasks — the makespan-vs-peak-memory trade-off
formalized in *Scheduling tree-shaped task graphs to minimize memory and
makespan* (arXiv:1210.2580) and its parallel extension (arXiv:1410.0329).
This module is that optimizer as a plan-level rewrite pass (in the
spirit of dask's ``cull``/``fuse`` graph optimizations):

(a) **chain fusion** — a parent with exactly one child is fused into its
    child's group while every member front stays under ``max_front``;
    the fused group runs as one dispatch (members sequentially, in tree
    order);
(b) **sibling merge** — small leaf groups under one parent are merged
    into supernode batches dispatched as one padded vmapped kernel;
    ``max_fill`` bounds the identity-lane padding bytes a merged
    dispatch may carry;
(c) **cull** — zero-length, zero-footprint leaves are removed.

The rewrites act at the *dispatch* level only: fronts are never merged
numerically.  Each original front still assembles (extend-add in tree
order) and factors at its own padded shape class, so the factors land in
the original index space **bit-identically**; what changes is the task
graph the planner schedules — one fused task per group, with its length
recomputed from the members' frontal flops and its footprint from the
members' ``Supernode`` entries, so PM shares, Lemma-4 equivalent
lengths, and the Schedule memory timeline stay exact on the rewritten
tree.  The :class:`Provenance` map (optimized task → original tasks) is
what ``Schedule.to_execution_plan`` and the executor's extend-add bridge
consume to run a fused plan against the original symbolic structure.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.graph import TaskTree
from repro_torch.core.memory import Footprints, sequential_peak
from repro_torch.core.trees import quotient_tree


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


# ----------------------------------------------------------------------
@dataclass(frozen=True)
class Provenance:
    """Optimized task → original tasks, plus the original tree context.

    ``groups[g]`` lists the *original tree indices* fused into optimized
    task ``g``, in execution order (children before parents within the
    group); ``culled`` lists the removed degenerate tasks.  Together they
    partition ``range(n_original)``.  ``labels``/``parent`` snapshot the
    original tree (labels map tree indices to supernode ids, ``-1`` for
    a virtual root), which is all the executor needs to expand a fused
    plan back onto the original fronts.
    """

    groups: Tuple[Tuple[int, ...], ...]
    culled: Tuple[int, ...]
    n_original: int
    labels: Tuple[int, ...]
    parent: Tuple[int, ...]

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "groups", tuple(tuple(int(m) for m in g) for g in self.groups)
        )
        object.__setattr__(self, "culled", tuple(int(c) for c in self.culled))
        object.__setattr__(self, "labels", tuple(int(x) for x in self.labels))
        object.__setattr__(self, "parent", tuple(int(x) for x in self.parent))

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def group_of(self) -> np.ndarray:
        """Original tree index → optimized task id (-1 for culled)."""
        out = np.full(self.n_original, -1, dtype=np.int64)
        for g, mem in enumerate(self.groups):
            for m in mem:
                out[m] = g
        return out

    def to_dict(self) -> Dict:
        return {
            "groups": [list(g) for g in self.groups],
            "culled": list(self.culled),
            "n_original": self.n_original,
            "labels": list(self.labels),
            "parent": list(self.parent),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "Provenance":
        return cls(
            groups=tuple(tuple(g) for g in d["groups"]),
            culled=tuple(d["culled"]),
            n_original=int(d["n_original"]),
            labels=tuple(d["labels"]),
            parent=tuple(d["parent"]),
        )


# ----------------------------------------------------------------------
# rewrite passes (operating on lists of member groups over the original
# tree; the quotient is only materialized at the end)
# ----------------------------------------------------------------------
def _cull(tree: TaskTree, fp: Optional[Footprints]) -> Set[int]:
    """Iteratively remove zero-length, zero-footprint leaves (never the
    root): the dask ``cull`` pass.  Culling a leaf may expose its parent
    as a new degenerate leaf, so the sweep runs to a fixpoint."""

    def removable(i: int) -> bool:
        if i == tree.root or tree.lengths[i] > 0:
            return False
        if fp is None:
            return True
        return (
            fp.front_bytes[i] == 0
            and fp.factor_bytes[i] == 0
            and fp.cb_bytes[i] == 0
        )

    nch = np.zeros(tree.n, dtype=np.int64)
    for i in range(tree.n):
        p = int(tree.parent[i])
        if p >= 0:
            nch[p] += 1
    stack = [i for i in range(tree.n) if nch[i] == 0 and removable(i)]
    culled: Set[int] = set()
    while stack:
        i = stack.pop()
        culled.add(i)
        p = int(tree.parent[i])
        if p >= 0:
            nch[p] -= 1
            if nch[p] == 0 and removable(p):
                stack.append(p)
    return culled


def _quotient_edges(
    tree: TaskTree, members: List[List[int]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(group_of, qparent, qnchild) of the current grouping."""
    group_of = np.full(tree.n, -1, dtype=np.int64)
    for g, mem in enumerate(members):
        for m in mem:
            group_of[m] = g
    ng = len(members)
    qparent = np.full(ng, -1, dtype=np.int64)
    qnchild = np.zeros(ng, dtype=np.int64)
    for g, mem in enumerate(members):
        seen: Set[int] = set()
        for m in mem:
            p = int(tree.parent[m])
            if p < 0:
                continue
            gp = int(group_of[p])
            if gp != g:
                qparent[g] = gp
                if gp not in seen:
                    # a group is one child of its parent, however many
                    # member edges cross the boundary
                    seen.add(gp)
        if qparent[g] >= 0:
            qnchild[qparent[g]] += 1
    return group_of, qparent, qnchild


def _fuse_chains(
    tree: TaskTree,
    members: List[List[int]],
    node_size: np.ndarray,
    sum_sizes: bool,
    max_front: float,
    max_batch: int,
) -> List[List[int]]:
    """Rewrite (a): fuse linear parent–child chains.

    A parent group with exactly one child group absorbs it when the
    combined group stays under the size threshold (sparse: every member
    front order ≤ ``max_front``; generic trees: summed lengths ≤
    ``max_front``) and under ``max_batch`` members.  Pairs merge per
    round (a chain of k collapses in O(log k) rounds), members keep
    children-before-parents order, so the fused dispatch can run them
    sequentially in tree order.
    """

    def cost(mem: Sequence[int]) -> float:
        vals = node_size[list(mem)]
        return float(vals.sum() if sum_sizes else vals.max())

    def fusable(mem: Sequence[int]) -> bool:
        return all(int(tree.labels[m]) >= 0 for m in mem)

    changed = True
    while changed:
        changed = False
        _, qparent, qnchild = _quotient_edges(tree, members)
        used: Set[int] = set()
        absorb: Dict[int, int] = {}  # parent group -> its only child group
        for g in range(len(members)):
            gp = int(qparent[g])
            if gp < 0 or qnchild[gp] != 1 or g in used or gp in used:
                continue
            if not (fusable(members[g]) and fusable(members[gp])):
                continue
            if len(members[g]) + len(members[gp]) > max_batch:
                continue
            if cost(members[g] + members[gp]) > max_front:
                continue
            absorb[gp] = g
            used.add(g)
            used.add(gp)
        if absorb:
            changed = True
            eaten = set(absorb.values())
            members = [
                (members[absorb[g]] + mem) if g in absorb else mem
                for g, mem in enumerate(members)
                if g not in eaten
            ]
    return members


def _group_levels(
    tree: TaskTree, mem: Sequence[int]
) -> List[List[int]]:
    """In-group dependency levels (level 0 = members with no in-group
    children) — the batching structure of a fused dispatch."""
    pos = {int(m): k for k, m in enumerate(mem)}
    ch: Dict[int, List[int]] = {int(m): [] for m in mem}
    for m in mem:
        p = int(tree.parent[m])
        if p in pos:
            ch[p].append(int(m))
    level: Dict[int, int] = {}
    for m in mem:  # exec order: children precede parents
        level[int(m)] = 1 + max(
            (level[c] for c in ch[int(m)]), default=-1
        )
    out: List[List[int]] = []
    for m in mem:
        lv = level[int(m)]
        while len(out) <= lv:
            out.append([])
        out[lv].append(int(m))
    return out


def _padding_waste(
    tree: TaskTree,
    mem: Sequence[int],
    shape_of: Optional[Dict[int, Tuple[int, int]]],
    itemsize: int,
) -> float:
    """Identity-lane padding bytes of the merged group's dispatch: per
    level and shape class, lanes are padded to the next power of two so
    the batch signature is warmup-covered.  Zero for generic trees (no
    padded kernel there)."""
    if shape_of is None:
        return 0.0
    waste = 0.0
    for lvl in _group_levels(tree, mem):
        counts: Dict[Tuple[int, int], int] = {}
        for m in lvl:
            key = shape_of.get(int(m))
            if key is not None:
                counts[key] = counts.get(key, 0) + 1
        for (mp, _), k in counts.items():
            waste += (_pow2_ceil(k) - k) * float(mp) * float(mp) * itemsize
    return waste


def _merge_siblings(
    tree: TaskTree,
    members: List[List[int]],
    node_size: np.ndarray,
    sum_sizes: bool,
    shape_of: Optional[Dict[int, Tuple[int, int]]],
    max_front: float,
    max_fill: float,
    max_batch: int,
    itemsize: int,
) -> List[List[int]]:
    """Rewrite (b): merge small sibling leaf groups into batches.

    Leaf groups (no group children) under one parent are packed into
    bins of at most ``max_batch`` members and at most ``max_fill``
    padding-waste bytes; candidates are sorted by dominant shape class
    first so same-shape fronts land in the same vmapped launch."""

    def cost(mem: Sequence[int]) -> float:
        vals = node_size[list(mem)]
        return float(vals.sum() if sum_sizes else vals.max())

    _, qparent, qnchild = _quotient_edges(tree, members)
    is_leaf = qnchild == 0
    buckets: Dict[int, List[int]] = {}
    for g, mem in enumerate(members):
        if (
            is_leaf[g]
            and qparent[g] >= 0
            and all(int(tree.labels[m]) >= 0 for m in mem)
            and cost(mem) <= max_front
        ):
            buckets.setdefault(int(qparent[g]), []).append(g)

    merged_away: Set[int] = set()
    grown: Dict[int, List[int]] = {}
    for gp in sorted(buckets):
        cands = sorted(
            buckets[gp],
            key=lambda g: (
                shape_of.get(int(members[g][0]), (0, 0)) if shape_of else (),
                min(members[g]),
            ),
        )
        bin_groups: List[int] = []

        def flush() -> None:
            if len(bin_groups) > 1:
                keep = min(bin_groups, key=lambda g: min(members[g]))
                mem = [
                    m
                    for g in sorted(bin_groups, key=lambda g: min(members[g]))
                    for m in members[g]
                ]
                grown[keep] = mem
                merged_away.update(g for g in bin_groups if g != keep)
            bin_groups.clear()

        for g in cands:
            trial = [
                m for b in bin_groups for m in members[b]
            ] + list(members[g])
            if bin_groups and (
                len(trial) > max_batch
                or _padding_waste(tree, trial, shape_of, itemsize) > max_fill
            ):
                flush()
            bin_groups.append(g)
        flush()

    return [
        grown.get(g, mem)
        for g, mem in enumerate(members)
        if g not in merged_away
    ]


# ----------------------------------------------------------------------
def _merged_footprints(
    tree: TaskTree, fp: Footprints, members: List[List[int]]
) -> Footprints:
    """Footprints of the fused tasks, exact under the rewrite semantics.

    ``factor`` and ``cb`` sum over members (only *boundary* CBs — those
    handed to a parent outside the group — survive the group).  ``front``
    is the peak of the group's internal mini-traversal: members run in
    execution order, each member's front coexisting with the factors,
    boundary CBs and still-unconsumed internal CBs accumulated so far —
    the same discipline the fused dispatch realizes, and an upper bound
    on it (the executor holds external CBs no longer than the model
    does).  ``front ≥ factor + cb`` always holds, so Liu's recursion and
    the schedule memory timeline treat a fused task exactly like a dense
    front.
    """
    ch = tree.children_lists()
    ng = len(members)
    front = np.zeros(ng)
    factor = np.zeros(ng)
    cb = np.zeros(ng)
    for g, mem in enumerate(members):
        inset = set(int(m) for m in mem)
        held = 0.0
        peak = 0.0
        for m in mem:
            m = int(m)
            peak = max(peak, held + float(fp.front_bytes[m]))
            for c in ch[m]:
                if c in inset:
                    held -= float(fp.cb_bytes[c])
            boundary = int(tree.parent[m]) not in inset
            held += float(fp.factor_bytes[m]) + float(fp.cb_bytes[m])
            peak = max(peak, held)
            factor[g] += float(fp.factor_bytes[m])
            if boundary:
                cb[g] += float(fp.cb_bytes[m])
        front[g] = peak
    return Footprints(front, factor, cb)


# ----------------------------------------------------------------------
def optimize_problem(
    problem,
    *,
    max_front: Optional[float] = None,
    max_fill: float = math.inf,
    memory_budget: Optional[float] = None,
    max_batch: int = 32,
    itemsize: int = 8,
):
    """Amalgamate ``problem``'s task tree; returns the optimized Problem.

    The result carries the rewritten :class:`~repro_torch.core.graph.TaskTree`
    (fused lengths = summed frontal flops), the recomputed
    :class:`~repro_torch.core.memory.Footprints` as its footprint override, and
    the :class:`Provenance` map under ``problem.provenance`` — which
    ``Session.execute`` forwards to the executor so the fused plan
    factorizes the *original* fronts bit-identically.

    ``max_front`` is the size threshold below which tasks fuse/merge: the
    front order for sparse problems (default 128 — one kernel tile), the
    summed task length for generic trees (default twice the mean
    positive length).  ``max_fill`` bounds the identity-lane padding
    bytes a merged batch dispatch may carry; ``max_batch`` caps members
    per fused task (matching the executor's dispatch batch cap).  A
    finite ``memory_budget`` (bytes) makes the pass back off — halving
    the threshold until the optimized tree's sequential (Liu) peak fits
    — degrading to cull-only rewrites; a budget below the *original*
    tree's sequential minimum raises ``ValueError``, mirroring
    ``pm_bounded_schedule``.
    """
    if getattr(problem, "provenance", None) is not None:
        raise ValueError(
            "problem already carries a provenance map; amalgamating an "
            "amalgamated tree is not supported — optimize the original"
        )
    from repro_torch.api.problem import Problem

    tree: TaskTree = problem.tree
    fp: Optional[Footprints] = problem.memory_footprints()

    # per-node size + shape class: front order / padded shape for sparse
    # problems, task length / no shape for generic trees
    symb = problem.symb
    shape_of: Optional[Dict[int, Tuple[int, int]]] = None
    if symb is not None:
        from repro_torch.kernels.ops import padded_shape

        node_size = np.zeros(tree.n)
        shape_of = {}
        for i in range(tree.n):
            s = int(tree.labels[i])
            if s >= 0:
                sn = symb.supernodes[s]
                node_size[i] = float(sn.m)
                shape_of[i] = padded_shape(sn.m, sn.nb)
        sum_sizes = False
        if max_front is None:
            max_front = 128.0
    else:
        node_size = np.asarray(tree.lengths, dtype=np.float64)
        sum_sizes = True
        if max_front is None:
            pos = node_size[node_size > 0]
            max_front = 2.0 * float(pos.mean()) if pos.size else 0.0

    culled = _cull(tree, fp)
    retained = [i for i in range(tree.n) if i not in culled]

    def rewrite(threshold: float) -> List[List[int]]:
        members = [[i] for i in retained]
        if threshold <= 0:
            return members  # cull-only floor
        members = _fuse_chains(
            tree, members, node_size, sum_sizes, threshold, max_batch
        )
        members = _merge_siblings(
            tree, members, node_size, sum_sizes, shape_of,
            threshold, max_fill, max_batch, itemsize,
        )
        # merged siblings expose new single-child chains
        members = _fuse_chains(
            tree, members, node_size, sum_sizes, threshold, max_batch
        )
        return members

    budget = (
        float(memory_budget)
        if memory_budget is not None and math.isfinite(float(memory_budget))
        else math.inf
    )
    tol = 1 + 1e-9
    if fp is not None and math.isfinite(budget):
        orig_min = sequential_peak(tree, fp)
        if budget < orig_min * (1 - 1e-12):
            raise ValueError(
                f"memory budget {budget:.4g} B is below the original "
                f"tree's sequential minimum {orig_min:.4g} B — no "
                f"amalgamation (or traversal) fits"
            )

    threshold = float(max_front)
    for _ in range(64):
        members = rewrite(threshold)
        members.sort(key=min)
        qtree = quotient_tree(tree, members, sorted(culled))
        qfp = _merged_footprints(tree, fp, members) if fp is not None else None
        if (
            fp is None
            or not math.isfinite(budget)
            or sequential_peak(qtree, qfp) <= budget * tol
        ):
            break
        if threshold <= 0:  # cull-only already equals the original peak
            break
        smallest = node_size[retained][node_size[retained] > 0]
        floor = float(smallest.min()) if smallest.size else 0.0
        threshold = threshold / 2 if threshold / 2 >= floor else 0.0

    prov = Provenance(
        groups=tuple(tuple(mem) for mem in members),
        culled=tuple(sorted(culled)),
        n_original=tree.n,
        labels=tuple(int(x) for x in tree.labels),
        parent=tuple(int(x) for x in tree.parent),
    )
    return Problem(
        tree=qtree,
        alpha=problem.alpha,
        name=f"{problem.name}+amalg",
        symb=problem.symb,
        matrix=problem.matrix,
        footprints=qfp,
        provenance=prov,
    )


__all__ = ["Provenance", "optimize_problem"]
