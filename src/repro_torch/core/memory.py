"""Memory model for tree-shaped factorizations: footprints, timelines,
memory-minimizing traversals and the budget-bounded PM schedule.

The PM model schedules *processors*, but the multifrontal application is
in practice memory-bound: companion work by the same group — "Scheduling
tree-shaped task graphs to minimize memory and makespan"
(arXiv:1210.2580) and "Parallel scheduling of task trees with limited
memory" (arXiv:1410.0329) — shows that traversal order and processor
allocation must respect a memory budget or the factorization simply does
not fit.  This module is the memory side of that trade-off:

* :class:`Footprints` — per-task byte counts in the multifrontal memory
  model: the *front* is resident while the task runs, the *factor*
  persists after completion (in-core factorization), and the
  *contribution block* (CB) stays resident from completion until the
  parent's front is assembled (extend-add).
* :func:`memory_timeline` — fold any wall-clock schedule (task → start /
  end spans) over the footprints into a resident-bytes step function
  with its peak.  The peak only depends on the *interleaving* of the
  spans, not on processor shares, so the same fold serves fluid PM
  schedules (in work-time coordinates), discretized plans and online
  replays.
* :func:`sequential_traversal` — Liu's memory-minimizing postorder
  [Liu, "On the storage requirement in the out-of-core multifrontal
  method", 1986], extended to retained factors: children ordered by
  decreasing ``peak_c − resident_after_c``.  Its root peak is the least
  memory *any* schedule of the tree needs — the feasibility line.
* :func:`pm_bounded_schedule` — the budget-respecting PM variant:
  process each subtree with the fluid PM optimum whenever its PM peak
  fits in the remaining budget, otherwise recurse into the children
  sequentially (in Liu order) and run the root front alone.  With
  ``budget=inf`` the whole tree fits and the result *is* the PM optimum;
  as the budget tightens the traversal degrades gracefully toward
  Liu's sequential postorder.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import TaskTree
from .pm import tree_equivalent_lengths, tree_pm_windows
from .schedule import ExplicitSchedule


# ----------------------------------------------------------------------
# Footprints: the multifrontal memory model
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class Footprints:
    """Per-task byte counts of the three multifrontal memory phases.

    ``front_bytes[i]``  — resident while task *i* runs (the full frontal
    matrix being factored);
    ``factor_bytes[i]`` — resident from task *i*'s completion to the end
    of the schedule (the factor panel, kept in core);
    ``cb_bytes[i]``     — resident from task *i*'s completion until its
    parent *starts* (the Schur complement handed to the extend-add).

    A generic tree that is not a factorization can still use the model:
    set ``front_bytes`` to the task's working set and factor/CB to its
    persistent/hand-off output (zeros give a memoryless task).
    """

    front_bytes: np.ndarray
    factor_bytes: np.ndarray
    cb_bytes: np.ndarray

    def __post_init__(self) -> None:
        for name in ("front_bytes", "factor_bytes", "cb_bytes"):
            arr = np.asarray(getattr(self, name), dtype=np.float64)
            if arr.ndim != 1:
                raise ValueError(f"{name} must be 1-D")
            if (arr < 0).any():
                raise ValueError(f"{name} must be non-negative")
            object.__setattr__(self, name, arr)
        if not (
            self.front_bytes.shape
            == self.factor_bytes.shape
            == self.cb_bytes.shape
        ):
            raise ValueError("footprint arrays must share one shape")

    @property
    def n(self) -> int:
        return int(self.front_bytes.shape[0])

    def take(self, indices: Sequence[int]) -> "Footprints":
        idx = np.asarray(indices, dtype=np.int64)
        return Footprints(
            self.front_bytes[idx], self.factor_bytes[idx], self.cb_bytes[idx]
        )

    def padded(self, n: int) -> "Footprints":
        """Zero-extend to ``n`` tasks (virtual roots carry no memory)."""
        if n < self.n:
            raise ValueError(f"cannot pad {self.n} footprints down to {n}")
        if n == self.n:
            return self
        pad = np.zeros(n - self.n)
        return Footprints(
            np.concatenate([self.front_bytes, pad]),
            np.concatenate([self.factor_bytes, pad]),
            np.concatenate([self.cb_bytes, pad]),
        )

    def total_factor(self) -> float:
        return float(self.factor_bytes.sum())


def zero_footprints(n: int) -> Footprints:
    z = np.zeros(n)
    return Footprints(z.copy(), z.copy(), z.copy())


def footprints_from_fronts(
    m: Sequence[int], nb: Sequence[int], itemsize: int = 8
) -> Footprints:
    """Footprints of dense fronts: order ``m[i]`` with ``nb[i]`` pivots.

    front = m² entries (the assembled frontal matrix), factor = m·nb (the
    stored panel ``[L11; L21]``), CB = (m − nb)² (the Schur complement).
    """
    m_arr = np.asarray(m, dtype=np.float64)
    nb_arr = np.asarray(nb, dtype=np.float64)
    k = itemsize
    return Footprints(
        m_arr * m_arr * k,
        m_arr * nb_arr * k,
        (m_arr - nb_arr) ** 2 * k,
    )


# ----------------------------------------------------------------------
# Resident-bytes timeline of an arbitrary schedule
# ----------------------------------------------------------------------
@dataclass
class MemoryTimeline:
    """Resident bytes over time: a step function plus its peak.

    ``steps`` are ``(t, bytes)`` — usage from time ``t`` until the next
    step.  ``peak`` accounts for the extend-add transient (a parent's
    front coexists with its children's CBs at the instant it starts), so
    it can exceed every step value.  ``node_peaks`` is the per-memory-
    node breakdown (``{0: peak}`` when the schedule has no placement).
    ``budget`` records the bound the schedule was planned against
    (``inf`` = unconstrained).
    """

    steps: List[Tuple[float, float]]
    peak: float
    node_peaks: Dict[int, float] = field(default_factory=dict)
    budget: float = math.inf

    def usage_at(self, t: float) -> float:
        u = 0.0
        for tt, b in self.steps:
            if tt > t:
                break
            u = b
        return u

    def to_dict(self) -> Dict:
        return {
            "steps": [[t, b] for t, b in self.steps],
            "peak": self.peak,
            "node_peaks": {str(k): v for k, v in self.node_peaks.items()},
            "budget": "inf" if math.isinf(self.budget) else self.budget,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "MemoryTimeline":
        budget = d.get("budget", "inf")
        return cls(
            steps=[(float(t), float(b)) for t, b in d["steps"]],
            peak=float(d["peak"]),
            node_peaks={int(k): float(v) for k, v in d.get("node_peaks", {}).items()},
            budget=math.inf if budget == "inf" else float(budget),
        )


def memory_timeline(
    parent: np.ndarray,
    spans: Dict[int, Tuple[float, float]],
    fp: Footprints,
    *,
    budget: float = math.inf,
    node_of: Optional[Dict[int, int]] = None,
) -> MemoryTimeline:
    """Fold task spans over the footprints into a :class:`MemoryTimeline`.

    Events at one time point apply in the real executor's order: task
    completions first (front → factor + CB), then task starts (+front),
    then CB consumption (a starting task frees its children's CBs *after*
    its front exists — the extend-add transient).  The peak is taken over
    every intermediate state, so it is conservative with respect to any
    interleaving the executor can realize.  The fold is invariant under
    monotone time reparameterization, so work-time spans (fluid
    schedules) and wall-clock spans (plans, replays) give the same peak.
    """
    parent = np.asarray(parent, dtype=np.int64)
    if not spans:
        return MemoryTimeline(steps=[], peak=0.0, node_peaks={0: 0.0}, budget=budget)
    t_end = max(b for _, b in spans.values())
    # phases: 0 = completion, 1 = start, 2 = CB consumption
    events: List[Tuple[float, int, float, int]] = []
    node_of = node_of or {}
    for i, (t0, t1) in spans.items():
        nd = node_of.get(i, 0)
        events.append((t0, 1, float(fp.front_bytes[i]), nd))
        events.append(
            (
                t1,
                0,
                float(fp.factor_bytes[i] + fp.cb_bytes[i] - fp.front_bytes[i]),
                nd,
            )
        )
        p = int(parent[i])
        # the CB is consumed when the parent's front is assembled; tasks
        # whose parent never runs (the root, truncated schedules) hold it
        # to the end of the schedule
        t_free = spans[p][0] if p >= 0 and p in spans else t_end
        events.append((max(t_free, t1), 2, -float(fp.cb_bytes[i]), nd))
    events.sort(key=lambda e: (e[0], e[1]))

    steps: List[Tuple[float, float]] = []
    usage = 0.0
    peak = 0.0
    per_node: Dict[int, float] = {}
    node_peaks: Dict[int, float] = {}
    k = 0
    while k < len(events):
        t = events[k][0]
        while k < len(events) and events[k][0] == t:
            _, _, delta, nd = events[k]
            usage += delta
            per_node[nd] = per_node.get(nd, 0.0) + delta
            peak = max(peak, usage)
            node_peaks[nd] = max(node_peaks.get(nd, 0.0), per_node[nd])
            k += 1
        usage = max(usage, 0.0)  # guard float dust
        if steps and steps[-1][0] == t:
            steps[-1] = (t, usage)
        else:
            steps.append((t, usage))
    return MemoryTimeline(
        steps=steps, peak=float(peak), node_peaks=node_peaks, budget=budget
    )


# ----------------------------------------------------------------------
# Liu's memory-minimizing sequential traversal
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class SequentialTraversal:
    """Result of Liu's bottom-up sweep.

    ``peak[i]`` — least resident bytes needed to process subtree ``i``
    one task at a time (optimal child order, retained factors);
    ``resident_after[i]`` — bytes still held once subtree ``i`` is done
    (all its factors + the root CB); ``child_order[i]`` — the optimal
    processing order of ``i``'s children.
    """

    peak: np.ndarray
    resident_after: np.ndarray
    child_order: List[List[int]]

    def min_peak(self, root: int) -> float:
        return float(self.peak[root])


def sequential_traversal(tree: TaskTree, fp: Footprints) -> SequentialTraversal:
    """Liu's optimal postorder, with factors retained in core.

    At node ``i`` with children processed in order ``c_1..c_k``::

        peak_i = max( max_j ( Σ_{l<j} R_l  +  peak_{c_j} ),
                      Σ_l R_l + front_i,           # extend-add transient
                      R_i )                        # state after completion

    where ``R_c = resident_after(c)``.  The ``R_i`` term matters only
    for generic footprints with ``factor + cb > front`` (a dense front's
    factor+CB never exceeds it); without it such models could certify a
    peak the post-completion state immediately violates.  The classical
    exchange argument shows the max is minimized by ordering children by
    decreasing ``peak_c − R_c``.
    """
    if fp.n != tree.n:
        raise ValueError(f"footprints cover {fp.n} tasks, tree has {tree.n}")
    ch = tree.children_lists()
    peak = np.zeros(tree.n)
    resident = np.zeros(tree.n)
    order: List[List[int]] = [[] for _ in range(tree.n)]
    for i in tree.topo_order():  # children before parents
        kids = sorted(ch[i], key=lambda c: resident[c] - peak[c])
        order[i] = kids
        held = 0.0
        p = 0.0
        for c in kids:
            p = max(p, held + peak[c])
            held += resident[c]
        p = max(p, held + float(fp.front_bytes[i]))
        resident[i] = float(
            fp.factor_bytes[i]
            + fp.cb_bytes[i]
            + sum(resident[c] - fp.cb_bytes[c] for c in kids)
        )
        peak[i] = max(p, resident[i])
    return SequentialTraversal(peak=peak, resident_after=resident, child_order=order)


def sequential_peak(tree: TaskTree, fp: Footprints) -> float:
    """Least memory any schedule of ``tree`` needs (Liu's bound)."""
    return sequential_traversal(tree, fp).min_peak(tree.root)


# ----------------------------------------------------------------------
# PM peak and the budget-bounded PM schedule
# ----------------------------------------------------------------------
def pm_peak(tree: TaskTree, alpha: float, fp: Footprints) -> float:
    """Peak resident bytes of the fluid PM schedule of ``tree``.

    Computed in work-time coordinates — the peak is invariant under the
    monotone work-time → wall-clock map, so no profile is needed.
    """
    w0, w1, _ = tree_pm_windows(tree, alpha)
    spans = {i: (float(w0[i]), float(w1[i])) for i in range(tree.n)}
    return memory_timeline(tree.parent, spans, fp).peak


def _subtree_nodes(tree: TaskTree, i: int, ch: List[List[int]]) -> List[int]:
    out: List[int] = []
    stack = [i]
    while stack:
        j = stack.pop()
        out.append(j)
        stack.extend(ch[j])
    return out


def pm_bounded_schedule(
    tree: TaskTree,
    alpha: float,
    p: float,
    fp: Footprints,
    budget: float,
) -> Tuple[ExplicitSchedule, Dict]:
    """PM shares under a memory budget, via segmented traversal.

    Walk the tree top-down: a subtree whose fluid-PM peak fits in the
    budget (on top of the bytes already held by completed segments) is
    scheduled as one PM segment on the full machine; otherwise its
    children are processed *sequentially* in Liu order (recursively) and
    its root front then runs alone.  ``budget=inf`` makes the whole tree
    one segment — the exact PM optimum.  Raises ``ValueError`` when the
    budget is below Liu's sequential minimum (no schedule fits).

    Constant capacity ``p`` only: segment boundaries are computed in
    wall-clock, and gluing PM segments under a step profile would need
    per-segment work-time offsets nobody requests yet.
    """
    seq = sequential_traversal(tree, fp)
    if budget < seq.min_peak(tree.root) * (1 - 1e-12):
        raise ValueError(
            f"memory budget {budget:.4g} B is below the sequential minimum "
            f"{seq.min_peak(tree.root):.4g} B — no traversal of this tree fits"
        )
    ch = tree.children_lists()
    ra = p**alpha
    es = ExplicitSchedule(alpha)
    info = {"segments": 0, "sequential_min": seq.min_peak(tree.root)}
    tol = 1 + 1e-9

    # Global PM windows, computed once: within a subtree the PM-alone
    # schedule is the global one under an affine time map (ratios split
    # multiplicatively), and the timeline peak is interleaving-invariant
    # — so the fit test folds the *global* spans of the subtree's tasks
    # instead of rebuilding a TaskTree and re-running the PM recursion
    # per candidate.  Zero-ratio subtrees (degenerate all-zero lengths)
    # fall back to the standalone fold.
    w0g, w1g, ratio_g = tree_pm_windows(tree, alpha)

    def subtree_pm_peak(i: int, nodes: List[int]) -> float:
        if ratio_g[i] > 0 or i == tree.root:
            spans = {
                int(j): (float(w0g[j]), float(w1g[j])) for j in nodes
            }
            return memory_timeline(tree.parent, spans, fp).peak
        idx = {j: k for k, j in enumerate(nodes)}
        sub = TaskTree(
            parent=np.array(
                [idx[int(tree.parent[j])] if j != i else -1 for j in nodes],
                dtype=np.int64,
            ),
            lengths=tree.lengths[nodes],
            labels=tree.labels[nodes],
        )
        return pm_peak(sub, alpha, fp.take(nodes))

    t = 0.0
    held = 0.0
    # explicit stack: ("enter", i) decides segment vs. split;
    # ("task", i) runs i's own front after its children completed.
    stack: List[Tuple[str, int]] = [("enter", tree.root)]
    while stack:
        op, i = stack.pop()
        if op == "enter":
            nodes = _subtree_nodes(tree, i, ch)
            if held + subtree_pm_peak(i, nodes) <= budget * tol:
                idx = {j: k for k, j in enumerate(nodes)}
                sub = TaskTree(
                    parent=np.array(
                        [
                            idx[int(tree.parent[j])] if j != i else -1
                            for j in nodes
                        ],
                        dtype=np.int64,
                    ),
                    lengths=tree.lengths[nodes],
                    labels=tree.labels[nodes],
                )
                sub_fp = fp.take(nodes)
                # one fluid-PM segment on the whole machine.  Leaf window
                # starts come out of a float subtraction and can land a
                # few ulp below the segment origin — clamp at 0 so one
                # segment never bleeds into its predecessor (the §4
                # resource check samples every event sliver).
                w0, w1, ratio = tree_pm_windows(sub, alpha)
                for k in range(sub.n):
                    a = max(float(w0[k]), 0.0)
                    b = max(float(w1[k]), a)
                    if b > a:
                        es.add(
                            nodes[k],
                            t + a / ra,
                            t + b / ra,
                            float(ratio[k]) * p,
                        )
                eq = tree_equivalent_lengths(sub, alpha)
                t += float(eq[sub.root]) / ra
                held += float(sub_fp.factor_bytes.sum() + fp.cb_bytes[i])
                info["segments"] += 1
            else:
                stack.append(("task", i))
                for c in reversed(seq.child_order[i]):
                    stack.append(("enter", c))
        else:  # "task": children done; assemble + factor i's front alone
            consumed = float(sum(fp.cb_bytes[c] for c in ch[i]))
            held_after = (
                held + float(fp.factor_bytes[i] + fp.cb_bytes[i]) - consumed
            )
            # both states must fit: the extend-add transient (front over
            # the held bytes) and the post-completion residency (matters
            # for generic footprints with factor + CB > front)
            if max(held + float(fp.front_bytes[i]), held_after) > budget * tol:
                raise ValueError(
                    f"memory budget {budget:.4g} B cannot hold front {i} "
                    f"({fp.front_bytes[i]:.4g} B) over {held:.4g} B of "
                    f"retained factors and contribution blocks"
                )
            if tree.lengths[i] > 0:
                dur = float(tree.lengths[i]) / ra
                es.add(i, t, t + dur, p)
                t += dur
                info["segments"] += 1
            held = held_after
    info["peak_model"] = held  # final resident: all factors + root CB
    return es, info


__all__ = [
    "Footprints",
    "MemoryTimeline",
    "SequentialTraversal",
    "footprints_from_fronts",
    "memory_timeline",
    "pm_bounded_schedule",
    "pm_peak",
    "sequential_peak",
    "sequential_traversal",
    "zero_footprints",
]
