"""The Prasanna–Musicus optimal schedule for SP graphs (paper §5).

Main results re-proved by the paper with pure scheduling arguments and
implemented here:

* Definition 1: equivalent length
    ``𝓛_T = L``, ``𝓛_{G1;G2} = 𝓛_{G1} + 𝓛_{G2}``,
    ``𝓛_{G1||G2} = (𝓛_{G1}^{1/α} + 𝓛_{G2}^{1/α})^α``.
* Lemma 4: in the optimal schedule each branch of a parallel composition
  holds a constant ratio ``π_i = 𝓛_i^{1/α} / Σ_j 𝓛_j^{1/α}`` of the
  processors given to the composition.
* Theorem 6: the optimal schedule is unique, siblings complete
  simultaneously, and the makespan under a step profile p(t) equals the
  makespan of the single equivalent task, i.e. the smallest τ with
  ``∫_0^τ p(t)^α dt = 𝓛_G``.

Everything is computed in *work-time* coordinates (see profiles.py): a
subgraph holding ratio r over work-interval of measure ``w`` performs
``r^α · w`` units of work, so the schedule is profile-independent; only the
final mapping back to wall-clock uses p(t).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .graph import PARALLEL, SERIES, TASK, SPNode, TaskTree
from .profiles import Profile


# ----------------------------------------------------------------------
# Equivalent lengths (Definition 1)
# ----------------------------------------------------------------------
def equivalent_length(g: SPNode, alpha: float) -> float:
    """𝓛_G of Definition 1 (iterative post-order)."""
    return equivalent_lengths(g, alpha)[g.uid]


def equivalent_lengths(g: SPNode, alpha: float) -> Dict[int, float]:
    """Equivalent length of *every* SP node, keyed by ``uid``."""
    inv = 1.0 / alpha
    out: Dict[int, float] = {}
    for node in g.iter_postorder():
        if node.kind == TASK:
            out[node.uid] = node.length
        elif node.kind == SERIES:
            out[node.uid] = float(sum(out[c.uid] for c in node.children))
        else:  # PARALLEL
            out[node.uid] = float(
                sum(out[c.uid] ** inv for c in node.children) ** alpha
            )
    return out


def tree_equivalent_lengths(tree: TaskTree, alpha: float) -> np.ndarray:
    """Vectorised 𝓛 for every *subtree* of an in-tree.

    ``eq[i] = L_i + (Σ_{c∈children(i)} eq[c]^{1/α})^α`` — the pseudo-tree
    series(parallel(children), task) rule.  O(n), no recursion; used for the
    §7 simulations on trees with up to 1e6 nodes.
    """
    inv = 1.0 / alpha
    order = tree.topo_order()
    eq = np.zeros(tree.n, dtype=np.float64)
    acc = np.zeros(tree.n, dtype=np.float64)  # Σ_children eq^{1/α}
    parent = tree.parent
    for i in order:
        e = tree.lengths[i] + acc[i] ** alpha
        eq[i] = e
        p = parent[i]
        if p >= 0:
            acc[p] += e**inv
    return eq


# ----------------------------------------------------------------------
# The PM schedule
# ----------------------------------------------------------------------
@dataclass
class TaskInterval:
    """One task's execution: constant ratio over a work-time interval."""

    label: Optional[int]
    uid: int
    length: float
    ratio: float  # share of p(t); constant (Lemma 4)
    w_start: float  # work-time coordinates
    w_end: float


@dataclass
class PMSchedule:
    """The unique optimal schedule (Theorem 6), profile-independent part.

    ``intervals`` are in work-time; ``materialize(profile)`` maps to
    wall-clock.  ``ratios[uid]`` is the constant ratio of every SP node.
    """

    alpha: float
    eq_root: float
    intervals: List[TaskInterval]
    ratios: Dict[int, float] = field(default_factory=dict)

    def makespan(self, profile: Profile) -> float:
        return profile.time_for_work(self.eq_root, self.alpha)

    def materialize(self, profile: Profile) -> List[Tuple[Optional[int], float, float, float]]:
        """[(label, t_start, t_end, ratio)] in wall-clock time."""
        out = []
        for iv in self.intervals:
            t0 = profile.time_for_work(iv.w_start, self.alpha)
            t1 = profile.time_for_work(iv.w_end, self.alpha)
            out.append((iv.label, t0, t1, iv.ratio))
        return out

    def shares_at_w(self, w: float) -> Dict[Optional[int], float]:
        """Active task → ratio at work-time w (for validation)."""
        return {
            iv.label: iv.ratio
            for iv in self.intervals
            if iv.w_start <= w < iv.w_end
        }


def pm_schedule(g: SPNode, alpha: float) -> PMSchedule:
    """Compute the unique optimal schedule of Theorem 6.

    Top-down sweep in work-time: the root holds ratio 1 over ``[0, 𝓛_G]``.
    A series node splits its interval sequentially by child equivalent
    lengths (work measure of child = 𝓛_child / r^α with the *same* ratio r —
    flow conservation).  A parallel node splits its ratio by Lemma 4's π_i,
    all children spanning the same interval (siblings end simultaneously).
    """
    eq = equivalent_lengths(g, alpha)
    inv = 1.0 / alpha
    intervals: List[TaskInterval] = []
    ratios: Dict[int, float] = {}

    # stack entries: (node, ratio, w_start)
    stack: List[Tuple[SPNode, float, float]] = [(g, 1.0, 0.0)]
    while stack:
        node, r, w0 = stack.pop()
        ratios[node.uid] = r
        dur = eq[node.uid] / (r**alpha) if eq[node.uid] > 0 else 0.0
        if node.kind == TASK:
            if node.length > 0:
                intervals.append(
                    TaskInterval(node.label, node.uid, node.length, r, w0, w0 + dur)
                )
            else:  # zero-length tasks occupy no time
                intervals.append(
                    TaskInterval(node.label, node.uid, 0.0, r, w0, w0)
                )
        elif node.kind == SERIES:
            w = w0
            for c in node.children:
                stack.append((c, r, w))
                w += eq[c.uid] / (r**alpha)
        else:  # PARALLEL: Lemma 4 ratios, same window
            denom = sum(eq[c.uid] ** inv for c in node.children)
            for c in node.children:
                if denom > 0:
                    rc = r * (eq[c.uid] ** inv) / denom
                else:
                    rc = 0.0
                stack.append((c, rc, w0))
    intervals.sort(key=lambda iv: (iv.w_start, iv.uid))
    return PMSchedule(alpha, eq[g.uid], intervals, ratios)


def pm_makespan(g: SPNode, alpha: float, profile: Profile) -> float:
    """Optimal makespan of G under p(t) (Theorem 6) without full schedule."""
    return profile.time_for_work(equivalent_length(g, alpha), alpha)


def pm_makespan_constant_p(g: SPNode, alpha: float, p: float) -> float:
    return equivalent_length(g, alpha) / p**alpha


# ----------------------------------------------------------------------
# Leaf starting ratios for trees (Theorem 6's "schedule defined by ratios
# of the leaves"), vectorised.
# ----------------------------------------------------------------------
def tree_pm_ratios(tree: TaskTree, alpha: float) -> np.ndarray:
    """ratio[i]: constant share (fraction of p(t)) of task i while running.

    Top-down over the tree: root ratio 1; children of i split ratio r_i by
    eq^{1/α} weights.  Task i itself runs at ratio r_i after its children
    complete (flow conservation).
    """
    eq = tree_equivalent_lengths(tree, alpha)
    inv = 1.0 / alpha
    ch = tree.children_lists()
    ratio = np.zeros(tree.n, dtype=np.float64)
    ratio[tree.root] = 1.0
    order = tree.topo_order()[::-1]  # parents before children
    for i in order:
        kids = ch[i]
        if not kids:
            continue
        denom = sum(eq[c] ** inv for c in kids)
        for c in kids:
            ratio[c] = ratio[i] * (eq[c] ** inv) / denom if denom > 0 else 0.0
    return ratio


def tree_pm_windows(tree: TaskTree, alpha: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(w_start, w_end, ratio) per task in work-time, vectorised tree path.

    Subtree of i spans ``[end_i − eq_i/r_i^α, end_i]``; its own task runs in
    the last ``L_i/r_i^α`` of that window; children all end when it starts.
    """
    eq = tree_equivalent_lengths(tree, alpha)
    ratio = tree_pm_ratios(tree, alpha)
    ch = tree.children_lists()
    w_end = np.zeros(tree.n)
    w_start = np.zeros(tree.n)
    order = tree.topo_order()[::-1]
    for i in order:
        r = ratio[i]
        ra = r**alpha if r > 0 else 1.0
        if tree.parent[i] < 0:
            w_end[i] = eq[i] / ra
        w_start[i] = w_end[i] - (tree.lengths[i] / ra if r > 0 else 0.0)
        child_end = w_start[i]
        for c in ch[i]:
            w_end[c] = child_end
    return w_start, w_end, ratio


# ----------------------------------------------------------------------
# Suffix cut: the part of a graph left after PM-executing eq-work (𝓛 − ω).
# Needed by the two-node algorithm (§6.1, Definition 12: B_u / B̄_u).
# ----------------------------------------------------------------------
def cut_suffix(g: SPNode, remaining: float, alpha: float) -> Optional[SPNode]:
    """Return the SP graph of the *last* ``remaining`` units of equivalent
    length of ``g`` under its own PM schedule (None if remaining <= 0).

    Under PM all branches of a parallel composition have identical work
    fractions at every instant (Lemma 5: w_1(t) = w_2(t) = w(t)), so when the
    composition has ω of its 𝓛 left, each branch has ω_i = 𝓛_i · (ω/𝓛) of
    its own 𝓛_i left, and (Σ ω_i^{1/α})^α = ω holds consistently.  A series
    node consumes children from the front, so its suffix keeps one (possibly
    partial) child plus the untouched tail.
    """
    if remaining <= 0:
        return None
    eq = equivalent_lengths(g, alpha)
    if remaining >= eq[g.uid]:
        return g

    def build(node: SPNode, rem: float) -> SPNode:
        # iterative would be nicer but suffix depth = graph depth of the cut
        # boundary only; guard with explicit stack for chains:
        stack: List[Tuple[SPNode, float]] = [(node, rem)]
        done: Dict[int, SPNode] = {}
        while stack:
            nd, rm = stack.pop()
            if nd.uid in done:
                continue
            if nd.kind == TASK:
                done[nd.uid] = SPNode(TASK, length=min(rm, nd.length), label=nd.label)
            elif nd.kind == PARALLEL:
                frac = rm / eq[nd.uid]
                kids = []
                ready = True
                for c in nd.children:
                    if c.uid not in done:
                        stack.append((nd, rm))
                        stack.append((c, eq[c.uid] * frac))
                        ready = False
                        break
                    kids.append(done[c.uid])
                if ready:
                    done[nd.uid] = SPNode(PARALLEL, children=[done[c.uid] for c in nd.children])
            else:  # SERIES: keep the tail
                acc = 0.0
                tail: List[SPNode] = []
                pending = None
                for c in reversed(nd.children):
                    if acc >= rm:
                        break
                    take = min(eq[c.uid], rm - acc)
                    if take >= eq[c.uid] - 1e-15:
                        tail.append(c)
                    else:
                        pending = (c, take)
                    acc += take
                if pending is not None and pending[0].uid not in done:
                    stack.append((nd, rm))
                    stack.append(pending)
                    continue
                kids = [done[pending[0].uid]] if pending is not None else []
                kids.extend(reversed(tail))
                done[nd.uid] = kids[0] if len(kids) == 1 else SPNode(SERIES, children=kids)
        return done[node.uid]

    return build(g, remaining)
