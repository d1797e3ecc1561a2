"""Speedup-unaware allocation strategies the paper compares against (§7).

* DIVISIBLE — assumes perfect linear speedup, so it runs the tasks one at a
  time (any topological order) each on the whole machine.  Under the true
  p^α model its makespan on a constant profile p is ``Σ_i L_i / p^α``.
* PROPORTIONAL — Pothen & Sun's proportional mapping [11]: every subtree gets
  a constant share proportional to the *sum of task lengths* of the subtree
  (not the equivalent length — the strategy is unaware of α).  Equal to PM
  when α = 1.  Evaluated under §7's realistic floor model: speedup p^α for
  p ≥ 1, linear p for p < 1.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .graph import TaskTree
from .profiles import Profile
from .schedule import ExplicitSchedule, simulate_constant_shares


# ----------------------------------------------------------------------
def divisible_makespan(tree: TaskTree, alpha: float, profile: Profile) -> float:
    """Sequential whole-machine execution: work-time needed is Σ L_i."""
    total = float(tree.lengths.sum())
    return profile.time_for_work(total, alpha)


def divisible_schedule(
    tree: TaskTree, alpha: float, profile: Profile
) -> ExplicitSchedule:
    order = tree.topo_order()  # post-order: children first — valid
    sched = ExplicitSchedule(alpha)
    w = 0.0
    for i in order:
        w0, w = w, w + float(tree.lengths[i])
        t0 = profile.time_for_work(w0, alpha)
        t1 = profile.time_for_work(w, alpha)
        # whole machine: share = p(t); split at profile breakpoints
        acc = 0.0
        for d, p in profile.steps:
            lo, hi = acc, acc + d
            acc = hi
            a, b = max(lo, t0), min(hi, t1)
            if b > a:
                sched.add(int(i), a, b, p)
            if hi >= t1:
                break
    return sched


# ----------------------------------------------------------------------
def subtree_weights(tree: TaskTree) -> np.ndarray:
    """W_i = Σ_{j in subtree(i)} L_j (proportional mapping's weight)."""
    w = tree.lengths.astype(np.float64).copy()
    order = tree.topo_order()
    for i in order:
        p = tree.parent[i]
        if p >= 0:
            w[p] += w[i]
    return w


def proportional_shares(tree: TaskTree, p: float) -> np.ndarray:
    """Constant per-task share under proportional mapping on p processors.

    Children of i split the share of i proportionally to subtree weights;
    node i itself runs on its full subtree share once children finish.
    """
    w = subtree_weights(tree)
    ch = tree.children_lists()
    share = np.zeros(tree.n)
    share[tree.root] = p
    for i in tree.topo_order()[::-1]:  # parents before children
        kids = ch[i]
        if not kids:
            continue
        denom = sum(w[c] for c in kids)
        for c in kids:
            share[c] = share[i] * (w[c] / denom) if denom > 0 else 0.0
    return share


def proportional_schedule(
    tree: TaskTree,
    alpha: float,
    p: float,
    speedup_floor: bool = True,
) -> ExplicitSchedule:
    """Event-driven evaluation of proportional mapping on constant p.

    §7: "the speedup is equal to p^α when p ≥ 1 and p otherwise" — the
    PROPORTIONAL strategy may allocate sub-unit shares, evaluated with the
    realistic linear floor.
    """
    shares = proportional_shares(tree, p)
    return simulate_constant_shares(
        tree, shares, Profile.constant(p), alpha, speedup_floor=speedup_floor
    )


def proportional_makespan(
    tree: TaskTree, alpha: float, p: float, speedup_floor: bool = True
) -> float:
    """Makespan recursion without building the explicit schedule.

    finish(i) = max_children finish(c) + L_i / f(share_i); O(n).
    """
    shares = proportional_shares(tree, p)

    def f(s: float) -> float:
        if s <= 0:
            return np.inf
        if speedup_floor and s < 1.0:
            return s
        return s**alpha

    finish = np.zeros(tree.n)
    child_max = np.zeros(tree.n)  # max finish among children seen so far
    for i in tree.topo_order():
        own = tree.lengths[i] / f(shares[i])
        finish[i] = child_max[i] + own
        p_ = tree.parent[i]
        if p_ >= 0:
            child_max[p_] = max(child_max[p_], finish[i])
    return float(finish[tree.root])


def strategies_comparison(
    tree: TaskTree, alpha: float, p: float
) -> Tuple[float, float, float]:
    """(PM, PROPORTIONAL, DIVISIBLE) makespans on constant p — the §7 data."""
    from .pm import tree_equivalent_lengths

    eq = tree_equivalent_lengths(tree, alpha)
    m_pm = eq[tree.root] / p**alpha
    m_prop = proportional_makespan(tree, alpha, p)
    m_div = float(tree.lengths.sum()) / p**alpha
    return m_pm, m_prop, m_div
