"""Explicit schedules: representation, validation, makespan (paper §4).

A schedule is a set of piecewise-constant share functions p_i(t).  §4 defines
validity: (i) resource — Σ_i p_i(t) ≤ p(t); (ii) completeness — every task
accrues ∫ p_i(t)^α dt ≥ L_i; (iii) precedence — a task only runs once all its
predecessors are complete.  The PM schedule is validated against exactly
these three predicates in the tests; the engine below is strategy-agnostic so
DIVISIBLE / PROPORTIONAL / two-node schedules all go through the same check.
"""
from __future__ import annotations


from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import TaskTree
from .profiles import Profile


@dataclass
class Piece:
    t0: float
    t1: float
    share: float


@dataclass
class ExplicitSchedule:
    """Wall-clock schedule: task label -> list of (t0, t1, share) pieces."""

    alpha: float
    pieces: Dict[int, List[Piece]] = field(default_factory=dict)

    def add(self, label: int, t0: float, t1: float, share: float) -> None:
        if t1 < t0 - 1e-12:
            raise ValueError(f"negative piece for task {label}")
        self.pieces.setdefault(label, []).append(Piece(t0, t1, share))

    def work_of(self, label: int) -> float:
        return sum((p.t1 - p.t0) * p.share**self.alpha for p in self.pieces.get(label, []))

    def completion_time(self, label: int) -> float:
        ps = self.pieces.get(label, [])
        return max((p.t1 for p in ps), default=0.0)

    def start_time(self, label: int) -> float:
        ps = self.pieces.get(label, [])
        return min((p.t0 for p in ps), default=0.0)

    def makespan(self) -> float:
        return max((p.t1 for ps in self.pieces.values() for p in ps), default=0.0)

    # ------------------------------------------------------------------
    def validate(
        self,
        tree: TaskTree,
        profile: Profile,
        rtol: float = 1e-6,
    ) -> None:
        """Raise AssertionError if the §4 validity conditions fail."""
        # (ii) completeness
        for i in range(tree.n):
            w = self.work_of(i)
            if tree.lengths[i] > 0:
                assert w >= tree.lengths[i] * (1 - rtol), (
                    f"task {i}: work {w} < length {tree.lengths[i]}"
                )
        # (iii) precedence: children complete before parent starts (the
        # slack is the reference's, computed once: makespan() scans every
        # piece)
        slack = rtol * max(1.0, self.makespan())
        for i in range(tree.n):
            p = int(tree.parent[i])
            if p >= 0 and tree.lengths[p] > 0:
                assert self.completion_time(i) <= self.start_time(p) + slack, (
                    f"task {p} starts before child {i} completes"
                )
        # (i) resource constraint at piece boundaries (shares are
        # piecewise-constant so checking midpoints of the event grid suffices)
        flat = [p for ps in self.pieces.values() for p in ps]
        t0 = np.array([p.t0 for p in flat], dtype=np.float64)
        t1 = np.array([p.t1 for p in flat], dtype=np.float64)
        events = sorted({p.t0 for p in flat} | {p.t1 for p in flat})
        for a, b in zip(events[:-1], events[1:]):
            mid = 0.5 * (a + b)
            # the pieces running at mid, summed in the reference's order
            # (the mask only finds them: the same floats, the same sum)
            used = sum(flat[j].share for j in np.flatnonzero((t0 <= mid) & (mid < t1)))
            cap = profile.p_at(mid)
            assert used <= cap * (1 + rtol) + 1e-9, (
                f"resource violation at t={mid}: {used} > {cap}"
            )


def from_pm(tree: TaskTree, alpha: float, profile: Profile) -> ExplicitSchedule:
    """Materialize the PM schedule of a tree as an ExplicitSchedule."""
    from .pm import tree_pm_windows

    w_start, w_end, ratio = tree_pm_windows(tree, alpha)
    sched = ExplicitSchedule(alpha)
    for i in range(tree.n):
        t0 = profile.time_for_work(w_start[i], alpha)
        t1 = profile.time_for_work(w_end[i], alpha)
        # share = ratio × p(t): may cross profile steps — split pieces.
        _add_ratio_piece(sched, i, t0, t1, ratio[i], profile)
    return sched


def _add_ratio_piece(
    sched: ExplicitSchedule,
    label: int,
    t0: float,
    t1: float,
    ratio: float,
    profile: Profile,
) -> None:
    """Add task pieces share = ratio·p(t) split at profile breakpoints."""
    acc = 0.0
    for d, p in profile.steps:
        lo, hi = acc, acc + d
        acc = hi
        a, b = max(lo, t0), min(hi, t1)
        if b > a:
            sched.add(label, a, b, ratio * p)
        if hi >= t1:
            break


# ----------------------------------------------------------------------
# Generic event-driven engine for ratio-based strategies.
# ----------------------------------------------------------------------
def simulate_constant_shares(
    tree: TaskTree,
    shares: Sequence[float],
    profile: Profile,
    alpha: float,
    speedup_floor: bool = False,
) -> ExplicitSchedule:
    """Run the tree where each task i uses a *fixed* share ``shares[i]`` from
    the moment it becomes ready until completion (PROPORTIONAL-style
    strategies).  A task is ready when all children are done; processors of a
    finished subtree idle until the parent's other children finish (the
    strategy is deliberately speedup-unaware — that is the paper's point).

    ``speedup_floor``: §7's realistic adjustment — speedup is p^α for p ≥ 1
    but p (linear) for p < 1.
    """
    shares_arr = np.asarray(shares, dtype=np.float64)
    ch = tree.children_lists()
    n_unfinished_children = np.array([len(c) for c in ch])
    remaining = tree.lengths.astype(np.float64).copy()
    ready = [i for i in range(tree.n) if n_unfinished_children[i] == 0]
    running: Dict[int, float] = {}  # label -> start time of current piece
    sched = ExplicitSchedule(alpha)
    t = 0.0

    def rate(i: int) -> float:
        s = shares_arr[i]
        if s <= 0:
            return 0.0
        if speedup_floor and s < 1.0:
            return s
        return s**alpha

    for i in ready:
        running[i] = t
    ready = []
    guard = 0
    while running or ready:
        guard += 1
        if guard > 10 * tree.n + 100:
            raise RuntimeError("simulate_constant_shares did not converge")
        # next completion among running tasks (profile is irrelevant to the
        # *relative* rates only if p(t) constant; handle steps by bounding
        # the horizon at the next profile breakpoint)
        next_done, t_done = None, np.inf
        for i in running:
            ri = rate(i)
            if ri <= 0:
                continue
            tt = t + remaining[i] / ri
            if tt < t_done:
                next_done, t_done = i, tt
        if next_done is None:
            raise RuntimeError("deadlock: running tasks with zero share")
        # advance to t_done, pay down all running tasks
        for i in list(running):
            remaining[i] -= (t_done - t) * rate(i)
        t = t_done
        done = [i for i in running if remaining[i] <= 1e-9]
        for i in done:
            sched.add(i, running.pop(i), t, shares_arr[i])
            p = int(tree.parent[i])
            if p >= 0:
                n_unfinished_children[p] -= 1
                if n_unfinished_children[p] == 0:
                    running[p] = t
    return sched
