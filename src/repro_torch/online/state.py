"""Task state machine over one or many TaskTrees (dask-scheduler style).

Every task of an admitted tree moves through

    waiting ──(all children done)──► ready ──(given a share)──► running
        running ──(realized work exhausted)──► done
        running ──(TaskFailure, no retry)──► failed

exactly like dask.distributed's per-key state machine, except the unit
of progress is *work under the p^α model* rather than a worker slot: a
running task with share s accrues work at rate s^α, and "done" fires
when its **realized** length (nominal length × noise factor) is paid
down.  The scheduler plans with *estimated* remaining work in nominal
units — it can observe a task's progress fraction but not its noise
multiplier — which is what makes the event loop genuinely online.

Each tree carries a :class:`TreeFuture` (resolved/failed at the root),
the multi-tenant analogue of dask's client futures.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.graph import TaskTree

WAITING = "waiting"
READY = "ready"
RUNNING = "running"
DONE = "done"
FAILED = "failed"


class OnlineFailure(RuntimeError):
    """Raised by TreeFuture.result() when the tree failed."""


@dataclass
class TaskState:
    """One task's live record."""

    index: int
    state: str = WAITING
    nominal: float = 0.0  # L_i the scheduler plans with
    realized: float = 0.0  # L_i × noise factor (what execution costs)
    remaining: float = 0.0  # realized work left
    share: float = 0.0  # processors currently held
    t_ready: float = math.nan
    t_start: float = math.nan
    t_done: float = math.nan

    @property
    def estimated_remaining(self) -> float:
        """Remaining work in nominal units (progress fraction is
        observable, the noise multiplier is not)."""
        if self.realized <= 0:
            return 0.0
        return self.nominal * (self.remaining / self.realized)


@dataclass
class TreeFuture:
    """Root future of one admitted tree (dask-client style)."""

    tree_id: int
    rid: Optional[int] = None
    tenant: int = 0
    t_submit: float = 0.0
    t_admit: float = math.nan
    t_done: float = math.nan
    state: str = "pending"  # pending | done | failed
    error: Optional[str] = None

    def done(self) -> bool:
        return self.state in ("done", "failed")

    def result(self) -> float:
        """Completion time of the root; raises on failure."""
        if self.state == "failed":
            raise OnlineFailure(self.error or f"tree {self.tree_id} failed")
        if self.state != "done":
            raise OnlineFailure(f"tree {self.tree_id} still pending")
        return self.t_done

    @property
    def latency(self) -> float:
        """Submit → root completion (includes queueing)."""
        return self.t_done - self.t_submit

    @property
    def service(self) -> float:
        """Admission → root completion (the tree's online makespan)."""
        return self.t_done - self.t_admit


@dataclass
class RequestRecord:
    """Per-request timing split of one served tree.

    ``latency`` (submit → done) decomposes into admission ``wait``
    (submit → admit, time spent queued) and ``exec_time`` (admit →
    done, the tree's online makespan).  Both halves are first-class:
    the serving layers (pod scheduler and cluster scheduler) publish
    them as separate histograms so a saturated admission queue is
    distinguishable from slow execution.
    """

    rid: Optional[int]
    tenant: int
    tree_id: int
    t_submit: float
    t_admit: float
    t_done: float

    @property
    def wait(self) -> float:
        return self.t_admit - self.t_submit

    @property
    def exec_time(self) -> float:
        return self.t_done - self.t_admit

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit

    @classmethod
    def of_future(cls, f: TreeFuture) -> "RequestRecord":
        return cls(
            rid=f.rid, tenant=f.tenant, tree_id=f.tree_id,
            t_submit=f.t_submit, t_admit=f.t_admit, t_done=f.t_done,
        )


class TreeRun:
    """State machine of one tree: transitions, residuals, realized work."""

    def __init__(
        self,
        tree_id: int,
        tree: TaskTree,
        noise,
        t_submit: float,
        *,
        rid: Optional[int] = None,
        tenant: int = 0,
        label_base: int = 0,
    ) -> None:
        self.tree_id = tree_id
        self.tree = tree
        self.label_base = label_base  # offset into the combined label space
        self.children = tree.children_lists()
        self.n_unfinished_children = np.array(
            [len(c) for c in self.children], dtype=np.int64
        )
        factors = np.array(
            [noise.factor(tree_id, i) for i in range(tree.n)], dtype=np.float64
        )
        self.tasks: List[TaskState] = [
            TaskState(
                index=i,
                nominal=float(tree.lengths[i]),
                realized=float(tree.lengths[i] * factors[i]),
                remaining=float(tree.lengths[i] * factors[i]),
            )
            for i in range(tree.n)
        ]
        self.future = TreeFuture(
            tree_id=tree_id, rid=rid, tenant=tenant, t_submit=t_submit
        )
        self.n_done = 0

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.tree.n

    def complete(self) -> bool:
        return self.n_done == self.n

    def failed(self) -> bool:
        return self.future.state == "failed"

    def admit(self, t: float) -> List[int]:
        """waiting → ready for every leaf; returns the new ready set."""
        self.future.t_admit = t
        out = []
        for i in range(self.n):
            if self.n_unfinished_children[i] == 0:
                ts = self.tasks[i]
                ts.state, ts.t_ready = READY, t
                out.append(i)
        return out

    def start(self, i: int, t: float) -> None:
        ts = self.tasks[i]
        if ts.state == READY:
            ts.state = RUNNING
            ts.t_start = t

    def mark_done(self, i: int, t: float) -> List[int]:
        """running/ready → done; returns children-complete parents that
        became ready (zero-length tasks chain through instantly)."""
        ts = self.tasks[i]
        ts.state, ts.t_done, ts.share, ts.remaining = DONE, t, 0.0, 0.0
        if math.isnan(ts.t_start):
            ts.t_start = t  # zero-length task: instantaneous
        self.n_done += 1
        newly_ready: List[int] = []
        p = int(self.tree.parent[i])
        if p >= 0:
            self.n_unfinished_children[p] -= 1
            if self.n_unfinished_children[p] == 0:
                pt = self.tasks[p]
                pt.state, pt.t_ready = READY, t
                newly_ready.append(p)
        return newly_ready

    def fail(self, t: float, reason: str) -> None:
        """Terminal tree failure: every unfinished task → failed."""
        for ts in self.tasks:
            if ts.state not in (DONE,):
                ts.state, ts.share = FAILED, 0.0
        self.future.state = "failed"
        self.future.error = reason
        self.future.t_done = t

    def finish(self, t: float) -> None:
        self.future.state = "done"
        self.future.t_done = t

    # ------------------------------------------------------------------
    def active_tasks(self) -> List[int]:
        """Tasks eligible for a share right now (ready or running)."""
        return [
            i
            for i, ts in enumerate(self.tasks)
            if ts.state in (READY, RUNNING)
        ]

    def estimated_residual(self) -> np.ndarray:
        """Per-task remaining work in nominal units (the scheduler's
        view): full nominal for waiting tasks, progress-scaled for
        running ones, zero for done."""
        out = np.zeros(self.n, dtype=np.float64)
        for i, ts in enumerate(self.tasks):
            if ts.state in (WAITING, READY):
                out[i] = ts.nominal
            elif ts.state == RUNNING:
                out[i] = ts.estimated_remaining
        return out

    def realized_lengths(self) -> np.ndarray:
        return np.array([ts.realized for ts in self.tasks], dtype=np.float64)


def combined_tree(runs: Dict[int, TreeRun]) -> TaskTree:
    """Concatenate every run under one virtual zero-length root.

    Lengths are the *realized* (noise-scaled) lengths for completed
    trees — the ground truth the §4 completeness predicate must hold
    against — and zero for failed/unfinished trees so partial work is
    not asserted complete.  Task ``i`` of run ``r`` maps to combined
    index ``r.label_base + i`` (the labels the scheduler's
    ExplicitSchedule uses), the virtual root is index 0.
    """
    n_total = 1 + sum(r.n for r in runs.values())
    parent = np.full(n_total, -1, dtype=np.int64)
    lengths = np.zeros(n_total, dtype=np.float64)
    for r in runs.values():
        b = r.label_base
        for i in range(r.n):
            p = int(r.tree.parent[i])
            parent[b + i] = b + p if p >= 0 else 0
        if r.complete():
            lengths[b : b + r.n] = r.realized_lengths()
    return TaskTree(parent=parent, lengths=lengths)


__all__ = [
    "DONE",
    "FAILED",
    "READY",
    "RUNNING",
    "WAITING",
    "OnlineFailure",
    "RequestRecord",
    "TaskState",
    "TreeFuture",
    "TreeRun",
    "combined_tree",
]
