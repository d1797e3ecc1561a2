"""Deterministic discrete-event core for the online scheduler.

The paper's key structural fact — Lemma 4 / Theorem 6: PM allocation
*ratios* are invariant under any processor profile p(t) — means the right
reaction to any runtime event is a cheap O(n) re-share, never a full
replan.  This module provides the substrate that makes "any runtime
event" a first-class object: a virtual clock, a min-heap of timestamped
event payloads (arrivals, capacity edits, node slowdowns, task
failures), the node-level processor pool those events edit (the live
p(t)), and pluggable duration-noise models so simulated task times can
deviate from the p^α model the scheduler plans with.

Everything is deterministic: ties break by insertion order, and noise is
keyed by (seed, tree, task) so a trace replays identically regardless of
event interleaving.
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field
from typing import Iterator, List

import numpy as np


# ----------------------------------------------------------------------
# Event payloads
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class Arrival:
    """A submitted tree reaches its arrival time and enters admission."""

    tree_id: int


@dataclass(frozen=True)
class SetCapacity:
    """Elastic capacity change: the pool's total processor count becomes
    ``capacity`` (the paper's step in p(t)); node speeds reset uniform."""

    capacity: float


@dataclass(frozen=True)
class SetNodeSpeed:
    """Per-node speed edit: 0 = node loss, 1 = healthy/rejoin, σ∈(0,1) =
    straggler slowdown.  Capacity = Σ speeds (§6.2's heterogeneity folded
    into processor counts)."""

    node: int
    speed: float


@dataclass(frozen=True)
class TaskFailure:
    """A running task loses its progress.  With ``retry`` the work is
    redone from scratch; without it the whole tree's future fails."""

    tree_id: int
    task: int
    retry: bool = True


@dataclass(order=True)
class Event:
    time: float
    seq: int
    payload: object = field(compare=False)


class EventQueue:
    """Min-heap of timestamped events; ties pop in push order."""

    def __init__(self) -> None:
        self._heap: List[Event] = []
        self._seq = itertools.count()

    def push(self, time: float, payload: object) -> None:
        if not math.isfinite(time):
            raise ValueError(f"event time must be finite, got {time}")
        heapq.heappush(self._heap, Event(float(time), next(self._seq), payload))

    def peek_time(self) -> float:
        return self._heap[0].time if self._heap else math.inf

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def pop_until(self, t: float) -> Iterator[Event]:
        """Drain every event with time ≤ t (in time, then push order)."""
        while self._heap and self._heap[0].time <= t:
            yield heapq.heappop(self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class VirtualClock:
    """Monotone simulated time."""

    def __init__(self, t0: float = 0.0) -> None:
        self.now = float(t0)

    def advance(self, t: float) -> float:
        if t < self.now - 1e-9:
            raise ValueError(f"clock moved backwards: {self.now} -> {t}")
        self.now = max(self.now, t)
        return self.now


# ----------------------------------------------------------------------
# The live processor pool (the p(t) the events edit)
# ----------------------------------------------------------------------
class ProcessorPool:
    """Node-level capacity: ``capacity() = Σ node speeds``.

    A healthy node contributes speed 1.0; loss/slowdown/rejoin are speed
    edits (SetNodeSpeed), elastic resizes are uniform resets
    (SetCapacity).  Fractional speeds model stragglers exactly as §6.2
    folds heterogeneity into processor counts.
    """

    def __init__(self, n_nodes: int, node_speed: float = 1.0) -> None:
        if n_nodes < 1:
            raise ValueError("pool needs at least one node")
        self.speeds = np.full(int(n_nodes), float(node_speed))

    @property
    def n_nodes(self) -> int:
        return int(self.speeds.shape[0])

    def capacity(self) -> float:
        return float(self.speeds.sum())

    def apply(self, payload: object) -> None:
        if isinstance(payload, SetCapacity):
            self.speeds = np.full(
                self.n_nodes, float(payload.capacity) / self.n_nodes
            )
        elif isinstance(payload, SetNodeSpeed):
            if not 0 <= payload.node < self.n_nodes:
                raise IndexError(f"no node {payload.node}")
            if payload.speed < 0:
                raise ValueError("node speed must be >= 0")
            self.speeds[payload.node] = float(payload.speed)
        else:
            raise TypeError(f"pool cannot apply {type(payload).__name__}")


# ----------------------------------------------------------------------
# Duration noise (deviation from the p^α model)
# ----------------------------------------------------------------------
class NoNoise:
    """Task times follow the model exactly (factor 1)."""

    def factor(self, tree_id: int, task: int) -> float:
        return 1.0


@dataclass(frozen=True)
class LognormalNoise:
    """Multiplicative lognormal deviation, median 1.

    Keyed by (seed, tree, task): a task's factor is independent of when
    it is sampled, so traces are replayable.
    """

    sigma: float = 0.3
    seed: int = 0

    def factor(self, tree_id: int, task: int) -> float:
        rng = np.random.default_rng((self.seed, tree_id, task))
        return float(rng.lognormal(0.0, self.sigma))


@dataclass(frozen=True)
class UniformNoise:
    """Multiplicative uniform deviation on [lo, hi]."""

    lo: float = 0.7
    hi: float = 1.5
    seed: int = 0

    def factor(self, tree_id: int, task: int) -> float:
        rng = np.random.default_rng((self.seed, tree_id, task))
        return float(rng.uniform(self.lo, self.hi))


__all__ = [
    "Arrival",
    "Event",
    "EventQueue",
    "LognormalNoise",
    "NoNoise",
    "ProcessorPool",
    "SetCapacity",
    "SetNodeSpeed",
    "TaskFailure",
    "UniformNoise",
    "VirtualClock",
]
