"""Fault tolerance and elastic capacity — the paper's p(t) made operational.

The PM model is defined for *any* step-function processor profile p(t)
(§4), and Lemma 4/Theorem 6 prove the optimal allocation ratios are
invariant under p(t) changes — only absolute shares rescale.  That theorem
is this module's fault-tolerance story:

* node loss   → p(t) steps down → surviving tasks keep their ratios
* node rejoin → p(t) steps up   → ditto
* makespan under the new profile is Theorem 6's work-time inversion —
  no re-optimization, an O(1) update of the profile plus an O(n) replan of
  the discretized groups.

``ElasticController`` glues the heartbeat failure detector to the PM
planner; ``run_elastic_schedule`` simulates a tree execution under a
failure trace and verifies work conservation (used by tests/benchmarks).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import TaskTree
from repro_torch.core.pm import tree_equivalent_lengths
from repro_torch.core.profiles import Profile
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.online.events import EventQueue, SetCapacity
from repro_torch.sparse.plan import ExecutionPlan, make_plan, replan_elastic


# ----------------------------------------------------------------------
@dataclass
class HeartbeatMonitor:
    """Failure detector over a simulated clock: a node is dead when its last
    heartbeat is older than ``timeout``."""

    n_nodes: int
    timeout: float = 3.0
    last_seen: Dict[int, float] = field(default_factory=dict)

    def beat(self, node: int, t: float) -> None:
        self.last_seen[node] = t

    def alive(self, t: float) -> List[int]:
        return [
            i
            for i in range(self.n_nodes)
            if t - self.last_seen.get(i, 0.0) <= self.timeout
        ]

    def dead(self, t: float) -> List[int]:
        return [i for i in range(self.n_nodes) if i not in self.alive(t)]


# ----------------------------------------------------------------------
@dataclass
class ElasticEvent:
    time: float
    devices: int  # new total device count


@dataclass
class ElasticController:
    """Tracks capacity events and produces profiles/replans."""

    initial_devices: int
    events: List[ElasticEvent] = field(default_factory=list)

    def capacity_change(self, time: float, devices: int) -> None:
        self.events.append(ElasticEvent(time, devices))

    def profile(self) -> Profile:
        """p(t) from the event history (the paper's step function)."""
        steps: List[Tuple[float, float]] = []
        t_prev, p_prev = 0.0, float(self.initial_devices)
        for ev in sorted(self.events, key=lambda e: e.time):
            if ev.time > t_prev:
                steps.append((ev.time - t_prev, p_prev))
            t_prev, p_prev = ev.time, float(ev.devices)
        steps.append((np.inf, p_prev))
        return Profile.of(steps)

    def pm_makespan(self, tree: TaskTree, alpha: float) -> float:
        eq = tree_equivalent_lengths(tree, alpha)
        return self.profile().time_for_work(eq[tree.root], alpha)

    def online_events(self) -> List[Tuple[float, SetCapacity]]:
        """The capacity history as online-scheduler events, ready to
        ``OnlineScheduler.inject`` (the fault-tolerance path now runs
        through the discrete-event core)."""
        return [
            (ev.time, SetCapacity(float(ev.devices)))
            for ev in sorted(self.events, key=lambda e: e.time)
        ]


# ----------------------------------------------------------------------
def run_elastic_schedule(
    tree: TaskTree,
    alpha: float,
    initial_devices: int,
    failures: List[ElasticEvent],
) -> Tuple[float, List[ExecutionPlan]]:
    """Discretized execution under capacity events: plan, execute until the
    next event, replan the residual on the new capacity.  Returns the total
    makespan and the plan sequence.  The failure trace is drained through
    the online event core's heap (repro_torch.online.events) — same event
    plumbing as the fluid online scheduler, discretized plans on top."""
    plans: List[ExecutionPlan] = []
    t_global = 0.0
    devices = initial_devices
    remaining = tree
    queue = EventQueue()
    for ev in failures:
        queue.push(ev.time, SetCapacity(float(ev.devices)))
    guard = 0

    def publish(t0: float, t1: float, devs: int) -> None:
        """Each plan segment is a virtual-clock span; capacity edits
        become a counter track next to the online scheduler's."""
        if not obs_events.enabled():
            return
        if t1 > t0:
            obs_events.BUS.span(
                "run",
                t0,
                t1,
                cat="plan",
                key=len(plans) - 1,
                clock=obs_events.VIRTUAL,
                devices=devs,
            )
        obs_events.BUS.point(
            "capacity", devs, t=t1, clock=obs_events.VIRTUAL
        )
        obs_metrics.REGISTRY.counter(
            "repro_elastic_replans_total",
            "residual replans after capacity events",
        ).inc()

    while True:
        guard += 1
        if guard > len(failures) + 10:
            raise RuntimeError("elastic loop did not converge")
        plan = make_plan(remaining, devices, alpha)
        plans.append(plan)
        end = t_global + plan.makespan
        if queue and queue.peek_time() < end:
            ev = queue.pop()
            # execute until the event, then rebuild residual work
            local_t = ev.time - t_global
            residual = _residual_tree(remaining, plan, local_t)
            publish(t_global, ev.time, devices)
            t_global = ev.time
            devices = int(ev.payload.capacity)
            remaining = residual
            if remaining.lengths.sum() <= 1e-12:
                return t_global, plans
        else:
            publish(t_global, end, devices)
            return end, plans


def run_elastic_online(
    tree: TaskTree,
    alpha: float,
    initial_devices: int,
    failures: List[ElasticEvent],
    **scheduler_kwargs,
):
    """Fluid counterpart of :func:`run_elastic_schedule`: the same failure
    trace injected into the online event-driven scheduler.  With zero
    noise the returned makespan equals the Theorem-6 work-time inversion
    (``ElasticController.pm_makespan``) — ratio invariance, observed
    through the event core.  Returns (makespan, OnlineReport)."""
    from repro_torch.online.scheduler import OnlineScheduler

    sched = OnlineScheduler(initial_devices, alpha, **scheduler_kwargs)
    sched.submit(tree)
    for ev in failures:
        sched.inject(ev.time, SetCapacity(float(ev.devices)))
    report = sched.run()
    return report.makespan, report


def _residual_tree(tree: TaskTree, plan: ExecutionPlan, t: float) -> TaskTree:
    remaining = tree.lengths.astype(np.float64).copy()
    for p in plan.tasks:
        i = p.task
        if p.end <= t:
            remaining[i] = 0.0
        elif p.start < t < p.end:
            frac = (t - p.start) / (p.end - p.start)
            remaining[i] *= 1.0 - frac
    return TaskTree(
        parent=tree.parent.copy(), lengths=remaining, labels=tree.labels.copy()
    )


__all__ = [
    "ElasticController",
    "ElasticEvent",
    "HeartbeatMonitor",
    "replan_elastic",
    "run_elastic_online",
    "run_elastic_schedule",
]
