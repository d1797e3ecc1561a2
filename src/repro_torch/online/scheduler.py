"""Event-driven online PM scheduler: trees as a service, not a batch plan.

Lemma 4 / Theorem 6 make the PM allocation *ratios* invariant under any
processor profile p(t): the optimal reaction to any runtime event — a
task finishing off-model, a new tree arriving, a node dying or slowing
down — is to recompute ratios on whatever work remains, an O(n)
re-share, never a combinatorial replan.  :class:`OnlineScheduler` is
that loop made executable:

1. advance the virtual clock to the next event (external from the heap,
   or the earliest task completion at current rates);
2. pay down realized work of every running task, recording the §4 share
   pieces;
3. apply the event (state-machine transitions, pool edits, admissions);
4. re-share: split the live capacity over admitted trees by residual
   eq-length weights (the forest is a parallel composition — Lemma 4 at
   the virtual root) and within each tree by the policy's ratios.

Share policies:

* ``pm``           — Def. 1 / Lemma 4 ratios on the *estimated residual*
  tree, recomputed at every event (the paper's optimum, made online).
* ``proportional`` — Pothen–Sun subtree-weight ratios on the residual
  (α-unaware, §7's baseline), same event reactivity.
* ``static``       — PM ratios frozen at admission from nominal lengths;
  never re-shared, so off-model durations leave processors idle exactly
  as a precomputed `ExecutionPlan` would.  Serves one tree at a time.
* ``static-proportional`` — §7's PROPORTIONAL verbatim: the Pothen–Sun
  mapping is a one-shot assignment, frozen and α-unaware.

The emitted :class:`~repro_torch.core.schedule.ExplicitSchedule` (over the
combined label space of every admitted tree) must pass the §4 validity
predicates — ``OnlineReport.validate()`` checks resource, completeness
and precedence against the realized lengths and the recorded capacity
profile.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.baselines import proportional_shares
from repro_torch.core.graph import TaskTree
from repro_torch.core.pm import tree_equivalent_lengths, tree_pm_ratios
from repro_torch.core.profiles import Profile
from repro_torch.core.schedule import ExplicitSchedule
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics

from .events import (
    Arrival,
    EventQueue,
    NoNoise,
    ProcessorPool,
    SetCapacity,
    SetNodeSpeed,
    TaskFailure,
    VirtualClock,
)
from .queue import AdmissionQueue
from .state import (
    DONE,
    READY,
    RUNNING,
    RequestRecord,
    TreeFuture,
    TreeRun,
    combined_tree,
)

SHARE_POLICIES = ("pm", "proportional", "static", "static-proportional")


def _is_frozen(policy: str) -> bool:
    return policy.startswith("static")


# ----------------------------------------------------------------------
@dataclass
class OnlineReport:
    """Everything an online run produced, with the §4 audit attached."""

    alpha: float
    policy: str
    makespan: float
    futures: Dict[int, TreeFuture]
    schedule: ExplicitSchedule
    capacity_steps: List[Tuple[float, float]]
    eq_nominal: Dict[int, float]
    n_events: int
    n_reshares: int
    utilization: float
    runs: Dict[int, TreeRun] = field(repr=False, default_factory=dict)
    host_s: float = field(default=0.0, compare=False)  # wall seconds of run()

    # -- §4 audit -------------------------------------------------------
    def profile(self) -> Profile:
        """The recorded p(t) as a step profile (capacity clamped positive
        so the Profile invariant holds through total-outage windows)."""
        steps: List[Tuple[float, float]] = []
        t_prev, c_prev = self.capacity_steps[0][0], self.capacity_steps[0][1]
        for t, c in self.capacity_steps[1:]:
            if t > t_prev:
                steps.append((t - t_prev, max(c_prev, 1e-12)))
            t_prev, c_prev = t, c
        steps.append((math.inf, max(c_prev, 1e-12)))
        return Profile.of(steps)

    def combined_tree(self) -> TaskTree:
        """All trees under one virtual root, realized lengths (state.py)."""
        return combined_tree(self.runs)

    def validate(self, rtol: float = 1e-6) -> None:
        """Assert the §4 predicates (resource, completeness, precedence)
        on the emitted schedule against realized lengths and p(t)."""
        self.schedule.validate(self.combined_tree(), self.profile(), rtol)

    def fluid_lower_bound(self) -> float:
        """Theorem 6 lower bound: the PM fluid makespan of the realized
        forest under the recorded profile (exact when every tree is
        submitted at t=0; still a valid bound otherwise)."""
        tree = self.combined_tree()
        eq = tree_equivalent_lengths(tree, self.alpha)[tree.root]
        return self.profile().time_for_work(eq, self.alpha)

    def tree_lower_bound(self, tree_id: int) -> float:
        """Per-tree bound: even alone on the whole pool from admission,
        tree ``tree_id`` cannot beat its own PM fluid optimum."""
        run = self.runs[tree_id]
        rt = TaskTree(run.tree.parent.copy(), run.realized_lengths())
        eq = tree_equivalent_lengths(rt, self.alpha)[rt.root]
        t0 = run.future.t_admit
        prof = self.profile().restricted_after(t0)
        return t0 + prof.time_for_work(eq, self.alpha)

    # -- service metrics ------------------------------------------------
    def latencies(self) -> Dict[int, float]:
        """tree_id → submit-to-completion latency (completed trees)."""
        return {
            k: f.latency for k, f in self.futures.items() if f.state == "done"
        }

    def mean_latency(self) -> float:
        lat = list(self.latencies().values())
        return float(np.mean(lat)) if lat else 0.0

    def mean_service(self) -> float:
        svc = [
            f.service for f in self.futures.values() if f.state == "done"
        ]
        return float(np.mean(svc)) if svc else 0.0

    def request_results(self) -> List[RequestRecord]:
        """Per-request records with the latency *split*: admission wait
        (submit → admit) vs execution time (admit → done), one per
        completed tree in submission order."""
        return [
            RequestRecord.of_future(f)
            for _, f in sorted(self.futures.items())
            if f.state == "done"
        ]

    def mean_wait(self) -> float:
        """Mean admission wait (submit → admit) over completed trees."""
        waits = [r.wait for r in self.request_results()]
        return float(np.mean(waits)) if waits else 0.0

    def task_records(self, tree_id: int) -> List[Tuple[int, float, float, float]]:
        """[(task, t_start, t_done, mean_share)] of one tree — the replay
        bridge's input (repro_torch.online.replay)."""
        run = self.runs[tree_id]
        out = []
        for i, ts in enumerate(run.tasks):
            pieces = self.schedule.pieces.get(run.label_base + i, [])
            dur = sum(p.t1 - p.t0 for p in pieces)
            mean_share = (
                sum((p.t1 - p.t0) * p.share for p in pieces) / dur
                if dur > 0
                else 0.0
            )
            out.append((i, ts.t_start, ts.t_done, mean_share))
        return out

    def summary(self) -> str:
        done = sum(1 for f in self.futures.values() if f.state == "done")
        failed = sum(1 for f in self.futures.values() if f.state == "failed")
        return (
            f"online[{self.policy}] {done} trees done"
            + (f", {failed} failed" if failed else "")
            + f" | makespan {self.makespan:.6g}"
            + f" | mean latency {self.mean_latency():.6g}"
            + f" | util {self.utilization:.1%}"
            + f" | {self.n_events} events, {self.n_reshares} re-shares"
        )


# ----------------------------------------------------------------------
class OnlineScheduler:
    """Discrete-event malleable-tree scheduler over a live processor pool.

    Parameters
    ----------
    pool : ProcessorPool or int (number of healthy unit-speed nodes).
    alpha : the p^α exponent the shares are computed with.
    policy : ``pm`` | ``proportional`` | ``static`` (see module doc).
    noise : duration-noise model (events.NoNoise/LognormalNoise/...).
    speedup_floor : §7's realistic floor — rate s (not s^α) for s < 1.
    admission : AdmissionQueue; defaults to unbounded FIFO.
    memory_capacity : bytes of memory the pool offers; admitted trees'
        minimal peaks (Liu's sequential bound) must fit in it together.
        A tree that can never fit is refused at ``submit``; one that
        cannot fit *now* waits in admission.  None / inf = unbounded.
    """

    def __init__(
        self,
        pool,
        alpha: float,
        *,
        policy: str = "pm",
        noise=None,
        speedup_floor: bool = False,
        admission: Optional[AdmissionQueue] = None,
        memory_capacity: Optional[float] = None,
    ) -> None:
        if policy not in SHARE_POLICIES:
            raise ValueError(f"unknown share policy {policy!r}")
        self.pool = (
            pool if isinstance(pool, ProcessorPool) else ProcessorPool(pool)
        )
        self.alpha = float(alpha)
        self.policy = policy
        self.noise = noise if noise is not None else NoNoise()
        self.speedup_floor = speedup_floor
        # NB: an empty AdmissionQueue is falsy — test against None, not truth
        self.admission = (
            admission if admission is not None else AdmissionQueue("fifo", None)
        )
        if _is_frozen(policy) and self.admission.max_concurrent != 1:
            # frozen shares of overlapping trees would break the §4
            # resource bound — static serving is inherently sequential.
            # Re-wrap rather than mutate the caller's queue.
            self.admission = AdmissionQueue(self.admission.policy, 1)

        self.memory_capacity = (
            math.inf if memory_capacity is None else float(memory_capacity)
        )
        if self.memory_capacity <= 0:
            raise ValueError("memory_capacity must be positive")
        self._mem_peak: Dict[int, float] = {}  # tree_id → minimal peak bytes

        self.clock = VirtualClock()
        self.events = EventQueue()
        self.runs: Dict[int, TreeRun] = {}
        self.admitted: List[int] = []
        self.schedule = ExplicitSchedule(self.alpha)
        self.eq_nominal: Dict[int, float] = {}
        self.service_by_tenant: Dict[int, float] = {}
        self._frozen: Dict[int, np.ndarray] = {}
        self._cap_history: List[Tuple[float, float]] = [
            (0.0, self.pool.capacity())
        ]
        self._next_base = 1  # combined label space; 0 = virtual root
        self._n_injected = 0
        self._n_events = 0
        self._n_reshares = 0
        self._busy_integral = 0.0
        self._cap_integral = 0.0

    # ------------------------------------------------------------------
    def submit(
        self,
        tree,
        at: Optional[float] = None,
        tenant: int = 0,
        rid: Optional[int] = None,
    ) -> TreeFuture:
        """Register a tree; it arrives (enters admission) at ``at``.

        ``tree`` may be a :class:`TaskTree` or a
        :class:`repro_torch.api.problem.Problem` — the shared problem is the
        single source of α and equivalent lengths, so admission (SJF by
        𝓛) and execution cannot drift.  A problem whose α differs from
        the scheduler's is refused.
        """
        from repro_torch.api.problem import Problem  # deferred: api ← online

        mem_peak = 0.0
        if isinstance(tree, Problem):
            problem = tree
            if abs(problem.alpha - self.alpha) > 1e-12:
                raise ValueError(
                    f"problem has alpha={problem.alpha}, scheduler runs "
                    f"alpha={self.alpha}"
                )
            tree, eq_root = problem.tree, problem.eq_root
            mem_peak = problem.min_peak_memory()
            if mem_peak > self.memory_capacity * (1 + 1e-12):
                raise ValueError(
                    f"problem {problem.name!r} needs at least "
                    f"{mem_peak:.4g} B resident (Liu bound), over the "
                    f"pool's {self.memory_capacity:.4g} B — refused"
                )
        else:
            eq_root = float(
                tree_equivalent_lengths(tree, self.alpha)[tree.root]
            )
        tree_id = len(self.runs)
        t = self.clock.now if at is None else max(float(at), self.clock.now)
        run = TreeRun(
            tree_id,
            tree,
            self.noise,
            t_submit=t,
            rid=rid,
            tenant=tenant,
            label_base=self._next_base,
        )
        self._next_base += tree.n
        self.runs[tree_id] = run
        self.eq_nominal[tree_id] = eq_root
        self._mem_peak[tree_id] = mem_peak
        self.inject(t, Arrival(tree_id))
        return run.future

    def inject(self, at: float, payload) -> None:
        """Push an external event (capacity, slowdown, failure, ...)."""
        self.events.push(max(float(at), self.clock.now), payload)
        self._n_injected += 1

    # ------------------------------------------------------------------
    def _rate(self, share: float) -> float:
        if share <= 0:
            return 0.0
        if self.speedup_floor and share < 1.0:
            return share
        return share**self.alpha

    def _active_runs(self) -> List[TreeRun]:
        return [self.runs[k] for k in self.admitted]

    def _next_completion(self) -> float:
        t_best = math.inf
        for run in self._active_runs():
            for i in run.active_tasks():
                ts = run.tasks[i]
                r = self._rate(ts.share)
                if ts.state == RUNNING and r > 0:
                    t_best = min(t_best, self.clock.now + ts.remaining / r)
        return t_best

    def _advance_to(self, t: float) -> None:
        dt = t - self.clock.now
        if dt <= 0:
            self.clock.advance(t)
            return
        t0 = self.clock.now
        cap = self.pool.capacity()
        self._cap_integral += cap * dt
        for run in self._active_runs():
            tree_share = 0.0
            for i in run.active_tasks():
                ts = run.tasks[i]
                if ts.state == RUNNING and ts.share > 0:
                    ts.remaining = max(
                        0.0, ts.remaining - dt * self._rate(ts.share)
                    )
                    self._add_piece(run.label_base + i, t0, t, ts.share)
                    tree_share += ts.share
            if tree_share > 0:
                self._busy_integral += tree_share * dt
                ten = run.future.tenant
                self.service_by_tenant[ten] = (
                    self.service_by_tenant.get(ten, 0.0) + tree_share * dt
                )
        self.clock.advance(t)

    def _add_piece(self, label: int, t0: float, t1: float, share: float) -> None:
        """Append a share piece, merging with a contiguous equal-share
        predecessor so re-shares that keep a ratio don't fragment."""
        ps = self.schedule.pieces.get(label)
        if (
            ps
            and abs(ps[-1].t1 - t0) <= 1e-12 * max(1.0, abs(t0))
            and ps[-1].share == share
        ):
            ps[-1].t1 = t1
        else:
            self.schedule.add(label, t0, t1, share)

    # ------------------------------------------------------------------
    def _process_completions(self) -> bool:
        """Mark done every active task whose realized work is exhausted,
        cascading readiness (zero-length tasks chain instantly)."""
        t = self.clock.now
        changed = False
        for run in self._active_runs():
            if run.failed():
                continue
            frontier = run.active_tasks()
            while frontier:
                nxt: List[int] = []
                for i in frontier:
                    ts = run.tasks[i]
                    if ts.state not in (READY, RUNNING):
                        continue
                    ctol = max(1e-12, 1e-9 * ts.realized)
                    if ts.remaining <= ctol:
                        nxt.extend(run.mark_done(i, t))
                        changed = True
                frontier = nxt
            if run.complete():
                run.finish(t)
        self.admitted = [
            k
            for k in self.admitted
            if not (self.runs[k].complete() or self.runs[k].failed())
        ]
        return changed

    def _apply(self, payload) -> None:
        t = self.clock.now
        if isinstance(payload, Arrival):
            run = self.runs[payload.tree_id]
            self.admission.push(
                payload.tree_id,
                run.future.tenant,
                self.eq_nominal[payload.tree_id],
                mem=self._mem_peak.get(payload.tree_id, 0.0),
            )
        elif isinstance(payload, (SetCapacity, SetNodeSpeed)):
            self.pool.apply(payload)
            self._cap_history.append((t, self.pool.capacity()))
        elif isinstance(payload, TaskFailure):
            run = self.runs.get(payload.tree_id)
            if run is None or run.complete() or run.failed():
                return
            ts = run.tasks[payload.task]
            if ts.state == DONE:
                return
            if payload.retry:
                ts.remaining = ts.realized  # progress lost, redo
            else:
                run.fail(t, f"task {payload.task} failed (no retry)")
                self.admitted = [
                    k for k in self.admitted if k != payload.tree_id
                ]
        else:
            raise TypeError(f"unknown event payload {type(payload).__name__}")

    def _mem_free(self) -> float:
        """Bytes of the memory pool not reserved by admitted trees."""
        if not math.isfinite(self.memory_capacity):
            return math.inf
        in_use = sum(self._mem_peak.get(k, 0.0) for k in self.admitted)
        return self.memory_capacity - in_use

    def _try_admit(self) -> None:
        admitted_any = False
        while self.admission.can_admit(len(self.admitted), self._mem_free()):
            pend = self.admission.pop_next(
                self.service_by_tenant, self._mem_free()
            )
            run = self.runs[pend.tree_id]
            self.admitted.append(pend.tree_id)
            run.admit(self.clock.now)
            admitted_any = True
            if self.policy == "static":
                self._frozen[pend.tree_id] = tree_pm_ratios(
                    run.tree, self.alpha
                )
            elif self.policy == "static-proportional":
                self._frozen[pend.tree_id] = proportional_shares(run.tree, 1.0)
        if admitted_any and obs_events.enabled():
            obs_events.BUS.point(
                "admission_queue_depth",
                len(self.admission),
                t=self.clock.now,
                clock=obs_events.VIRTUAL,
            )

    # ------------------------------------------------------------------
    def _reshare(self) -> None:
        """The O(n) Lemma-4 re-share over every admitted tree."""
        runs = self._active_runs()
        if not runs:
            return
        self._n_reshares += 1
        cap = self.pool.capacity()
        inv = 1.0 / self.alpha
        ratios_by_run: Dict[int, np.ndarray] = {}
        weights: List[float] = []
        for run in runs:
            if _is_frozen(self.policy):
                ratios_by_run[run.tree_id] = self._frozen[run.tree_id]
                weights.append(1.0)  # sequential: the only admitted tree
                continue
            res = TaskTree(run.tree.parent, run.estimated_residual())
            if self.policy == "pm":
                eq = tree_equivalent_lengths(res, self.alpha)
                ratios_by_run[run.tree_id] = tree_pm_ratios(res, self.alpha)
                weights.append(float(eq[res.root]) ** inv)
            else:  # proportional: α-unaware subtree-weight split
                ratios_by_run[run.tree_id] = proportional_shares(res, 1.0)
                weights.append(float(res.lengths.sum()))  # = root subtree weight
        denom = sum(weights)
        for run, w in zip(runs, weights):
            frac = w / denom if denom > 0 else 0.0
            ratios = ratios_by_run[run.tree_id]
            for i in run.active_tasks():
                ts = run.tasks[i]
                share = frac * float(ratios[i]) * cap
                ts.share = share
                if ts.state == READY and share > 0:
                    run.start(i, self.clock.now)

    # ------------------------------------------------------------------
    def run(self, until: float = math.inf) -> OnlineReport:
        """Drive the event loop until every tree resolves (or ``until``)."""
        t_run0 = time.perf_counter()
        total_tasks = sum(r.n for r in self.runs.values())
        guard_max = 10 * (total_tasks + self._n_injected) + 100
        guard = 0
        while True:
            guard += 1
            if guard > guard_max:
                raise RuntimeError("online event loop did not converge")
            t_ext = self.events.peek_time()
            t_comp = self._next_completion()
            t_next = min(t_ext, t_comp)
            if not math.isfinite(t_next) or t_next > until:
                break
            self._advance_to(t_next)
            self._n_events += 1
            changed = self._process_completions()
            eps = 1e-12 * max(1.0, abs(self.clock.now))
            for ev in self.events.pop_until(self.clock.now + eps):
                self._apply(ev.payload)
                changed = True
            if changed:
                self._process_completions()  # zero-length arrivals etc.
                self._try_admit()
                self._reshare()
        report = self._report()
        report.host_s = time.perf_counter() - t_run0
        return report

    def _report(self) -> OnlineReport:
        t_end = max(
            (
                r.future.t_done
                for r in self.runs.values()
                if r.future.done()
            ),
            default=self.clock.now,
        )
        util = (
            self._busy_integral / self._cap_integral
            if self._cap_integral > 0
            else 0.0
        )
        report = OnlineReport(
            alpha=self.alpha,
            policy=self.policy,
            makespan=float(t_end),
            futures={k: r.future for k, r in self.runs.items()},
            schedule=self.schedule,
            capacity_steps=list(self._cap_history),
            eq_nominal=dict(self.eq_nominal),
            n_events=self._n_events,
            n_reshares=self._n_reshares,
            utilization=float(util),
            runs=dict(self.runs),
        )
        if obs_events.enabled():
            self._publish_obs(report)
        return report

    def _publish_obs(self, report: OnlineReport) -> None:
        """Publish the run to the obs bus (virtual clock) and registry.

        One ``tree`` span per admitted tree (admit → done), one ``task``
        span per task (start → done), capacity steps as a counter track,
        and the per-tenant admission wait into its histogram — the §4
        share pieces themselves stay on ``report.schedule`` (the
        efficiency module folds them into p̂(t) directly).
        """
        bus = obs_events.BUS
        reg = obs_metrics.REGISTRY
        wait_h = reg.histogram(
            "repro_admission_wait_seconds",
            "request arrival -> admission (virtual time)",
            unit="s",
        )
        for k, run in report.runs.items():
            fut = run.future
            if not math.isnan(fut.t_admit) and not math.isnan(fut.t_done):
                bus.span(
                    "run",
                    fut.t_admit,
                    fut.t_done,
                    cat="tree",
                    key=k,
                    clock=obs_events.VIRTUAL,
                    tenant=fut.tenant,
                    failed=run.failed(),
                )
            if not math.isnan(fut.t_admit):
                wait = fut.t_admit - fut.t_submit
                wait_h.observe(wait)
                if wait > 0:
                    bus.span(
                        "ready",
                        fut.t_submit,
                        fut.t_admit,
                        cat="tree",
                        key=k,
                        clock=obs_events.VIRTUAL,
                        tenant=fut.tenant,
                    )
            for i, ts in enumerate(run.tasks):
                if not math.isnan(ts.t_start) and not math.isnan(ts.t_done):
                    if ts.t_done > ts.t_start:
                        bus.span(
                            "run",
                            ts.t_start,
                            ts.t_done,
                            cat="task",
                            key=run.label_base + i,
                            clock=obs_events.VIRTUAL,
                            tree=k,
                        )
        for t, cap in report.capacity_steps:
            bus.point("capacity", cap, t=t, clock=obs_events.VIRTUAL)
        reg.counter(
            "repro_online_events_total", "online scheduler events processed"
        ).inc(report.n_events)
        reg.counter(
            "repro_online_reshares_total", "Lemma-4 O(n) re-shares"
        ).inc(report.n_reshares)
        reg.gauge(
            "repro_online_utilization",
            "busy-share integral / capacity integral",
        ).set(report.utilization)


__all__ = ["OnlineReport", "OnlineScheduler", "SHARE_POLICIES"]
