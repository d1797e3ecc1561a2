"""One schedule type and one run-report type for every subsystem.

Before the facade each planner had its own result: ``PMSchedule``
(work-time intervals), ``ExplicitSchedule`` (§4 share pieces),
``ExecutionPlan`` (discretized device groups), ``OnlineReport`` (event
audit) and ``ExecutionReport`` (measured trace).  :class:`Schedule` is
the common denominator they all convert into — a list of wall-clock
share entries plus the two numbers every comparison needs (makespan and
the Theorem-6 fluid lower bound) — with the shared services attached:

* §4 validation (resource / completeness / precedence) via the existing
  :meth:`~repro_torch.core.schedule.ExplicitSchedule.validate` engine,
* JSON round-trip, so plans can be cached and shipped between planner
  and executor processes,
* Gantt / chrome-trace export,
* conversion back to an :class:`~repro_torch.sparse.plan.ExecutionPlan` for
  the wave executor (exact when the schedule is discretized; pow-2
  rounding of time-averaged shares otherwise).

:class:`RunReport` is the uniform result of running one — simulated
(online event loop), executed (torch devices), or served (request stream).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.memory import MemoryTimeline, memory_timeline
from repro_torch.core.profiles import Profile
from repro_torch.core.schedule import ExplicitSchedule

# v1: no memory timeline.  v2: adds the optional "memory" block
# (resident-bytes steps + peak + per-node peaks + planning budget).
# Loading stays backward compatible: v1 documents deserialize with
# ``memory=None``.
_JSON_VERSION = 2
_READABLE_VERSIONS = (1, 2)


# ----------------------------------------------------------------------
@dataclass(frozen=True)
class ShareEntry:
    """One task holding a constant share over a wall-clock interval."""

    task: int  # tree index
    label: int  # user-facing label (supernode id; -1 for virtual)
    start: float
    end: float
    share: float  # processors (fractional: fluid; integral: device group)

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class Schedule:
    """Canonical schedule: wall-clock share entries + the two makespans.

    ``fluid_makespan`` is always the PM optimum of the same problem on
    the same platform (Theorem 6), so ``efficiency()`` measures distance
    to the true lower bound regardless of which policy produced the
    schedule.  ``discretized`` marks integral device-group shares (the
    executable kind).  ``meta`` holds policy-specific extras (placements
    for the §6 partitioners, λ for the FPTAS, ...) and must stay
    JSON-serializable.
    """

    alpha: float
    policy: str
    platform: str
    capacity: float
    entries: List[ShareEntry]
    makespan: float
    fluid_makespan: float
    discretized: bool = False
    profile_steps: Optional[List[Tuple[float, float]]] = None
    memory: Optional[MemoryTimeline] = None
    meta: Dict = field(default_factory=dict)
    _plan: Optional[object] = field(default=None, repr=False, compare=False)

    # -- derived --------------------------------------------------------
    def efficiency(self) -> float:
        """Fluid-optimum / achieved (1.0 = provably optimal)."""
        return self.fluid_makespan / self.makespan if self.makespan > 0 else 1.0

    def work_of(self, task: int) -> float:
        return sum(
            e.duration * e.share**self.alpha
            for e in self.entries
            if e.task == task
        )

    def tasks(self) -> List[int]:
        return sorted({e.task for e in self.entries})

    def profile(self) -> Profile:
        """The capacity profile the schedule was planned against."""
        if self.profile_steps:
            return Profile.of([(d, p) for d, p in self.profile_steps])
        return Profile.constant(self.capacity)

    # -- the memory dimension -------------------------------------------
    def _task_spans(self) -> Dict[int, Tuple[float, float]]:
        spans: Dict[int, Tuple[float, float]] = {}
        for e in self.entries:
            t0, t1 = spans.get(e.task, (e.start, e.end))
            spans[e.task] = (min(t0, e.start), max(t1, e.end))
        return spans

    def attach_memory(self, problem, budget: float = math.inf) -> "Schedule":
        """Compute and attach the resident-bytes timeline of this
        schedule under ``problem``'s footprints.

        No-op (returns ``self``) when the problem has no memory model or
        the schedule is placement-only; the memory accessors then stay
        unavailable rather than reporting a fake zero.
        """
        fp = problem.memory_footprints()
        if fp is None or not self.entries:
            return self
        self.memory = memory_timeline(
            problem.tree.parent, self._task_spans(), fp, budget=budget
        )
        return self

    def _require_memory(self) -> MemoryTimeline:
        if self.memory is None:
            raise ValueError(
                f"schedule from policy {self.policy!r} has no memory "
                f"timeline; plan via Session with a problem that carries "
                f"footprints, or call attach_memory(problem)"
            )
        return self.memory

    def memory_profile(self) -> List[Tuple[float, float]]:
        """Resident bytes over time as ``(t, bytes)`` steps."""
        return list(self._require_memory().steps)

    def peak_memory(self) -> float:
        """Peak resident bytes (includes the extend-add transient)."""
        return self._require_memory().peak

    def node_peaks(self) -> Dict[int, float]:
        """Per-memory-node peak bytes (``{0: peak}`` without placement)."""
        return dict(self._require_memory().node_peaks)

    # -- §4 validation (shared across every producing policy) -----------
    def to_explicit(self) -> ExplicitSchedule:
        es = ExplicitSchedule(self.alpha)
        for e in self.entries:
            if e.end > e.start:
                es.add(e.task, e.start, e.end, e.share)
        return es

    def validate(self, problem, rtol: float = 1e-6) -> None:
        """Assert the §4 validity predicates against ``problem``, plus
        the memory predicate when a timeline is attached.

        Placement-only schedules (the §6 partitioners return node
        assignments, not share functions) have no entries to check and
        raise so a caller cannot mistake "nothing checked" for "valid".

        The memory check re-derives the resident-bytes timeline from the
        entries and the problem's footprints (so a tampered serialized
        timeline cannot certify itself) and asserts the peak stays
        within the recorded planning budget.
        """
        if not self.entries:
            raise ValueError(
                f"schedule from policy {self.policy!r} is placement-only; "
                f"there are no share pieces to validate"
            )
        self.to_explicit().validate(problem.tree, self.profile(), rtol)
        if self.memory is not None:
            fp = problem.memory_footprints()
            if fp is not None:
                fresh = memory_timeline(
                    problem.tree.parent, self._task_spans(), fp
                )
                assert fresh.peak <= self.memory.peak * (1 + rtol) + 1.0, (
                    f"memory timeline understates the peak: recomputed "
                    f"{fresh.peak:.6g} B > recorded {self.memory.peak:.6g} B"
                )
            if math.isfinite(self.memory.budget):
                assert self.memory.peak <= self.memory.budget * (1 + rtol), (
                    f"peak memory {self.memory.peak:.6g} B exceeds the "
                    f"planning budget {self.memory.budget:.6g} B"
                )

    # -- executor bridge ------------------------------------------------
    def to_execution_plan(self):
        """An :class:`~repro_torch.sparse.plan.ExecutionPlan` for the executor.

        A discretized schedule converts exactly (this is how a plan
        shipped as JSON becomes executable again); a fluid one gets its
        time-averaged shares rounded to power-of-two groups.
        """
        from repro_torch.sparse.plan import (
            ExecutionPlan,
            PlannedTask,
            pow2_devices,
        )

        if self._plan is not None:
            return self._plan
        if not self.entries:
            raise ValueError(
                f"schedule from policy {self.policy!r} has no entries to "
                f"convert into an ExecutionPlan"
            )
        total = int(round(self.capacity))
        by_task: Dict[int, List[ShareEntry]] = {}
        for e in self.entries:
            by_task.setdefault(e.task, []).append(e)
        tasks = []
        for t, es in sorted(by_task.items()):
            start = min(e.start for e in es)
            end = max(e.end for e in es)
            dur = sum(e.duration for e in es)
            mean_share = (
                sum(e.duration * e.share for e in es) / dur if dur > 0 else 0.0
            )
            if self.discretized:
                g = int(round(max(e.share for e in es)))
            else:
                g = pow2_devices(mean_share, total)
            if dur <= 0:
                g = 0
            tasks.append(
                PlannedTask(
                    task=t,
                    label=es[0].label,
                    devices=g,
                    start=float(start),
                    end=float(end),
                )
            )
        plan = ExecutionPlan(
            tasks=tasks,
            makespan=float(self.makespan),
            fluid_makespan=float(self.fluid_makespan),
            total_devices=total,
            alpha=self.alpha,
            strategy=self.policy,
        )
        self._plan = plan
        return plan

    # -- JSON round-trip ------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "version": _JSON_VERSION,
            "kind": "schedule",
            "alpha": self.alpha,
            "policy": self.policy,
            "platform": self.platform,
            "capacity": self.capacity,
            "discretized": self.discretized,
            "makespan": self.makespan,
            "fluid_makespan": self.fluid_makespan,
            "profile_steps": (
                [[d if math.isfinite(d) else "inf", p] for d, p in self.profile_steps]
                if self.profile_steps is not None
                else None
            ),
            "entries": [
                [e.task, e.label, e.start, e.end, e.share]
                for e in self.entries
            ],
            "memory": self.memory.to_dict() if self.memory is not None else None,
            "meta": self.meta,
        }

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict) -> "Schedule":
        if d.get("kind") != "schedule":
            raise ValueError("not a serialized Schedule")
        if d.get("version") not in _READABLE_VERSIONS:
            raise ValueError(f"unsupported schedule version {d.get('version')}")
        steps = d.get("profile_steps")
        mem = d.get("memory")  # absent in v1 documents
        return cls(
            alpha=float(d["alpha"]),
            policy=str(d["policy"]),
            platform=str(d["platform"]),
            capacity=float(d["capacity"]),
            entries=[
                ShareEntry(int(t), int(l), float(a), float(b), float(s))
                for t, l, a, b, s in d["entries"]
            ],
            makespan=float(d["makespan"]),
            fluid_makespan=float(d["fluid_makespan"]),
            discretized=bool(d["discretized"]),
            profile_steps=(
                [
                    (math.inf if du == "inf" else float(du), float(p))
                    for du, p in steps
                ]
                if steps is not None
                else None
            ),
            memory=MemoryTimeline.from_dict(mem) if mem else None,
            meta=dict(d.get("meta", {})),
        )

    @classmethod
    def from_json(cls, s: str) -> "Schedule":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Schedule":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- exports --------------------------------------------------------
    def gantt(self, width: int = 60, max_rows: int = 40) -> str:
        """ASCII Gantt chart (one row per task, time left → right)."""
        if not self.entries:
            return f"(placement-only schedule: {self.meta.get('placement')})"
        span = max(self.makespan, max(e.end for e in self.entries), 1e-12)
        by_task: Dict[int, List[ShareEntry]] = {}
        for e in self.entries:
            by_task.setdefault(e.task, []).append(e)
        rows = []
        order = sorted(
            by_task, key=lambda t: min(e.start for e in by_task[t])
        )
        for t in order[:max_rows]:
            line = [" "] * width
            for e in by_task[t]:
                a = int(e.start / span * (width - 1))
                b = max(int(e.end / span * (width - 1)), a)
                for k in range(a, b + 1):
                    line[k] = "█" if e.share >= 1 else "▒"
            label = by_task[t][0].label
            rows.append(f"{label:>6d} |{''.join(line)}|")
        if len(order) > max_rows:
            rows.append(f"  ... ({len(order) - max_rows} more tasks)")
        header = (
            f"{self.policy} on {self.platform}: makespan {self.makespan:.4g}"
            f" (fluid LB {self.fluid_makespan:.4g},"
            f" eff {self.efficiency():.1%})"
        )
        return "\n".join([header] + rows)

    def to_trace(self, time_scale: float = 1e6) -> List[Dict]:
        """Chrome trace-event export (load in ui.perfetto.dev).

        Thin wrapper over :func:`repro_torch.obs.trace.from_schedule` — all
        trace emitters share one field set.
        """
        from repro_torch.obs import trace as obs_trace

        return obs_trace.from_schedule(self, time_scale)

    # -- conversions from the legacy result types -----------------------
    @classmethod
    def from_explicit(
        cls,
        es: ExplicitSchedule,
        *,
        policy: str,
        platform: str,
        capacity: float,
        fluid_makespan: float,
        makespan: Optional[float] = None,
        labels: Optional[Sequence[int]] = None,
        profile_steps: Optional[Sequence[Tuple[float, float]]] = None,
        meta: Optional[Dict] = None,
    ) -> "Schedule":
        entries = [
            ShareEntry(
                task=t,
                label=int(labels[t]) if labels is not None else t,
                start=p.t0,
                end=p.t1,
                share=p.share,
            )
            for t, ps in sorted(es.pieces.items())
            for p in ps
        ]
        entries.sort(key=lambda e: (e.start, e.task))
        return cls(
            alpha=es.alpha,
            policy=policy,
            platform=platform,
            capacity=float(capacity),
            entries=entries,
            makespan=float(es.makespan() if makespan is None else makespan),
            fluid_makespan=float(fluid_makespan),
            discretized=False,
            profile_steps=list(profile_steps) if profile_steps else None,
            meta=meta or {},
        )

    @classmethod
    def from_plan(
        cls,
        plan,
        *,
        policy: str,
        platform: str,
        meta: Optional[Dict] = None,
    ) -> "Schedule":
        """From an :class:`~repro_torch.sparse.plan.ExecutionPlan` (exact)."""
        entries = [
            ShareEntry(
                task=t.task,
                label=t.label,
                start=t.start,
                end=t.end,
                share=float(t.devices),
            )
            for t in plan.tasks
        ]
        entries.sort(key=lambda e: (e.start, e.task))
        return cls(
            alpha=plan.alpha,
            policy=policy,
            platform=platform,
            capacity=float(plan.total_devices),
            entries=entries,
            makespan=float(plan.makespan),
            fluid_makespan=float(plan.fluid_makespan),
            discretized=True,
            meta={**(meta or {}), "strategy": plan.strategy},
            _plan=plan,
        )

    @classmethod
    def from_online(
        cls,
        report,
        *,
        policy: str,
        platform: str,
        fluid_makespan: Optional[float] = None,
        tree_id: Optional[int] = None,
        meta: Optional[Dict] = None,
    ) -> "Schedule":
        """From an :class:`~repro_torch.online.scheduler.OnlineReport`.

        With ``tree_id`` the combined label space is mapped back onto
        that tree's task indices; otherwise entries keep the combined
        indices (multi-tree serving).
        """
        if tree_id is not None:
            run = report.runs[tree_id]
            base, n = run.label_base, run.n
            labels = run.tree.labels

            def remap(lbl):
                if base <= lbl < base + n:
                    i = lbl - base
                    return i, int(labels[i])
                return None
        else:

            def remap(lbl):
                return lbl, lbl

        entries = []
        for lbl, ps in sorted(report.schedule.pieces.items()):
            m = remap(lbl)
            if m is None:
                continue
            t, user = m
            for p in ps:
                entries.append(ShareEntry(t, user, p.t0, p.t1, p.share))
        entries.sort(key=lambda e: (e.start, e.task))
        steps = [
            (t1 - t0, max(c0, 1e-12))
            for (t0, c0), (t1, _) in zip(
                report.capacity_steps, report.capacity_steps[1:]
            )
            if t1 > t0
        ]
        last_cap = report.capacity_steps[-1][1]
        steps.append((math.inf, max(last_cap, 1e-12)))
        return cls(
            alpha=report.alpha,
            policy=policy,
            platform=platform,
            capacity=float(report.capacity_steps[0][1]),
            entries=entries,
            makespan=float(report.makespan),
            fluid_makespan=float(
                report.fluid_lower_bound()
                if fluid_makespan is None
                else fluid_makespan
            ),
            discretized=False,
            profile_steps=steps,
            meta={
                **(meta or {}),
                "n_events": report.n_events,
                "n_reshares": report.n_reshares,
                "utilization": report.utilization,
            },
        )


# ----------------------------------------------------------------------
@dataclass
class RunReport:
    """Uniform result of running a schedule.

    ``kind`` is ``planned`` (no run — just the schedule), ``simulated``
    (online event loop), ``executed`` (torch devices) or ``served``
    (request stream).  ``schedule`` is the realized schedule of the run;
    ``planned`` the pre-run schedule when the two differ.  ``detail``
    keeps the subsystem-native report (OnlineReport / ExecutionReport)
    for deep inspection; ``artifact`` carries a run's product (the
    numeric :class:`~repro_torch.sparse.multifrontal.Factorization`).
    """

    kind: str
    schedule: Schedule
    makespan: float
    fluid_makespan: float
    planned: Optional[Schedule] = None
    metrics: Dict[str, float] = field(default_factory=dict)
    detail: object = field(default=None, repr=False)
    artifact: object = field(default=None, repr=False)

    def efficiency(self) -> float:
        return self.fluid_makespan / self.makespan if self.makespan > 0 else 1.0

    def summary(self) -> str:
        head = (
            f"{self.kind}[{self.schedule.policy} on {self.schedule.platform}]"
            f" makespan {self.makespan:.6g}"
            f" | fluid LB {self.fluid_makespan:.6g}"
            f" ({self.efficiency():.1%} of optimal)"
        )
        extras = [f"{k}={v:.6g}" for k, v in sorted(self.metrics.items())]
        return head + (" | " + " ".join(extras) if extras else "")

    def save_html(self, path) -> str:
        """Dump the run as a static HTML observability report: not ported
        yet."""
        raise NotImplementedError(
            "RunReport.save_html needs repro_torch.obs.dashboard, not ported "
            "yet (ROADMAP queue 1 item 4)"
        )


__all__ = ["RunReport", "Schedule", "ShareEntry"]
