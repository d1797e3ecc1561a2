"""The fluent facade: ``Session(platform).analyze(A).plan().execute()``.

One object strings the whole pipeline together — tree of `p^α` malleable
tasks → policy plan → (simulated | executed | served) run — over any
:class:`~repro_torch.api.platform.Platform` and any registered
:class:`~repro_torch.api.policy.Policy`.  Every step returns ``self`` until
a terminal verb produces a :class:`~repro_torch.api.schedule.RunReport`:

>>> import torch
>>> from repro_torch.api import DeviceMesh, Session
>>> rep = (Session(DeviceMesh(plan_devices=256))
...        .analyze(a, alpha=0.9, ordering=nested_dissection_2d(200))
...        .plan("greedy")
...        .execute(dtype=torch.float64))

Terminal verbs:

* ``execute(...)`` — the plan executor on the platform's torch devices
  (every CUDA device for ``DeviceMesh()``; CPU lanes when the caller
  passes them); needs a problem that came from a matrix (``analyze``) and
  converts the current schedule to an ExecutionPlan (exact when
  discretized).
* ``simulate(noise=..., events=...)`` — the discrete-event online loop
  (duration noise, capacity edits, failures) on the planned problem.
* ``serve(stream)`` — multi-tenant request serving through the admission
  queue, in virtual time; ``serve(stream, cluster=...)`` serves it on a
  scheduler/worker cluster (:mod:`repro_torch.cluster`) in wall time, its
  workers factoring numeric trees on the platform's torch devices;
  ``serve(..., dashboard_port=...)`` keeps the live observability
  dashboard (:mod:`repro_torch.obs.dashboard`) on ``self.dashboard``
  until ``close()``.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .platform import Platform, as_platform
from .policy import accepts_memory_budget, get_policy
from .problem import Problem, as_problem
from .schedule import RunReport, Schedule, ShareEntry


def _clean_metrics(metrics: dict) -> dict:
    """Drop unknown (None / NaN) metric values instead of storing null.

    A metric a run could not measure (e.g. ready latency on the wave
    path) is *absent*, not null — consumers ``get()`` it and JSON
    artifacts never carry ``null``.
    """
    return {
        k: float(v)
        for k, v in metrics.items()
        if v is not None and not (isinstance(v, float) and math.isnan(v))
    }


class Session:
    """A scheduling session on one platform.

    The session is a small state machine: ``analyze``/``load`` set the
    problem, ``plan`` sets the schedule, the terminal verbs run it.
    Each setter returns ``self`` so calls chain fluently; ``problem``
    and ``schedule`` stay inspectable at every step.
    """

    def __init__(self, platform=None) -> None:
        self.platform: Platform = as_platform(platform)
        self.problem: Optional[Problem] = None
        self.schedule: Optional[Schedule] = None
        self.dashboard = None  # live obs dashboard (serve(dashboard_port=))

    # -- problem setup --------------------------------------------------
    def analyze(
        self,
        a,
        alpha: float = 0.9,
        *,
        ordering=None,
        relax: int = 2,
        flop_rate: float = 1.0,
    ) -> "Session":
        """Sparse SPD matrix → ordering → symbolic → task tree."""
        self.problem = Problem.from_matrix(
            a, alpha, ordering=ordering, relax=relax, flop_rate=flop_rate
        )
        self.schedule = None
        return self

    def analyze_workload(self, spec, **kwargs) -> "Session":
        """Model-zoo workload → task tree: not ported yet."""
        raise NotImplementedError(
            "Session.analyze_workload needs repro_torch.workloads, not ported "
            "yet (ROADMAP queue 1 item 9)"
        )

    def load(self, problem, alpha: Optional[float] = None) -> "Session":
        """Set the problem directly (Problem, TaskTree+α, lengths+α)."""
        self.problem = as_problem(problem, alpha)
        self.schedule = None
        return self

    def optimize(
        self,
        *,
        max_front: Optional[float] = None,
        max_fill: float = math.inf,
        memory_budget: Optional[float] = None,
        max_batch: int = 32,
    ) -> "Session":
        """Amalgamate the loaded problem's task tree (cull degenerate
        fronts, fuse parent–child chains, merge small siblings into
        batch dispatches) — see :func:`repro_torch.sparse.optimize_problem`.

        The optimized Problem replaces ``self.problem`` and carries the
        provenance map (optimized task → original fronts); ``plan``
        serializes it into the schedule's meta and ``execute`` forwards
        it to the executor so the factors still land in the *original*
        index space bit-identically.  A finite ``memory_budget`` makes
        the rewrite back off until its sequential peak fits.
        """
        from repro_torch.sparse.optimize import optimize_problem

        self.problem = optimize_problem(
            self._require_problem(),
            max_front=max_front,
            max_fill=max_fill,
            memory_budget=memory_budget,
            max_batch=max_batch,
        )
        self.schedule = None
        return self

    def _require_problem(self) -> Problem:
        if self.problem is None:
            raise RuntimeError(
                "no problem loaded; call .analyze(A, alpha=...) or "
                ".load(problem) first"
            )
        return self.problem

    # -- planning -------------------------------------------------------
    def plan(
        self,
        policy: str = "pm",
        *,
        memory_budget: Optional[float] = None,
        **opts,
    ) -> "Session":
        """Plan with a registered policy; the Schedule lands on
        ``self.schedule`` (chain ``.execute()`` / inspect directly).

        ``memory_budget`` (bytes) is the resource dimension: a
        budget-aware policy (``pm-bounded``) plans within it; any other
        policy's schedule is *certified* against it and a violating plan
        raises instead of being returned.  A finite budget that cannot
        be checked at all — a placement-only schedule, or a problem
        without footprints — also raises, so "planned with a budget"
        always means "the budget was actually enforced".  When the
        problem carries footprints the schedule always gets its
        resident-bytes timeline attached (``schedule.memory_profile()``
        / ``peak_memory()``).
        """
        problem = self._require_problem()
        if memory_budget is not None and accepts_memory_budget(policy):
            opts["memory_budget"] = memory_budget
        sched = get_policy(policy, **opts).plan(problem, self.platform)
        budget = math.inf if memory_budget is None else float(memory_budget)
        if sched.entries and sched.memory is None:
            sched.attach_memory(problem, budget=budget)
        if memory_budget is not None and math.isfinite(budget):
            if sched.memory is None:
                why = (
                    "the schedule is placement-only"
                    if not sched.entries
                    else "the problem carries no memory footprints"
                )
                raise ValueError(
                    f"cannot certify policy {policy!r} against a memory "
                    f"budget: {why}"
                )
            if sched.memory.peak > budget * (1 + 1e-9):
                raise ValueError(
                    f"policy {policy!r} needs {sched.memory.peak:.4g} B "
                    f"peak memory, over the {budget:.4g} B budget; plan "
                    f"with 'pm-bounded' to stay within it"
                )
        if problem.provenance is not None:
            # ship the amalgamation map with the plan (JSON-serializable)
            sched.meta["provenance"] = problem.provenance.to_dict()
        if problem.meta:
            # any problem meta rides the schedule into JSON v2; the
            # plan's own keys win
            for k, v in problem.meta.items():
                sched.meta.setdefault(k, v)
        self.schedule = sched
        return self

    @property
    def fluid_makespan(self) -> float:
        """Theorem-6 lower bound of the loaded problem on this platform."""
        return self._require_problem().fluid_makespan(self.platform.profile())

    def _require_schedule(self) -> Schedule:
        if self.schedule is None:
            self.plan()
        assert self.schedule is not None
        return self.schedule

    # -- terminal verbs -------------------------------------------------
    def _memory_capacity(self, memory_budget: Optional[float]) -> float:
        """The byte pool online admission gates on: an explicit budget,
        else the platform's real memory."""
        if memory_budget is not None:
            return float(memory_budget)
        return self.platform.resources().total_memory()

    def simulate(
        self,
        *,
        noise=None,
        events: Sequence[Tuple[float, object]] = (),
        policy: Optional[str] = None,
        speedup_floor: bool = False,
        until: float = np.inf,
        memory_budget: Optional[float] = None,
    ) -> RunReport:
        """Run the problem through the discrete-event online scheduler.

        ``policy`` is the share rule (``pm`` / ``proportional`` /
        ``static`` / ``static-proportional``); defaults to the planned
        policy when that is a share rule, else ``pm``.  ``events`` are
        ``(time, payload)`` pairs of online events (SetCapacity,
        SetNodeSpeed, TaskFailure); a non-constant platform profile is
        injected automatically as SetCapacity steps.  Admission is
        memory-aware: a problem whose minimal peak cannot fit the
        platform's memory (or the ``memory_budget`` override) is
        refused.
        """
        from repro_torch.online.events import SetCapacity
        from repro_torch.online.scheduler import SHARE_POLICIES, OnlineScheduler

        problem = self._require_problem()
        if policy is None:
            planned = self.schedule.policy if self.schedule else "pm"
            policy = planned if planned in SHARE_POLICIES else "pm"
        steps = self.platform.profile().steps
        sched = OnlineScheduler(
            self.platform.to_pool(),
            problem.alpha,
            policy=policy,
            noise=noise,
            speedup_floor=speedup_floor,
            memory_capacity=self._memory_capacity(memory_budget),
        )
        profile = self.platform.profile()
        t_acc = 0.0
        for d, p in steps[:-1]:
            t_acc += d
            sched.inject(t_acc, SetCapacity(float(profile.p_at(t_acc))))
        for t, payload in events:
            sched.inject(t, payload)
        sched.submit(problem)
        report = sched.run(until=until)
        realized = Schedule.from_online(
            report,
            policy=f"online-{policy}",
            platform=self.platform.describe(),
            tree_id=0,
        )
        realized.attach_memory(problem)
        fluid = realized.fluid_makespan
        return RunReport(
            kind="simulated",
            schedule=realized,
            makespan=report.makespan,
            fluid_makespan=fluid,
            planned=self.schedule,
            metrics=_clean_metrics(
                {
                    "utilization": report.utilization,
                    "n_events": float(report.n_events),
                    "n_reshares": float(report.n_reshares),
                    "fluid_ratio": (
                        report.makespan / fluid if fluid > 0 else None
                    ),
                }
            ),
            detail=report,
        )

    def execute(
        self,
        *,
        warmup: bool = True,
        mode: str = "async",
        dtype: torch.dtype = torch.float32,
        **executor_kwargs,
    ) -> RunReport:
        """Execute the current schedule on the platform's torch devices.

        ``mode`` selects the runner: ``"async"`` (default) dispatches
        each front the instant its children's Schur complements land —
        the per-front futures executor, no wave barrier — while
        ``"waves"`` keeps the barrier-synchronous runner for A/B
        comparison.  Both produce bit-identical factors.  ``dtype`` is
        the fronts' type (``torch.float32``, the executor's default, or
        ``torch.float64``).  Remaining keyword arguments (``delay_fn``,
        ``memory_cap_bytes``, ``max_batch``, ...) reach
        :class:`~repro_torch.runtime.executor.PlanExecutor` unchanged.

        The problem must carry its sparse context (``analyze`` or
        ``Problem.from_matrix``/``from_symbolic`` with a matrix); a
        fluid schedule is discretized on the way (exact pass-through
        for ``greedy``-family schedules and shipped-JSON plans).
        """
        from repro_torch.runtime.executor import PlanExecutor

        problem = self._require_problem()
        if problem.symb is None or problem.matrix is None:
            raise RuntimeError(
                "execute() needs a problem with symbolic+matrix context; "
                "build it with Session.analyze or Problem.from_matrix"
            )
        schedule = self._require_schedule()
        if schedule.entries:
            plan = schedule.to_execution_plan()
        else:
            raise RuntimeError(
                f"policy {schedule.policy!r} produced a placement, not an "
                f"executable schedule; plan with 'greedy' (or any "
                f"share-based policy) to execute"
            )
        devices = self.platform.devices()
        if problem.provenance is not None:
            executor_kwargs.setdefault("provenance", problem.provenance)
        executor = PlanExecutor(
            problem.symb,
            plan,
            devices=devices,
            dtype=dtype,
            mode=mode,
            **executor_kwargs,
        )
        fact, report = executor.run(problem.matrix, warmup=warmup)
        # the schedule's fluid bound is in model units; map it to seconds
        # at the measured work rate so efficiency() compares like units
        proj = report.projected_seconds()
        fluid_seconds = (
            proj * schedule.fluid_makespan / schedule.makespan
            if schedule.makespan > 0
            else proj
        )
        return RunReport(
            kind="executed",
            schedule=schedule,
            makespan=report.measured_makespan,
            fluid_makespan=fluid_seconds,
            planned=schedule,
            metrics=_clean_metrics(
                {
                    "measured_rate": report.measured_rate(),
                    "n_dispatches": float(report.n_dispatches),
                    "n_devices": float(report.n_devices),
                    "projected_seconds": report.projected_seconds(),
                    # the memory dimension, measured on the real buffers
                    # vs. projected from the plan's timeline
                    "measured_peak_bytes": report.measured_peak_bytes,
                    "projected_peak_bytes": report.projected_peak_bytes,
                    "fluid_ratio": (
                        report.measured_makespan / fluid_seconds
                        if fluid_seconds > 0
                        else None
                    ),
                    # async-mode observable: the key is simply absent on
                    # the wave path (no per-front ready instant), never
                    # null
                    "mean_ready_latency_s": report.mean_ready_latency(),
                }
            ),
            detail=report,
            artifact=fact,
        )

    def serve(
        self,
        stream: Iterable,
        *,
        policy: str = "pm",
        admission: str = "fifo",
        max_concurrent: Optional[int] = None,
        qos_weights: Optional[dict] = None,
        noise=None,
        speedup_floor: bool = False,
        alpha: Optional[float] = None,
        memory_budget: Optional[float] = None,
        dashboard_port: Optional[int] = None,
        cluster=None,
        time_scale: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ) -> RunReport:
        """Serve a stream of tree requests on this platform.

        Stream items: ``TreeRequest``, ``Problem`` (arrival 0), or
        ``(tree_or_problem, arrival)`` / ``(tree_or_problem, arrival,
        tenant)`` tuples.  α comes from the loaded problem, the
        ``alpha`` argument, or the first Problem in the stream.

        Admission is memory-aware: the platform's memory (or the
        ``memory_budget`` override) is a pool; a tree is only admitted
        when its minimal peak fits next to the already-admitted trees'
        peaks (delayed otherwise), and a tree that can never fit is
        refused at submission.

        ``qos_weights`` maps tenant id → relative share weight for the
        ``admission="fair"`` policy (a weight-2 tenant is admitted as if
        it had consumed half its actual service); tenants without an
        entry weigh 1.

        ``cluster`` switches the backend from the in-process
        virtual-time engine to a scheduler/worker cluster
        (:mod:`repro_torch.cluster`): pass a worker count (an inproc
        :class:`~repro_torch.cluster.service.LocalCluster` is started on
        the platform's torch devices — every CUDA device when the
        platform names none, raising where there is none — and torn down
        around the call) or a running ``LocalCluster`` (left running).
        On a cluster, latencies are wall-clock and numeric problems
        return real factorizations in ``report.artifact[rid]``, factored
        in ``dtype`` (``torch.float32``, ``execute``'s default, or
        ``torch.float64``; a started cluster only: a running one keeps
        its own); ``time_scale`` > 0 paces submissions at ``arrival ×
        time_scale`` wall seconds (0 = submit immediately in arrival
        order).

        ``dashboard_port`` starts the live observability dashboard
        (``repro_torch.obs.dashboard.Dashboard``, localhost) on that port
        (0 = auto) for the duration of the serve loop and leaves it
        running on ``self.dashboard`` afterwards — browse
        ``self.dashboard.url``, stop it with ``self.dashboard.stop()``.
        A dashboard left over from an earlier ``serve`` call is shut down
        first, so repeated serves never collide on a port;
        ``Session.close()`` (or using the session as a context manager)
        stops it deterministically.
        """
        from repro_torch.online.queue import TreeRequest, serve_trees

        if dashboard_port is not None:
            from repro_torch.obs.dashboard import Dashboard

            if self.dashboard is not None:  # no port squatting across serves
                self.dashboard.stop()
            self.dashboard = Dashboard(
                dashboard_port,
                context={"subtitle": f"serving on {self.platform.describe()}"},
            )

        items = list(stream)
        if alpha is None and self.problem is not None:
            alpha = self.problem.alpha
        if alpha is None:  # pre-scan: any Problem in the stream fixes α
            for item in items:
                inner = item[0] if isinstance(item, tuple) and item else item
                if isinstance(inner, Problem):
                    alpha = inner.alpha
                    break
        if alpha is None:
            raise ValueError(
                "serve() could not determine alpha; load a problem, pass "
                "alpha=, or put a Problem in the stream"
            )
        reqs: List[TreeRequest] = []
        for item in items:
            if isinstance(item, TreeRequest):
                reqs.append(item)
                continue
            arrival, tenant = 0.0, 0
            if isinstance(item, tuple):
                if len(item) == 3:
                    item, arrival, tenant = item[0], float(item[1]), int(item[2])
                elif len(item) == 2:
                    item, arrival = item[0], float(item[1])
                else:
                    raise ValueError(
                        "stream tuples are (problem, arrival[, tenant])"
                    )
            prob = as_problem(item, alpha)
            reqs.append(
                TreeRequest(
                    tree=prob, arrival=arrival, tenant=tenant, rid=len(reqs)
                )
            )
        if cluster is not None:
            return self._serve_cluster(
                reqs,
                cluster,
                alpha=alpha,
                policy=policy,
                admission=admission,
                max_concurrent=max_concurrent,
                qos_weights=qos_weights,
                memory_budget=memory_budget,
                time_scale=time_scale,
                dtype=dtype,
            )
        report = serve_trees(
            reqs,
            self.platform.to_pool(),
            alpha,
            policy=policy,
            admission=admission,
            max_concurrent=max_concurrent,
            weights=qos_weights,
            noise=noise,
            speedup_floor=speedup_floor,
            memory_capacity=self._memory_capacity(memory_budget),
        )
        realized = Schedule.from_online(
            report,
            policy=f"serve-{policy}",
            platform=self.platform.describe(),
        )
        fluid = realized.fluid_makespan
        run = RunReport(
            kind="served",
            schedule=realized,
            makespan=report.makespan,
            fluid_makespan=fluid,
            planned=self.schedule,
            metrics=_clean_metrics(
                {
                    "mean_latency": report.mean_latency(),
                    "mean_service": report.mean_service(),
                    "utilization": report.utilization,
                    "fluid_ratio": (
                        report.makespan / fluid if fluid > 0 else None
                    ),
                }
            ),
            detail=report,
        )
        dash = getattr(self, "dashboard", None)
        if dash is not None:
            dash.update_context(
                makespan=run.makespan,
                fluid_makespan=run.fluid_makespan,
                subtitle=f"served {len(reqs)} trees on "
                f"{self.platform.describe()}",
            )
        return run

    # ------------------------------------------------------------------
    def _serve_cluster(
        self,
        reqs,
        cluster,
        *,
        alpha: float,
        policy: str,
        admission: str,
        max_concurrent,
        qos_weights,
        memory_budget,
        time_scale: float,
        dtype: torch.dtype,
    ) -> RunReport:
        """Serve the request list on a scheduler/worker cluster."""
        import math as _math
        import time as _time

        from repro_torch.cluster.engine import ClusterEngine
        from repro_torch.cluster.service import LocalCluster

        own = False
        if isinstance(cluster, int):
            pool = max(int(round(self.platform.capacity())), 1)
            n_workers = max(cluster, 1)
            cluster = LocalCluster(
                n_workers,
                slots_per_worker=max(1, round(pool / n_workers)),
                devices=self.platform.devices() or None,
                dtype=dtype,
                alpha=alpha,
                policy=policy if policy in ("pm", "proportional") else "pm",
                admission=admission,
                max_concurrent=max_concurrent,
                qos_weights=qos_weights,
                memory_capacity=self._memory_capacity(memory_budget),
            )
            own = True
        elif not isinstance(cluster, LocalCluster):
            raise TypeError(
                "cluster= takes a worker count or a LocalCluster, got "
                f"{type(cluster).__name__}"
            )
        engine = ClusterEngine(cluster, own=own, label="session")
        try:
            t0 = _time.perf_counter()
            for req in sorted(reqs, key=lambda r: r.arrival):
                if time_scale > 0:
                    lag = req.arrival * time_scale - (
                        _time.perf_counter() - t0
                    )
                    if lag > 0:
                        _time.sleep(lag)
                engine.submit(
                    req.tree, tenant=req.tenant, rid=req.rid, alpha=alpha
                )
            results = engine.drain(timeout=max(60.0, 10.0 * len(reqs)))
            stats = engine.stats()
            sched_stats = engine.scheduler_stats()
        finally:
            engine.close()

        entries, offset = [], 0
        artifacts = {}
        t_min = min(
            (r.t_submit for r in results if r.ok), default=0.0
        )
        for res in sorted(results, key=lambda r: (r.tenant, r.rid or 0)):
            if not res.ok:
                continue
            for span in res.spans:
                if span["end"] > span["start"]:
                    entries.append(
                        ShareEntry(
                            task=offset + int(span["task"]),
                            label=int(span["task"]),
                            start=span["start"] - t_min,
                            end=span["end"] - t_min,
                            share=float(span["slots"]),
                        )
                    )
            offset += len(res.spans)
            if res.factor is not None:
                artifacts[res.rid] = res.factor
        capacity = float(sched_stats.get("total_slots") or 0.0)
        # Theorem-6 fluid bound of the served forest in wall seconds
        # (simulated work only: work_rate converts units to seconds;
        # numeric trees have no calibrated rate, so the bound is omitted)
        fluid = 0.0
        if not artifacts and capacity > 0:
            inv = 1.0 / alpha
            eq_total = (
                sum(r.tree.eq_root ** inv for r in reqs) ** alpha
            )
            fluid = eq_total / (
                capacity ** alpha * cluster.scheduler.work_rate
            )
        realized = Schedule(
            alpha=alpha,
            policy=f"cluster-{policy}",
            platform=f"cluster({cluster.address})",
            capacity=capacity,
            entries=entries,
            makespan=stats.makespan,
            fluid_makespan=fluid,
            discretized=True,
            meta={
                "backend": "cluster",
                "n_workers": len(cluster.workers),
                "admission": admission,
            },
        )
        run = RunReport(
            kind="served",
            schedule=realized,
            makespan=stats.makespan,
            fluid_makespan=fluid if fluid > 0 else None,
            planned=self.schedule,
            metrics=_clean_metrics(
                {
                    "n_requests": float(stats.n_requests),
                    "n_failed": float(stats.n_failed),
                    "qps": stats.qps,
                    "p50_latency": stats.p50_latency,
                    "p99_latency": stats.p99_latency,
                    "mean_latency": stats.mean_latency,
                    "mean_wait": stats.mean_wait,
                    "mean_exec": stats.mean_exec,
                    "n_dispatches": float(
                        sched_stats.get("n_dispatches", 0)
                    ),
                    "n_reshares": float(sched_stats.get("n_reshares", 0)),
                    "fluid_ratio": (
                        stats.makespan / fluid
                        if fluid > 0 and _math.isfinite(fluid)
                        else None
                    ),
                }
            ),
            detail={"stats": stats, "scheduler": sched_stats,
                    "results": results},
            artifact=artifacts or None,
        )
        dash = getattr(self, "dashboard", None)
        if dash is not None:
            dash.update_context(
                makespan=run.makespan,
                subtitle=f"cluster-served {stats.n_requests} trees @ "
                f"{cluster.address}",
            )
        return run

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Release session-owned services (the live dashboard).

        Idempotent; after close a later ``serve(dashboard_port=)`` may
        start a fresh dashboard.
        """
        if self.dashboard is not None:
            self.dashboard.stop()
            self.dashboard = None

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        prob = self.problem.name if self.problem else None
        pol = self.schedule.policy if self.schedule else None
        return (
            f"Session({self.platform.describe()}, problem={prob!r}, "
            f"planned={pol!r})"
        )


__all__ = ["Session"]
