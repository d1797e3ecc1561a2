"""Replay bridge: an online run drives the plan executor.

The online scheduler reasons in fluid shares; the plan executor
(`repro_torch.runtime.executor`) consumes a discretized
:class:`~repro_torch.sparse.plan.ExecutionPlan`.  This module closes the
gap: run a factorization tree through :class:`OnlineScheduler`, snapshot
each task's (start, end, mean share) from the emitted schedule, round
shares to power-of-two device groups, and hand the result to
:class:`~repro_torch.runtime.executor.PlanExecutor` for a real
factorization on the card (or on CPU lanes the caller passes, which run
the kernels' plain versions).

With the async futures executor (``mode="async"``, the default) this is
no longer a projection but **the** execution path: the executor runs the
same dask-style per-front state machine as the online simulation
(``repro_torch.online.state``) — a front dispatches the instant its
children's Schur complements land — so the online run's event-driven
structure is preserved on real devices rather than flattened into
barrier waves.  The plan's role shrinks to what §4 says it should be:
priorities and device shares, not a rigid timetable.  ``mode="waves"``
keeps the barrier replay for A/B comparison: precedence is inherited
from the online run — a parent's start *is* the completion event of its
last child — so the wave walk stays valid by construction (waves are
grouped with the tolerance rule of ``ExecutionPlan.waves``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import scipy.sparse as sp
import torch

from repro_torch.sparse.plan import ExecutionPlan, PlannedTask, pow2_devices
from repro_torch.sparse.symbolic import SymbolicFactorization

from .scheduler import OnlineReport, OnlineScheduler


def _as_problem(tree_or_problem, alpha: Optional[float]):
    """Coerce to the shared Problem (single source of α and 𝓛)."""
    from repro_torch.api.problem import as_problem  # deferred: api ← online

    return as_problem(tree_or_problem, alpha)


def plan_from_online(
    tree_or_problem,
    report: OnlineReport,
    total_devices: int,
    *,
    tree_id: int = 0,
) -> ExecutionPlan:
    """Project one tree's online run onto an ExecutionPlan.

    Task start/end times are the online event times; device groups are
    the power-of-two rounding of the task's time-averaged share.  The
    plan's ``fluid_makespan`` stays the PM optimum on ``total_devices``
    so ``efficiency()`` still measures distance to the true bound —
    taken from the shared Problem's cached equivalent lengths, the same
    numbers admission used.
    """
    problem = _as_problem(tree_or_problem, report.alpha)
    tree, alpha = problem.tree, problem.alpha
    run = report.runs[tree_id]
    tasks = []
    for i, t_start, t_done, mean_share in report.task_records(tree_id):
        zero = tree.lengths[i] <= 0
        tasks.append(
            PlannedTask(
                task=i,
                label=int(tree.labels[i]),
                devices=0 if zero else pow2_devices(mean_share, total_devices),
                start=float(t_start),
                end=float(t_done),
            )
        )
    tasks.sort(key=lambda t: (t.start, t.task))
    return ExecutionPlan(
        tasks=tasks,
        makespan=float(run.future.t_done - run.future.t_admit),
        fluid_makespan=float(problem.eq_root / total_devices**alpha),
        total_devices=int(total_devices),
        alpha=alpha,
        strategy=f"online-{report.policy}",
    )


def run_online_plan(
    tree_or_problem,
    total_devices: int,
    alpha: Optional[float] = None,
    *,
    policy: str = "pm",
    noise=None,
    speedup_floor: bool = False,
) -> Tuple[ExecutionPlan, OnlineReport]:
    """Run one tree online on ``total_devices`` and project the plan.

    Accepts a TaskTree (+α) or a shared Problem; the same Problem feeds
    the online run and the plan projection.
    """
    problem = _as_problem(tree_or_problem, alpha)
    sched = OnlineScheduler(
        total_devices,
        problem.alpha,
        policy=policy,
        noise=noise,
        speedup_floor=speedup_floor,
    )
    sched.submit(problem)
    report = sched.run()
    return plan_from_online(problem, report, total_devices), report


def execute_online(
    a: sp.csr_matrix,
    symb: SymbolicFactorization,
    total_devices: int,
    alpha: float,
    *,
    policy: str = "pm",
    noise=None,
    mode: str = "async",
    warmup: bool = True,
    devices: Optional[Sequence] = None,
    dtype: torch.dtype = torch.float32,
    **executor_kwargs,
):
    """Factorize ``a`` through the online scheduler: online run → plan →
    executor.  Returns (Factorization, ExecutionReport, OnlineReport).

    This is the real execution path: the default ``mode="async"`` runs
    the per-front futures executor, whose event-driven dispatch mirrors
    the online run's state machine one-to-one (``mode="waves"`` keeps
    the legacy barrier replay).  One shared Problem (built from the
    symbolic analysis) drives the online admission, the plan projection
    and the executor, so α and the frontal lengths cannot drift between
    the three.

    ``devices=None`` runs on every CUDA device and raises when there is
    none, as :class:`~repro_torch.runtime.executor.PlanExecutor` does; the
    CPU is used only when the caller passes CPU devices.  ``dtype`` is the
    fronts' type (``torch.float32`` or ``torch.float64``).
    """
    from repro_torch.api.problem import Problem  # deferred: api ← online
    from repro_torch.runtime import executor  # deferred: runtime ← online

    if devices is None:  # raise before the online run, not after it
        devices = executor._default_devices()
    problem = Problem.from_symbolic(symb, alpha, matrix=a)
    plan, online_report = run_online_plan(
        problem, total_devices, policy=policy, noise=noise
    )
    fact, exec_report = executor.PlanExecutor(
        symb, plan, devices=devices, dtype=dtype, mode=mode, **executor_kwargs
    ).run(a, warmup=warmup)
    return fact, exec_report, online_report


__all__ = ["execute_online", "plan_from_online", "run_online_plan"]
