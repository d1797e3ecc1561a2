"""PM execution planning: assembly tree → device-group waves on a TPU mesh.

This is where the paper's technique becomes a framework feature.  The
symbolic phase yields a TaskTree (lengths = frontal flops); the PM schedule
yields each front's optimal fractional share; the discretizer rounds shares
to power-of-two sub-mesh groups (§7 aggregation analogue — no front below
``min_devices``); a list scheduler emits waves that respect precedence and
mesh capacity.  The projected makespan uses the p^α model with α calibrated
from the kernel roofline (see benchmarks.alpha_calibration).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.baselines import proportional_shares
from repro_torch.core.graph import TaskTree
from repro_torch.core.multinode import discretize_shares_pow2
from repro_torch.core.pm import tree_equivalent_lengths, tree_pm_ratios
from repro_torch.core.profiles import Profile


def pow2_devices(share: float, total: int) -> int:
    """Nearest power-of-two device count for a fluid share, in [1, total].

    The one rounding rule every fluid→discretized bridge uses (the
    online replay projection and ``Schedule.to_execution_plan``), so
    the two cannot drift apart.
    """
    if share <= 0:
        return 1
    g = 2 ** int(round(math.log2(max(share, 1.0))))
    return int(min(max(g, 1), total))


@dataclass
class PlannedTask:
    task: int  # tree index
    label: int  # user label (supernode id; -1 for virtual)
    devices: int  # discretized device-group size
    start: float  # projected start (model time)
    end: float


@dataclass
class ExecutionPlan:
    tasks: List[PlannedTask]
    makespan: float  # projected, p^α model
    fluid_makespan: float  # PM optimum on the same device count (lower bound)
    total_devices: int
    alpha: float
    strategy: str = "pm"  # share rule the groups were derived from

    def waves(self, rtol: float = 1e-9, atol: float = 1e-12) -> List[List[PlannedTask]]:
        """Group tasks into maximal sets with equal start times.

        Equality is tolerance-based: starts within
        ``max(atol, rtol·makespan)`` of a wave's *first* task join that
        wave, so accumulated float error in chained start times (or an
        online replay's event timestamps) cannot split a wave.  Anchoring
        at the first task keeps the tolerance from chaining across
        genuinely distinct waves.
        """
        tol = max(atol, rtol * max(self.makespan, 0.0))
        out: List[List[PlannedTask]] = []
        for t in sorted(self.tasks, key=lambda t: (t.start, t.task)):
            if out and t.start - out[-1][0].start <= tol:
                out[-1].append(t)
            else:
                out.append([t])
        return out

    def efficiency(self) -> float:
        return self.fluid_makespan / self.makespan if self.makespan > 0 else 1.0


def make_plan(
    tree: TaskTree,
    total_devices: int,
    alpha: float,
    min_devices: int = 1,
    strategy: str = "pm",
) -> ExecutionPlan:
    """List-schedule the tree with discretized device groups.

    Greedy event-driven scheduler: a task is ready when its children are
    done; ready tasks start (largest share first) whenever their device
    group fits in the free capacity.  Running time of task i on g devices is
    L_i / g^α.  This dominates the naive per-level wave model because
    independent subtrees overlap across levels exactly as PM prescribes.

    ``strategy`` selects the share rule the device groups are derived from:
    "pm" (the paper's α-aware eq^{1/α} split) or "proportional" (Pothen–Sun
    subtree-weight split, §7's speedup-unaware baseline) — the executable
    analogue of the §7 simulation comparison.  ``fluid_makespan`` stays the
    PM optimum in both cases so ``efficiency()`` always measures distance to
    the true lower bound.
    """
    if strategy == "pm":
        ratios = tree_pm_ratios(tree, alpha)
    elif strategy == "proportional":
        ratios = proportional_shares(tree, 1.0)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    eq = tree_equivalent_lengths(tree, alpha)
    groups = discretize_shares_pow2(
        ratios, total_devices, min_devices, enforce_total=False
    )

    ch = tree.children_lists()
    n_unfinished = np.array([len(c) for c in ch])
    ready = sorted(
        (i for i in range(tree.n) if n_unfinished[i] == 0),
        key=lambda i: -ratios[i],
    )
    free = total_devices
    t = 0.0
    running: List[Tuple[float, int]] = []  # (end_time, task)
    planned: Dict[int, PlannedTask] = {}
    guard = 0
    while ready or running:
        guard += 1
        if guard > 10 * tree.n + 100:
            raise RuntimeError("planner did not converge")
        # choose which ready tasks start now (largest PM share first)
        placed: List[int] = []
        free_tmp = free
        still_ready = []
        for i in ready:
            g = int(groups[i]) if tree.lengths[i] > 0 else 0
            if g <= free_tmp:
                placed.append(i)
                free_tmp -= g
            else:
                still_ready.append(i)
        # spare-capacity boost (beyond-paper): when nothing else is waiting,
        # double the most-starved starting groups — this hands e.g. the root
        # front the whole mesh instead of its pre-rounded share.
        boost = {i: int(groups[i]) for i in placed if tree.lengths[i] > 0}
        if boost and not still_ready:
            while True:
                starv = {
                    i: ratios[i] * total_devices / boost[i] for i in boost
                }
                cand = sorted(boost, key=lambda i: -starv[i])
                hit = next(
                    (
                        i
                        for i in cand
                        if boost[i] <= free_tmp and boost[i] < total_devices
                    ),
                    None,
                )
                if hit is None:
                    break
                free_tmp -= boost[hit]
                boost[hit] *= 2
        for i in placed:
            g = boost.get(i, 0)
            dur = tree.lengths[i] / g**alpha if g > 0 else 0.0
            planned[i] = PlannedTask(
                task=i, label=int(tree.labels[i]), devices=g, start=t, end=t + dur
            )
            running.append((t + dur, i))
            free -= g
        ready = still_ready
        if not running:
            if ready:
                raise RuntimeError("capacity deadlock: group larger than mesh")
            break
        # advance to next completion
        running.sort()
        t_next, i_done = running.pop(0)
        t = t_next
        free += planned[i_done].devices if tree.lengths[i_done] > 0 else 0
        # release any other tasks completing at the same time
        while running and running[0][0] <= t + 1e-15:
            _, j = running.pop(0)
            free += planned[j].devices if tree.lengths[j] > 0 else 0
            _complete(j, tree, n_unfinished, ready, ratios)
        _complete(i_done, tree, n_unfinished, ready, ratios)
        ready.sort(key=lambda i: -ratios[i])

    makespan = max((p.end for p in planned.values()), default=0.0)
    fluid = eq[tree.root] / total_devices**alpha
    return ExecutionPlan(
        tasks=[planned[i] for i in sorted(planned)],
        makespan=float(makespan),
        fluid_makespan=float(fluid),
        total_devices=total_devices,
        alpha=alpha,
        strategy=strategy,
    )


def _complete(i, tree, n_unfinished, ready, ratios) -> None:
    p = int(tree.parent[i])
    if p >= 0:
        n_unfinished[p] -= 1
        if n_unfinished[p] == 0:
            ready.append(p)


def replan_elastic(
    tree: TaskTree,
    plan: ExecutionPlan,
    t_event: float,
    new_total_devices: int,
    alpha: float,
) -> ExecutionPlan:
    """Re-plan after a capacity change at ``t_event`` (node loss / grow).

    The paper's PM theory handles time-varying p(t) natively: ratios are
    invariant (Lemma 4).  In the discretized world we rebuild the residual
    tree (remaining work of unfinished tasks) and plan it on the new mesh.
    """
    remaining = tree.lengths.astype(np.float64).copy()
    for p in plan.tasks:
        i = p.task
        if p.end <= t_event:
            remaining[i] = 0.0
        elif p.start < t_event:
            frac = (t_event - p.start) / (p.end - p.start)
            remaining[i] *= 1.0 - frac
    residual = TaskTree(
        parent=tree.parent.copy(), lengths=remaining, labels=tree.labels.copy()
    )
    return make_plan(residual, new_total_devices, alpha, strategy=plan.strategy)


def pm_projected_makespan(
    tree: TaskTree, alpha: float, profile: Profile
) -> float:
    """Fluid PM makespan under an arbitrary step profile (Theorem 6)."""
    eq = tree_equivalent_lengths(tree, alpha)
    return profile.time_for_work(eq[tree.root], alpha)


def plan_memory_timeline(plan: ExecutionPlan, tree: TaskTree, fp):
    """Resident-bytes timeline the plan projects under ``fp`` footprints.

    ``fp`` is a :class:`~repro_torch.core.memory.Footprints` over the tree's
    task indices (pad symbolic footprints over a virtual root first).
    This is the number the executor compares its measured buffer peak
    against.
    """
    from repro_torch.core.memory import memory_timeline

    spans = {t.task: (t.start, t.end) for t in plan.tasks}
    return memory_timeline(tree.parent, spans, fp)
