"""String-keyed policy registry: every planner behind one ``plan()``.

A policy is a class with ``plan(problem, platform) -> Schedule``,
registered by name via the :func:`register_policy` decorator.  New
policies (a different moldable/malleable family à la Wu–Loiseau, a
memory-aware tree scheduler à la Marchal–Sinnen–Vivien) drop in as one
new file containing one decorated class — nothing in ``Session`` or the
callers changes.

Built-ins:

=====================  =================================================
``pm``                 fluid PM optimum (Theorem 6), §4-explicit
``proportional``       Pothen–Sun fluid baseline (§7, speedup floor)
``divisible``          sequential whole-machine baseline (§7)
``greedy``             discretized list schedule, pow-2 groups, PM shares
``greedy-proportional``  ditto with proportional shares
``static``             PM ratios frozen at admission (what a precomputed
                       plan does), via the online event core
``online``             event-driven re-share (zero noise ⇒ equals pm)
``two-node``           Algorithm 11 on 2 homogeneous nodes (placement)
``hetero``             Algorithm 12 FPTAS on 2 heterogeneous nodes
``k-node``             beyond-paper greedy on k homogeneous nodes
``pm-bounded``         PM under a memory budget: segmented Liu-order
                       traversal (arXiv:1210.2580 / 1410.0329); equals
                       ``pm`` when ``memory_budget=inf``
=====================  =================================================

``memory_budget`` is a *planning dimension* of the registry: a policy
that declares the keyword (``pm-bounded``) actively plans within it;
for any other policy ``Session.plan(..., memory_budget=B)`` certifies
the produced schedule against ``B`` and refuses plans that exceed it.
"""
from __future__ import annotations

import inspect
import math
from typing import Dict, List, Optional, Type

from repro_torch.core.baselines import (
    divisible_makespan,
    divisible_schedule,
    proportional_shares,
)
from repro_torch.core.schedule import from_pm, simulate_constant_shares

from .platform import Platform
from .problem import Problem
from .schedule import Schedule

POLICY_REGISTRY: Dict[str, Type["Policy"]] = {}


def register_policy(name: str):
    """Class decorator: make a Policy resolvable by name."""

    def deco(cls: Type["Policy"]) -> Type["Policy"]:
        if not isinstance(name, str) or not name:
            raise ValueError("policy name must be a non-empty string")
        if name in POLICY_REGISTRY:
            raise ValueError(f"policy {name!r} already registered")
        cls.name = name
        POLICY_REGISTRY[name] = cls
        return cls

    return deco


def get_policy(name: str, **opts) -> "Policy":
    """Instantiate a registered policy by name."""
    try:
        cls = POLICY_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; available: {available_policies()}"
        ) from None
    return cls(**opts)


def available_policies() -> List[str]:
    return sorted(POLICY_REGISTRY)


def accepts_memory_budget(name: str) -> bool:
    """Whether the policy plans *within* a memory budget (declares the
    ``memory_budget`` keyword), as opposed to only being certified
    against one after the fact."""
    cls = POLICY_REGISTRY[name]
    return "memory_budget" in inspect.signature(cls.__init__).parameters


# ----------------------------------------------------------------------
class Policy:
    """Base class: one planning rule, platform-aware."""

    name: str = "policy"

    def plan(self, problem: Problem, platform: Platform) -> Schedule:
        raise NotImplementedError

    # -- shared helpers -------------------------------------------------
    @staticmethod
    def _fluid(problem: Problem, platform: Platform) -> float:
        """Theorem-6 lower bound on the platform's total capacity."""
        return problem.fluid_makespan(platform.profile())

    @staticmethod
    def _steps(platform: Platform):
        prof = platform.profile()
        return [(d, p) for d, p in prof.steps]

    @staticmethod
    def _require_constant(platform: Platform, what: str) -> float:
        steps = platform.profile().steps
        if len(steps) != 1:
            raise ValueError(
                f"{what} handles constant capacity only; "
                f"got a {len(steps)}-step profile"
            )
        return float(steps[0][1])


# ----------------------------------------------------------------------
@register_policy("pm")
class PMPolicy(Policy):
    """The paper's optimum: unique PM schedule under any p(t) (Thm 6)."""

    def plan(self, problem: Problem, platform: Platform) -> Schedule:
        profile = platform.profile()
        es = from_pm(problem.tree, problem.alpha, profile)
        fluid = self._fluid(problem, platform)
        return Schedule.from_explicit(
            es,
            policy=self.name,
            platform=platform.describe(),
            capacity=platform.capacity(),
            fluid_makespan=fluid,
            makespan=fluid,  # Theorem 6: PM achieves the bound exactly
            labels=problem.tree.labels,
            profile_steps=self._steps(platform),
            meta={"eq_root": problem.eq_root},
        )


@register_policy("proportional")
class ProportionalPolicy(Policy):
    """Pothen–Sun proportional mapping (§7), with the realistic floor."""

    def __init__(self, speedup_floor: bool = True) -> None:
        self.speedup_floor = speedup_floor

    def plan(self, problem: Problem, platform: Platform) -> Schedule:
        p = self._require_constant(platform, "proportional mapping")
        shares = proportional_shares(problem.tree, p)
        es = simulate_constant_shares(
            problem.tree,
            shares,
            platform.profile(),
            problem.alpha,
            speedup_floor=self.speedup_floor,
        )
        return Schedule.from_explicit(
            es,
            policy=self.name,
            platform=platform.describe(),
            capacity=p,
            fluid_makespan=self._fluid(problem, platform),
            labels=problem.tree.labels,
            profile_steps=self._steps(platform),
            meta={"speedup_floor": self.speedup_floor},
        )


@register_policy("divisible")
class DivisiblePolicy(Policy):
    """Sequential whole-machine execution (§7's DIVISIBLE)."""

    def plan(self, problem: Problem, platform: Platform) -> Schedule:
        profile = platform.profile()
        es = divisible_schedule(problem.tree, problem.alpha, profile)
        return Schedule.from_explicit(
            es,
            policy=self.name,
            platform=platform.describe(),
            capacity=platform.capacity(),
            fluid_makespan=self._fluid(problem, platform),
            makespan=divisible_makespan(problem.tree, problem.alpha, profile),
            labels=problem.tree.labels,
            profile_steps=self._steps(platform),
        )


# ----------------------------------------------------------------------
@register_policy("pm-bounded")
class PMBoundedPolicy(Policy):
    """PM shares under a memory budget (arXiv:1210.2580 / 1410.0329).

    When the fluid PM schedule's peak resident bytes fit in the budget
    (always true for ``memory_budget=inf``, or when the problem carries
    no footprints) the plan *is* the PM optimum.  Otherwise the tree is
    traversed in segments: each subtree whose PM peak fits on top of the
    bytes already retained runs as one full-machine PM segment, the rest
    recurses into Liu's memory-minimizing child order.  Raises when the
    budget is below Liu's sequential minimum — no schedule of the tree
    fits at all.
    """

    def __init__(self, memory_budget: float = math.inf) -> None:
        self.memory_budget = float(memory_budget)
        if self.memory_budget <= 0:
            raise ValueError("memory_budget must be positive")

    def plan(self, problem: Problem, platform: Platform) -> Schedule:
        budget = self.memory_budget
        fp = problem.memory_footprints()
        base = PMPolicy().plan(problem, platform)
        base.policy = self.name
        if fp is not None:
            base.attach_memory(problem, budget=budget)
        if base.memory is None or base.memory.peak <= budget * (1 + 1e-12):
            base.meta["segments"] = 1
            return base

        from repro_torch.core.memory import pm_bounded_schedule

        p = self._require_constant(platform, "the memory-bounded planner")
        es, info = pm_bounded_schedule(
            problem.tree, problem.alpha, p, fp, budget
        )
        sched = Schedule.from_explicit(
            es,
            policy=self.name,
            platform=platform.describe(),
            capacity=p,
            fluid_makespan=self._fluid(problem, platform),
            labels=problem.tree.labels,
            profile_steps=self._steps(platform),
            meta={
                "memory_budget": budget,
                "segments": info["segments"],
                "sequential_min": info["sequential_min"],
            },
        )
        sched.attach_memory(problem, budget=budget)
        return sched


# ----------------------------------------------------------------------
class _ListSchedulePolicy(Policy):
    """Shared body of the discretized list-scheduling policies."""

    strategy = "pm"

    def __init__(self, min_devices: int = 1) -> None:
        self.min_devices = int(min_devices)

    def plan(self, problem: Problem, platform: Platform) -> Schedule:
        from repro_torch.sparse.plan import make_plan

        p = self._require_constant(platform, "the list scheduler")
        plan = make_plan(
            problem.tree,
            int(round(p)),
            problem.alpha,
            min_devices=self.min_devices,
            strategy=self.strategy,
        )
        return Schedule.from_plan(
            plan, policy=self.name, platform=platform.describe()
        )


@register_policy("greedy")
class GreedyPolicy(_ListSchedulePolicy):
    """PM shares rounded to pow-2 device groups, list-scheduled."""

    strategy = "pm"


@register_policy("greedy-proportional")
class GreedyProportionalPolicy(_ListSchedulePolicy):
    """Pothen–Sun shares rounded to pow-2 groups (the §7 baseline,
    executable)."""

    strategy = "proportional"


# ----------------------------------------------------------------------
class _OnlinePolicy(Policy):
    """Plan by running the deterministic (zero-noise) online loop."""

    share_policy = "pm"

    def plan(self, problem: Problem, platform: Platform) -> Schedule:
        from repro_torch.online.scheduler import OnlineScheduler

        self._require_constant(platform, "the online planner")
        sched = OnlineScheduler(
            platform.to_pool(), problem.alpha, policy=self.share_policy
        )
        sched.submit(problem)
        report = sched.run()
        return Schedule.from_online(
            report,
            policy=self.name,
            platform=platform.describe(),
            fluid_makespan=self._fluid(problem, platform),
            tree_id=0,
        )


@register_policy("static")
class StaticPolicy(_OnlinePolicy):
    """PM ratios frozen at admission — what a precomputed fluid plan
    does when durations go off-model (here: none do, so it equals pm)."""

    share_policy = "static"


@register_policy("online")
class OnlineReSharePolicy(_OnlinePolicy):
    """Event-driven Lemma-4 re-share; zero noise makes it the PM
    optimum, observed through the event core."""

    share_policy = "pm"


# ----------------------------------------------------------------------
@register_policy("two-node")
class TwoNodePolicy(Policy):
    """Algorithm 11: trees on two homogeneous multicore nodes (§6.1)."""

    def __init__(self, snap: bool = True) -> None:
        self.snap = snap

    def plan(self, problem: Problem, platform: Platform) -> Schedule:
        from repro_torch.core.two_node import homogeneous_two_node

        sizes = platform.node_sizes()
        if len(sizes) != 2 or sizes[0] != sizes[1]:
            raise ValueError(
                f"two-node needs a platform with 2 equal nodes, got {sizes}"
            )
        res = homogeneous_two_node(
            problem.tree, problem.alpha, float(sizes[0]), snap=self.snap
        )
        placement = sorted(
            (int(k), int(v)) for k, v in res.placement.items()
        )
        return Schedule(
            alpha=problem.alpha,
            policy=self.name,
            platform=platform.describe(),
            capacity=platform.capacity(),
            entries=[],
            makespan=float(res.makespan),
            fluid_makespan=self._fluid(problem, platform),
            discretized=False,
            meta={"placement": placement, "snap": self.snap},
        )


@register_policy("hetero")
class HeteroFPTASPolicy(Policy):
    """Algorithm 12: independent tasks on 2 heterogeneous nodes (§6.2)."""

    def __init__(self, lam: float = 1.05) -> None:
        self.lam = float(lam)

    def plan(self, problem: Problem, platform: Platform) -> Schedule:
        from repro_torch.core.hetero import hetero_fptas

        sizes = platform.node_sizes()
        if len(sizes) != 2:
            raise ValueError(
                f"hetero FPTAS needs a platform with 2 nodes, got {sizes}"
            )
        tree = problem.tree
        leaves = [
            i
            for i in range(tree.n)
            if i != tree.root and int(tree.parent[i]) == tree.root
        ]
        if len(leaves) != tree.n - 1 or tree.lengths[tree.root] > 0:
            raise ValueError(
                "hetero FPTAS schedules independent tasks; give a star "
                "problem (Problem.from_lengths)"
            )
        lengths = [float(tree.lengths[i]) for i in leaves]
        res = hetero_fptas(
            lengths, float(sizes[0]), float(sizes[1]), problem.alpha, self.lam
        )
        on_p = set(res.on_p)
        placement = sorted(
            (int(tree.labels[leaves[j]]), 0 if j in on_p else 1)
            for j in range(len(leaves))
        )
        return Schedule(
            alpha=problem.alpha,
            policy=self.name,
            platform=platform.describe(),
            capacity=platform.capacity(),
            entries=[],
            makespan=float(res.makespan),
            fluid_makespan=float(res.lower_bound),
            discretized=False,
            meta={
                "placement": placement,
                "lam": self.lam,
                "lower_bound": res.lower_bound,
            },
        )


@register_policy("hetero-mixed")
class MixedHeteroPolicy(Policy):
    """Beyond-paper §6.2: two *genuinely* mixed nodes (per-node α and
    work rate — a CPU host next to an accelerator mesh).

    Reads the per-node exponents/speeds from the platform
    (:meth:`~repro_torch.api.platform.Platform.node_alphas` /
    ``node_speeds``; a platform without per-node exponents falls back
    to the problem's single α, where the candidates coincide with
    Algorithm 12's).  Tasks are partitioned by
    :func:`repro_torch.core.hetero.mixed_hetero_fptas`; like the other
    placement policies the schedule carries the node assignment in
    ``meta`` rather than share entries.  Any tree shape is accepted —
    the partition covers every positive-length task and the reported
    makespan ignores precedence (it is the independent-task bound §6
    analyses; for a star problem it is exact).
    """

    def __init__(self, lam: float = 1.05) -> None:
        self.lam = float(lam)

    def plan(self, problem: Problem, platform: Platform) -> Schedule:
        from repro_torch.core.hetero import NodeSpec, mixed_hetero_fptas

        sizes = platform.node_sizes()
        if len(sizes) != 2:
            raise ValueError(
                f"hetero-mixed needs a platform with 2 nodes, got {sizes}"
            )
        alphas = platform.node_alphas() or (problem.alpha, problem.alpha)
        speeds = platform.node_speeds()
        tree = problem.tree
        tasks = [i for i in range(tree.n) if tree.lengths[i] > 0]
        if not tasks:
            raise ValueError("hetero-mixed needs at least one nonzero task")
        works = [float(tree.lengths[i]) for i in tasks]
        node_p = NodeSpec(float(sizes[0]), float(alphas[0]), float(speeds[0]))
        node_q = NodeSpec(float(sizes[1]), float(alphas[1]), float(speeds[1]))
        res = mixed_hetero_fptas(works, node_p, node_q, lam=self.lam)
        on_p = set(res.on_p)
        placement = sorted(
            (int(tree.labels[t]), 0 if j in on_p else 1)
            for j, t in enumerate(tasks)
        )
        return Schedule(
            alpha=problem.alpha,
            policy=self.name,
            platform=platform.describe(),
            capacity=platform.capacity(),
            entries=[],
            makespan=float(res.makespan),
            fluid_makespan=float(res.lower_bound),
            discretized=False,
            meta={
                "placement": placement,
                "alphas": [node_p.alpha, node_q.alpha],
                "speeds": [node_p.speed, node_q.speed],
                "lam": self.lam,
                "lower_bound": res.lower_bound,
            },
        )


@register_policy("k-node")
class KNodePolicy(Policy):
    """Beyond-paper: Lemma-10-style greedy on k homogeneous nodes."""

    def plan(self, problem: Problem, platform: Platform) -> Schedule:
        from repro_torch.core.multinode import k_node_greedy, k_node_lower_bound

        sizes = platform.node_sizes()
        if len(sizes) < 2 or len(set(sizes)) != 1:
            raise ValueError(
                f"k-node needs >= 2 equal nodes, got {sizes}"
            )
        p, k = float(sizes[0]), len(sizes)
        res = k_node_greedy(problem.tree, problem.alpha, p, k)
        placement = sorted(
            (int(lbl), int(node)) for lbl, node in res.placement.items()
        )
        return Schedule(
            alpha=problem.alpha,
            policy=self.name,
            platform=platform.describe(),
            capacity=platform.capacity(),
            entries=[],
            makespan=float(res.makespan),
            fluid_makespan=float(
                k_node_lower_bound(problem.tree, problem.alpha, p, k)
            ),
            discretized=False,
            meta={"placement": placement, "node_eq": list(res.node_eq)},
        )


__all__ = [
    "POLICY_REGISTRY",
    "Policy",
    "accepts_memory_budget",
    "available_policies",
    "get_policy",
    "register_policy",
]
