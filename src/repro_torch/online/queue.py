"""Multi-tenant admission queue: factorization trees as a service.

The scheduler shares the live pool among *admitted* trees (PM over the
forest — a parallel composition, Lemma 4 at the virtual root).  The
admission queue decides which pending trees are admitted and when:

* ``fifo``   — arrival order.
* ``sjf``    — shortest job first by PM *equivalent length* 𝓛 (Def. 1):
  the correct "size" of a malleable tree is its eq-length, not its total
  work — a deep chain is long even if its Σ L_i is small.
* ``fair``   — fair share across tenants: admit the pending tree of the
  tenant with the least accumulated service (∫ share dt), FIFO within a
  tenant.

``max_concurrent`` bounds the number of simultaneously admitted trees
(processor-sharing degree); ``1`` serves trees one at a time on the
whole pool.

Admission is also *memory-aware* (arXiv:1210.2580 / 1410.0329: a tree
traversal needs a minimum resident size or it does not fit): each
pending tree carries its minimal peak bytes (Liu's sequential bound),
and the queue only hands out trees whose peak fits in the bytes the
scheduler still has free — others wait, regardless of the concurrency
bound.  Trees that could never fit are refused at submission
(:meth:`~repro_torch.online.scheduler.OnlineScheduler.submit`).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.graph import TaskTree

POLICIES = ("fifo", "sjf", "fair")


@dataclass
class TreeRequest:
    """One request of the serving stream.

    ``tree`` is a :class:`TaskTree` or a shared
    :class:`repro_torch.api.problem.Problem`; :func:`serve_trees` wraps bare
    trees into Problems so admission ordering (SJF by 𝓛) and execution
    read α and lengths from the same object.
    """

    tree: object  # TaskTree | repro_torch.api.problem.Problem
    arrival: float = 0.0
    tenant: int = 0
    rid: Optional[int] = None


@dataclass
class _Pending:
    tree_id: int
    tenant: int
    eq: float
    seq: int
    mem: float = 0.0  # minimal peak bytes (Liu's sequential bound)


class AdmissionQueue:
    """Pending-tree queue with a pluggable admission policy."""

    def __init__(
        self,
        policy: str = "fifo",
        max_concurrent: Optional[int] = None,
        weights: Optional[Dict[int, float]] = None,
    ) -> None:
        if policy not in POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}")
        if max_concurrent is not None and max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        if weights is not None and any(w <= 0 for w in weights.values()):
            raise ValueError("QoS weights must be positive")
        self.policy = policy
        self.max_concurrent = max_concurrent
        # tenant → QoS weight for `fair`: service is normalized by the
        # weight, so a weight-2 tenant is admitted as if it had consumed
        # half its actual service (weighted fair share); absent ⇒ 1.0
        self.weights = {int(t): float(w) for t, w in (weights or {}).items()}
        self._pending: List[_Pending] = []
        self._seq = itertools.count()

    def weight(self, tenant: int) -> float:
        return self.weights.get(int(tenant), 1.0)

    def __len__(self) -> int:
        return len(self._pending)

    def __bool__(self) -> bool:
        return bool(self._pending)

    def push(
        self, tree_id: int, tenant: int, eq: float, mem: float = 0.0
    ) -> None:
        self._pending.append(
            _Pending(tree_id, tenant, float(eq), next(self._seq), float(mem))
        )
        from repro_torch.obs import metrics as obs_metrics

        obs_metrics.REGISTRY.counter(
            "repro_admission_requests_total",
            "requests entering the admission queue, by tenant",
        ).inc(tenant=tenant)

    @staticmethod
    def _fits(p: _Pending, mem_free: float) -> bool:
        return p.mem <= mem_free * (1 + 1e-12) + 1e-9

    def can_admit(self, n_admitted: int, mem_free: float = math.inf) -> bool:
        """Whether some pending tree may be admitted now: the
        concurrency bound has room *and* at least one pending tree's
        peak fits in ``mem_free`` bytes."""
        if not self._pending:
            return False
        if self.max_concurrent is not None and n_admitted >= self.max_concurrent:
            return False
        return any(self._fits(p, mem_free) for p in self._pending)

    def pop_next(
        self,
        service_by_tenant: Optional[Dict[int, float]] = None,
        mem_free: float = math.inf,
    ) -> _Pending:
        """Remove and return the next tree to admit under the policy,
        considering only trees whose peak memory fits (a too-big tree is
        delayed, not a head-of-line blocker)."""
        fitting = [
            j for j, p in enumerate(self._pending) if self._fits(p, mem_free)
        ]
        if not fitting:
            raise IndexError("no admissible tree (queue empty or none fits)")
        if self.policy == "fifo":
            key = lambda p: (p.seq,)
        elif self.policy == "sjf":
            key = lambda p: (p.eq, p.seq)
        else:  # fair (weighted: normalized service decides)
            svc = service_by_tenant or {}
            key = lambda p: (svc.get(p.tenant, 0.0) / self.weight(p.tenant), p.seq)
        best = min(fitting, key=lambda j: key(self._pending[j]))
        return self._pending.pop(best)


def serve_trees(
    requests: Sequence[TreeRequest],
    n_devices: int,
    alpha: float,
    *,
    policy: str = "pm",
    admission: str = "fifo",
    max_concurrent: Optional[int] = None,
    weights: Optional[Dict[int, float]] = None,
    noise=None,
    speedup_floor: bool = False,
    memory_capacity: Optional[float] = None,
):
    """Serve a stream of tree requests; returns the :class:`OnlineReport`.

    ``policy`` is the share rule (pm / proportional / static — see
    OnlineScheduler); ``admission`` the queue discipline.  Static share
    plans cannot overlap trees (frozen shares of two trees would break
    the §4 resource bound), so ``static`` forces ``max_concurrent=1``.
    ``memory_capacity`` (bytes) makes admission memory-aware: admitted
    trees' minimal peaks must fit in the pool together.  ``weights``
    are per-tenant QoS weights for ``admission="fair"``.
    """
    from repro_torch.api.problem import as_problem  # deferred: api ← online
    from .scheduler import OnlineScheduler  # deferred: queue ← scheduler

    if policy.startswith("static"):
        max_concurrent = 1
    sched = OnlineScheduler(
        n_devices,
        alpha,
        policy=policy,
        noise=noise,
        speedup_floor=speedup_floor,
        admission=AdmissionQueue(admission, max_concurrent, weights),
        memory_capacity=memory_capacity,
    )
    for req in requests:
        sched.submit(
            as_problem(req.tree, alpha),
            at=req.arrival,
            tenant=req.tenant,
            rid=req.rid,
        )
    return sched.run()


def poisson_arrivals(
    n: int, mean_interarrival: float, seed: int = 0
) -> np.ndarray:
    """Seeded Poisson-process arrival times for benchmark streams."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(mean_interarrival, size=n))


__all__ = [
    "POLICIES",
    "AdmissionQueue",
    "TreeRequest",
    "poisson_arrivals",
    "serve_trees",
]
