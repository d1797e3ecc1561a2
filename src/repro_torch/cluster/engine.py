"""JetStream-style serving engine facade over both backends.

The JetStream engine API models a serving runtime as
an *engine* with a fixed number of concurrency **slots**, request
admission into free slots, and continuous batching of compatible work
into shared device dispatches.  This module maps that contract onto
malleable-tree serving and gives it two interchangeable backends:

:class:`SimEngine`
    the in-process backend: the discrete-event
    :class:`~repro_torch.online.scheduler.OnlineScheduler` +
    :class:`~repro_torch.online.queue.AdmissionQueue` in **virtual time**.
    Deterministic and instantaneous — what the reference's
    ``serve/pod_scheduler.py`` runs on (not ported yet).  ``max_concurrent`` is the slot count.

:class:`ClusterEngine`
    the distributed backend: a
    :class:`~repro_torch.cluster.scheduler.ClusterScheduler` with real
    workers over :mod:`repro_torch.cluster.comm`, in **wall time**.  Slots
    are worker capacities; continuous batching merges same-shape
    fronts across tenants into one kernel launch on a worker's device.

Both speak the same verbs — ``submit(problem, tenant=, rid=) →
future``-ish handle, ``drain()``, ``stats() → EngineStats`` — so the
API layer (``Session.serve``) picks a backend with one argument
(``cluster=``).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.api.problem import Problem, as_problem
from repro_torch.online.state import RequestRecord


def _quantile(xs: List[float], q: float) -> float:
    return float(np.quantile(np.asarray(xs, dtype=np.float64), q)) if xs else 0.0


@dataclass
class EngineStats:
    """Service-level numbers both backends report identically."""

    n_requests: int = 0
    n_failed: int = 0
    makespan: float = 0.0  # first submit → last completion
    qps: float = 0.0  # completed requests / makespan
    p50_latency: float = 0.0
    p99_latency: float = 0.0
    mean_latency: float = 0.0
    mean_wait: float = 0.0  # admission wait (submit → admit)
    mean_exec: float = 0.0  # execution (admit → done)
    per_tenant: Dict[int, dict] = field(default_factory=dict)

    @classmethod
    def of_records(
        cls, records: List[RequestRecord], *, n_failed: int = 0
    ) -> "EngineStats":
        if not records:
            return cls(n_failed=n_failed)
        lat = [r.latency for r in records]
        t_first = min(r.t_submit for r in records)
        t_last = max(r.t_done for r in records)
        makespan = max(t_last - t_first, 1e-12)
        per_tenant: Dict[int, dict] = {}
        for tenant in sorted({r.tenant for r in records}):
            rs = [r for r in records if r.tenant == tenant]
            per_tenant[tenant] = {
                "n": len(rs),
                "qps": len(rs) / makespan,
                "p50_latency": _quantile([r.latency for r in rs], 0.5),
                "p99_latency": _quantile([r.latency for r in rs], 0.99),
                "mean_wait": float(np.mean([r.wait for r in rs])),
            }
        return cls(
            n_requests=len(records),
            n_failed=n_failed,
            makespan=makespan,
            qps=len(records) / makespan,
            p50_latency=_quantile(lat, 0.5),
            p99_latency=_quantile(lat, 0.99),
            mean_latency=float(np.mean(lat)),
            mean_wait=float(np.mean([r.wait for r in records])),
            mean_exec=float(np.mean([r.exec_time for r in records])),
            per_tenant=per_tenant,
        )

    def as_dict(self) -> dict:
        return {
            "n_requests": self.n_requests,
            "n_failed": self.n_failed,
            "makespan": self.makespan,
            "qps": self.qps,
            "p50_latency": self.p50_latency,
            "p99_latency": self.p99_latency,
            "mean_latency": self.mean_latency,
            "mean_wait": self.mean_wait,
            "mean_exec": self.mean_exec,
            "per_tenant": self.per_tenant,
        }


# ----------------------------------------------------------------------
class SimEngine:
    """Virtual-time engine: OnlineScheduler + AdmissionQueue in-process.

    Submissions carry explicit ``arrival`` times (virtual seconds);
    :meth:`run` drives the event loop and resolves everything at once.
    """

    backend = "sim"

    def __init__(
        self,
        slots,
        alpha: Optional[float] = None,
        *,
        policy: str = "pm",
        admission: str = "fifo",
        max_concurrent: Optional[int] = None,
        qos_weights=None,
        memory_capacity: Optional[float] = None,
        noise=None,
        speedup_floor: bool = False,
    ) -> None:
        self.slots = slots
        self.alpha = alpha
        self.policy = policy
        self.admission = admission
        self.max_concurrent = max_concurrent
        self.qos_weights = qos_weights
        self.memory_capacity = memory_capacity
        self.noise = noise
        self.speedup_floor = speedup_floor
        self._pending: List[tuple] = []  # (problem, arrival, tenant, rid)
        self._report = None

    def submit(
        self,
        problem,
        *,
        arrival: float = 0.0,
        tenant: int = 0,
        rid: Optional[int] = None,
    ) -> None:
        problem = as_problem(problem, self.alpha)
        if self.alpha is None:
            self.alpha = problem.alpha
        self._pending.append((problem, float(arrival), tenant, rid))

    def run(self, until: float = math.inf):
        """Drive the virtual clock to completion → OnlineReport."""
        from repro_torch.online.events import NoNoise
        from repro_torch.online.queue import AdmissionQueue
        from repro_torch.online.scheduler import OnlineScheduler

        if self.alpha is None:
            raise ValueError("no submissions: alpha never bound")
        sched = OnlineScheduler(
            self.slots,
            self.alpha,
            policy=self.policy,
            noise=self.noise or NoNoise(),
            admission=AdmissionQueue(
                self.admission, self.max_concurrent, self.qos_weights
            ),
            memory_capacity=self.memory_capacity,
            speedup_floor=self.speedup_floor,
        )
        for rid, (problem, arrival, tenant, prid) in enumerate(self._pending):
            sched.submit(
                problem,
                at=arrival,
                tenant=tenant,
                rid=prid if prid is not None else rid,
            )
        self._report = sched.run(until=until)
        return self._report

    def records(self) -> List[RequestRecord]:
        if self._report is None:
            self.run()
        return self._report.request_results()

    def stats(self) -> EngineStats:
        report = self._report if self._report is not None else self.run()
        n_failed = sum(
            1 for f in report.futures.values() if f.state == "failed"
        )
        return EngineStats.of_records(self.records(), n_failed=n_failed)


# ----------------------------------------------------------------------
class ClusterEngine:
    """Wall-clock engine over a scheduler/worker cluster.

    Wraps a :class:`~repro_torch.cluster.service.LocalCluster` (owned, torn
    down on :meth:`close`) or an externally managed cluster/client.
    """

    backend = "cluster"

    def __init__(self, cluster, *, own: bool = False, label: str = "engine") -> None:
        self.cluster = cluster
        self._own = own
        self.client = cluster.client(label=label)
        self.futures: List = []

    def submit(
        self,
        problem,
        *,
        tenant: int = 0,
        rid: Optional[int] = None,
        alpha: Optional[float] = None,
    ):
        fut = self.client.submit(
            as_problem(problem, alpha), tenant=tenant, rid=rid
        )
        self.futures.append(fut)
        return fut

    def drain(self, timeout: float = 60.0) -> List:
        """Wait for every submitted tree; returns TreeResults."""
        return self.client.gather(self.futures, timeout=timeout)

    def records(self) -> List[RequestRecord]:
        out = []
        for f in self.futures:
            if f.done():
                r = f.result(timeout=0)
                if r.ok:
                    out.append(RequestRecord(
                        rid=r.rid, tenant=r.tenant, tree_id=r.tree_id,
                        t_submit=r.t_submit, t_admit=r.t_admit,
                        t_done=r.t_done,
                    ))
        return out

    def stats(self) -> EngineStats:
        n_failed = sum(
            1 for f in self.futures
            if f.done() and not f.result(timeout=0).ok
        )
        return EngineStats.of_records(self.records(), n_failed=n_failed)

    def scheduler_stats(self, timeout: float = 5.0) -> dict:
        return self.client.stats(timeout=timeout)

    def close(self) -> None:
        self.client.close()
        if self._own:
            self.cluster.stop()

    def __enter__(self) -> "ClusterEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["ClusterEngine", "EngineStats", "SimEngine"]
