"""Cluster lifecycle: start a scheduler + workers in one process.

:class:`LocalCluster` is the deployment unit tests, benchmarks and
``Session.serve(cluster=...)`` use: one scheduler and ``n_workers``
workers wired over the chosen comm scheme (``inproc`` for
deterministic in-process runs, ``tcp`` for a real loopback cluster —
same protocol either way).  It is a context manager and its
:meth:`stop` is deterministic: workers deregister and join, the
scheduler loop and listener close, and :func:`leaked_threads` /
:func:`open_socket_count` let a test assert nothing survived the drain.

Workers run on torch devices: ``devices=None`` means every CUDA device
(worker *i* on ``devices[i % len(devices)]``) and raises where there is
none, the rule of the port's executor; the CPU (the kernels' plain
versions) is used only when the caller passes it.
"""
from __future__ import annotations

import itertools
import threading
from typing import List, Optional, Sequence

import torch

from repro_torch.cluster.scheduler import ClusterClient, ClusterScheduler
from repro_torch.cluster.worker import Worker

_CLUSTER_SEQ = itertools.count(1)
_THREAD_PREFIX = "repro_torch-"


def leaked_threads() -> List[str]:
    """Names of live threads of the port's cluster and dashboard (empty
    after a clean stop).  Their names start with ``repro_torch-``, so the
    JAX package's threads (``repro-``) in the same process never count."""
    return [
        t.name
        for t in threading.enumerate()
        if t.name.startswith(_THREAD_PREFIX) and t.is_alive()
    ]


def open_socket_count(cluster: "LocalCluster") -> int:
    """Open TCP endpoints still owned by this cluster (0 after stop)."""
    n = 0
    for comm in [w.comm for w in cluster.workers]:
        if getattr(comm, "backend", "") == "tcp" and not comm.closed:
            n += 1
    listener = cluster.scheduler.listener
    sock = getattr(listener, "_sock", None)
    if sock is not None and sock.fileno() != -1:
        n += 1
    return n


class LocalCluster:
    """One scheduler + ``n_workers`` workers, in this process.

    Parameters
    ----------
    n_workers, slots_per_worker : cluster capacity (total slots =
        product).
    scheme : ``"inproc"`` (deterministic, default) or ``"tcp"``
        (loopback sockets, same protocol).
    dispatch_overhead_s : fixed per-dispatch cost each worker pays —
        the quantity cross-tenant batching amortizes; keep 0 for pure
        numeric runs.
    devices : the workers' torch devices, worker *i* on
        ``devices[i % len(devices)]`` (several workers may share one
        card); ``None`` (default) is every CUDA device and raises
        :class:`RuntimeError` where there is none.
    dtype : the numeric fronts' type, ``torch.float32`` (default) or
        ``torch.float64``.
    Remaining keywords are forwarded to :class:`ClusterScheduler`
    (policy, admission, max_concurrent, memory_capacity, batching,
    max_batch, work_rate, heartbeat/tick timings, alpha).
    """

    def __init__(
        self,
        n_workers: int = 2,
        *,
        slots_per_worker: int = 2,
        scheme: str = "inproc",
        heartbeat_interval: float = 0.05,
        heartbeat_timeout: float = 0.25,
        dispatch_overhead_s: float = 0.0,
        devices: Optional[Sequence[torch.device]] = None,
        dtype: torch.dtype = torch.float32,
        name: Optional[str] = None,
        **scheduler_kwargs,
    ) -> None:
        if scheme not in ("inproc", "tcp"):
            raise ValueError(f"unknown comm scheme {scheme!r}")
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError(
                    "LocalCluster: no CUDA device; pass "
                    "devices=[torch.device('cpu')] to run on the CPU"
                )
            devices = [torch.device("cuda", i) for i in range(n)]
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("LocalCluster: devices is empty")
        self.name = name or f"cluster-{next(_CLUSTER_SEQ)}"
        address = (
            f"inproc://{self.name}" if scheme == "inproc"
            else "tcp://127.0.0.1:0"
        )
        self.scheduler = ClusterScheduler(
            address,
            heartbeat_timeout=heartbeat_timeout,
            dtype=dtype,
            name=f"{self.name}-scheduler",
            **scheduler_kwargs,
        )
        self.address = self.scheduler.address  # real address (tcp port bound)
        self.workers: List[Worker] = [
            Worker(
                self.address,
                slots=slots_per_worker,
                name=f"{self.name}-worker-{i}",
                heartbeat_interval=heartbeat_interval,
                dispatch_overhead_s=dispatch_overhead_s,
                device=self.devices[i % len(self.devices)],
            )
            for i in range(n_workers)
        ]
        self._stopped = False

    # ------------------------------------------------------------------
    def client(self, label: str = "client") -> ClusterClient:
        return ClusterClient(self.address, label=f"{self.name}-{label}")

    def total_slots(self) -> int:
        return sum(w.slots for w in self.workers)

    def drain(self, timeout: float = 30.0) -> bool:
        return self.scheduler.drain(timeout=timeout)

    def stop(self, timeout: float = 5.0) -> None:
        """Deterministic teardown: workers first, then the scheduler."""
        if self._stopped:
            return
        self._stopped = True
        for w in self.workers:
            w.stop(timeout=timeout)
        self.scheduler.stop(timeout=timeout)

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def __repr__(self) -> str:
        return (
            f"<LocalCluster {self.name} @ {self.address} "
            f"workers={len(self.workers)}×"
            f"{self.workers[0].slots if self.workers else 0} slots>"
        )


__all__ = ["LocalCluster", "leaked_threads", "open_socket_count"]
