"""Persistent serving cluster: scheduler/worker split over pluggable comm.

The distributed half of the serving story (the in-process half lives in
:mod:`repro_torch.online`):

* :mod:`repro_torch.cluster.comm` — inproc/TCP message layer, one protocol;
* :mod:`repro_torch.cluster.scheduler` — long-lived scheduler: admission,
  Lemma-4 re-share on every cluster event, cross-tenant continuous
  batching, heartbeat failure detector → Theorem-6 capacity events;
* :mod:`repro_torch.cluster.worker` — slot-registering, heartbeating workers
  executing front groups on a torch device (the hand-written kernels on
  a CUDA device, their plain versions on the CPU);
* :mod:`repro_torch.cluster.engine` — the JetStream-style engine facade over
  both the virtual-time and the cluster backend;
* :mod:`repro_torch.cluster.service` — :class:`LocalCluster` lifecycle.
"""
from repro_torch.cluster.comm import (
    Comm,
    CommClosedError,
    CommError,
    FaultInjector,
    RetryPolicy,
    connect,
    decode,
    encode,
    listen,
)
from repro_torch.cluster.engine import ClusterEngine, EngineStats, SimEngine
from repro_torch.cluster.scheduler import (
    ClusterClient,
    ClusterFuture,
    ClusterScheduler,
    TreeResult,
)
from repro_torch.cluster.service import LocalCluster, leaked_threads, open_socket_count
from repro_torch.cluster.worker import Worker

__all__ = [
    "ClusterClient",
    "ClusterEngine",
    "ClusterFuture",
    "ClusterScheduler",
    "Comm",
    "CommClosedError",
    "CommError",
    "EngineStats",
    "FaultInjector",
    "LocalCluster",
    "RetryPolicy",
    "SimEngine",
    "TreeResult",
    "Worker",
    "connect",
    "decode",
    "encode",
    "leaked_threads",
    "listen",
    "open_socket_count",
]
