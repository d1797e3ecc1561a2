"""repro_torch.api — the unified scheduling facade (port of ``repro.api``).

Three concepts, one result type:

* :class:`Platform`  — where things run: shared-memory processors
  (:class:`SharedMemory`, §4's p(t)), distributed multicore nodes
  (:class:`MulticoreCluster`, §6's 𝓡 constraint), or torch devices
  (:class:`DeviceMesh`: every CUDA device, or CPU lanes the caller passes).
* :class:`Policy`    — how shares are decided: a string-keyed registry
  (``pm``, ``proportional``, ``divisible``, ``greedy``, ``static``,
  ``two-node``, ``hetero``, ``k-node``, ...); new policies register via
  the :func:`register_policy` decorator in their own file.
* :class:`Session`   — the fluent driver:
  ``Session(platform).analyze(A, alpha=0.9).plan(policy="greedy")`` then
  ``.execute(dtype=...)`` on the platform's devices, ``.simulate(noise=...)``
  (event loop) or ``.serve(stream)`` (request serving, in virtual time).

Every path produces the same :class:`Schedule` (§4 validation, fluid
lower bound, JSON round-trip, Gantt/trace export) and, when run, a
:class:`RunReport`.  The shared :class:`Problem` carries the tree and α
so no subsystem re-derives lengths independently.
"""
from .platform import (
    DeviceMesh,
    MixedCluster,
    MulticoreCluster,
    Platform,
    Resources,
    SharedMemory,
    as_platform,
)
from .policy import (
    POLICY_REGISTRY,
    Policy,
    accepts_memory_budget,
    available_policies,
    get_policy,
    register_policy,
)
from .problem import Problem, as_problem
from .schedule import RunReport, Schedule, ShareEntry
from .session import Session

__all__ = [
    "DeviceMesh",
    "MixedCluster",
    "MulticoreCluster",
    "POLICY_REGISTRY",
    "Platform",
    "Policy",
    "Problem",
    "Resources",
    "RunReport",
    "Schedule",
    "Session",
    "SharedMemory",
    "ShareEntry",
    "accepts_memory_budget",
    "as_platform",
    "as_problem",
    "available_policies",
    "get_policy",
    "register_policy",
]
