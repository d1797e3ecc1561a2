"""Online scheduling: the paper's profile-invariance (Lemma 4 / Thm 6)
turned into an event-driven control layer that serves trees of malleable
tasks as a service (port of ``repro.online``).

events     discrete-event core: heap, virtual clock, pool, noise models
state      dask-style task state machine + per-tree root futures
scheduler  OnlineScheduler: O(n) PM re-share on every event, §4-valid
queue      multi-tenant admission (FIFO / SJF-by-𝓛 / fair-share)
replay     bridge an online run onto the plan executor (the card)

``OnlineScheduler`` is exported directly, without the reference's PEP-562
deprecation shim: the port's own callers import from this package, where
a shim would warn (``repro_torch.serve.serve_online`` is the one name the
port's ``api._deprecate`` shims).
"""
from .events import (
    Arrival,
    EventQueue,
    LognormalNoise,
    NoNoise,
    ProcessorPool,
    SetCapacity,
    SetNodeSpeed,
    TaskFailure,
    UniformNoise,
    VirtualClock,
)
from .queue import AdmissionQueue, TreeRequest, poisson_arrivals, serve_trees
from .replay import execute_online, plan_from_online, run_online_plan
from .scheduler import SHARE_POLICIES, OnlineReport, OnlineScheduler
from .state import OnlineFailure, TreeFuture, TreeRun, combined_tree

__all__ = [k for k in dir() if not k.startswith("_")]
