"""Malleable-plan executor: run an ExecutionPlan on CUDA devices.

This closes the loop the rest of the repo only *projects*: the symbolic
phase (repro_torch.sparse.symbolic) turns a sparse SPD matrix into an assembly
tree of malleable tasks, the PM planner (repro_torch.sparse.plan) turns the tree
into per-front device-group shares with p^α model times — and this module
actually factorizes the matrix by running those fronts on the card(s): fronts
are assembled and factored by the hand-written CUDA kernels of
``repro_torch.kernels`` (their plain PyTorch versions on CPU devices, which
the caller asks for explicitly with ``devices=[torch.device("cpu")] * k``).

One numeric path per front, shared by four runners, and one route shape.
The run's values (the lower CSC's ``data``, float64) cross to each lane
the run engages once (``_Run.values_on``); every front's original entries
are gathered and placed on the card through index maps in padded
coordinates, built once a pattern (``_entry_maps``: one vectorised pass
over the lower CSC; ``_kid``: each child's rows in its parent's padded
front) and uploaded to a lane in a few flat tensors (``_lane``).  The
main thread pops a dispatch's children's blocks and hands a worker a job
(``_take``, ``_jobs``: the members' rows of the front table, the
dispatch's index table); the worker (``_run_job``) builds the members'
float64 (B, mp, mp) stack on its lane: zeros with a unit diagonal on the
padding, the original entries and their mirrors in one indexed write,
each child's Schur block added in tree order by the ``extend_add``
kernel, one cast to the run's dtype — the host's arithmetic in the
host's order, so the bits are the host-assembled, host-padded fronts'.
A dispatch of small fronts (padded order up to ``VMEM_FRONT_MAX``, a
batch of one shape class) is factored in one launch (``_run_batch``), a
large front alone by the panel + SYRK pipeline; then every member's
(m, nb) panel is gathered on the card into one buffer and copied to the
host once, and split there into views.  Every Schur block stays on its
lane as a view of its front's factored padded output (``_Kept``) until
the parent's worker has added it; nothing padded crosses the bus.  The
memory bookkeeping counts a front as its m² entries at the run's dtype,
a small dispatch's padded stack as the host copy the reference makes,
and a kept block as the host copy it replaces, so the cap's decisions do
not depend on where a block lives: the bookkeeping
(``memory_cap_bytes``, ``measured_peak_bytes``) models the reference's
resident bytes, not what a lane holds, which for a kept block is its
front's whole factored padded output (mp² in the run's dtype, panel and
padding included, shared with the other members of its stack; 134 MB at
mp = 4,096 in float64 against the 115 MB of its Schur block).

The runners differ only in what they dispatch and when; each keeps its
state on one ``_Run`` (panels, queued Schur blocks, memory counters,
trace) and produces **bit-identical factors**:

1. *Async futures runner* (``mode="async"``, the default) — the dask-style
   per-front state machine of the online scheduler made real.  A front is
   *ready* the instant the last of its children's Schur complements lands;
   ready fronts of the same padded shape class are opportunistically
   coalesced into one batched kernel launch (up to ``max_batch``), each
   dispatch's device group is carved incrementally from the currently free
   devices (:class:`~repro_torch.distributed.device_groups.BuddyAllocator`), and
   the dispatch is issued on a worker thread immediately — extend-add and
   later dispatches overlap whatever is still in flight.  No global wave
   barrier: a straggling front only stalls its own ancestors, never the
   rest of the mesh (§3–§4's instantaneous re-share, applied to discrete
   device groups).  Child Schur-complement buffers are freed when their
   last (only) consumer assembles, which happens as early as possible, so
   the measured peak tightens relative to the wave path; an optional
   ``memory_cap_bytes`` defers dispatches that would exceed a byte budget
   while anything is in flight.  The ready set (``_Ready``) is one
   min-heap of ``(priority, front)`` per shape class, so a dispatch takes
   the class with the smallest top without rescanning the ready fronts.
2. *Wave runner* (``mode="waves"``, the legacy path, kept for A/B
   benchmarking) — ``plan.waves()`` gives maximal same-start task sets;
   each wave's fronts are assembled, batched per shape class, and factored
   before the next wave starts.  One straggler front stalls the entire
   wave front behind the barrier — exactly the rigidity the malleable
   model exists to avoid, and what ``benchmarks.bench_async`` measures.

An amalgamated plan (``provenance=``) runs the same two loops with the
fused group as the unit: a group is one dispatch (the async runner's
groups share one heap), and its members factor level by level on the
first lane through the same per-front path (``_run_group``), each
member's Schur block kept there for its parent inside the group or
outside it.

Both modes emit a :class:`TraceEvent` per front (planned and carved group
sizes, dispatch width, wall-clock start/end, flops, and — new with the
futures runner — when the front became ready and when it was submitted, so
ready-latency and dispatch-latency are first-class observables; see
``ExecutionReport.to_trace`` for the chrome-trace rendering).  The
:class:`ExecutionReport` compares the measured makespan against the plan's
p^α projection and re-fits an *empirical* α from the trace (log throughput
vs log engaged-devices regression over dispatches, the same regression the
paper's §3 runs on measured dense-kernel timings).

Straggler injection: ``delay_fn`` (front id → seconds; see
``repro_torch.runtime.straggler.FrontDelays``) stretches a front's dispatch as if
its device were slow — applied identically in both modes, it is the
controlled experiment for the barrier-vs-futures comparison.

Timing semantics: each dispatch is timed host-side around the copy of its
panels back to the host (which synchronizes the launching stream); fronts
sharing a dispatch share its interval, and throughput is measured at
dispatch granularity (one point per kernel launch — see
``ExecutionReport.dispatch_points``) for the α re-fit.  ``warmup=True``
builds or loads the kernel library and runs an identity front of every
small shape class through the route once on every distinct device,
untimed, so no build lands inside the trace.  A list of devices may repeat one card as several
logical lanes.

Sharded dispatch (``shard_dispatch``, on by default for CUDA devices): a
batch of small fronts whose carved groups span several lanes is padded
with identity fronts to a multiple of the lane count and split into equal
shards, one kernel launch per lane, all issued before the first copy back;
the trace's ``dispatch_devices`` is the number of lanes the dispatch
engaged.  Fronts are independent, so no collective is needed, and a
front's bits depend on neither its batch nor its lane.

Host stages: every thread of a ``run`` is at each moment in exactly one of
``STAGES`` (self time; see ``STAGES`` for what each covers).  Each stretch
of a stage is a bus span of category ``dispatch`` keyed by the dispatch's
sequence number and, while ``torch.profiler`` records, an
``executor.<stage>`` range in its trace.  A run's totals (seconds by stage,
bytes copied between host and device and the useful part of them, the
pauses of Python's garbage collector) land on ``ExecutionReport.host`` and,
once per ``run`` (so ``warmup`` adds nothing), in registry counters:
``repro_executor_stage_seconds_total{stage}``,
``repro_executor_copy_bytes_total{kind=copied|useful}`` (the run's values
once a lane and every front's panel: all of it useful, since nothing
padded crosses), ``repro_host_gc_seconds_total`` (a ``gc.callbacks`` hook
installed for the run) and, from the clocks of the worker threads and
apart from their stages, ``repro_executor_large_seconds_total`` (inside
``_run_job`` for a large front: the assembly on the lane, the panel +
SYRK loop, the panel's copy), ``repro_executor_large_bytes_total`` (the
part of ``copied`` it moved: the large fronts' panels),
``repro_executor_large_fronts_total``, ``repro_executor_kept_bytes_total``
/ ``repro_executor_kept_blocks_total`` (the Schur bytes and blocks a large
front kept on a lane for a large parent's extend-add, counted as the host
copies they replace), ``repro_executor_small_fronts_total`` (small fronts
assembled on a lane) and ``repro_executor_small_kept_bytes_total`` (their
Schur bytes kept on a lane, counted likewise); each large front is an
``executor.large`` profiler range.  Index tables are not a run's data and
are not counted: the maps' uploads (the pattern's, once a lane) and a
dispatch's rows of the front table (four integers a front).  ``RunReport.metrics``
keeps the reference's names.  Every span and point of a run is stamped
on the bus clock (``BUS.wall()``; the report's run-relative times are
shifted by the run's start when published), so consecutive runs lie end
to end on one axis, and ``BUS.epoch`` places them on the ``perf_counter``
base.  A profiler range opened on a worker thread
started inside the profiled window does not reach the exported trace, so
``executor.transfer`` may be absent there; it stays a bus span.  The
``repro_resident_bytes`` gauge keeps no series: the bus's
``resident_bytes`` point carries it.
"""
from __future__ import annotations

import contextlib
import gc
import heapq
import math
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass, field, fields
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.distributed.device_groups import (
    BuddyAllocator,
    DeviceGroup,
    assign_wave_groups,
    pow2_floor,
    scale_group,
)
from repro_torch.kernels.frontal_cholesky import VMEM_FRONT_MAX, extend_add
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.kernels.ops import batched_front_factor, factor_padded, padded_shape
from repro_torch.sparse.multifrontal import Factorization, lower_csc
from repro_torch.sparse.plan import ExecutionPlan
from repro_torch.sparse.symbolic import SymbolicFactorization

DelayFn = Callable[[int], float]  # front id -> injected dispatch delay (s)

MODES = ("async", "waves")

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}

# The host stages of a run.  The main thread's: ``scan`` (the ready scan:
# shape classes, priorities, device groups, memory bookkeeping, handing a
# dispatch to a worker; the static schedule on the wave path), ``assemble``
# (the matrix in CSC and the pattern's maps; popping the children's Schur
# blocks), ``pad`` (building a dispatch's index table), ``wait`` (blocked
# on the workers, or an injected delay), ``extract`` (splitting the panels
# and the completion's bookkeeping), ``report`` (the projected peak, the
# report and its publishing).  The thread that runs a dispatch's kernels:
# ``transfer`` (the assembly on the lane, the launches, the panels' copy
# out; the main thread's own on the wave path; on the fused async path a
# worker's whole group, its host steps included).
STAGES = ("scan", "assemble", "pad", "wait", "extract", "report", "transfer")


def _large_range():
    """An ``executor.large`` profiler range while ``torch.profiler``
    records, else nothing."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.autograd.profiler.record_function("executor.large")
    return contextlib.nullcontext()


def _default_devices() -> List[torch.device]:
    """Every CUDA device; raises when there is none (the CPU is only ever
    used when the caller passes it explicitly)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "PlanExecutor: no CUDA device; pass devices=[torch.device('cpu')]"
            " * k to run the plain PyTorch versions on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


# ----------------------------------------------------------------------
@dataclass(frozen=True)
class HostTotals:
    """One run's host accounting.

    ``seconds``: by stage (every name of ``STAGES``); ``gc_seconds``: the
    pauses of Python's garbage collector while the run was in progress;
    ``copied_bytes``: what crossed between host and device (the run's
    values once a lane in, every front's panel out); ``useful_bytes``: of
    those, the fronts' own, which is all of it (nothing padded crosses).
    """

    seconds: Dict[str, float]
    gc_seconds: float
    copied_bytes: float
    useful_bytes: float


@dataclass(frozen=True)
class TraceEvent:
    """One front's execution record."""

    front: int  # supernode id (plan label)
    wave: int  # wave index (waves mode) / dispatch sequence (async mode)
    devices: int  # planned device-group size (the plan's model)
    devices_used: int  # group carved on the executing mesh (placement)
    dispatch_devices: int  # distinct devices the front's dispatch engaged
    t_start: float  # seconds since run start
    t_end: float
    flops: float
    batched: int  # number of fronts sharing this dispatch
    # futures-mode observables (NaN on the wave path, which has no
    # per-front ready instant — readiness is the wave barrier itself)
    t_ready: float = math.nan  # children done → front became dispatchable
    t_submit: float = math.nan  # handed to a worker / dispatch issued
    device0: int = -1  # first device lane of the carved group (mesh index)

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start

    @property
    def ready_latency(self) -> float:
        """Ready → dispatch start: time spent waiting for devices/batching."""
        return self.t_start - self.t_ready

    @property
    def dispatch_latency(self) -> float:
        """Submit → dispatch start: queueing inside the worker pool."""
        return self.t_start - self.t_submit


@dataclass
class ExecutionReport:
    """Measured-vs-projected comparison of one executed plan."""

    plan_makespan: float  # p^α model units (flops at task_tree's flop_rate)
    plan_alpha: float
    plan_devices: int
    measured_makespan: float  # seconds
    trace: List[TraceEvent] = field(default_factory=list)
    n_dispatches: int = 0
    n_devices: int = 1
    interpret: bool = True  # True when the plain versions ran (CPU devices)
    # the memory dimension: peak bytes of the reference's host buffers
    # (fronts + retained panels + pending Schur updates; a block kept on
    # a lane counted as its host copy) vs. the peak the plan's
    # resident-bytes timeline projects at the executed dtype
    measured_peak_bytes: float = 0.0
    projected_peak_bytes: float = 0.0
    mode: str = "waves"  # which runner produced this report
    host: Optional[HostTotals] = None  # set when the run ends

    # ------------------------------------------------------------------
    def total_flops(self) -> float:
        return float(sum(e.flops for e in self.trace))

    def measured_rate(self) -> float:
        """Effective flop rate (flops/s) over the whole run."""
        return self.total_flops() / max(self.measured_makespan, 1e-12)

    def projected_seconds(self) -> float:
        """Plan makespan mapped to seconds at the measured flop rate.

        The plan's unit is "flops on one device" (task_tree(flop_rate=1)),
        so normalizing by the measured aggregate rate asks: had the machine
        sustained its observed throughput *and* the p^α model held, how long
        should the critical path have taken?  The ratio to the measured
        makespan is the model error + discretization + dispatch overhead.

        Busy time sums each dispatch interval once (fronts sharing a
        dispatch share its interval — counting per front would deflate the
        rate by the batching factor).
        """
        busy = sum(
            t1 - t0
            for (t0, t1) in {(e.t_start, e.t_end) for e in self.trace}
            if t1 > t0
        )
        work_rate = self.total_flops() / max(busy, 1e-12)
        return self.plan_makespan / work_rate

    def dispatch_points(self) -> List[Tuple[int, float]]:
        """One (engaged devices, flops/s) point per kernel dispatch.

        Fronts sharing a dispatch share its wall-clock interval, so the
        dispatch — not the front — is the unit at which throughput is
        actually observable; splitting the interval per front would just
        replicate the same aggregate rate.
        """
        by_interval: Dict[Tuple[float, float], List[TraceEvent]] = {}
        for e in self.trace:
            by_interval.setdefault((e.t_start, e.t_end), []).append(e)
        out: List[Tuple[int, float]] = []
        for (t0, t1), evs in by_interval.items():
            if t1 - t0 <= 1e-9:
                continue
            out.append(
                (evs[0].dispatch_devices, sum(e.flops for e in evs) / (t1 - t0))
            )
        return out

    def fit_alpha(self) -> Optional[float]:
        """Empirical α: regress log throughput on log engaged devices.

        The §3 regression run on *this* execution instead of the roofline
        model, at dispatch granularity (see ``dispatch_points``).  With the
        current front-per-device dispatch it measures *across-front*
        scaling — how throughput grows with the devices a wave engages;
        once a cross-device factor kernel lands, the same fit reads
        intra-front scaling.  Returns None when dispatches engaged fewer
        than two distinct device counts (e.g. the single-device fallback)
        — there is no slope to fit, not a value of 0.
        """
        pts = [(g, r) for g, r in self.dispatch_points() if g >= 1 and r > 0]
        if len({g for g, _ in pts}) < 2:
            return None
        lg = np.log([g for g, _ in pts])
        lr = np.log([r for _, r in pts])
        return float(np.polyfit(lg, lr, 1)[0])

    def mean_ready_latency(self) -> Optional[float]:
        """Mean ready→start latency over fronts that recorded readiness
        (async mode); None on a wave-mode trace."""
        lats = [
            e.ready_latency
            for e in self.trace
            if not math.isnan(e.t_ready)
        ]
        if not lats:
            return None
        return float(np.mean(lats))

    def to_trace(self, time_scale: float = 1e6) -> List[Dict]:
        """Chrome trace-event export (load in ui.perfetto.dev).

        Thin wrapper over :func:`repro_torch.obs.trace.from_execution_report`
        — all trace emitters share one field set.  One ``X`` slice per
        front on its dispatch's row; async-mode ready/dispatch latencies
        land in ``args`` so the stall structure (waiting-for-devices vs
        running) is visible next to the slices.
        """
        return obs_trace.from_execution_report(self, time_scale)

    def summary(self) -> str:
        a_fit = self.fit_alpha()
        proj_s = self.projected_seconds()
        lines = [
            f"executed {len(self.trace)} fronts in {self.n_dispatches} "
            f"dispatches on {self.n_devices} device(s) "
            f"(mode={self.mode}, interpret={self.interpret})",
            f"measured  makespan {self.measured_makespan*1e3:9.2f} ms  "
            f"({self.measured_rate():.3g} flop/s effective)",
            f"projected makespan {proj_s*1e3:9.2f} ms  "
            f"(p^α model at measured work rate, α={self.plan_alpha})",
            f"measured/projected {self.measured_makespan/max(proj_s,1e-12):9.2f}x",
            "empirical alpha    "
            + (f"{a_fit:9.3f}" if a_fit is not None else "      n/a")
            + f"  (planned {self.plan_alpha})",
        ]
        lat = self.mean_ready_latency()
        if lat is not None:
            lines.append(f"ready latency      {lat*1e3:9.2f} ms mean")
        if self.projected_peak_bytes > 0:
            lines.append(
                f"peak memory        {self.measured_peak_bytes/2**20:9.2f} MiB"
                f" measured vs {self.projected_peak_bytes/2**20:.2f} MiB"
                f" projected"
            )
        return "\n".join(lines)


# ----------------------------------------------------------------------
class _RunTally:
    """The totals of one ``run``, merged from its threads' stage clocks
    and from a ``gc.callbacks`` hook, published once when it ends."""

    def __init__(self, itemsize: int) -> None:
        self.itemsize = itemsize
        self.seconds = dict.fromkeys(STAGES, 0.0)
        self.copied = 0.0
        self.useful = 0.0
        self.routes = _RouteTally()
        self.gc_seconds = 0.0
        self._gc_t0: Optional[float] = None
        self._lock = threading.Lock()

    def on_gc(self, phase: str, info: Dict) -> None:
        """``gc.callbacks`` hook: one collection at a time runs, so the
        start and stop of a pause come in pairs."""
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_seconds += time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    def merge(self, clock: "_StageClock") -> None:
        with self._lock:
            for stage, sec in clock.seconds.items():
                self.seconds[stage] += sec
            self.copied += clock.copied
            self.useful += clock.useful
            self.routes.add(clock.routes)

    def totals(self) -> HostTotals:
        return HostTotals(dict(self.seconds), self.gc_seconds, self.copied, self.useful)

    def publish(self) -> None:
        """Add the run's totals to the registry's counters."""
        if not obs_events.enabled():
            return
        reg = obs_metrics.REGISTRY
        stages = reg.counter(
            "repro_executor_stage_seconds_total",
            "host seconds of PlanExecutor.run by stage (self time)",
            unit="s",
        )
        for stage, sec in self.seconds.items():
            stages.inc(sec, stage=stage)
        copies = reg.counter(
            "repro_executor_copy_bytes_total",
            "bytes between host and device: all copied, and the fronts' own (useful)",
            unit="bytes",
        )
        copies.inc(self.copied, kind="copied")
        copies.inc(self.useful, kind="useful")
        reg.counter(
            "repro_host_gc_seconds_total",
            "pauses of Python's garbage collector during PlanExecutor.run",
            unit="s",
        ).inc(self.gc_seconds)
        r = self.routes
        reg.counter(
            "repro_executor_large_seconds_total",
            "seconds of the threads that ran a large front's job inside it",
            unit="s",
        ).inc(r.large_seconds)
        reg.counter(
            "repro_executor_large_bytes_total",
            "bytes a large front's job copied between host and device (its panel)",
            unit="bytes",
        ).inc(r.large_bytes)
        reg.counter(
            "repro_executor_large_fronts_total",
            "fronts factored by the panel + SYRK pipeline (padded order past VMEM_FRONT_MAX)",
        ).inc(r.large_fronts)
        reg.counter(
            "repro_executor_kept_bytes_total",
            "Schur bytes the large route kept on the card for a large parent's extend-add",
            unit="bytes",
        ).inc(r.kept_bytes)
        reg.counter(
            "repro_executor_kept_blocks_total",
            "Schur blocks the large route kept on the card for a large parent's extend-add",
        ).inc(r.kept_blocks)
        reg.counter(
            "repro_executor_small_fronts_total",
            "small fronts (padded order up to VMEM_FRONT_MAX) assembled on a lane",
        ).inc(r.small_fronts)
        reg.counter(
            "repro_executor_small_kept_bytes_total",
            "Schur bytes of small fronts kept on a lane, as the host copies they replace",
            unit="bytes",
        ).inc(r.small_kept_bytes)


@dataclass
class _RouteTally:
    """What the jobs of one clock did, by route: the large fronts'
    seconds, panel bytes and count, and the Schur bytes and blocks they
    kept for a large parent; the small fronts assembled on a lane and the
    Schur bytes they kept there."""

    large_seconds: float = 0.0
    large_bytes: float = 0.0
    large_fronts: int = 0
    kept_bytes: float = 0.0
    kept_blocks: int = 0
    small_fronts: int = 0
    small_kept_bytes: float = 0.0

    def add(self, other: "_RouteTally") -> None:
        for f in fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


class _StageClock:
    """One thread's stage clock: from its start to ``close`` the thread is
    in exactly one stage, so the stages' seconds are self time.

    Each stretch of a stage is a bus span (category ``dispatch``, ``key``
    the dispatch's sequence number, -1 for none) and, while
    ``torch.profiler`` records, an ``executor.<stage>`` range.  The
    seconds and bytes are the thread's own until ``close`` merges them
    into the run's tally.  A ``fixed`` clock stays in its first stage and
    ignores ``lap``: a worker thread's, so the main thread's stages stay
    its own self time whatever code the worker shares with it.
    """

    def __init__(
        self,
        tally: _RunTally,
        stage: str,
        key: int = -1,
        device: int = -1,
        fixed: bool = False,
    ) -> None:
        self.tally = tally
        self.device = device
        self.fixed = fixed
        self.seconds = dict.fromkeys(STAGES, 0.0)
        self.copied = 0.0
        self.useful = 0.0
        self.routes = _RouteTally()
        self._range = None
        self._start(stage, key, time.perf_counter())

    def _start(self, stage: str, key: int, t: float) -> None:
        self._stage, self._key, self._t = stage, key, t
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.autograd.profiler.record_function(f"executor.{stage}")
            self._range.__enter__()

    def _stop(self, t: float) -> None:
        self.seconds[self._stage] += t - self._t
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if obs_events.enabled():
            epoch = obs_events.BUS.epoch
            obs_events.BUS.span(
                self._stage, self._t - epoch, t - epoch,
                cat="dispatch", key=self._key, device=self.device,
            )

    def lap(self, stage: str, key: int = -1) -> None:
        """End the current stretch now and start one of ``stage``."""
        if self.fixed or (stage == self._stage and key == self._key):
            return
        t = time.perf_counter()
        self._stop(t)
        self._start(stage, key, t)

    def moved(self, nbytes: int) -> None:
        """Count bytes that crossed between host and device: the fronts'
        own, so useful too."""
        self.copied += nbytes
        self.useful += nbytes

    def close(self) -> None:
        if self._stage is None:
            return
        self._stop(time.perf_counter())
        self._stage = None
        self.tally.merge(self)

    def __enter__(self) -> "_StageClock":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

# ----------------------------------------------------------------------
@dataclass(frozen=True)
class _Dispatch:
    """One kernel launch: same-shape fronts of one wave."""

    wave: int
    key: Tuple[int, int]  # (mp, nbp) shape class
    supernodes: Tuple[int, ...]  # supernode ids in batch order


@dataclass
class _Inflight:
    """Bookkeeping for one issued async dispatch."""

    seq: int  # dispatch sequence number (the trace's wave field)
    units: Tuple[int, ...]  # fronts, or one fused group
    groups: Dict[int, DeviceGroup]
    dispatch_devices: int
    held_bytes: float  # buffers the worker holds until completion
    t_submit: float
    job: Optional["_Job"]  # the fronts' job; None for a fused group


@dataclass
class _Kept:
    """A front's Schur block kept on its lane for the parent's extend-add:
    the lower triangle of ``out[off:off+n, off:off+n]``, its factored
    padded output (a view of its dispatch's stack).  ``nbytes`` is what
    the block would hold on the host, so the memory bookkeeping counts it
    as it did there."""

    out: torch.Tensor
    off: int
    n: int
    nbytes: int

    def block(self, device: torch.device) -> torch.Tensor:
        """The block as a view on ``device``; copied there from another
        card (the reader's ``.to``), a view of ``out`` on its own."""
        b = self.out[self.off : self.off + self.n, self.off : self.off + self.n]
        return b if b.device == torch.device(device) else b.to(device)


class _LaneMaps(NamedTuple):
    """A pattern's index maps on one lane (``PlanExecutor._lane``): every
    front's original entries, grouped by front, as their places in the
    lower CSC's ``data`` (``idx``) and their linear positions in the
    front's padded (mp, mp) block, below the diagonal and mirrored
    (``lower``, ``mirror``; int64), and ``_kid`` (int32)."""

    idx: torch.Tensor
    lower: torch.Tensor
    mirror: torch.Tensor
    kid: torch.Tensor


@dataclass
class _Job:
    """What the main thread hands a worker: the members of a dispatch
    (supernode ids of one shape class ``(mp, nbp)``, in batch order), the
    dispatch's index table (``table``, int64 (6, B), one column a member:
    nb; nbp + m − nb, where the padding's diagonal resumes; the offset
    from a dispatch entry's number to its place in the entry maps; the
    end of its entries among the dispatch's; the start and the end of its
    panel in the dispatch's panel buffer), the members' children's Schur
    blocks in tree order as ``(slot, child, block)``, and the run whose
    values they read (None for warmup's identity fronts: columns of
    zeros, no entries, no children)."""

    members: Tuple[int, ...]
    mp: int
    nbp: int
    table: np.ndarray
    kids: List[Tuple[int, int, _Kept]]
    run: Optional["_Run"]


def _cut_panels(out: torch.Tensor, d: torch.Tensor, nbp: int, n: int) -> torch.Tensor:
    """Every member's (m, nb) panel of a factored (B, mp, mp) stack, one
    after another in one flat tensor of ``n`` entries on the stack's
    device: row r of a panel is row r of its front above nb and
    r + (nbp − nb) below, zero above L11's diagonal.  ``d`` is the job's
    index table (``_Job.table``) on the device."""
    mp = out.shape[-1]
    k = torch.arange(n, device=out.device)
    slot = torch.searchsorted(d[5], k, right=True)  # each entry's member
    k -= d[4][slot]
    nb = d[0][slot]
    r = torch.div(k, nb, rounding_mode="floor")
    c = k - r * nb
    row = torch.where(r < nb, r, r + (nbp - nb))
    return torch.where(r >= c, out.view(-1)[(slot * mp + row) * mp + c], 0.0)


def _top(item: Tuple[object, list]):
    return item[1][0]


class _Ready:
    """The ready units of an async run (fronts, or an amalgamated plan's
    fused groups): one min-heap of priorities per class, a front's padded
    shape class (fused groups share one class), and their count.  A
    priority is ``(planned start, id)``; the ids make the keys unique, so
    heap order is the reference's ``min`` over a ready list."""

    def __init__(self) -> None:
        self.heaps: Dict[object, list] = {}
        self.n = 0

    def push(self, key, prio: Tuple[float, int]) -> None:
        heapq.heappush(self.heaps.setdefault(key, []), prio)
        self.n += 1

    def top(self) -> Tuple[object, list]:
        """The class holding the highest-priority ready unit, and its heap."""
        return min(self.heaps.items(), key=_top)

    @staticmethod
    def head(heap: list, k: int) -> List[int]:
        """The ids of a heap's ``k`` smallest entries, in order, without
        popping: a best-first walk down from the root (the children of
        ``i`` are at ``2i + 1`` and ``2i + 2``), so O(k log k) whatever
        the heap's size."""
        out, frontier = [], [(heap[0], 0)]
        while frontier and len(out) < k:
            e, i = heapq.heappop(frontier)
            out.append(e[-1])
            for j in (2 * i + 1, 2 * i + 2):
                if j < len(heap):
                    heapq.heappush(frontier, (heap[j], j))
        return out

    def pop(self, key, k: int) -> None:
        """Remove the ``k`` smallest entries of class ``key``."""
        heap = self.heaps[key]
        for _ in range(k):
            heapq.heappop(heap)
        if not heap:
            del self.heaps[key]
        self.n -= k

    def take(self, pred: Callable[[int], bool]) -> List[int]:
        """Remove and return the ready ids for which ``pred`` holds."""
        out = []
        for key, heap in list(self.heaps.items()):
            out += [e[-1] for e in heap if pred(e[-1])]
            heap[:] = [e for e in heap if not pred(e[-1])]
            heapq.heapify(heap)
            if not heap:
                del self.heaps[key]
        self.n -= len(out)
        return out


class _Run:
    """What one ``run`` owns: the factor's panels, the Schur blocks queued
    for their parents' extend-add (``updates``: rows and a
    :class:`_Kept`), its values on each lane, the memory bookkeeping, the
    ready set and the allocator of the async runner, the trace and the
    dispatch count, on a clock (``now``) that starts with it.

    The bookkeeping is the reference's: ``held`` the panels and queued
    blocks (a kept block at its host copy's bytes), ``inflight`` what
    issued dispatches hold, ``peak`` the largest resident sum noted."""

    def __init__(
        self, ex: "PlanExecutor", acsc: sp.csc_matrix, clock: _StageClock
    ) -> None:
        self.ex, self.acsc, self.clock = ex, acsc, clock
        self.panels: List[Optional[np.ndarray]] = [None] * ex.symb.n_supernodes
        self.updates: Dict[int, Tuple[np.ndarray, _Kept]] = {}
        self._values: Dict[torch.device, torch.Tensor] = {}
        self._values_lock = threading.Lock()
        self.held = self.inflight = self.peak = 0.0
        self.ready = _Ready()
        self.alloc: Optional[BuddyAllocator] = None
        self.trace: List[TraceEvent] = []
        self.n_disp = 0
        self.t_run0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t_run0

    def values_on(self, device: torch.device, clock: Optional[_StageClock]) -> torch.Tensor:
        """Every front's original entries on ``device``, in the order of
        the entry maps: the lower CSC's values (float64) cross to the
        lane once a run, counted on ``clock``, and are gathered there."""
        with self._values_lock:
            got = self._values.get(device)
            if got is None:
                data = np.asarray(self.acsc.data, dtype=np.float64)
                got = torch.from_numpy(data).to(device)[self.ex._lane(device).idx]
                self._values[device] = got
                if clock is not None:
                    clock.moved(data.nbytes)
        return got

    def note(self, extra: float = 0.0) -> None:
        """Raise the peak to the resident bytes plus a transient ``extra``."""
        self.peak = max(self.peak, self.held + self.inflight + extra)

    def record(self, u: int, g: Optional[DeviceGroup], wave: int, dispatch_devices: int,
               t0: float, t1: float, batched: int, t_ready: float = math.nan,
               t_submit: float = math.nan) -> None:
        """The trace events of unit ``u``'s fronts, on the group ``g``
        carved for it (None: one device, lane 0)."""
        ex = self.ex
        for s in ex._fronts_of[u]:
            self.trace.append(
                TraceEvent(
                    front=s,
                    wave=wave,
                    devices=ex._planned[u],
                    devices_used=g.size if g else 1,
                    dispatch_devices=dispatch_devices,
                    t_start=t0,
                    t_end=t1,
                    flops=ex.symb.supernodes[s].flops,
                    batched=batched,
                    t_ready=t_ready,
                    t_submit=t_submit,
                    device0=g.offset if g else 0,
                )
            )

    def publish_state(self) -> None:
        """Live counter samples on the bus clock: the bus points become
        perfetto counter tracks; the gauges feed the dashboard."""
        if not obs_events.enabled():
            return
        bus = obs_events.BUS
        t = bus.wall()
        resident = self.held + self.inflight
        bus.point("queue_depth", self.ready.n, t=t)
        bus.point("resident_bytes", resident, t=t)
        reg = obs_metrics.REGISTRY
        reg.gauge(
            "repro_queue_depth",
            "ready fronts awaiting dispatch",
            unit="fronts",
            track=True,
        ).set(self.ready.n, t=t)
        reg.gauge(
            "repro_resident_bytes",
            "live host buffers (panels + CBs + in-flight)",
            unit="bytes",
        ).set(resident, t=t)
        reg.gauge(
            "repro_buddy_free_devices",
            "free devices in the buddy allocator",
            unit="devices",
        ).set(self.alloc.n_free, t=t)
        reg.gauge(
            "repro_buddy_fragmentation",
            "1 - largest free run / free devices",
        ).set(self.alloc.fragmentation, t=t)

    def finish(self, mode: str) -> Tuple[Factorization, ExecutionReport]:
        """The factorization and the report, with the plan's projected
        peak, published to the bus on its clock."""
        self.clock.lap("report")
        ex = self.ex
        assert all(p is not None for p in self.panels), "plan missed supernodes"
        report = ExecutionReport(
            plan_makespan=ex.plan.makespan,
            plan_alpha=ex.plan.alpha,
            plan_devices=ex.plan.total_devices,
            measured_makespan=max((e.t_end for e in self.trace), default=0.0),
            trace=self.trace,
            n_dispatches=self.n_disp,
            n_devices=len(ex.devices),
            interpret=ex.interpret,
            measured_peak_bytes=float(self.peak),
            projected_peak_bytes=float(ex._projected_peak()),
            mode=mode,
        )
        if obs_events.enabled():
            _publish_report_obs(report, self.t_run0 - obs_events.BUS.epoch)
        fact = Factorization(symb=ex.symb, panels=self.panels)  # type: ignore[arg-type]
        return fact, report


class PlanExecutor:
    """Executes an :class:`ExecutionPlan` for a symbolic factorization.

    Parameters
    ----------
    symb, plan : the symbolic analysis and the plan over its task tree
        (``plan`` task labels are supernode ids).
    devices : torch devices to execute on; defaults to every CUDA device
        and raises when there is none.  ``[torch.device("cpu")] * k`` runs
        the kernels' plain versions on the CPU over k logical lanes; a list
        may repeat one card the same way.  A list that mixes CPU and CUDA
        devices raises ``ValueError``.
    dtype : front dtype, ``torch.float32`` (default) or ``torch.float64``.
    max_batch : cap on fronts per dispatch (bounds padded-batch memory).
    mode : ``"async"`` (per-front futures, the default) or ``"waves"``
        (the legacy barrier-synchronous runner, kept for A/B runs).
    shard_dispatch : split a batch of small fronts over the lanes of its
        carved groups' union, one launch per lane (default: on for CUDA
        devices, off on CPU lanes, as the reference turns it off in
        interpret mode).  Off, a dispatch runs on the first lane of its
        group.  Large fronts and amalgamated group dispatches always run
        on one lane.
    delay_fn : optional front id → seconds straggler injection (see
        :class:`repro_torch.runtime.straggler.FrontDelays`); stretches the
        front's dispatch in both modes.
    memory_cap_bytes : async-mode byte budget — a dispatch that would push
        resident buffers past the cap is deferred while anything is in
        flight (and shrunk to a single front before being deferred);
        progress is always guaranteed when the pipeline is empty.  The
        resident bytes are the reference's (a block kept on a lane counts
        as its host copy), not what the lanes hold.
    max_workers : async worker threads; defaults to ``max(2, n_devices)``.
    provenance : amalgamation map
        (:class:`repro_torch.sparse.optimize.Provenance`, or anything with
        its ``groups``, ``labels`` and ``parent`` fields) when
        ``plan`` schedules an *optimized* tree: plan labels are then
        fused-group ids, and each group dispatch factors its member fronts
        (children before parents, same-shape members batched per level)
        against the **original** symbolic structure — extend-add still
        folds children in tree order, so the factors land in the original
        index space bit-identically to the unoptimized run.
    """

    def __init__(
        self,
        symb: SymbolicFactorization,
        plan: ExecutionPlan,
        *,
        devices: Optional[Sequence] = None,
        dtype: torch.dtype = torch.float32,
        max_batch: int = 32,
        mode: str = "async",
        shard_dispatch: Optional[bool] = None,
        delay_fn: Optional[DelayFn] = None,
        memory_cap_bytes: Optional[float] = None,
        max_workers: Optional[int] = None,
        provenance=None,
    ) -> None:
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if dtype not in _NP_DTYPE:
            raise TypeError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
        self.symb = symb
        self.plan = plan
        self.devices = (
            [torch.device(d) for d in devices]
            if devices is not None
            else _default_devices()
        )
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1:
            raise ValueError(
                f"PlanExecutor: devices must be all CPU lanes or all CUDA "
                f"devices, got {sorted(kinds)}"
            )
        # the report's field: True exactly when the plain versions run
        self.interpret = kinds == {"cpu"}
        self.shard_dispatch = (
            not self.interpret if shard_dispatch is None else bool(shard_dispatch)
        )
        self.dtype = np.dtype(_NP_DTYPE[dtype])
        self.max_batch = int(max_batch)
        self.mode = mode
        self.delay_fn = delay_fn
        self.memory_cap_bytes = memory_cap_bytes
        self.max_workers = max_workers

        self._children: List[List[int]] = [[] for _ in range(symb.n_supernodes)]
        for s, sn in enumerate(symb.supernodes):
            if sn.parent >= 0:
                self._children[sn.parent].append(s)
        # each supernode's padded shape class: the pattern is fixed, so no
        # run recomputes one
        self._shape: List[Tuple[int, int]] = [
            padded_shape(sn.m, sn.nb) for sn in symb.supernodes
        ]
        self._tdtype = dtype
        # index maps in padded coordinates: each child's border rows in its
        # parent's padded front (the pattern's, fixed here: ``_kid``, one
        # flat int32 array, child c's at ``_kid_at[c]:_kid_at[c + 1]``);
        # every front's original entries' places in a matrix's lower CSC,
        # built by the first run of a pattern (``_entry_maps``); all of
        # them uploaded to a lane on first use (``_lane``)
        ns, n = symb.n_supernodes, symb.n
        m = np.array([sn.m for sn in symb.supernodes], dtype=np.int64)
        nb = np.array([sn.nb for sn in symb.supernodes], dtype=np.int64)
        parent = np.array([sn.parent for sn in symb.supernodes], dtype=np.int64)
        # the padding a front's border rows move down by
        self._shift = np.array([nbp for _, nbp in self._shape], dtype=np.int64) - nb
        cols = np.concatenate([sn.cols for sn in symb.supernodes])
        self._col_sn = np.empty(n, dtype=np.int64)  # each column's front
        self._col_sn[cols] = np.repeat(np.arange(ns), nb)
        self._col_k = np.empty(n, dtype=np.int64)  # and its pivot there
        self._col_k[cols] = np.concatenate([np.arange(k) for k in nb])
        # every front's rows as one sorted key (front, row), and where each
        # front's rows begin in it
        self._row_key = np.concatenate(
            [s * n + sn.rows.astype(np.int64) for s, sn in enumerate(symb.supernodes)]
        )
        self._row_start = np.concatenate([[0], np.cumsum(m)[:-1]]).astype(np.int64)
        front = np.repeat(np.arange(ns), m)  # each (front, row)'s front
        border = np.arange(len(front)) - self._row_start[front] >= nb[front]
        border &= parent[front] >= 0
        p = parent[front[border]]
        key = p * n + self._row_key[border] - front[border] * n
        at = np.minimum(np.searchsorted(self._row_key, key), len(self._row_key) - 1)
        assert np.array_equal(self._row_key[at], key), "child border not in front"
        local = at - self._row_start[p]
        self._kid = np.where(local < nb[p], local, local + self._shift[p]).astype(np.int32)
        self._kid_at = np.concatenate([[0], np.cumsum(np.where(parent >= 0, m - nb, 0))])
        self._ent: Tuple[np.ndarray, ...] = ()
        self._desc = np.zeros((4, 0), dtype=np.int64)
        self._entry_pattern: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._lane_maps: Dict[torch.device, _LaneMaps] = {}
        self._lane_lock = threading.Lock()  # workers upload to one lane at once

        self._prov = provenance
        # the units a run makes ready and dispatches: fronts, or the fused
        # groups of an amalgamated plan; each unit's fronts, its parent
        # unit, how many child units it waits for, its ready class, and
        # what it adds to a dispatch's byte estimate (a front's m² entries
        # at the run's dtype, and a small front's padded copy)
        item = self.dtype.itemsize
        self._front_bytes = [sn.m * sn.m * item for sn in symb.supernodes]
        if provenance is None:
            self._fronts_of: List[Sequence[int]] = [(s,) for s in range(ns)]
            self._unit_parent = [sn.parent for sn in symb.supernodes]
            self._unit_kids = [len(c) for c in self._children]
            self._unit_key: Sequence[object] = self._shape
            self._unit_bytes = [
                fb + (0 if mp > VMEM_FRONT_MAX else mp * mp * item)
                for fb, (mp, _) in zip(self._front_bytes, self._shape)
            ]
        else:
            self._build_groups(provenance)
        # each unit's planned start (its dispatch priority), planned group
        # size, and that size rescaled to the executing mesh
        by_task = {t.label: t for t in plan.tasks if t.label >= 0}
        units = range(len(self._fronts_of))
        self._prio = [(by_task[u].start if u in by_task else 0.0, u) for u in units]
        self._planned = [by_task[u].devices if u in by_task else 1 for u in units]
        self._want = [
            scale_group(by_task[u].devices, plan.total_devices, len(self.devices))
            if u in by_task and by_task[u].devices > 0
            else 1
            for u in units
        ]

    def _build_groups(self, prov) -> None:
        """Expand the provenance map into executable group structure.

        ``prov.groups`` lists *original tree* indices; through
        ``prov.labels`` they become supernode ids (virtual nodes drop
        out).  Every supernode must appear in exactly one group —
        anything else means the plan and the symbolic analysis disagree.
        """
        ns = self.symb.n_supernodes
        self._groups: List[List[int]] = []
        gid_of = np.full(ns, -1, dtype=np.int64)
        for g, mem in enumerate(prov.groups):
            sns = [int(prov.labels[m]) for m in mem if int(prov.labels[m]) >= 0]
            self._groups.append(sns)
            for s in sns:
                if gid_of[s] >= 0:
                    raise ValueError(f"supernode {s} in two provenance groups")
                gid_of[s] = g
        missing = np.flatnonzero(gid_of < 0)
        if missing.size:
            raise ValueError(
                f"provenance does not cover supernodes {missing[:5].tolist()}"
            )
        # in-group dependency levels: level 0 = members whose in-group
        # children are none; a level's members factor together (batched
        # per shape class), so children always land before their parent
        self._group_levels: List[List[List[int]]] = []
        for g, sns in enumerate(self._groups):
            inset = set(sns)
            level: Dict[int, int] = {}
            for s in sorted(sns):  # children have smaller ids (postorder)
                kids = [c for c in self._children[s] if c in inset]
                level[s] = 1 + max((level[c] for c in kids), default=-1)
            levels: List[List[int]] = []
            for s in sorted(sns):
                while len(levels) <= level[s]:
                    levels.append([])
                levels[level[s]].append(s)
            self._group_levels.append(levels)
        # the fronts whose Schur blocks enter a group from outside, the
        # distinct child groups it waits for, and its single parent group
        self._group_in: List[List[int]] = []
        self._unit_kids, self._unit_parent = [], []
        for g, sns in enumerate(self._groups):
            inflow = [c for s in sns for c in self._children[s] if gid_of[c] != g]
            self._group_in.append(inflow)
            self._unit_kids.append(len({int(gid_of[c]) for c in inflow}))
            pg = -1
            for s in sns:
                p = self.symb.supernodes[s].parent
                if p >= 0 and gid_of[p] != g:
                    pg = int(gid_of[p])
            self._unit_parent.append(pg)
        self._fronts_of = self._groups
        self._unit_key = [None] * len(self._groups)  # one ready class
        self._unit_bytes = [
            sum(self._front_bytes[s] for s in sns) for sns in self._groups
        ]

    # ------------------------------------------------------------------
    def dispatches(self) -> List[_Dispatch]:
        """The static wave-mode dispatch schedule (shapes only).

        Derived from the plan alone.  The async runner forms its
        dispatches dynamically from the ready set instead.
        """
        out: List[_Dispatch] = []
        for w, wave in enumerate(self.plan.waves()):
            classes: Dict[Tuple[int, int], List[int]] = {}
            for t in sorted(wave, key=lambda t: t.task):
                if t.label < 0:
                    continue  # virtual root: no computation
                classes.setdefault(self._shape[t.label], []).append(t.label)
            for key in sorted(classes):
                sns = classes[key]
                for lo in range(0, len(sns), self.max_batch):
                    chunk = sns[lo : lo + self.max_batch]
                    out.append(_Dispatch(w, key, tuple(chunk)))
        return out

    def _wave_groups(self) -> Dict[int, DeviceGroup]:
        """Supernode id → device group, carved per wave."""
        ndev = len(self.devices)
        out: Dict[int, DeviceGroup] = {}
        for wave in self.plan.waves():
            req = {
                t.label: scale_group(
                    t.devices, self.plan.total_devices, ndev
                )
                for t in wave
                if t.label >= 0 and t.devices > 0
            }
            out.update(assign_wave_groups(req, ndev))
        return out

    def _delay_for(self, supernodes: Sequence[int]) -> float:
        """Injected dispatch delay: a batch is as slow as its slowest
        member (they share the kernel launch)."""
        if self.delay_fn is None:
            return 0.0
        return max((float(self.delay_fn(s)) for s in supernodes), default=0.0)

    # ------------------------------------------------------------------
    def _run_batch(self, batch, nbp: int, group_devices: List) -> torch.Tensor:
        """Factor a (B, mp, mp) padded stack (a tensor on the first lane,
        or what ``torch.as_tensor`` takes), split over ``group_devices``
        when more than one is given and sharding is on, else in one launch
        on its first device; returns the factored stack on the first
        device.

        Sharded, the stack is padded with identity fronts to a multiple
        of the lane count and cut into equal shards, one launch per lane,
        every shard launched before the first is gathered, so distinct
        cards work at once (lanes that repeat a card take turns on its
        current stream)."""
        dev = group_devices[0]
        x = torch.as_tensor(batch, device=dev)
        b, mp = x.shape[0], x.shape[1]
        assert mp <= VMEM_FRONT_MAX, "large fronts take the per-front path"
        if len(group_devices) == 1 or not self.shard_dispatch:
            return batched_front_factor(x, nbp)
        pad = (-b) % len(group_devices)
        if pad:
            eye = torch.eye(mp, dtype=x.dtype, device=dev).expand(pad, mp, mp)
            x = torch.cat([x, eye])
        shards = [
            batched_front_factor(part.to(d), nbp)
            for part, d in zip(x.chunk(len(group_devices)), group_devices)
        ]
        return torch.cat([o.to(dev) for o in shards])[:b]

    def _entry_maps(self, acsc: sp.csc_matrix) -> None:
        """Every front's original entries, in one vectorised pass: their
        indices in the sorted lower CSC's ``data`` and their linear
        positions in the front's padded (mp, mp) block, below the diagonal
        and mirrored (``gather_front_entries``'s assignments; of an entry
        given twice, the last), grouped by front in three flat arrays
        (``_ent``); and the front table (``_desc``, (4, n_supernodes): a
        front's m, nb, first entry there and number of entries).  Built once a pattern: a matrix
        with other ``indptr`` / ``indices`` rebuilds them and drops what
        the lanes hold."""
        if self._entry_pattern is not None and all(
            np.array_equal(x, y)
            for x, y in zip(self._entry_pattern, (acsc.indptr, acsc.indices))
        ):
            return
        self._lane_maps = {}
        symb, n = self.symb, self.symb.n
        indptr, rows = acsc.indptr, acsc.indices.astype(np.int64)
        col = np.repeat(np.arange(n), np.diff(indptr))
        s, k = self._col_sn[col], self._col_k[col]
        key = s * n + rows
        g = np.minimum(np.searchsorted(self._row_key, key), len(self._row_key) - 1)
        # below the diagonal, a row of the front, and not followed by the
        # same entry again (sorted columns put a repeat next to it)
        keep = (rows >= col) & (self._row_key[g] == key)
        keep[:-1] &= ~((col[1:] == col[:-1]) & (rows[1:] == rows[:-1]))
        idx = np.flatnonzero(keep)
        idx = idx[np.argsort(s[idx], kind="stable")]  # grouped by front
        s, k, r = s[idx], k[idx], g[idx] - self._row_start[s[idx]]
        m = np.array([sn.m for sn in symb.supernodes], dtype=np.int64)
        nb = np.array([sn.nb for sn in symb.supernodes], dtype=np.int64)
        mp = np.array([x for x, _ in self._shape], dtype=np.int64)[s]
        r = np.where(r >= nb[s], r + self._shift[s], r)  # the border moves down
        self._ent = (idx, r * mp + k, k * mp + r)
        bounds = np.searchsorted(s, np.arange(symb.n_supernodes + 1))
        self._desc = np.stack([m, nb, bounds[:-1], np.diff(bounds)])
        self._entry_pattern = (indptr.copy(), acsc.indices.copy())

    def _lane(self, device: torch.device) -> _LaneMaps:
        """The pattern's index maps on ``device``, uploaded on first use in
        four flat tensors.  The uploads are the pattern's, once a lane,
        and are not counted as a run's copies."""
        with self._lane_lock:
            got = self._lane_maps.get(device)
            if got is None:
                got = _LaneMaps(*(torch.from_numpy(x).to(device)
                                  for x in (*self._ent, self._kid)))
                self._lane_maps[device] = got
        return got

    def _assemble_stack(
        self, job: _Job, d: torch.Tensor, dev: torch.device, clock: Optional[_StageClock]
    ) -> torch.Tensor:
        """A job's fronts as a float64 (B, mp, mp) stack on ``dev``, built
        as the host builds and pads them: zeros with 1 on the padding's
        diagonal, each member's original entries and their mirrors placed
        in one indexed write (the two meet only on the diagonal, with one
        value), each child's block added in tree order (``extend_add``).
        ``d`` is the job's ``table`` on ``dev``."""
        b, mp, nbp = job.table.shape[1], job.mp, job.nbp
        nb, hi, shift, ends = d[0], d[1], d[2], d[3]
        f = torch.zeros((b, mp, mp), dtype=torch.float64, device=dev)
        i = torch.arange(mp, device=dev)
        f.diagonal(dim1=1, dim2=2).copy_(
            ((i >= nb[:, None]) & (i < nbp)) | (i >= hi[:, None]))
        n_ent = int(job.table[3, -1])
        if not (n_ent or job.kids):
            return f  # warmup's identity fronts
        lane = self._lane(dev)
        src = torch.arange(n_ent, device=dev)
        slot = torch.searchsorted(ends, src, right=True)  # each entry's member
        src += shift[slot]
        at = slot * (mp * mp)
        values = job.run.values_on(dev, clock)[src]
        f.view(-1)[torch.cat([lane.lower[src] + at, lane.mirror[src] + at])] = (
            torch.cat([values, values]))
        for k, c, blk in job.kids:
            extend_add(f[k], blk.block(dev), lane.kid[self._kid_at[c] : self._kid_at[c + 1]])
        job.kids.clear()  # the children's kept blocks go with it
        return f

    def _run_job(
        self, job: _Job, devs: List, clock: Optional[_StageClock] = None
    ) -> Tuple[np.ndarray, List[Optional[_Kept]]]:
        """Assemble a job's fronts on the first of ``devs``
        (``_assemble_stack``), cast them once to the run's dtype, so their
        bits are the host-assembled, host-padded fronts', and factor them:
        a batch of small fronts in one launch (sharded over ``devs`` by
        ``_run_batch``), a large front by the panel + SYRK pipeline.
        Returns the members' panels, cut on the card as
        ``extract_panel_schur`` cuts them (``tril`` of the top block), one
        after another in one host buffer (one copy; ``_land`` splits it),
        and each member's Schur block kept on the lane (:class:`_Kept`,
        None where it has none).  The bytes that cross (the panels, and
        the run's values on their first use on a lane), the large route's
        seconds and fronts, and the kept blocks are counted on ``clock``;
        while ``torch.profiler`` records, a large front is an
        ``executor.large`` range."""
        t0 = time.perf_counter()
        dev, nbp = devs[0], job.nbp
        large = job.mp > VMEM_FRONT_MAX
        with _large_range() if large else contextlib.nullcontext():
            d = torch.from_numpy(job.table).to(dev)
            x = self._assemble_stack(job, d, dev, clock).to(self._tdtype)
            out = factor_padded(x[0], nbp)[None] if large else self._run_batch(x, nbp, devs)
            x = None
            panels = _cut_panels(out, d, nbp, int(job.table[5, -1])).cpu().numpy()
        item = self.dtype.itemsize
        kept: List[Optional[_Kept]] = []
        for j, s in enumerate(job.members):
            sn = self.symb.supernodes[s]
            mb = sn.m - sn.nb
            kept.append(_Kept(out[j], nbp, mb, mb * mb * item) if mb > 0 else None)
        if clock is not None:
            clock.moved(panels.nbytes)
            routes = clock.routes
            if large:
                routes.large_seconds += time.perf_counter() - t0
                routes.large_bytes += panels.nbytes
                routes.large_fronts += 1
                p = self.symb.supernodes[job.members[0]].parent
                if kept[0] is not None and self._shape[p][0] > VMEM_FRONT_MAX:
                    routes.kept_bytes += kept[0].nbytes
                    routes.kept_blocks += 1
            else:
                routes.small_fronts += len(job.members)
                routes.small_kept_bytes += sum(blk.nbytes for blk in kept if blk is not None)
        return panels, kept

    def warmup(self) -> None:
        """Build or load the kernel library and run one identity front of
        every small shape class through the route on every distinct device
        (untimed), so no card's first launch (module load, shared-memory
        opt-in) lands inside a timed run.  This covers every lane a
        dispatch of any runner can engage."""
        keys = sorted({k for k in self._shape if k[0] <= VMEM_FRONT_MAX})
        identity = np.zeros((6, 1), dtype=np.int64)  # no rows: all padding
        for dev in dict.fromkeys(self.devices):
            for mp, nbp in keys:
                self._run_job(_Job((), mp, nbp, identity, [], None), [dev])

    def _dispatch_devices(
        self, supernodes: Sequence[int], groups: Dict[int, DeviceGroup]
    ) -> List:
        """Union of the batch fronts' device groups, in mesh order."""
        idx = sorted(
            {
                i
                for s in supernodes
                if s in groups
                for i in range(
                    groups[s].offset, groups[s].offset + groups[s].size
                )
            }
        )
        return [self.devices[i] for i in idx] or self.devices[:1]

    def _projected_peak(self) -> float:
        """The plan's resident-bytes timeline peak at this dtype.

        With a provenance map the plan's tasks are fused groups; each
        member front inherits its group's span, and the timeline is
        folded over the *original* tree — the projection stays in the
        original front space, directly comparable to the measured
        buffers."""
        from repro_torch.core.memory import memory_timeline
        from repro_torch.sparse.plan import plan_memory_timeline

        tree = self.symb.task_tree()
        fp = self.symb.footprints(itemsize=self.dtype.itemsize).padded(tree.n)
        if self._prov is None:
            return float(plan_memory_timeline(self.plan, tree, fp).peak)
        spans = {}
        for t in self.plan.tasks:
            if t.label >= 0:
                for i in self._prov.groups[t.label]:
                    spans[int(i)] = (t.start, t.end)
        parent = np.asarray(self._prov.parent, dtype=np.int64)
        return float(memory_timeline(parent, spans, fp).peak)

    # ------------------------------------------------------------------
    def run(
        self, a: sp.csr_matrix, warmup: bool = True
    ) -> Tuple[Factorization, ExecutionReport]:
        """Factorize ``a`` by executing the plan; returns the factorization
        and the measured-vs-projected report.  Takes the async futures
        runner or the wave runner per ``self.mode``, over fronts or, for an
        amalgamated plan (``provenance=``), over fused groups.  The run's
        host totals (see ``STAGES``) are kept on the report's ``host``;
        ``warmup`` adds nothing to them."""
        if warmup:
            self.warmup()
        if self.mode == "async":
            runner = self._run_async
        else:
            runner = self._run_waves if self._prov is None else self._run_waves_prov
        tally = _RunTally(self.dtype.itemsize)
        hook = tally.on_gc
        gc.callbacks.append(hook)
        try:
            with _StageClock(tally, "assemble") as clock:
                acsc = lower_csc(a)
                self._entry_maps(acsc)
                clock.lap("scan")
                st = _Run(self, acsc, clock)
                runner(st)
                fact, report = st.finish(self.mode)
        finally:
            gc.callbacks.remove(hook)
        report.host = tally.totals()
        tally.publish()
        return fact, report

    # -- one numeric path per front, shared by every runner --------------
    def _take_kids(self, s: int, updates: Dict) -> Tuple[List[Tuple[int, _Kept]], float]:
        """The host's part of front ``s``'s assembly: pop — i.e. free — its
        children's Schur blocks from ``updates`` (the run's, or a fused
        group's), in tree order.  Returns them as (child, block) and their
        bytes.  Children are folded in tree order whatever the completion
        order, so the float summation order (and therefore the factor
        bits) is identical across runners."""
        t_a0 = time.perf_counter()
        kids = self._children[s]
        blocks, consumed = self._pop_children(kids, updates)
        self._assemble_span(s, t_a0)
        return [(c, blk) for c, (_, blk) in zip(kids, blocks)], consumed

    def _pop_children(self, kids: Sequence[int], updates: Dict) -> Tuple[List, float]:
        """Pop the (rows, Schur block) pairs of ``kids`` in order from
        ``updates``, the dict that holds them (a run's, or a fused
        group's), and their bytes (a kept block's as its host copy would
        hold them)."""
        assert all(c in updates for c in kids), "dispatch order violates tree precedence"
        blocks = [updates.pop(c) for c in kids]
        return blocks, float(sum(rows.nbytes + blk.nbytes for rows, blk in blocks))

    def _assemble_span(self, s: int, t_a0: float) -> None:
        """The bus span of front ``s``'s assembly, begun at ``t_a0``."""
        if obs_events.enabled():
            epoch = obs_events.BUS.epoch
            obs_events.BUS.span(
                "assemble",
                t_a0 - epoch,
                time.perf_counter() - epoch,
                cat="front",
                key=s,
                children=len(self._children[s]),
            )

    def _take(self, st: _Run, members: Sequence[int]) -> Tuple[List, float]:
        """Pop a dispatch's children's blocks from the run and note the
        extend-add transient, the consumed blocks beside the new fronts,
        before the blocks leave the count.  Returns each member's
        children's blocks and the fronts' bytes."""
        kids, consumed = [], 0.0
        for s in members:
            k, c = self._take_kids(s, st.updates)
            kids.append(k)
            consumed += c
        fronts_bytes = float(sum(self._front_bytes[s] for s in members))
        st.note(fronts_bytes)
        st.held -= consumed
        return kids, fronts_bytes

    def _jobs(self, members: Sequence[int], kids: Sequence, run: _Run) -> List[_Job]:
        """The jobs of one dispatch: one for a batch of small fronts, one a
        front for large ones; each with its index table and its members'
        children's blocks by slot, in tree order."""
        mp, nbp = self._shape[members[0]]
        batches = ([[i] for i in range(len(members))] if mp > VMEM_FRONT_MAX
                   else [range(len(members))])
        return [
            _Job(tuple(members[i] for i in batch), mp, nbp,
                 self._table([members[i] for i in batch], nbp),
                 [(j, c, blk) for j, i in enumerate(batch) for c, blk in kids[i]], run)
            for batch in batches
        ]

    def _table(self, members: List[int], nbp: int) -> np.ndarray:
        """A dispatch's index table (see :class:`_Job`) from the members'
        columns of the front table."""
        m, nb, first, count = self._desc[:, members]
        ends, size = np.cumsum(count), m * nb
        pends = np.cumsum(size)
        return np.stack([nb, nbp + m - nb, first - (ends - count), ends, pends - size, pends])

    def _batch_bytes(self, members: Sequence[int]) -> float:
        """What a batch of small fronts would hold as the reference's host
        stack of padded fronts at the run's dtype (the bookkeeping's)."""
        mp = self._shape[members[0]][0]
        return float(len(members) * mp * mp * self.dtype.itemsize)

    def _store(self, s, panel, schur, panels, updates) -> int:
        """Record a factored front in ``panels`` and queue its Schur block
        (kept on a lane) in ``updates`` for the parent's extend-add,
        unless ``schur`` is None (a fused group's member whose parent is in
        the group).  Returns the bytes it keeps."""
        sn = self.symb.supernodes[s]
        panels[s] = panel
        kept = panel.nbytes
        if sn.m > sn.nb and schur is not None:
            rows = sn.rows[sn.nb :]
            updates[s] = (rows, schur)
            kept += rows.nbytes + schur.nbytes
        return kept

    def _land(self, job: _Job, out, panels, updates) -> int:
        """Split a finished job's panel buffer into its members' panels
        (views of it) and store them with their kept blocks; returns the
        bytes kept."""
        buf, kept = out
        at = total = 0
        for s, blk in zip(job.members, kept):
            sn = self.symb.supernodes[s]
            panel = buf[at : at + sn.m * sn.nb].reshape(sn.m, sn.nb)
            at += sn.m * sn.nb
            total += self._store(s, panel, blk, panels, updates)
        return total

    def _work(self, st: _Run, seq: int, lane: int, delay: float, fixed: bool, fn, *args):
        """A dispatch on a worker thread: ``fn(*args, clock)`` on the
        thread's own ``transfer`` clock (``fixed`` for a fused group, which
        stalls itself); returns its result and its interval on the run's
        clock."""
        t0 = st.now()
        if delay > 0:
            time.sleep(delay)  # the straggling device — only this
            # dispatch's ancestors wait for it
        with _StageClock(st.clock.tally, "transfer", seq, lane, fixed=fixed) as wc:
            out = fn(*args, wc)
        return out, t0, st.now()

    def _run_group(
        self,
        gid: int,
        st: _Run,
        cb: Dict[int, Tuple[np.ndarray, _Kept]],
        seq: int,
        clock: _StageClock,
    ) -> Dict:
        """Factor one fused group's member fronts; the body both fused
        runners share (the caller lands its results in the run).  Its
        stages are timed on ``clock``, the calling thread's, under the
        dispatch's sequence number ``seq``; a worker's ``fixed`` clock
        counts it all as ``transfer``.

        ``cb`` holds the Schur blocks entering the group from its external
        children; the members queue theirs there too.  Levels run children
        before parents, and each member takes the per-front path of a
        plain run on the first lane: a level's small members of one shape
        class in jobs of up to ``max_batch`` (each front is its own CTA,
        so batching never changes a front's bits), a large one in a job of
        its own; each keeps its Schur block on the lane.

        Returns per-member ``(s, panel, schur)`` (``schur`` only for
        members whose parent lies outside the group) and the transient
        byte peak the group held, each front counted as its m² entries at
        the run's dtype and a batch as the reference's padded host stack.
        """
        members = self._groups[gid]
        delay = self._delay_for(members)
        if delay > 0:
            clock.lap("wait", seq)
            time.sleep(delay)  # one injected stall per *dispatch*: fused
            # members share the launch, so a group pays its slowest member
            # once — the whole point of amalgamation
        held = float(sum(r.nbytes + u.nbytes for r, u in cb.values()))
        peak = held
        panels: Dict[int, np.ndarray] = {}
        devs = self.devices[:1]
        for level in self._group_levels[gid]:
            clock.lap("assemble", seq)
            kids: Dict[int, List] = {}
            consumed = 0.0
            for s in level:
                kids[s], c = self._take_kids(s, cb)
                # extend-add transient: the children's blocks coexist with
                # the assembled front
                peak = max(peak, held + self._front_bytes[s])
                consumed += c
                held += self._front_bytes[s]
            peak = max(peak, held)
            held -= consumed

            kept = 0
            classes: Dict[Tuple[int, int], List[int]] = {}
            for s in level:
                classes.setdefault(self._shape[s], []).append(s)
            for key in sorted(classes):
                sns = classes[key]
                step = 1 if key[0] > VMEM_FRONT_MAX else self.max_batch
                for lo in range(0, len(sns), step):
                    chunk = sns[lo : lo + step]
                    clock.lap("pad", seq)
                    (job,) = self._jobs(chunk, [kids[s] for s in chunk], st)
                    if key[0] <= VMEM_FRONT_MAX:
                        peak = max(peak, held + self._batch_bytes(chunk))
                    clock.lap("transfer", seq)
                    out = self._run_job(job, devs, clock)
                    clock.lap("extract", seq)
                    kept += self._land(job, out, panels, cb)
            held += kept - sum(self._front_bytes[s] for s in level)
            peak = max(peak, held)
        return {
            "results": [(s, panels[s], cb[s][1] if s in cb else None) for s in members],
            "transient": peak,
        }

    # -- wave runners (barrier-synchronous) -----------------------------
    def _run_waves(self, st: _Run) -> None:
        """``dispatches()`` in order, each factored before the next starts."""
        clock = st.clock
        groups = self._wave_groups()
        for d in self.dispatches():
            seq = st.n_disp
            clock.lap("assemble", seq)
            large = d.key[0] > VMEM_FRONT_MAX
            kids, fronts_bytes = self._take(st, d.supernodes)
            devs = self._dispatch_devices(d.supernodes, groups)
            if not self.shard_dispatch or large:
                devs = devs[:1]  # large fronts run on one lane
            delay = self._delay_for(d.supernodes)
            t0 = t1 = st.now()
            if delay > 0:
                clock.lap("wait", seq)
                time.sleep(delay)  # the straggling device, behind the barrier
            clock.lap("pad", seq)
            jobs = self._jobs(d.supernodes, kids, st)
            if not large:
                st.note(fronts_bytes + self._batch_bytes(d.supernodes))
            for job in jobs:
                clock.lap("transfer", seq)
                out = self._run_job(job, devs, clock)
                t1 = st.now()
                clock.lap("extract", seq)
                st.held += self._land(job, out, st.panels, st.updates)
            st.n_disp += 1
            for s in d.supernodes:
                st.record(s, groups.get(s), d.wave, len(devs), t0, t1, len(d.supernodes))

    def _run_waves_prov(self, st: _Run) -> None:
        """The wave runner over fused groups: one dispatch per group task."""
        clock = st.clock
        groups = self._wave_groups()  # keyed by group label
        for w, wave in enumerate(self.plan.waves()):
            for t in sorted(wave, key=lambda t: t.task):
                if t.label < 0:
                    continue
                gid, seq = t.label, st.n_disp
                clock.lap("scan", seq)
                kids = self._group_in[gid]
                blocks, consumed = self._pop_children(kids, st.updates)
                t0 = st.now()
                res = self._run_group(gid, st, dict(zip(kids, blocks)), seq, clock)
                t1 = st.now()
                clock.lap("extract", seq)
                st.note(res["transient"])
                st.held -= consumed
                for s, panel, schur in res["results"]:
                    st.held += self._store(s, panel, schur, st.panels, st.updates)
                st.n_disp += 1
                st.record(gid, groups.get(gid), w, 1, t0, t1, len(self._groups[gid]))

    # -- async futures runner (per-unit state machine) ------------------
    def _run_async(self, st: _Run) -> None:
        """Event-driven execution: a unit (a front, or a fused group) is
        dispatched the instant its children's Schur blocks have landed; no
        wave barrier.  Ready fronts of one shape class coalesce into one
        dispatch; a fused group is one dispatch (the optimizer already
        chose the batches).

        The main thread owns all bookkeeping (readiness, the fronts'
        assembly, memory accounting, trace); worker threads run the
        dispatches (and a fused group's assembly), so no lock is needed
        beyond the futures.
        """
        fused = self._prov is not None
        clock, ready, cap = st.clock, st.ready, self.memory_cap_bytes
        alloc = st.alloc = BuddyAllocator(len(self.devices))
        n_unfinished = list(self._unit_kids)
        t_ready = [math.nan] * len(n_unfinished)
        in_flight: Dict = {}  # Future -> _Inflight
        n_done = 0

        def make_ready(u: int, t: float) -> None:
            t_ready[u] = t
            ready.push(self._unit_key[u], self._prio[u])

        def finish_unit(u: int, t: float) -> None:
            """The parent becomes ready the instant its last child lands."""
            p = self._unit_parent[u]
            if p >= 0:
                n_unfinished[p] -= 1
                if n_unfinished[p] == 0:
                    make_ready(p, t)

        for u, k in enumerate(n_unfinished):
            if k == 0:
                make_ready(u, 0.0)

        def launch_ready(pool) -> int:
            """Issue as many dispatches as devices/memory admit; returns
            how many were launched."""
            clock.lap("scan", st.n_disp)
            launched = 0
            while ready.n and alloc.n_free:
                key, heap = ready.top()
                # power-of-two batches of small fronts, as in the reference,
                # so dispatch counts compare one to one with it (the
                # remainder stays ready for the next dispatch); a large
                # front or a fused group alone
                k = (1 if fused or key[0] > VMEM_FRONT_MAX
                     else pow2_floor(min(len(heap), self.max_batch)))
                members = ready.head(heap, k)
                if cap is not None:
                    resident = st.held + st.inflight
                    while (len(members) > 1 and resident
                           + sum(self._unit_bytes[u] for u in members) > cap):
                        members = members[:-1]  # shed the lowest priority
                    if (resident + sum(self._unit_bytes[u] for u in members) > cap
                            and (in_flight or launched)):
                        break  # wait for buffers to free; with the pipeline
                        # empty, dispatch anyway (progress beats the cap)
                groups: Dict[int, DeviceGroup] = {}
                for u in members:
                    g = alloc.alloc(self._want[u])
                    if g is None:
                        break
                    groups[u] = g
                if not groups:
                    break  # no free device — wait for a completion
                # every chosen member joins the dispatch: the batch is one
                # kernel launch sharded over the carved groups' union, so
                # fronts beyond the free capacity time-share it (same
                # discipline as the wave carver's oversubscription rule)
                ready.pop(key, len(members))
                t_sub = st.now()
                issue = self._issue_group if fused else self._issue_fronts
                fut, job, held, n_devs = issue(st, pool, members, groups)
                st.inflight += held
                in_flight[fut] = _Inflight(
                    st.n_disp, tuple(members), groups, n_devs, held, t_sub, job
                )
                st.n_disp += 1
                launched += 1
                st.publish_state()
            return launched

        def complete(fut) -> None:
            nonlocal n_done
            info = in_flight.pop(fut)
            clock.lap("extract", info.seq)
            out, t0, t1 = fut.result()
            if fused:
                for s, panel, schur in out["results"]:
                    st.held += self._store(s, panel, schur, st.panels, st.updates)
                extra = out["transient"] - self._unit_bytes[info.units[0]]
                batched = len(self._fronts_of[info.units[0]])
            else:
                st.held += self._land(info.job, out, st.panels, st.updates)
                extra, batched = 0.0, len(info.units)
            st.inflight -= info.held_bytes
            st.note(extra)
            for u in info.units:
                g = info.groups.get(u)
                if g is not None:
                    alloc.free(g)
                st.record(u, g, info.seq, info.dispatch_devices, t0, t1, batched,
                          t_ready[u], info.t_submit)
                finish_unit(u, t1)
            n_done += len(info.units)
            st.publish_state()

        workers = self.max_workers or max(2, len(self.devices))
        pool = ThreadPoolExecutor(max_workers=workers)
        try:
            while n_done < len(n_unfinished):
                launched = launch_ready(pool)
                if in_flight:
                    clock.lap("wait")
                    done, _ = futures_wait(set(in_flight), return_when=FIRST_COMPLETED)
                    for fut in done:
                        complete(fut)
                elif not launched:
                    # only fused placeholder groups, which factor nothing
                    # (e.g. a lone virtual root), may be left
                    rest = ready.take(lambda u: not self._fronts_of[u])
                    if not rest:
                        unit = "groups" if fused else "fronts"
                        raise RuntimeError(f"async executor stalled with ready {unit}")
                    for u in rest:
                        finish_unit(u, st.now())
                        n_done += 1
            clock.lap("report")
        finally:
            pool.shutdown(wait=True)

    def _issue_fronts(
        self, st: _Run, pool, members: List[int], groups: Dict[int, DeviceGroup]
    ):
        """Issue a batch of ready fronts of one shape class (a large front
        alone): pop their children's blocks and build the job on the main
        thread, and hand it to a worker.  Returns the future, the job, the
        bytes the worker holds, and the lanes it engages."""
        clock, seq = st.clock, st.n_disp
        clock.lap("assemble", seq)
        large = self._shape[members[0]][0] > VMEM_FRONT_MAX
        kids, fronts_bytes = self._take(st, members)
        delay = self._delay_for(members)
        devs = self._dispatch_devices(members, groups)
        if not self.shard_dispatch or large:
            devs = devs[:1]  # large fronts run on one lane
        lane = min(g.offset for g in groups.values())  # devs[0]'s
        clock.lap("pad", seq)
        (job,) = self._jobs(members, kids, st)
        clock.lap("scan", seq)
        if large:
            held = fronts_bytes
        else:
            held = self._batch_bytes(members)
            st.note(fronts_bytes + held)
        fut = pool.submit(self._work, st, seq, lane, delay, False, self._run_job, job, devs)
        return fut, job, held, len(devs)

    def _issue_group(
        self, st: _Run, pool, members: List[int], groups: Dict[int, DeviceGroup]
    ):
        """Issue a ready fused group: pop the blocks entering it and hand
        it whole to a worker, whose fixed clock counts the group as
        ``transfer``.  Its bytes are estimated at its fronts' m² entries
        until it completes.  Returns as ``_issue_fronts``."""
        (gid,) = members
        kids = self._group_in[gid]
        blocks, consumed = self._pop_children(kids, st.updates)
        est = self._unit_bytes[gid]
        st.note(est)
        st.held -= consumed
        seq = st.n_disp
        fut = pool.submit(self._work, st, seq, groups[gid].offset, 0.0, True,
                          self._run_group, gid, st, dict(zip(kids, blocks)), seq)
        return fut, None, consumed + est, 1

BATCH_WIDTH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _publish_report_obs(report: ExecutionReport, t0: float) -> None:
    """Publish a finished run's trace to the obs bus and registry.

    Spans are pre-timed from the TraceEvent record, whose times are
    seconds since the run's start, shifted by ``t0``, the run's start on
    the bus clock: a ``run`` phase per front on its device lane, plus
    ``ready`` / ``submit`` phases when the async runner recorded them.
    Aggregates land in the metric registry under the ``repro_*`` names
    cataloged in docs/OBSERVABILITY.md.
    """
    bus = obs_events.BUS
    reg = obs_metrics.REGISTRY
    for e in report.trace:
        dev = max(e.device0, 0)
        if not math.isnan(e.t_ready) and e.t_submit > e.t_ready:
            bus.span(
                "ready", t0 + e.t_ready, t0 + e.t_submit, cat="front",
                key=e.front, device=dev,
            )
        if not math.isnan(e.t_submit) and e.t_start > e.t_submit:
            bus.span(
                "submit", t0 + e.t_submit, t0 + e.t_start, cat="front",
                key=e.front, device=dev,
            )
        bus.span(
            "run", t0 + e.t_start, t0 + e.t_end, cat="front", key=e.front,
            device=dev,
            devices_used=e.devices_used,
            dispatch_devices=e.dispatch_devices,
            devices_planned=e.devices,
            batched=e.batched,
            flops=e.flops,
            wave=e.wave,
            mode=report.mode,
        )
    reg.counter(
        "repro_dispatches_total", "kernel dispatches issued"
    ).inc(report.n_dispatches)
    reg.counter(
        "repro_fronts_completed_total", "fronts factored"
    ).inc(len(report.trace))
    ready_h = reg.histogram(
        "repro_ready_latency_seconds",
        "front ready -> dispatch start",
        unit="s",
    )
    disp_h = reg.histogram(
        "repro_dispatch_latency_seconds",
        "dispatch submit -> start (worker-pool queueing)",
        unit="s",
    )
    for e in report.trace:
        if not math.isnan(e.t_ready):
            ready_h.observe(e.ready_latency)
        if not math.isnan(e.t_submit):
            disp_h.observe(e.dispatch_latency)
    width_h = reg.histogram(
        "repro_batch_width",
        "fronts coalesced per dispatch",
        unit="fronts",
        buckets=BATCH_WIDTH_BUCKETS,
    )
    for batched in {
        (e.t_start, e.t_end): e.batched for e in report.trace
    }.values():
        width_h.observe(batched)
    reg.gauge(
        "repro_peak_resident_bytes",
        "measured peak of real host buffers",
        unit="bytes",
    ).set(report.measured_peak_bytes)
    reg.gauge(
        "repro_projected_peak_bytes",
        "plan-projected peak resident bytes",
        unit="bytes",
    ).set(report.projected_peak_bytes)


def execute_plan(
    a: sp.csr_matrix,
    symb: SymbolicFactorization,
    plan: ExecutionPlan,
    **kwargs,
) -> Tuple[Factorization, ExecutionReport]:
    """One-call convenience: ``PlanExecutor(symb, plan, **kwargs).run(a)``.
    Runs on every CUDA device unless ``devices=`` says otherwise."""
    return PlanExecutor(symb, plan, **kwargs).run(a)
