"""Malleable-plan executor: run an ExecutionPlan on CUDA devices.

This closes the loop the rest of the repo only *projects*: the symbolic
phase (repro_torch.sparse.symbolic) turns a sparse SPD matrix into an assembly
tree of malleable tasks, the PM planner (repro_torch.sparse.plan) turns the tree
into per-front device-group shares with p^α model times — and this module
actually factorizes the matrix by running those fronts on the card(s): fronts
are assembled and factored by the hand-written CUDA kernels of
``repro_torch.kernels`` (their plain PyTorch versions on CPU devices, which
the caller asks for explicitly with ``devices=[torch.device("cpu")] * k``).

Two routes by a front's padded order.  Both place a front's original
entries through index maps built once a pattern (``_entry_maps``: one
vectorised pass over the lower CSC).  A small front (up to
``VMEM_FRONT_MAX``) is assembled on the host, padded to its shape class,
batched with others of its class and factored in one launch; its panel
and Schur block come back to the host.  A large front is assembled on its
lane (``_run_large``): float64 zeros with a unit diagonal on the padding,
its original entries scattered through its maps (and ``_kid_pos``; both
uploaded to a lane on first use), each child's Schur block added in tree
order by the ``extend_add`` kernel, one cast to the run's dtype — the
host's arithmetic in the host's order, so the bits are the
host-assembled front's — then the panel + SYRK pipeline.  Only its panel
comes back.  Its Schur block stays on the lane, as its factored padded
output (``_Kept``), when the parent is large too, until the parent's
worker has added it; to a small parent it comes back as before.  The
memory bookkeeping counts a kept block as the host copy it replaces, so
the cap's decisions do not depend on where a block lives: the bookkeeping
(``memory_cap_bytes``, ``measured_peak_bytes``) models the reference's
resident bytes, not what a lane holds, which for a kept block is its
child's whole factored padded output (mp² in the run's dtype, panel and
padding included; 134 MB at mp = 4,096 in float64 against the 115 MB of
its Schur block).  The provenance runners assemble every front on the
host and send a large one through the same panel + SYRK code
(``_run_large_host``).

Two execution modes share every numeric path (assembly, kernels, extend-add,
memory accounting) and produce **bit-identical factors**:

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
   while anything is in flight.  The ready set is one min-heap of
   ``(priority, front)`` per shape class, the classes fixed per executor,
   so a dispatch takes the class with the smallest top without rescanning
   the ready fronts.
2. *Wave runner* (``mode="waves"``, the legacy path, kept for A/B
   benchmarking) — ``plan.waves()`` gives maximal same-start task sets;
   each wave's fronts are assembled, batched per shape class, and factored
   before the next wave starts.  One straggler front stalls the entire
   wave front behind the barrier — exactly the rigidity the malleable
   model exists to avoid, and what ``benchmarks.bench_async`` measures.

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
result back to the host (which synchronizes the launching stream); fronts
sharing a dispatch share its interval, and throughput is measured at
dispatch granularity (one point per kernel launch — see
``ExecutionReport.dispatch_points``) for the α re-fit.  ``warmup=True``
builds or loads the kernel library and runs identity fronts of every
shape class once on every lane it will use, untimed, so no build lands
inside the trace.  A list of devices may repeat one card as several
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
``repro_executor_copy_bytes_total{kind=copied|useful}`` (useful: a small
front's m² entries sent, its panel and Schur block received; everything
the large route moves, since nothing padded crosses there),
``repro_host_gc_seconds_total`` (a ``gc.callbacks`` hook installed for the
run) and, from the clocks of the threads that ran the large route and
apart from their stages, ``repro_executor_large_seconds_total`` (inside
``_run_large``: the assembly on the lane, the panel + SYRK loop, the
copies), ``repro_executor_large_bytes_total`` (the part of ``copied`` it
moved: original entries and small children's Schur blocks in, panels and
a small parent's Schur block out), ``repro_executor_large_fronts_total``,
and ``repro_executor_kept_bytes_total`` / ``repro_executor_kept_blocks_total``
(the Schur bytes and blocks kept on a lane for a large parent's
extend-add, counted as the host copies they replace); each large front is
an ``executor.large`` profiler range.  The index maps' uploads are the
pattern's, not a run's, and are not counted.  ``RunReport.metrics``
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
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
from repro_torch.kernels.ops import (
    batched_front_factor,
    extract_panel_schur,
    factor_padded,
    pad_front_np,
    padded_shape,
    panel_of,
    partial_cholesky,
    schur_of,
)
from repro_torch.sparse.multifrontal import (
    Factorization,
    assemble_front_np,
    extend_add_np,
    lower_csc,
)
from repro_torch.sparse.plan import ExecutionPlan
from repro_torch.sparse.symbolic import SymbolicFactorization

DelayFn = Callable[[int], float]  # front id -> injected dispatch delay (s)

MODES = ("async", "waves")

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}

# The host stages of a run.  The main thread's: ``scan`` (the ready scan:
# shape classes, priorities, device groups, memory bookkeeping, handing a
# dispatch to a worker; the static schedule on the wave path), ``assemble``
# (the matrix in CSC, gathering entries and the children's extend-add),
# ``pad`` (padding fronts to their shape class and stacking them), ``wait``
# (blocked on the workers, or an injected delay), ``extract`` (panels and
# Schur blocks out of a factored stack, and the completion's bookkeeping),
# ``report`` (the projected peak, the report and its publishing).  The
# thread that runs a dispatch's kernels: ``transfer`` (copy in, launch,
# wait, copy out; the main thread's own on the wave path; on the fused
# async path a worker's whole group, its assembly, padding and extraction
# included).
STAGES = ("scan", "assemble", "pad", "wait", "extract", "report", "transfer")


def _heap_head(heap: list, k: int) -> list:
    """The ``k`` smallest entries of a heap, in order, without popping: a
    best-first walk down from the root (the children of ``i`` are at
    ``2i + 1`` and ``2i + 2``), so O(k log k) whatever the heap's size."""
    out, frontier = [], [(heap[0], 0)]
    while frontier and len(out) < k:
        e, i = heapq.heappop(frontier)
        out.append(e)
        for j in (2 * i + 1, 2 * i + 2):
            if j < len(heap):
                heapq.heappush(frontier, (heap[j], j))
    return out


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
    ``copied_bytes``: what crossed between host and device (padded stacks
    both ways; a large front's original entries and small children's
    Schur blocks in, its panel and a small parent's Schur block out);
    ``useful_bytes``: of those, a small front's m² entries sent and its
    panel and Schur block received, and all the large route moved.
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
    # the memory dimension: peak bytes of the real host-side buffers
    # (fronts + retained panels + pending Schur updates) vs. the peak the
    # plan's resident-bytes timeline projects at the executed dtype
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
        self.large = _LargeTally()
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
            self.large.add(clock.large)

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
        reg.counter(
            "repro_executor_large_seconds_total",
            "seconds of the threads that ran _run_large inside it",
            unit="s",
        ).inc(self.large.seconds)
        reg.counter(
            "repro_executor_large_bytes_total",
            "bytes _run_large copied between host and device",
            unit="bytes",
        ).inc(self.large.bytes)
        reg.counter(
            "repro_executor_large_fronts_total",
            "fronts factored by _run_large (padded order past VMEM_FRONT_MAX)",
        ).inc(self.large.fronts)
        reg.counter(
            "repro_executor_kept_bytes_total",
            "Schur bytes the large route kept on the card for a large parent's extend-add",
            unit="bytes",
        ).inc(self.large.kept_bytes)
        reg.counter(
            "repro_executor_kept_blocks_total",
            "Schur blocks the large route kept on the card for a large parent's extend-add",
        ).inc(self.large.kept_blocks)


class _LargeTally:
    """The large route's seconds, bytes and fronts on one clock, and the
    Schur bytes and blocks it kept on the card for the parents'
    extend-add."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self.bytes = 0.0
        self.fronts = 0
        self.kept_bytes = 0.0
        self.kept_blocks = 0

    def add(self, other: "_LargeTally") -> None:
        self.seconds += other.seconds
        self.bytes += other.bytes
        self.fronts += other.fronts
        self.kept_bytes += other.kept_bytes
        self.kept_blocks += other.kept_blocks


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
        self.large = _LargeTally()
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

    def useful_front(self, m: int, panel: np.ndarray, schur: np.ndarray) -> None:
        """Count a front's useful bytes: its m² entries sent, its panel
        and Schur block received."""
        self.useful += m * m * self.tally.itemsize + panel.nbytes + schur.nbytes

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
    supernodes: Tuple[int, ...]
    key: Tuple[int, int]
    groups: Dict[int, DeviceGroup]
    dispatch_devices: int
    held_bytes: float  # buffers the worker holds until completion
    t_submit: float
    large: bool  # per-front path: assembled on the lane, panel + SYRK


@dataclass
class _Kept:
    """A large front's Schur block kept on its lane for a large parent's
    extend-add: the lower triangle of ``out[off:off+n, off:off+n]``, its
    factored padded output.  ``nbytes`` is what the block would hold on
    the host, so the memory bookkeeping counts it as it did there."""

    out: torch.Tensor
    off: int
    n: int
    nbytes: int

    def block(self, device: torch.device) -> torch.Tensor:
        """The block as a view on ``device``; copied there from another
        card (the reader's ``.to``), a view of ``out`` on its own."""
        b = self.out[self.off : self.off + self.n, self.off : self.off + self.n]
        return b if b.device == torch.device(device) else b.to(device)


@dataclass
class _LargeJob:
    """What the main thread hands a large front's worker: the front's
    original entries (float64, in the order of its entry map) and its
    children's Schur blocks in tree order, each a host array (a small
    child's) or a :class:`_Kept` (a large child's)."""

    s: int
    values: np.ndarray
    kids: List[Tuple[int, object]]


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
        # index maps: each child's border rows at their padded positions in
        # a large parent (the pattern's, fixed here); every front's original
        # entries' places in a matrix's lower CSC, built by the first run of
        # a pattern (``_entry_maps``); a large front's uploaded to a lane on
        # first use
        self._large = [
            s for s, (mp, _) in enumerate(self._shape) if mp > VMEM_FRONT_MAX
        ]
        ns, n = symb.n_supernodes, symb.n
        nb = [sn.nb for sn in symb.supernodes]
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
        self._row_start = np.concatenate(
            [[0], np.cumsum([sn.m for sn in symb.supernodes])[:-1]]
        ).astype(np.int64)
        self._kid_pos: Dict[int, np.ndarray] = {}
        for p in self._large:
            sn = symb.supernodes[p]
            nbp = self._shape[p][1]
            for c in self._children[p]:
                sc = symb.supernodes[c]
                local = np.searchsorted(sn.rows, sc.rows[sc.nb :])
                assert np.array_equal(sn.rows[local], sc.rows[sc.nb :]), (
                    "child border not in front"
                )
                self._kid_pos[c] = np.where(
                    local < sn.nb, local, local + (nbp - sn.nb)
                ).astype(np.int32)
        self._entries: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._entry_pattern: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._lane_maps: Dict[torch.device, Dict] = {}
        self._lane_lock = threading.Lock()  # workers upload to one lane at once

        self._prov = provenance
        if provenance is not None:
            self._build_groups(provenance)

    def _build_groups(self, prov) -> None:
        """Expand the provenance map into executable group structure.

        ``prov.groups`` lists *original tree* indices; through
        ``prov.labels`` they become supernode ids (virtual nodes drop
        out).  Every supernode must appear in exactly one group —
        anything else means the plan and the symbolic analysis disagree.
        """
        ns = self.symb.n_supernodes
        self._groups: List[List[int]] = []
        self._gid_of = np.full(ns, -1, dtype=np.int64)
        for g, mem in enumerate(prov.groups):
            sns = [int(prov.labels[m]) for m in mem if int(prov.labels[m]) >= 0]
            self._groups.append(sns)
            for s in sns:
                if self._gid_of[s] >= 0:
                    raise ValueError(f"supernode {s} in two provenance groups")
                self._gid_of[s] = g
        missing = np.flatnonzero(self._gid_of < 0)
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
        # distinct external child groups / the single external parent
        self._group_ext_children: List[List[int]] = []
        self._group_parent: List[int] = []
        for g, sns in enumerate(self._groups):
            ext = sorted(
                {
                    int(self._gid_of[c])
                    for s in sns
                    for c in self._children[s]
                    if self._gid_of[c] != g
                }
            )
            self._group_ext_children.append(ext)
            pg = -1
            for s in sns:
                p = self.symb.supernodes[s].parent
                if p >= 0 and self._gid_of[p] != g:
                    pg = int(self._gid_of[p])
            self._group_parent.append(pg)

    # ------------------------------------------------------------------
    def dispatches(self) -> List[_Dispatch]:
        """The static wave-mode dispatch schedule (shapes only).

        Derived from the plan alone, so it can drive both warmup
        compilation and the timed wave run.  The async runner forms its
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
    def _run_batch(
        self,
        batch: np.ndarray,
        nbp: int,
        group_devices: List,
        clock: Optional[_StageClock] = None,
    ) -> np.ndarray:
        """Factor a (B, mp, mp) padded stack, split over ``group_devices``
        when more than one is given and sharding is on, else in one launch
        on its first device; returns the factored stack (host).  The bytes
        copied both ways are counted on ``clock``.

        Sharded, the stack is padded with identity fronts to a multiple
        of the lane count and cut into equal shards, one launch per lane;
        every shard is copied and launched before the first copy back, so
        distinct cards work at once (lanes that repeat a card take turns
        on its current stream)."""
        mp = batch.shape[1]
        assert mp <= VMEM_FRONT_MAX, "large fronts take the per-front path"
        if len(group_devices) == 1 or not self.shard_dispatch:
            x = torch.from_numpy(batch).to(group_devices[0])
            # .cpu() waits for the launch on the calling thread's current stream
            out = batched_front_factor(x, nbp).cpu().numpy()
            if clock is not None:
                clock.copied += batch.nbytes + out.nbytes
            return out
        b = batch.shape[0]
        pad = (-b) % len(group_devices)
        if pad:
            eye = np.broadcast_to(np.eye(mp, dtype=batch.dtype), (pad, mp, mp))
            batch = np.concatenate([batch, eye])
        shards = [
            batched_front_factor(torch.from_numpy(part).to(dev), nbp)
            for part, dev in zip(np.split(batch, len(group_devices)), group_devices)
        ]
        # in lane order; each .cpu() waits only for its own card's stream
        out = np.concatenate([o.cpu().numpy() for o in shards])
        if clock is not None:
            clock.copied += batch.nbytes + out.nbytes
        return out[:b]

    def _entry_maps(self, acsc: sp.csc_matrix) -> None:
        """Every front's original entries, in one vectorised pass: their
        indices in the sorted lower CSC's ``data`` and their linear
        positions in the front, below the diagonal and mirrored
        (``gather_front_entries``'s assignments; of an entry given twice,
        the last).  A small front's positions are in its (m, m) block, a
        large front's in its padded (mp, mp) one.  Built once a pattern: a
        matrix with other ``indptr`` / ``indices`` rebuilds them and drops
        what the lanes hold."""
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
        shape = np.array(self._shape, dtype=np.int64).reshape(-1, 2)
        m = np.array([sn.m for sn in symb.supernodes], dtype=np.int64)
        nb = np.array([sn.nb for sn in symb.supernodes], dtype=np.int64)
        large = shape[:, 0] > VMEM_FRONT_MAX
        order = np.where(large, shape[:, 0], m)[s]  # the block's order
        r = np.where(large[s] & (r >= nb[s]), r + (shape[:, 1] - nb)[s], r)
        lower, mirror = r * order + k, k * order + r
        bounds = np.searchsorted(s, np.arange(symb.n_supernodes + 1))
        self._entries = {
            f: (idx[a:b], lower[a:b], mirror[a:b])
            for f, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))
        }
        self._entry_pattern = (indptr.copy(), acsc.indices.copy())

    def _on_lane(self, key: Tuple[str, int], device: torch.device) -> Tuple[torch.Tensor, ...]:
        """An index map on ``device``, uploaded on first use: ``("kid",
        c)`` the child's padded positions (int32), ``("entries", s)`` the
        front's lower and mirrored linear positions (int64).  The uploads
        are the pattern's, once a lane, and are not counted as a run's
        copies."""
        with self._lane_lock:
            lane = self._lane_maps.setdefault(device, {})
            got = lane.get(key)
            if got is None:
                kind, i = key
                arrays = (self._kid_pos[i],) if kind == "kid" else self._entries[i][1:]
                got = tuple(torch.from_numpy(x).to(device) for x in arrays)
                lane[key] = got
        return got

    def _run_large(
        self,
        job: _LargeJob,
        device: torch.device,
        clock: Optional[_StageClock] = None,
    ) -> Tuple[np.ndarray, object]:
        """Assemble one large front on ``device`` and factor it through the
        panel + SYRK pipeline; returns (panel, schur): the panel on the
        host; the Schur block kept on the lane (:class:`_Kept`) when the
        parent is large too, else on the host.

        The front is built as the host builds it: float64 zeros (1 on the
        padding's diagonal), the original entries and their mirror, each
        child's block added in tree order (``extend_add``), one cast to
        the run's dtype; so its bits are the host-assembled front's.  The
        bytes that cross (entries and small children's blocks in, panel
        and a small parent's Schur block out: all of them the front's
        own), the seconds, the front and a kept block are counted on
        ``clock``; while ``torch.profiler`` records, the front is an
        ``executor.large`` range."""
        t0 = time.perf_counter()
        sn = self.symb.supernodes[job.s]
        m, nb, mb = sn.m, sn.nb, sn.m - sn.nb
        mp, nbp = self._shape[job.s]
        with _large_range():
            f = torch.zeros((mp, mp), dtype=torch.float64, device=device)
            diag = f.diagonal()
            diag[nb:nbp] = 1.0
            diag[nbp + mb :] = 1.0
            below, mirror = self._on_lane(("entries", job.s), device)
            values = torch.from_numpy(job.values).to(device)
            flat = f.view(-1)
            flat[below] = values
            flat[mirror] = values
            moved = job.values.nbytes
            for c, blk in job.kids:
                if isinstance(blk, _Kept):
                    src = blk.block(device)
                else:
                    src = torch.from_numpy(blk).to(device)
                    moved += blk.nbytes
                extend_add(f, src, self._on_lane(("kid", c), device)[0])
            job.kids.clear()  # the children's kept blocks go with it
            src = values = None
            out = factor_padded(f.to(self._tdtype), nbp)
            f = None
            panel = panel_of(out, m, nb).cpu().numpy()
            moved += panel.nbytes
            p = sn.parent
            if mb > 0 and p >= 0 and self._shape[p][0] > VMEM_FRONT_MAX:
                schur = _Kept(out, nbp, mb, mb * mb * self.dtype.itemsize)
            else:
                schur = schur_of(out, m, nb).cpu().numpy()
                moved += schur.nbytes
        if clock is not None:
            clock.copied += moved
            clock.useful += moved
            clock.large.seconds += time.perf_counter() - t0
            clock.large.bytes += moved
            clock.large.fronts += 1
            if isinstance(schur, _Kept):
                clock.large.kept_bytes += schur.nbytes
                clock.large.kept_blocks += 1
        return panel, schur

    def _run_large_host(
        self,
        front: np.ndarray,
        nb: int,
        device: torch.device,
        clock: Optional[_StageClock] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """A large front assembled on the host (the provenance runners')
        through the same panel + SYRK code (``partial_cholesky``); returns
        (panel, schur) on the host.  Counted on ``clock`` as
        ``_run_large`` counts: the front in, its panel and Schur block
        out."""
        t0 = time.perf_counter()
        with _large_range():
            panel, schur = partial_cholesky(torch.from_numpy(front).to(device), nb)
            panel, schur = panel.cpu().numpy(), schur.cpu().numpy()
        if clock is not None:
            nbytes = front.nbytes + panel.nbytes + schur.nbytes
            clock.copied += nbytes
            clock.large.seconds += time.perf_counter() - t0
            clock.large.bytes += nbytes
            clock.large.fronts += 1
        return panel, schur

    def warmup(
        self,
        ds: Optional[List[_Dispatch]] = None,
        groups: Optional[Dict[int, DeviceGroup]] = None,
    ) -> None:
        """Build or load the kernel library and run one identity front of
        every small wave-dispatch shape class on each device it will use
        (untimed): with sharding on, every lane of the dispatch's group,
        so no card's first launch (module load, shared-memory opt-in)
        lands inside the timed run."""
        groups = self._wave_groups() if groups is None else groups
        seen = set()
        for d in self.dispatches() if ds is None else ds:
            mp, nbp = d.key
            if mp > VMEM_FRONT_MAX:
                continue
            devs = self._dispatch_devices(d.supernodes, groups)
            for dev in devs if self.shard_dispatch else devs[:1]:
                if (mp, nbp, dev) in seen:
                    continue
                seen.add((mp, nbp, dev))
                self._run_batch(np.eye(mp, dtype=self.dtype)[None], nbp, [dev])

    def _warmup_async(self) -> None:
        """Build or load the kernel library and run one identity front of
        every small shape class on every distinct device (untimed), so no
        build lands inside the timed region.  This covers every lane a
        sharded dispatch can engage, so the async runners need no
        plan-derived ``warmup`` beside it."""
        keys = sorted({k for k in self._shape if k[0] <= VMEM_FRONT_MAX})
        for dev in dict.fromkeys(self.devices):
            for mp, nbp in keys:
                self._run_batch(np.eye(mp, dtype=self.dtype)[None], nbp, [dev])

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
        and the measured-vs-projected report.  Dispatches to the async
        futures runner or the legacy wave runner per ``self.mode``; an
        amalgamated plan (``provenance=``) takes the group-dispatch
        variants of the same two runners.  The run's host totals (see
        ``STAGES``) are kept on the report's ``host``; ``warmup`` adds
        nothing to them."""
        if warmup:
            if self._prov is None and self.mode == "waves":
                self.warmup()
            else:
                self._warmup_async()
        if self._prov is not None:
            runner = self._run_waves_prov if self.mode == "waves" else self._run_async_prov
        else:
            runner = self._run_waves if self.mode == "waves" else self._run_async
        tally = _RunTally(self.dtype.itemsize)
        hook = tally.on_gc
        gc.callbacks.append(hook)
        try:
            with _StageClock(tally, "assemble") as clock:
                fact, report = runner(a, clock)
        finally:
            gc.callbacks.remove(hook)
        report.host = tally.totals()
        tally.publish()
        return fact, report

    # -- shared numeric helpers ----------------------------------------
    def _assemble(
        self,
        s: int,
        acsc: sp.csc_matrix,
        panels: List[Optional[np.ndarray]],
        updates: Dict[int, Tuple[np.ndarray, np.ndarray]],
    ) -> Tuple[np.ndarray, float]:
        """Assemble front ``s`` (original entries + children extend-add),
        popping — i.e. freeing — the children's Schur buffers.  Returns
        (front, consumed CB bytes).  Children are folded in tree order
        regardless of completion order, so the float summation order (and
        therefore the factor bits) is identical across modes."""
        sn = self.symb.supernodes[s]
        kids = self._children[s]
        assert all(panels[c] is not None for c in kids), (
            "dispatch order violates tree precedence"
        )
        t_a0 = time.perf_counter()
        kid_updates, consumed = self._pop_children(s, updates)
        idx, lower, mirror = self._entries[s]
        f = np.zeros((sn.m, sn.m))
        flat = f.reshape(-1)
        flat[lower] = flat[mirror] = acsc.data[idx]
        for rows_c, upd in kid_updates:
            extend_add_np(f, sn, rows_c, upd)
        out = f.astype(self.dtype, copy=False)
        self._assemble_span(s, t_a0)
        return out, consumed

    def _take_large(
        self,
        s: int,
        acsc: sp.csc_matrix,
        panels: List[Optional[np.ndarray]],
        updates: Dict[int, Tuple[np.ndarray, object]],
    ) -> Tuple[_LargeJob, float]:
        """The main thread's part of a large front's assembly: pop (free)
        the children's Schur blocks, kept on a lane or on the host, and
        gather the front's original entries for its worker.  Returns the
        job and the consumed CB bytes, counted as ``_assemble`` counts."""
        assert all(panels[c] is not None for c in self._children[s]), (
            "dispatch order violates tree precedence"
        )
        t_a0 = time.perf_counter()
        kids, consumed = self._pop_children(s, updates)
        values = np.asarray(acsc.data[self._entries[s][0]], dtype=np.float64)
        job = _LargeJob(s, values, [(c, blk) for c, (_, blk) in zip(self._children[s], kids)])
        self._assemble_span(s, t_a0)
        return job, consumed

    def _pop_children(self, s: int, updates: Dict) -> Tuple[List, float]:
        """Pop the children's (rows, Schur block) pairs in tree order, and
        their bytes (a kept block's as its host copy would hold them)."""
        kids = [updates.pop(c) for c in self._children[s]]
        return kids, float(sum(rows.nbytes + blk.nbytes for rows, blk in kids))

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

    def _store(self, s, panel, schur, panels, updates, clock: _StageClock) -> None:
        """Record a factored front: keep the panel, queue the Schur
        complement (a host array, or a block kept on a lane) for the
        parent's extend-add.  A small front's useful bytes are counted
        here; the large route counts its own where it copies."""
        sn = self.symb.supernodes[s]
        if self._shape[s][0] <= VMEM_FRONT_MAX:
            clock.useful_front(sn.m, panel, schur)
        panels[s] = panel
        self._mem_panels += float(panel.nbytes)
        if sn.m > sn.nb:
            updates[s] = (sn.rows[sn.nb :], schur)
            self._mem_updates += float(sn.rows[sn.nb :].nbytes + schur.nbytes)

    def _make_report(
        self,
        trace: List[TraceEvent],
        n_disp: int,
        mem_peak: float,
        mode: str,
        t_run0: float,
    ) -> ExecutionReport:
        """The report of a run that started at ``t_run0`` (perf_counter),
        with the plan's projected peak, published to the bus on its
        clock."""
        measured = max((e.t_end for e in trace), default=0.0)
        report = self._build_report(
            trace, n_disp, mem_peak, self._projected_peak(), mode, measured
        )
        if obs_events.enabled():
            _publish_report_obs(report, t_run0 - obs_events.BUS.epoch)
        return report

    def _build_report(
        self, trace, n_disp, mem_peak, projected_peak, mode, measured
    ) -> ExecutionReport:
        return ExecutionReport(
            plan_makespan=self.plan.makespan,
            plan_alpha=self.plan.alpha,
            plan_devices=self.plan.total_devices,
            measured_makespan=measured,
            trace=trace,
            n_dispatches=n_disp,
            n_devices=len(self.devices),
            interpret=self.interpret,
            measured_peak_bytes=float(mem_peak),
            projected_peak_bytes=float(projected_peak),
            mode=mode,
        )

    # -- wave runner (legacy, barrier-synchronous) ---------------------
    def _run_waves(
        self, a: sp.csr_matrix, clock: _StageClock
    ) -> Tuple[Factorization, ExecutionReport]:
        symb = self.symb
        acsc = lower_csc(a)
        self._entry_maps(acsc)
        clock.lap("scan")
        groups = self._wave_groups()
        ds = self.dispatches()
        by_task = {t.label: t for t in self.plan.tasks if t.label >= 0}

        updates: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        panels: List[Optional[np.ndarray]] = [None] * symb.n_supernodes
        trace: List[TraceEvent] = []
        n_disp = 0
        # measured peak over the real buffers: retained panels + pending
        # Schur updates + the dispatch's assembled fronts (the executor's
        # realization of the schedule's memory timeline)
        self._mem_panels = 0.0
        self._mem_updates = 0.0
        mem_peak = 0.0
        t_run0 = time.perf_counter()

        for d in ds:
            clock.lap("assemble", n_disp)
            mp, nbp = d.key
            large = mp > VMEM_FRONT_MAX
            fronts = []  # assembled fronts; a large front's job for its lane
            consumed = 0.0
            for s in d.supernodes:
                f, c = (self._take_large(s, acsc, panels, updates) if large
                        else self._assemble(s, acsc, panels, updates))
                consumed += c
                fronts.append(f)
            fronts_bytes = float(
                sum(symb.supernodes[s].m ** 2 for s in d.supernodes) * self.dtype.itemsize
            )
            # extend-add transient: consumed CBs (still counted in
            # _mem_updates) coexist with the assembled fronts
            mem_peak = max(
                mem_peak, self._mem_panels + self._mem_updates + fronts_bytes
            )
            self._mem_updates -= consumed

            disp_devs = self._dispatch_devices(d.supernodes, groups)
            if not self.shard_dispatch or large:
                disp_devs = disp_devs[:1]  # large fronts run on one lane
            delay = self._delay_for(d.supernodes)
            t0 = time.perf_counter() - t_run0
            if delay > 0:
                clock.lap("wait", n_disp)
                time.sleep(delay)  # the straggling device, behind the barrier
            if large:
                # large fronts: assembled on the lane, per-front panel+SYRK
                for s, job in zip(d.supernodes, fronts):
                    clock.lap("transfer", n_disp)
                    panel, schur = self._run_large(job, disp_devs[0], clock)
                    clock.lap("extract", n_disp)
                    self._store(s, panel, schur, panels, updates, clock)
                t1 = time.perf_counter() - t_run0
            else:
                clock.lap("pad", n_disp)
                batch = np.stack(
                    [
                        pad_front_np(f, symb.supernodes[s].nb, self.dtype)
                        for s, f in zip(d.supernodes, fronts)
                    ]
                )
                mem_peak = max(
                    mem_peak,
                    self._mem_panels
                    + self._mem_updates
                    + fronts_bytes
                    + float(batch.nbytes),
                )
                clock.lap("transfer", n_disp)
                out = self._run_batch(batch, nbp, disp_devs, clock)
                t1 = time.perf_counter() - t_run0
                clock.lap("extract", n_disp)
                for s, o in zip(d.supernodes, out):
                    sn = symb.supernodes[s]
                    panel, schur = extract_panel_schur(o, sn.m, sn.nb)
                    self._store(s, panel, schur, panels, updates, clock)
            n_disp += 1
            for s in d.supernodes:
                sn = symb.supernodes[s]
                g = groups.get(s)
                trace.append(
                    TraceEvent(
                        front=s,
                        wave=d.wave,
                        devices=by_task[s].devices if s in by_task else 1,
                        devices_used=g.size if g else 1,
                        dispatch_devices=len(disp_devs),
                        t_start=t0,
                        t_end=t1,
                        flops=sn.flops,
                        batched=len(d.supernodes),
                        device0=g.offset if g else 0,
                    )
                )

        clock.lap("report")
        assert all(p is not None for p in panels), "plan missed supernodes"
        report = self._make_report(trace, n_disp, mem_peak, "waves", t_run0)
        return Factorization(symb=symb, panels=panels), report  # type: ignore[arg-type]

    # -- async futures runner (per-front state machine) ----------------
    def _run_async(
        self, a: sp.csr_matrix, clock: _StageClock
    ) -> Tuple[Factorization, ExecutionReport]:
        """Event-driven execution: fronts dispatch the instant their
        children's Schur complements land; no wave barrier.

        The main thread owns all bookkeeping (readiness, assembly,
        extend-add, memory accounting, trace); worker threads only run
        the kernel dispatch, so no lock is needed beyond the futures.
        """
        symb = self.symb
        acsc = lower_csc(a)
        self._entry_maps(acsc)
        clock.lap("scan")
        ndev = len(self.devices)
        by_task = {t.label: t for t in self.plan.tasks if t.label >= 0}

        n = symb.n_supernodes
        itemsize = self.dtype.itemsize
        # plan-derived dispatch priority (earliest planned start first) and
        # desired group size, rescaled to the executing mesh
        prio = {
            s: (by_task[s].start if s in by_task else 0.0, s) for s in range(n)
        }
        want = {
            s: (
                scale_group(
                    by_task[s].devices, self.plan.total_devices, ndev
                )
                if s in by_task and by_task[s].devices > 0
                else 1
            )
            for s in range(n)
        }

        n_unfinished = np.array(
            [len(self._children[s]) for s in range(n)], dtype=np.int64
        )
        updates: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        panels: List[Optional[np.ndarray]] = [None] * n
        trace: List[TraceEvent] = []
        alloc = BuddyAllocator(ndev)
        in_flight: Dict = {}  # Future -> _Inflight
        t_ready: Dict[int, float] = {}
        # the ready fronts: one min-heap of (prio, front) per shape class;
        # prio ends in the front's id, so heap order is priority order
        ready: Dict[Tuple[int, int], List[Tuple[Tuple[float, int], int]]] = {}
        n_ready = 0
        self._mem_panels = 0.0
        self._mem_updates = 0.0
        mem_inflight = 0.0
        mem_peak = 0.0
        n_done = 0
        n_disp = 0
        seq = 0

        t_run0 = time.perf_counter()

        def make_ready(s: int, t: float) -> None:
            nonlocal n_ready
            t_ready[s] = t
            heapq.heappush(ready.setdefault(self._shape[s], []), (prio[s], s))
            n_ready += 1

        def now() -> float:
            return time.perf_counter() - t_run0

        def publish_state() -> None:
            """Live counter samples on the bus clock: the bus points become
            perfetto counter tracks; the gauges feed the dashboard."""
            if not obs_events.enabled():
                return
            bus = obs_events.BUS
            t = bus.wall()
            resident = self._mem_panels + self._mem_updates + mem_inflight
            bus.point("queue_depth", n_ready, t=t)
            bus.point("resident_bytes", resident, t=t)
            reg = obs_metrics.REGISTRY
            reg.gauge(
                "repro_queue_depth",
                "ready fronts awaiting dispatch",
                unit="fronts",
                track=True,
            ).set(n_ready, t=t)
            reg.gauge(
                "repro_resident_bytes",
                "live host buffers (panels + CBs + in-flight)",
                unit="bytes",
            ).set(resident, t=t)
            reg.gauge(
                "repro_buddy_free_devices",
                "free devices in the buddy allocator",
                unit="devices",
            ).set(alloc.n_free, t=t)
            reg.gauge(
                "repro_buddy_fragmentation",
                "1 - largest free run / free devices",
            ).set(alloc.fragmentation, t=t)

        for s in range(n):
            if n_unfinished[s] == 0:
                make_ready(s, 0.0)

        def worker_small(batch, nbp, devs, delay, key, lane):
            t0 = now()
            if delay > 0:
                time.sleep(delay)  # the straggling device — only this
                # dispatch's ancestors wait for it
            with _StageClock(clock.tally, "transfer", key, lane) as wc:
                out = self._run_batch(batch, nbp, devs, wc)
            return {"out": out, "t0": t0, "t1": now()}

        def worker_large(jobs, dev, delay, key, lane):
            # jobs: one _LargeJob a front — assembled on the lane, then
            # the per-front panel+SYRK pipeline
            t0 = now()
            if delay > 0:
                time.sleep(delay)
            with _StageClock(clock.tally, "transfer", key, lane) as wc:
                outs = [self._run_large(job, dev, wc) for job in jobs]
            return {"outs": outs, "t0": t0, "t1": now()}

        def launch_ready(pool) -> int:
            """Issue as many dispatches as devices/memory admit; returns
            how many were launched."""
            nonlocal mem_inflight, mem_peak, n_disp, n_ready, seq
            clock.lap("scan", seq)
            launched = 0
            while n_ready:
                if alloc.n_free == 0:
                    break
                # the class holding the highest-priority ready front
                key = min(ready, key=lambda k: ready[k][0])
                heap = ready[key]
                mp, nbp = key
                # power-of-two batch sizes only, as in the reference, so
                # dispatch counts compare one to one with it (the remainder
                # stays ready for the next dispatch); large fronts one by one
                k = (
                    1
                    if mp > VMEM_FRONT_MAX
                    else pow2_floor(min(len(heap), self.max_batch))
                )
                members = [s for _, s in _heap_head(heap, k)]

                def dispatch_bytes(ms) -> float:
                    fb = sum(
                        symb.supernodes[s].m ** 2 * itemsize for s in ms
                    )
                    bb = 0 if mp > VMEM_FRONT_MAX else len(ms) * mp * mp * itemsize
                    return float(fb + bb)

                if self.memory_cap_bytes is not None:
                    resident = (
                        self._mem_panels + self._mem_updates + mem_inflight
                    )
                    while (
                        len(members) > 1
                        and resident + dispatch_bytes(members)
                        > self.memory_cap_bytes
                    ):
                        members = members[:-1]  # shed the lowest priority
                    if resident + dispatch_bytes(members) > self.memory_cap_bytes:
                        if in_flight or launched:
                            break  # wait for buffers to free
                        # pipeline empty: dispatch anyway (progress beats
                        # the cap, same as the wave path's single dispatch)

                groups: Dict[int, DeviceGroup] = {}
                for s in members:
                    g = alloc.alloc(want[s])
                    if g is None:
                        break
                    groups[s] = g
                if not groups:
                    break  # no free device — wait for a completion
                # every chosen member joins the dispatch: the batch is one
                # kernel launch sharded over the carved groups' union, so
                # fronts beyond the free capacity time-share it (same
                # discipline as the wave carver's oversubscription rule)
                for _ in members:
                    heapq.heappop(heap)
                if not heap:
                    del ready[key]
                n_ready -= len(members)

                t_sub = now()
                clock.lap("assemble", seq)
                large = mp > VMEM_FRONT_MAX
                fronts = []  # assembled fronts; a large front's job for its lane
                consumed = 0.0
                for s in members:
                    f, c = (self._take_large(s, acsc, panels, updates) if large
                            else self._assemble(s, acsc, panels, updates))
                    consumed += c
                    fronts.append(f)
                fronts_bytes = float(
                    sum(symb.supernodes[s].m ** 2 for s in members) * itemsize
                )
                # extend-add transient: consumed CBs coexist with the
                # newly assembled fronts
                mem_peak = max(
                    mem_peak,
                    self._mem_panels
                    + self._mem_updates
                    + mem_inflight
                    + fronts_bytes,
                )
                self._mem_updates -= consumed
                delay = self._delay_for(members)

                devs = self._dispatch_devices(members, groups)
                if not self.shard_dispatch or large:
                    devs = devs[:1]  # large fronts run on one lane
                lane = min(g.offset for g in groups.values())  # devs[0]'s
                if large:
                    clock.lap("scan", seq)
                    held = fronts_bytes
                    fut = pool.submit(worker_large, fronts, devs[0], delay, seq, lane)
                else:
                    clock.lap("pad", seq)
                    batch = np.stack(
                        [
                            pad_front_np(f, symb.supernodes[s].nb, self.dtype)
                            for s, f in zip(members, fronts)
                        ]
                    )
                    clock.lap("scan", seq)
                    mem_peak = max(
                        mem_peak,
                        self._mem_panels
                        + self._mem_updates
                        + mem_inflight
                        + fronts_bytes
                        + float(batch.nbytes),
                    )
                    held = float(batch.nbytes)
                    fut = pool.submit(
                        worker_small, batch, nbp, devs, delay, seq, lane
                    )
                del fronts
                mem_inflight += held
                in_flight[fut] = _Inflight(
                    seq=seq,
                    supernodes=tuple(members),
                    key=key,
                    groups=groups,
                    dispatch_devices=len(devs),
                    held_bytes=held,
                    t_submit=t_sub,
                    large=large,
                )
                seq += 1
                n_disp += 1
                launched += 1
                publish_state()
            return launched

        def complete(fut) -> None:
            nonlocal mem_inflight, mem_peak, n_done
            info = in_flight.pop(fut)
            clock.lap("extract", info.seq)
            res = fut.result()
            t0, t1 = res["t0"], res["t1"]
            if info.large:
                for s, (panel, schur) in zip(info.supernodes, res["outs"]):
                    self._store(s, panel, schur, panels, updates, clock)
            else:
                for s, o in zip(info.supernodes, res["out"]):
                    sn = symb.supernodes[s]
                    panel, schur = extract_panel_schur(o, sn.m, sn.nb)
                    self._store(s, panel, schur, panels, updates, clock)
            mem_inflight -= info.held_bytes
            mem_peak = max(
                mem_peak, self._mem_panels + self._mem_updates + mem_inflight
            )
            for s in info.supernodes:
                g = info.groups.get(s)
                if g is not None:
                    alloc.free(g)
                sn = symb.supernodes[s]
                trace.append(
                    TraceEvent(
                        front=s,
                        wave=info.seq,
                        devices=by_task[s].devices if s in by_task else 1,
                        devices_used=g.size if g else 1,
                        dispatch_devices=info.dispatch_devices,
                        t_start=t0,
                        t_end=t1,
                        flops=sn.flops,
                        batched=len(info.supernodes),
                        t_ready=t_ready[s],
                        t_submit=info.t_submit,
                        device0=g.offset if g is not None else 0,
                    )
                )
                # the completion event: the parent becomes ready the
                # instant its last child's Schur complement lands
                p = symb.supernodes[s].parent
                if p >= 0:
                    n_unfinished[p] -= 1
                    if n_unfinished[p] == 0:
                        make_ready(p, t1)
            n_done += len(info.supernodes)
            publish_state()

        workers = self.max_workers or max(2, ndev)
        pool = ThreadPoolExecutor(max_workers=workers)
        try:
            while n_done < n:
                launched = launch_ready(pool)
                if in_flight:
                    clock.lap("wait")
                    done, _ = futures_wait(
                        set(in_flight), return_when=FIRST_COMPLETED
                    )
                    for fut in done:
                        complete(fut)
                elif not launched:
                    raise RuntimeError(
                        "async executor stalled with ready fronts"
                    )
            clock.lap("report")
        finally:
            pool.shutdown(wait=True)

        assert all(p is not None for p in panels), "plan missed supernodes"
        report = self._make_report(trace, n_disp, mem_peak, "async", t_run0)
        return Factorization(symb=symb, panels=panels), report  # type: ignore[arg-type]


    # -- amalgamated-plan runners (provenance group dispatches) --------
    def _run_group(
        self,
        gid: int,
        acsc: sp.csc_matrix,
        ext_cb: Dict[int, Tuple[np.ndarray, np.ndarray]],
        clock: _StageClock,
        seq: int,
    ) -> Dict:
        """Factor one fused group's member fronts; the worker body shared
        by both provenance runners (pure compute — no shared state is
        mutated, the callers own all bookkeeping).  Its stages are timed
        on ``clock``, the calling thread's, under the dispatch's sequence
        number ``seq``; a worker's ``fixed`` clock counts it all as
        ``transfer``.

        ``ext_cb`` holds the Schur complements crossing into the group
        from already-finished external children.  Levels run children
        before parents; within a level, same-shape small members factor
        as **one batched launch** (each front is its own CTA, so batching
        never changes a front's bits) and each member still assembles via
        ``assemble_front_np`` with its children folded in tree order —
        the bit-identity discipline of ``_assemble``, unchanged.

        Returns per-member ``(s, panel, schur)`` (``schur`` only for
        members whose parent lies outside the group), the dispatch's
        wall-clock interval, and the transient byte peak the group held.
        """
        symb = self.symb
        members = self._groups[gid]
        inset = set(members)
        cb = dict(ext_cb)
        results: List[Tuple[int, np.ndarray, Optional[np.ndarray]]] = []
        t0 = time.perf_counter()
        delay = self._delay_for(members)
        if delay > 0:
            clock.lap("wait", seq)
            time.sleep(delay)  # one injected stall per *dispatch*: fused
            # members share the launch, so a group pays its slowest member
            # once — the whole point of amalgamation
        held = float(
            sum(r.nbytes + u.nbytes for r, u in cb.values())
        )
        peak = held
        panels_local: Dict[int, np.ndarray] = {}
        for level in self._group_levels[gid]:
            clock.lap("assemble", seq)
            fronts: Dict[int, np.ndarray] = {}
            consumed = 0.0
            for s in level:
                sn = symb.supernodes[s]
                kid_updates = [cb[c] for c in self._children[s]]
                f = assemble_front_np(acsc, sn, kid_updates)
                fronts[s] = f.astype(self.dtype, copy=False)
                # extend-add transient: the children's CBs coexist with
                # the assembled front until this pop
                peak = max(peak, held + float(fronts[s].nbytes))
                for c in self._children[s]:
                    r, u = cb.pop(c)
                    consumed += float(r.nbytes + u.nbytes)
                held += float(fronts[s].nbytes)
            peak = max(peak, held)
            held -= consumed

            classes: Dict[Tuple[int, int], List[int]] = {}
            for s in level:
                classes.setdefault(self._shape[s], []).append(s)
            for key in sorted(classes):
                mp, nbp = key
                sns = classes[key]
                if mp > VMEM_FRONT_MAX:
                    for s in sns:
                        sn = symb.supernodes[s]
                        clock.lap("transfer", seq)
                        panel, schur = self._run_large_host(
                            fronts[s], sn.nb, self.devices[0], clock
                        )
                        clock.useful_front(sn.m, panel, schur)
                        panels_local[s] = panel
                        if sn.m > sn.nb:
                            cb[s] = (sn.rows[sn.nb :], schur)
                    continue
                for lo in range(0, len(sns), self.max_batch):
                    chunk = sns[lo : lo + self.max_batch]
                    clock.lap("pad", seq)
                    batch = np.stack(
                        [
                            pad_front_np(
                                fronts[s], symb.supernodes[s].nb, self.dtype
                            )
                            for s in chunk
                        ]
                    )
                    peak = max(peak, held + float(batch.nbytes))
                    clock.lap("transfer", seq)
                    out = self._run_batch(batch, nbp, self.devices[:1], clock)
                    clock.lap("extract", seq)
                    for s, o in zip(chunk, out):
                        sn = symb.supernodes[s]
                        panel, schur = extract_panel_schur(o, sn.m, sn.nb)
                        clock.useful_front(sn.m, panel, schur)
                        panels_local[s] = panel
                        if sn.m > sn.nb:
                            cb[s] = (sn.rows[sn.nb :], schur)
            for s in level:
                sn = symb.supernodes[s]
                held += float(panels_local[s].nbytes)
                if sn.m > sn.nb:
                    held += float(cb[s][1].nbytes + cb[s][0].nbytes)
                held -= float(fronts[s].nbytes)
            peak = max(peak, held)

        for s in members:
            sn = symb.supernodes[s]
            ext = sn.parent < 0 or sn.parent not in inset
            schur = cb[s][1] if (ext and sn.m > sn.nb) else None
            results.append((s, panels_local[s], schur))
        return {
            "results": results,
            "t0": t0,
            "t1": time.perf_counter(),
            "transient": peak,
        }

    def _pop_ext_cb(
        self,
        gid: int,
        updates: Dict[int, Tuple[np.ndarray, np.ndarray]],
    ) -> Tuple[Dict[int, Tuple[np.ndarray, np.ndarray]], float]:
        """Pop the Schur complements entering group ``gid`` from outside
        (main-thread bookkeeping; the bytes stay counted in
        ``_mem_updates`` until the caller subtracts the returned total —
        the extend-add transient)."""
        ext: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        consumed = 0.0
        for s in self._groups[gid]:
            for c in self._children[s]:
                if self._gid_of[c] != gid:
                    r, u = updates.pop(c)
                    ext[c] = (r, u)
                    consumed += float(r.nbytes + u.nbytes)
        return ext, consumed

    def _store_group(self, res: Dict, panels, updates) -> None:
        """Land a finished group's results in the shared front space."""
        for s, panel, schur in res["results"]:
            sn = self.symb.supernodes[s]
            panels[s] = panel
            self._mem_panels += float(panel.nbytes)
            if schur is not None:
                updates[s] = (sn.rows[sn.nb :], schur)
                self._mem_updates += float(
                    sn.rows[sn.nb :].nbytes + schur.nbytes
                )

    def _run_waves_prov(
        self, a: sp.csr_matrix, clock: _StageClock
    ) -> Tuple[Factorization, ExecutionReport]:
        """Wave runner over fused groups: same barrier discipline as
        ``_run_waves``, one dispatch per group task."""
        symb = self.symb
        acsc = lower_csc(a)
        clock.lap("scan")
        groups = self._wave_groups()  # keyed by group label
        by_task = {t.label: t for t in self.plan.tasks if t.label >= 0}

        updates: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        panels: List[Optional[np.ndarray]] = [None] * symb.n_supernodes
        trace: List[TraceEvent] = []
        n_disp = 0
        self._mem_panels = 0.0
        self._mem_updates = 0.0
        mem_peak = 0.0
        t_run0 = time.perf_counter()

        for w, wave in enumerate(self.plan.waves()):
            for t in sorted(wave, key=lambda t: t.task):
                if t.label < 0:
                    continue
                gid = t.label
                clock.lap("scan", n_disp)
                ext_cb, consumed = self._pop_ext_cb(gid, updates)
                res = self._run_group(gid, acsc, ext_cb, clock, n_disp)
                clock.lap("extract", n_disp)
                mem_peak = max(
                    mem_peak,
                    self._mem_panels + self._mem_updates + res["transient"],
                )
                self._mem_updates -= consumed
                self._store_group(res, panels, updates)
                n_disp += 1
                g = groups.get(gid)
                t0 = res["t0"] - t_run0
                t1 = res["t1"] - t_run0
                for s in self._groups[gid]:
                    trace.append(
                        TraceEvent(
                            front=s,
                            wave=w,
                            devices=t.devices,
                            devices_used=g.size if g else 1,
                            dispatch_devices=1,
                            t_start=t0,
                            t_end=t1,
                            flops=symb.supernodes[s].flops,
                            batched=len(self._groups[gid]),
                            device0=g.offset if g else 0,
                        )
                    )

        clock.lap("report")
        assert all(p is not None for p in panels), "plan missed supernodes"
        report = self._make_report(trace, n_disp, mem_peak, "waves", t_run0)
        return Factorization(symb=symb, panels=panels), report  # type: ignore[arg-type]

    def _run_async_prov(
        self, a: sp.csr_matrix, clock: _StageClock
    ) -> Tuple[Factorization, ExecutionReport]:
        """Async futures runner over fused groups.

        The state machine of ``_run_async`` with the group as the unit of
        readiness and dispatch: a group is ready when its last external
        child group completes, its device group is carved from the free
        set, and its members factor on a worker thread as one dispatch.
        Groups never coalesce across the provenance partition — the
        optimizer already chose the batches.
        """
        symb = self.symb
        acsc = lower_csc(a)
        clock.lap("scan")
        ndev = len(self.devices)
        by_task = {t.label: t for t in self.plan.tasks if t.label >= 0}

        ng = len(self._groups)
        itemsize = self.dtype.itemsize
        prio = {
            g: (by_task[g].start if g in by_task else 0.0, g)
            for g in range(ng)
        }
        want = {
            g: (
                scale_group(
                    by_task[g].devices, self.plan.total_devices, ndev
                )
                if g in by_task and by_task[g].devices > 0
                else 1
            )
            for g in range(ng)
        }
        n_unfinished = np.array(
            [len(self._group_ext_children[g]) for g in range(ng)],
            dtype=np.int64,
        )
        updates: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        panels: List[Optional[np.ndarray]] = [None] * symb.n_supernodes
        trace: List[TraceEvent] = []
        alloc = BuddyAllocator(ndev)
        in_flight: Dict = {}  # Future -> (gid, group alloc, held, t_submit, seq)
        t_ready: Dict[int, float] = {}
        ready: List[int] = []
        self._mem_panels = 0.0
        self._mem_updates = 0.0
        mem_inflight = 0.0
        mem_peak = 0.0
        n_done = 0
        n_disp = 0
        seq = 0
        t_run0 = time.perf_counter()

        def now() -> float:
            return time.perf_counter() - t_run0

        for g in range(ng):
            if n_unfinished[g] == 0:
                t_ready[g] = 0.0
                ready.append(g)

        def est_bytes(gid: int) -> float:
            return float(
                sum(
                    symb.supernodes[s].m ** 2 * itemsize
                    for s in self._groups[gid]
                )
            )

        def publish_state() -> None:
            if not obs_events.enabled():
                return
            bus = obs_events.BUS
            t = bus.wall()
            resident = self._mem_panels + self._mem_updates + mem_inflight
            bus.point("queue_depth", len(ready), t=t)
            bus.point("resident_bytes", resident, t=t)
            reg = obs_metrics.REGISTRY
            reg.gauge(
                "repro_queue_depth",
                "ready fronts awaiting dispatch",
                unit="fronts",
                track=True,
            ).set(len(ready), t=t)
            reg.gauge(
                "repro_resident_bytes",
                "live host buffers (panels + CBs + in-flight)",
                unit="bytes",
            ).set(resident, t=t)
            reg.gauge(
                "repro_buddy_free_devices",
                "free devices in the buddy allocator",
                unit="devices",
            ).set(alloc.n_free, t=t)
            reg.gauge(
                "repro_buddy_fragmentation",
                "1 - largest free run / free devices",
            ).set(alloc.fragmentation, t=t)

        def worker_group(gid, ext_cb, sq, lane):
            with _StageClock(clock.tally, "transfer", sq, lane, fixed=True) as wc:
                return self._run_group(gid, acsc, ext_cb, wc, sq)

        def launch_ready(pool) -> int:
            nonlocal mem_inflight, mem_peak, n_disp, seq
            clock.lap("scan", seq)
            launched = 0
            while ready:
                if alloc.n_free == 0:
                    break
                gid = min(ready, key=lambda g: prio[g])
                if self.memory_cap_bytes is not None:
                    resident = (
                        self._mem_panels + self._mem_updates + mem_inflight
                    )
                    if resident + est_bytes(gid) > self.memory_cap_bytes:
                        # a fused dispatch cannot shed members; defer it
                        # while anything can still free buffers (progress
                        # is guaranteed when the pipeline drains empty)
                        if in_flight or launched:
                            break
                g_alloc = alloc.alloc(want[gid])
                if g_alloc is None:
                    break
                ready.remove(gid)
                t_sub = now()
                ext_cb, consumed = self._pop_ext_cb(gid, updates)
                held = consumed + est_bytes(gid)
                mem_peak = max(
                    mem_peak,
                    self._mem_panels
                    + self._mem_updates
                    + mem_inflight
                    + est_bytes(gid),
                )
                self._mem_updates -= consumed
                mem_inflight += held
                fut = pool.submit(worker_group, gid, ext_cb, seq, g_alloc.offset)
                in_flight[fut] = (gid, g_alloc, held, t_sub, seq)
                seq += 1
                n_disp += 1
                launched += 1
                publish_state()
            return launched

        def complete(fut) -> None:
            nonlocal mem_inflight, mem_peak, n_done
            gid, g_alloc, held, t_sub, sq = in_flight.pop(fut)
            clock.lap("extract", sq)
            res = fut.result()
            self._store_group(res, panels, updates)
            mem_inflight -= held
            mem_peak = max(
                mem_peak,
                self._mem_panels
                + self._mem_updates
                + mem_inflight
                + res["transient"]
                - est_bytes(gid),
            )
            alloc.free(g_alloc)
            t0 = res["t0"] - t_run0
            t1 = res["t1"] - t_run0
            for s in self._groups[gid]:
                trace.append(
                    TraceEvent(
                        front=s,
                        wave=sq,
                        devices=by_task[gid].devices if gid in by_task else 1,
                        devices_used=g_alloc.size,
                        dispatch_devices=1,
                        t_start=t0,
                        t_end=t1,
                        flops=symb.supernodes[s].flops,
                        batched=len(self._groups[gid]),
                        t_ready=t_ready[gid],
                        t_submit=t_sub,
                        device0=g_alloc.offset,
                    )
                )
            pg = self._group_parent[gid]
            if pg >= 0:
                n_unfinished[pg] -= 1
                if n_unfinished[pg] == 0:
                    t_ready[pg] = t1
                    ready.append(pg)
            n_done += 1
            publish_state()

        workers = self.max_workers or max(2, ndev)
        pool = ThreadPoolExecutor(max_workers=workers)
        try:
            while n_done < ng:
                launched = launch_ready(pool)
                if in_flight:
                    clock.lap("wait")
                    done, _ = futures_wait(
                        set(in_flight), return_when=FIRST_COMPLETED
                    )
                    for fut in done:
                        complete(fut)
                elif not launched and n_done < ng:
                    # remaining groups are label -1 placeholders with no
                    # computation (e.g. a lone virtual root)
                    rest = [g for g in ready if not self._groups[g]]
                    if not rest:
                        raise RuntimeError(
                            "async executor stalled with ready groups"
                        )
                    for g in rest:
                        ready.remove(g)
                        pg = self._group_parent[g]
                        if pg >= 0:
                            n_unfinished[pg] -= 1
                            if n_unfinished[pg] == 0:
                                t_ready[pg] = now()
                                ready.append(pg)
                        n_done += 1
            clock.lap("report")
        finally:
            pool.shutdown(wait=True)

        assert all(p is not None for p in panels), "plan missed supernodes"
        report = self._make_report(trace, n_disp, mem_peak, "async", t_run0)
        return Factorization(symb=symb, panels=panels), report  # type: ignore[arg-type]


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
