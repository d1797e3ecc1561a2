"""The one chrome-trace / perfetto exporter.

Every trace the repo emits goes through the builders here, so every
emitter produces the same field set — ``{name, cat, ph, ts, dur, pid,
tid, args}`` for slices — and a regression test can hold them to it.
``ExecutionReport.to_trace`` and ``Schedule.to_trace`` are thin wrappers
over :func:`from_execution_report` / :func:`from_schedule`; both stay
slices-only by default (existing consumers assert ``ph == "X"``
throughout).

:func:`from_bus` is the richer view over live telemetry: one perfetto
*process* per device lane, one *thread* per unit of work (front / task /
tree), ``ready`` / ``submit`` / ``run`` / ``assemble`` phase slices,
``M`` metadata rows naming the lanes, and ``C`` counter tracks folded
from the bus's numeric point events (resident bytes, queue depth,
capacity).  Load the saved JSON in ui.perfetto.dev.

Timestamps are exported in microseconds (``time_scale=1e6`` from
seconds), the trace-event format's native unit.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from .events import EventBus, Span

SLICE_KEYS = frozenset({"name", "cat", "ph", "ts", "dur", "pid", "tid", "args"})

# Render order of front lifecycle phases when sorting a lane.
PHASE_ORDER = {"ready": 0, "submit": 1, "run": 2, "assemble": 3}


# ----------------------------------------------------------------------
# Builders — the only places trace-event dicts are assembled
# ----------------------------------------------------------------------
def slice_event(
    name: str,
    cat: str,
    ts: float,
    dur: float,
    *,
    pid: int = 0,
    tid: int = 0,
    args: Optional[Dict] = None,
) -> Dict:
    """A complete ``ph="X"`` slice with the canonical key set."""
    return {
        "name": name,
        "cat": cat,
        "ph": "X",
        "ts": ts,
        "dur": dur,
        "pid": pid,
        "tid": tid,
        "args": dict(args or {}),
    }


def counter_event(name: str, ts: float, value: float, *, pid: int = 0) -> Dict:
    """A ``ph="C"`` counter sample; perfetto draws these as area tracks."""
    return {
        "name": name,
        "ph": "C",
        "ts": ts,
        "pid": pid,
        "args": {name: value},
    }


def metadata_event(name: str, *, pid: int = 0, tid: int = 0, **args) -> Dict:
    """A ``ph="M"`` metadata record (process / thread naming)."""
    return {"name": name, "ph": "M", "pid": pid, "tid": tid, "args": args}


# ----------------------------------------------------------------------
# The two legacy emitters, now thin wrappers
# ----------------------------------------------------------------------
def from_execution_report(report, time_scale: float = 1e6) -> List[Dict]:
    """Slices for an :class:`~repro_torch.runtime.executor.ExecutionReport`.

    One ``X`` slice per front on its dispatch's row; async-mode
    ready/dispatch latencies land in ``args`` so the stall structure
    (waiting-for-devices vs running) is visible next to the slices.
    """
    import math

    out: List[Dict] = []
    for e in report.trace:
        if e.t_end <= e.t_start:
            continue
        args: Dict = {
            "devices_planned": e.devices,
            "devices_used": e.devices_used,
            "dispatch_devices": e.dispatch_devices,
            "batched": e.batched,
            "flops": e.flops,
        }
        if not math.isnan(e.t_ready):
            args["ready_latency_s"] = e.ready_latency
        if not math.isnan(e.t_submit):
            args["dispatch_latency_s"] = e.dispatch_latency
        out.append(
            slice_event(
                f"front {e.front}",
                report.mode,
                e.t_start * time_scale,
                e.duration * time_scale,
                pid=0,
                tid=e.wave,
                args=args,
            )
        )
    return out


def from_schedule(schedule, time_scale: float = 1e6) -> List[Dict]:
    """Slices for a planned :class:`~repro_torch.api.schedule.Schedule`."""
    out: List[Dict] = []
    for e in schedule.entries:
        if e.end <= e.start:
            continue
        out.append(
            slice_event(
                f"task {e.label}",
                schedule.policy,
                e.start * time_scale,
                e.duration * time_scale,
                pid=0,
                tid=e.task,
                args={"share": e.share},
            )
        )
    return out


# ----------------------------------------------------------------------
# The bus view: device lanes + phases + counter tracks
# ----------------------------------------------------------------------
def from_bus(
    bus: EventBus,
    time_scale: float = 1e6,
    *,
    clock: Optional[str] = None,
) -> List[Dict]:
    """Full perfetto trace from live telemetry.

    Layout: ``pid`` = device lane (``device N``; lane -1 → ``host``
    as pid 0 shifted by one so device 0 keeps its own process),
    ``tid`` = the unit's key (front / task / tree id), so one thread row
    shows a unit's whole lifecycle — ``ready`` → ``submit`` → ``run`` →
    ``assemble`` — and counter tracks (``C``) ride on the host process.

    Pass ``clock`` (``"wall"`` or ``"virtual"``) to restrict mixed-clock
    buses to one time domain; by default all spans are exported (the
    usual bus holds a single domain per run).
    """
    spans: List[Span] = bus.spans()
    if clock is not None:
        spans = [s for s in spans if s.clock == clock]

    out: List[Dict] = []
    pids_seen: Dict[int, str] = {}

    def pid_of(device: int) -> int:
        # host/sim lane is pid 0; device d occupies pid d + 1
        pid = 0 if device < 0 else device + 1
        pids_seen.setdefault(pid, "host" if device < 0 else f"device {device}")
        return pid

    for s in sorted(
        spans, key=lambda s: (s.t0, PHASE_ORDER.get(s.name, 9), s.key)
    ):
        if s.t1 <= s.t0:
            continue
        out.append(
            slice_event(
                f"{s.name} {s.cat} {s.key}" if s.key >= 0 else s.name,
                s.cat,
                s.t0 * time_scale,
                s.duration * time_scale,
                pid=pid_of(s.device),
                tid=s.key if s.key >= 0 else 0,
                args={"clock": s.clock, **s.attrs},
            )
        )

    counters = bus.counter_tracks()
    if clock is not None:
        wanted = {
            e.name
            for e in bus.events()
            if e.value is not None and e.clock == clock
        }
        counters = {k: v for k, v in counters.items() if k in wanted}
    for name, pts in sorted(counters.items()):
        pid_of(-1)
        for t, v in pts:
            out.append(counter_event(name, t * time_scale, v, pid=0))

    meta = [
        metadata_event("process_name", pid=pid, process_name=label)
        for pid, label in sorted(pids_seen.items())
    ]
    return meta + out


def save_trace(events: List[Dict], path) -> None:
    """Write a trace-event JSON file loadable in ui.perfetto.dev."""
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)


__all__ = [
    "PHASE_ORDER",
    "SLICE_KEYS",
    "counter_event",
    "from_bus",
    "from_execution_report",
    "from_schedule",
    "metadata_event",
    "save_trace",
    "slice_event",
]
