"""Process-local structured event bus — the one telemetry substrate.

Before this module, every subsystem kept a private trace type: the
executor's ``TraceEvent`` list, the online scheduler's §4 share pieces,
ad-hoc ``RunReport.metrics`` dicts.  None of them shared a clock and
none could be watched live.  The bus replaces the *recording* side of
all three with a single vocabulary:

* :class:`Span` — a named interval ``[t0, t1]`` with a category (the
  subsystem's noun: ``front``, ``group``, ``task``, ``tree``,
  ``request``), a ``key`` (front / task id), a ``device`` lane, and a
  free-form attribute dict.  Spans are what the chrome-trace exporter
  (:mod:`repro_torch.obs.trace`) renders as slices and what
  :mod:`repro_torch.obs.efficiency` folds into the measured share timeline
  p̂(t) (the paper §4's instantaneous-allocation profile, observed).
* :class:`Event` — a named point sample ``(t, value)``; numeric-valued
  events become perfetto counter tracks (resident bytes, queue depth,
  capacity).

**Dual clocks.**  Real runs (the JAX executor) stamp wall time —
seconds since the bus epoch, monotonic via ``time.perf_counter`` — and
simulated runs (the discrete-event online scheduler) stamp *virtual*
time.  Every record carries its ``clock`` so the two never mix silently;
exporters and metrics group by clock domain.

**Zero-overhead mode.**  ``obs.disable()`` flips one module flag; every
publish method returns immediately.  Instrumented code may also guard
larger blocks with :func:`enabled`.  Publishing never mutates numeric
state anywhere — disabling telemetry must (and does — see
``tests/test_obs.py``) leave factorization bits identical.

The bus is process-local and thread-safe (the async executor publishes
from worker threads).  It is *not* a metrics store — counters, gauges
and histograms live in :mod:`repro_torch.obs.metrics`.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

WALL = "wall"
VIRTUAL = "virtual"
CLOCKS = (WALL, VIRTUAL)


@dataclass(frozen=True)
class Event:
    """A point sample: named, timestamped, optionally numeric.

    Numeric-valued events are the raw material of counter tracks
    (resident bytes, queue depth, capacity steps); value-less events are
    instants (an admission, a failure).
    """

    name: str
    t: float
    clock: str = WALL
    value: Optional[float] = None
    attrs: Dict = field(default_factory=dict)


@dataclass(frozen=True)
class Span:
    """A named interval — one phase of one unit of work.

    ``cat`` is the unit's noun (``front`` / ``group`` / ``task`` /
    ``tree`` / ``request``); ``name`` the lifecycle phase (``ready`` /
    ``submit`` / ``run`` / ``assemble`` for executor fronts).  ``key``
    identifies the unit within its category, ``device`` the lane it
    occupied (device index for real runs; -1 when not device-bound).
    """

    sid: int
    name: str
    cat: str
    key: int
    device: int
    t0: float
    t1: float
    clock: str = WALL
    attrs: Dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class EventBus:
    """Thread-safe, process-local collector of spans and events.

    Two publishing styles:

    * ``begin(...) -> sid`` / ``end(sid)`` — live spans; an unmatched
      ``begin`` stays in the open set (``open_spans()``), an ``end``
      for an unknown sid raises (orphan ends are bugs, not data).
    * ``span(name, t0, t1, ...)`` — pre-timed spans, for publishers
      that already measured the interval (the executor's workers).

    ``point(name, value)`` records an :class:`Event`.  ``subscribe``
    registers a callback invoked with each closed span / event (the
    live dashboard polls instead, but external sinks can stream).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sid = itertools.count()
        self.reset_epoch()
        self._spans: List[Span] = []
        self._events: List[Event] = []
        self._open: Dict[int, Tuple[str, str, int, int, float, str, Dict]] = {}
        self._subscribers: List[Callable] = []

    # -- clocks ---------------------------------------------------------
    def reset_epoch(self) -> None:
        """Re-zero the wall clock (the start of a run)."""
        self._epoch = time.perf_counter()

    def wall(self) -> float:
        """Seconds since the bus epoch (the shared monotonic clock)."""
        return time.perf_counter() - self._epoch

    # -- publishing -----------------------------------------------------
    def begin(
        self,
        name: str,
        *,
        cat: str = "span",
        key: int = -1,
        device: int = -1,
        t: Optional[float] = None,
        clock: str = WALL,
        **attrs,
    ) -> int:
        if not _ENABLED[0]:
            return -1
        sid = next(self._sid)
        t0 = self.wall() if t is None else float(t)
        with self._lock:
            self._open[sid] = (name, cat, int(key), int(device), t0, clock, attrs)
        return sid

    def end(self, sid: int, t: Optional[float] = None, **attrs) -> Optional[Span]:
        if not _ENABLED[0]:
            return None
        if sid < 0:  # begin() was called while disabled
            return None
        with self._lock:
            if sid not in self._open:
                raise KeyError(f"end() for unknown span id {sid} (orphan end)")
            name, cat, key, device, t0, clock, a0 = self._open.pop(sid)
        t1 = self.wall() if t is None else float(t)
        sp = Span(sid, name, cat, key, device, t0, t1, clock, {**a0, **attrs})
        self._record_span(sp)
        return sp

    def span(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        cat: str = "span",
        key: int = -1,
        device: int = -1,
        clock: str = WALL,
        **attrs,
    ) -> Optional[Span]:
        """Record a pre-timed span in one call."""
        if not _ENABLED[0]:
            return None
        sp = Span(
            next(self._sid), name, cat, int(key), int(device),
            float(t0), float(t1), clock, attrs,
        )
        self._record_span(sp)
        return sp

    def point(
        self,
        name: str,
        value: Optional[float] = None,
        *,
        t: Optional[float] = None,
        clock: str = WALL,
        **attrs,
    ) -> None:
        """Record a point sample (numeric ones feed counter tracks)."""
        if not _ENABLED[0]:
            return
        ev = Event(
            name,
            self.wall() if t is None else float(t),
            clock,
            None if value is None else float(value),
            attrs,
        )
        with self._lock:
            self._events.append(ev)
            subs = list(self._subscribers)
        for fn in subs:
            fn(ev)

    def _record_span(self, sp: Span) -> None:
        with self._lock:
            self._spans.append(sp)
            subs = list(self._subscribers)
        for fn in subs:
            fn(sp)

    # -- reading --------------------------------------------------------
    def spans(self, cat: Optional[str] = None, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if cat is not None:
            out = [s for s in out if s.cat == cat]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def events(self, name: Optional[str] = None) -> List[Event]:
        with self._lock:
            out = list(self._events)
        if name is not None:
            out = [e for e in out if e.name == name]
        return out

    def open_spans(self) -> List[int]:
        """Span ids begun but not ended (must be empty after a clean run)."""
        with self._lock:
            return sorted(self._open)

    def counter_tracks(self) -> Dict[str, List[Tuple[float, float]]]:
        """Numeric event samples grouped by name, time-sorted —
        the counter-track view the trace exporter and dashboard render."""
        tracks: Dict[str, List[Tuple[float, float]]] = {}
        for e in self.events():
            if e.value is not None:
                tracks.setdefault(e.name, []).append((e.t, e.value))
        for v in tracks.values():
            v.sort(key=lambda p: p[0])
        return tracks

    def subscribe(self, fn: Callable) -> Callable:
        """Stream closed spans / events to ``fn``; returns an unsubscribe."""
        with self._lock:
            self._subscribers.append(fn)

        def _unsub() -> None:
            with self._lock:
                if fn in self._subscribers:
                    self._subscribers.remove(fn)

        return _unsub

    def clear(self) -> None:
        """Drop all recorded telemetry and re-zero the epoch."""
        with self._lock:
            self._spans.clear()
            self._events.clear()
            self._open.clear()
        self.reset_epoch()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans) + len(self._events)


# ----------------------------------------------------------------------
# The process-local bus and the zero-overhead switch
# ----------------------------------------------------------------------
BUS = EventBus()
_ENABLED = [True]  # single-cell so instrumented code sees flips instantly


def get_bus() -> EventBus:
    return BUS


def enabled() -> bool:
    """Whether telemetry is being recorded (guard for larger blocks)."""
    return _ENABLED[0]


def enable() -> None:
    _ENABLED[0] = True


def disable() -> None:
    """Zero-overhead mode: every publish becomes an immediate return.

    Numeric results are unaffected by construction — publishers never
    read the bus back into computation.
    """
    _ENABLED[0] = False


__all__ = [
    "BUS",
    "CLOCKS",
    "Event",
    "EventBus",
    "Span",
    "VIRTUAL",
    "WALL",
    "disable",
    "enable",
    "enabled",
    "get_bus",
]
