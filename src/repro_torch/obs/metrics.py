"""Counter / gauge / histogram registry with Prometheus + JSON exporters.

The scheduler-efficiency numbers the repo cares about (dispatch latency,
ready latency, coalesced-batch width, buddy-allocator fragmentation,
resident bytes vs budget, queue depth, per-tenant wait) used to live in
ad-hoc report dicts that only existed after a run finished.  The
registry makes them live instruments: instrumented code updates them as
it goes, the dashboard and exporters read consistent snapshots at any
point.

Three instrument kinds (the Prometheus trio, stdlib-only):

* :class:`Counter` — monotone accumulator (``inc``); per-label children
  via ``labels(tenant=3)``.
* :class:`Gauge` — last-value instrument (``set``); with ``track=True``
  it also keeps a bounded ``(t, value)`` series for sparklines and
  perfetto counter tracks.
* :class:`Histogram` — fixed-bucket distribution (``observe``) with
  cumulative bucket counts, sum and count (Prometheus semantics, so
  mean = sum/count and quantiles are bucket-resolved).

``snapshot()`` returns a JSON-safe dict; ``prometheus()`` renders the
text exposition format (``# HELP`` / ``# TYPE`` lines included) that the
dashboard serves at ``/metrics``.

All mutation honors the global :func:`repro_torch.obs.disable` switch, so a
disabled process records nothing anywhere.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from .events import BUS, _ENABLED

# Latency-flavored default buckets (seconds): 100µs .. 100s, log-spaced.
DEFAULT_BUCKETS = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0,
)


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    """Shared name/help/unit plumbing; subclasses add semantics."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", unit: str = "") -> None:
        self.name = name
        self.help = help
        self.unit = unit
        self._lock = threading.Lock()

    def header(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = "", unit: str = "") -> None:
        super().__init__(name, help, unit)
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {(): 0.0}

    def inc(self, v: float = 1.0, **labels) -> None:
        if not _ENABLED[0]:
            return
        if v < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(v)

    @property
    def value(self) -> float:
        """The unlabeled series (plus nothing else)."""
        return self._values.get((), 0.0)

    def value_of(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def to_dict(self) -> Dict:
        with self._lock:
            series = {
                _fmt_labels(k) or "total": v for k, v in self._values.items()
            }
        return {"kind": self.kind, "unit": self.unit, "values": series}

    def prometheus(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return self.header() + [
            f"{self.name}{_fmt_labels(k)} {v:g}" for k, v in items
        ]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(
        self,
        name: str,
        help: str = "",
        unit: str = "",
        track: bool = False,
        maxlen: int = 4096,
    ) -> None:
        super().__init__(name, help, unit)
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self.series: Optional[deque] = deque(maxlen=maxlen) if track else None

    def set(self, v: float, t: Optional[float] = None, **labels) -> None:
        if not _ENABLED[0]:
            return
        key = _label_key(labels)
        with self._lock:
            self._values[key] = float(v)
            if self.series is not None and not labels:
                self.series.append(
                    (BUS.wall() if t is None else float(t), float(v))
                )

    def add(self, dv: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            cur = self._values.get(key, 0.0)
        self.set(cur + float(dv), **labels)

    @property
    def value(self) -> float:
        return self._values.get((), 0.0)

    def value_of(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def track(self) -> List[Tuple[float, float]]:
        """The recorded (t, value) series (empty unless track=True)."""
        return list(self.series or ())

    def to_dict(self) -> Dict:
        with self._lock:
            series = {
                _fmt_labels(k) or "value": v for k, v in self._values.items()
            }
        return {"kind": self.kind, "unit": self.unit, "values": series}

    def prometheus(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return self.header() + [
            f"{self.name}{_fmt_labels(k)} {v:g}" for k, v in items
        ]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        unit: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> None:
        super().__init__(name, help, unit)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +inf bucket
        self.sum = 0.0
        self.count = 0
        self._children: Dict[Tuple[Tuple[str, str], ...], "Histogram"] = {}

    def observe(self, v: float, **labels) -> None:
        """Record ``v`` in the aggregate; with labels, also in the
        per-label child distribution (Prometheus-style children, so
        per-tenant quantiles are first-class: ``h.child(tenant=3)``)."""
        if not _ENABLED[0]:
            return
        v = float(v)
        if math.isnan(v):
            return
        if labels:
            key = _label_key(labels)
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = Histogram(
                        self.name, self.help, self.unit, self.buckets
                    )
                    self._children[key] = child
            child.observe(v)
        with self._lock:
            self.sum += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def child(self, **labels) -> Optional["Histogram"]:
        """The per-label child distribution, or None if never observed."""
        return self._children.get(_label_key(labels))

    def children(self) -> Dict[str, "Histogram"]:
        """Rendered-label → child histogram (for tables/exporters)."""
        return {_fmt_labels(k): h for k, h in sorted(self._children.items())}

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-resolved quantile (upper bound of the q-th bucket)."""
        if not self.count:
            return 0.0
        target = q * self.count
        acc = 0
        for i, b in enumerate(self.buckets):
            acc += self.counts[i]
            if acc >= target:
                return b
        return math.inf

    def to_dict(self) -> Dict:
        with self._lock:
            return {
                "kind": self.kind,
                "unit": self.unit,
                "count": self.count,
                "sum": self.sum,
                "mean": self.mean(),
                "p50": self.quantile(0.5),
                "p99": self.quantile(0.99),
                "buckets": {
                    ("+inf" if i == len(self.buckets) else f"{self.buckets[i]:g}"): c
                    for i, c in enumerate(self.counts)
                },
                **(
                    {
                        "children": {
                            _fmt_labels(k): {
                                "count": h.count,
                                "mean": h.mean(),
                                "p50": h.quantile(0.5),
                                "p99": h.quantile(0.99),
                            }
                            for k, h in sorted(self._children.items())
                        }
                    }
                    if self._children
                    else {}
                ),
            }

    def prometheus(self) -> List[str]:
        with self._lock:
            lines = self.header()
            acc = 0
            for i, b in enumerate(self.buckets):
                acc += self.counts[i]
                lines.append(f'{self.name}_bucket{{le="{b:g}"}} {acc}')
            acc += self.counts[-1]
            lines.append(f'{self.name}_bucket{{le="+Inf"}} {acc}')
            lines.append(f"{self.name}_sum {self.sum:g}")
            lines.append(f"{self.name}_count {self.count}")
            children = sorted(self._children.items())
        for key, child in children:
            labels = _fmt_labels(key)[1:-1]  # strip the braces, re-merge
            lines.append(f"{self.name}_sum{{{labels}}} {child.sum:g}")
            lines.append(f"{self.name}_count{{{labels}}} {child.count}")
        return lines


class Registry:
    """Name-keyed instrument store; get-or-create, kind-checked."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, *args, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        return self._get(Counter, name, help, unit)

    def gauge(
        self, name: str, help: str = "", unit: str = "", track: bool = False
    ) -> Gauge:
        g = self._get(Gauge, name, help, unit)
        if track and g.series is None:
            g.series = deque(maxlen=4096)
        return g

    def histogram(
        self,
        name: str,
        help: str = "",
        unit: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get(Histogram, name, help, unit, buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # -- exporters ------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        """JSON-safe snapshot of every instrument (the artifact format
        the bench-gate uploads)."""
        return {n: self._metrics[n].to_dict() for n in self.names()}

    def prometheus(self) -> str:
        """Prometheus text exposition format (served at ``/metrics``)."""
        lines: List[str] = []
        for n in self.names():
            lines.extend(self._metrics[n].prometheus())
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


REGISTRY = Registry()


def get_registry() -> Registry:
    return REGISTRY


__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "REGISTRY",
    "Registry",
    "get_registry",
]
