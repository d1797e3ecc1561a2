"""From a profiled window to device times: busy union, copies, kernels, gaps.

The window runs under ``torch.profiler`` with the benchmark's own
``record_function`` ranges around its calls; the profiler's chrome trace is
read back here.  Device activity is every kernel, memcpy and memset event,
on any stream; busy time is the union of their intervals, so work that
overlaps on two streams counts once.  Idle time is split by what the
host was doing in it, from a sampler of the Python threads' stacks (the
innermost frame inside the measured package), since the program has no
ranges of its own.
"""
from __future__ import annotations

import collections
import json
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
COPY_CATS = ("gpu_memcpy", "gpu_memset")
WINDOW_RANGE = "bench.window"

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The disjoint, sorted union of ``intervals``."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def gaps(busy: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The idle intervals of [lo, hi] between the disjoint ``busy`` ones."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


class HostSampler:
    """Samples every Python thread's stack at a fixed period (seconds).

    Each sample is ``(perf_counter, labels)``: per thread, the innermost
    frame whose file lies under ``package_dir``, as ``path:function``
    relative to it, marked ``(wait)`` when the thread is blocked in
    ``threading``.  Threads outside the package are left out.
    """

    def __init__(self, package_dir: Path, period: float = 0.005) -> None:
        self.root = str(package_dir.resolve()) + "/"
        self.period = period
        self.samples: List[Tuple[float, Tuple[str, ...]]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="bench-sampler", daemon=True)

    def _label(self, frame) -> Optional[str]:
        inner = frame
        while frame is not None:
            path = frame.f_code.co_filename
            if path.startswith(self.root):
                where = f"{path[len(self.root):]}:{frame.f_code.co_name}"
                if inner.f_code.co_filename.endswith("threading.py"):
                    where += " (wait)"
                return where
            frame = frame.f_back
        return None

    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.period):
            now = time.perf_counter()
            labels = tuple(
                lab
                for tid, fr in sys._current_frames().items()
                if tid != me and (lab := self._label(fr)) is not None
            )
            self.samples.append((now, labels))

    def __enter__(self) -> "HostSampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            raise RuntimeError("host sampler did not stop")

    def attribute(self, idle: Sequence[Interval]) -> Dict[str, float]:
        """Split the idle seconds of ``idle`` (disjoint, sorted, perf_counter)
        over what the host was doing: each sample inside an idle interval
        counts for the busy threads' labels (the waiting ones' when all
        wait), shared equally, and the counts are scaled to the idle
        seconds.  With no sample in the idle time, all of it is ``host``."""
        total = sum(b - a for a, b in idle)
        weights: Dict[str, float] = collections.defaultdict(float)
        i = 0
        for t, labels in self.samples:
            while i < len(idle) and idle[i][1] < t:
                i += 1
            if i == len(idle):
                break
            if t < idle[i][0] or not labels:
                continue
            busy = [lab for lab in labels if not lab.endswith("(wait)")] or list(labels)
            for lab in busy:
                weights[lab] += 1.0 / len(busy)
        n = sum(weights.values())
        if n == 0:
            return {"host": total} if total > 0 else {}
        return {lab: total * w / n for lab, w in weights.items()}


@dataclass
class DeviceTrace:
    """Device times of the traced window, in seconds; ``idle_gaps`` holds
    the idle seconds by what the host was doing in them."""

    window_s: float
    busy_s: float
    kernel_s: float
    copy_s: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def read_chrome_trace(path: Path, window_start_pc: float,
                      sampler: Optional[HostSampler], top: int = 10) -> DeviceTrace:
    """Reduce a chrome trace to the window's device times.

    The window is the ``bench.window`` range; its start in the trace's
    clock is matched to ``window_start_pc`` (perf_counter, taken on
    entering the range) to place the host samples.
    """
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in spans if e.get("name") == WINDOW_RANGE and e.get("cat") == "user_annotation"]
    if len(marks) != 1:
        raise RuntimeError(f"expected one {WINDOW_RANGE} range in the trace, found {len(marks)}")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
    per_cat: Dict[str, List[Interval]] = collections.defaultdict(list)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        a = float(e["ts"])
        b = a + float(e["dur"])
        for a2, b2 in clip([(a, b)], lo, hi):
            per_cat[e["cat"]].append((a2, b2))
            by_name[e["name"]] += (b2 - a2) * 1e-6
    busy = union([iv for ivs in per_cat.values() for iv in ivs])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    kernel_s = sum(b - a for a, b in per_cat["kernel"]) * 1e-6
    copy_s = sum(b - a for c in COPY_CATS for a, b in per_cat[c]) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = [(window_start_pc + (a - lo) * 1e-6, window_start_pc + (b - lo) * 1e-6)
            for a, b in gaps(busy, lo, hi)]
    shares = sampler.attribute(idle) if sampler is not None else {}
    named = sorted(shares.items(), key=lambda kv: -kv[1])[:top]
    return DeviceTrace(
        window_s=(hi - lo) * 1e-6, busy_s=busy_s, kernel_s=kernel_s, copy_s=copy_s,
        device_ops=ops, idle_gaps=named,
    )
