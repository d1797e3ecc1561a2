"""Paper-grounded scheduler-efficiency metrics.

The paper's §4 describes a schedule entirely by its instantaneous
allocation profile — each task's share of p(t) — and Theorem 6 gives the
fluid PM makespan as a *lower bound* no schedule can beat.  This module
derives the quantitative health of any run from exactly those objects:

* :func:`fold_share_timeline` / :func:`measured_share_timeline` — the
  measured per-front share timeline p̂(t), folded from telemetry spans
  (or schedule entries): at every instant, how many processors the run
  actually engaged.
* :func:`fluid_ratio` — makespan / Theorem-6 fluid bound (≥ 1; equal to
  1 within numerical noise on the zero-noise single-tree case, because
  the online PM loop *is* the fluid optimum there).
* :func:`l2_share_deviation` — the L2 distance between p̂(t) and the
  fluid PM profile p*(t) (full capacity until the fluid makespan),
  normalized so 0.0 means "indistinguishable from the optimum" and the
  number is comparable across problem sizes.
* :func:`alpha_residuals` — per shape-bucket residuals of the p^α model
  against measured dispatch throughput (the §3 regression, bucketed),
  so a drifting α shows up per front class rather than as one global
  average.
* :func:`device_utilization` — per-device busy fraction and overall
  occupancy from device-lane spans.

Everything is pure (lists in, dicts out) so the same functions serve the
live dashboard, the static HTML report, and the bench gate.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .events import Span

Steps = List[Tuple[float, float]]  # (t, value) step function, right-open


# ----------------------------------------------------------------------
# Share timelines: p̂(t)
# ----------------------------------------------------------------------
def fold_share_timeline(
    intervals: Iterable[Tuple[float, float, float]],
) -> Steps:
    """Fold ``(t0, t1, share)`` intervals into the total-share step
    function Σ shares(t).

    Returns ``[(t, total), ...]`` with a closing ``(t_end, 0.0)`` step —
    the same shape as ``Schedule.memory_profile()`` steps.
    """
    deltas: Dict[float, float] = {}
    for t0, t1, s in intervals:
        if t1 <= t0 or s == 0:
            continue
        deltas[t0] = deltas.get(t0, 0.0) + float(s)
        deltas[t1] = deltas.get(t1, 0.0) - float(s)
    steps: Steps = []
    acc = 0.0
    for t in sorted(deltas):
        acc += deltas[t]
        steps.append((t, max(acc, 0.0)))
    return steps


def measured_share_timeline(spans: Sequence[Span]) -> Steps:
    """p̂(t) from telemetry: fold the ``run`` spans' engaged devices.

    Fronts sharing one dispatch each carved their own group, so summing
    per-span ``devices_used`` counts every engaged device once.
    """
    return fold_share_timeline(
        (s.t0, s.t1, float(s.attrs.get("devices_used", 1)))
        for s in spans
        if s.name == "run"
    )


def schedule_share_timeline(schedule) -> Steps:
    """p̂(t) from a :class:`~repro_torch.api.schedule.Schedule`'s entries."""
    return fold_share_timeline(
        (e.start, e.end, e.share) for e in schedule.entries
    )


def _value_at(steps: Steps, t: float) -> float:
    v = 0.0
    for ts, val in steps:
        if ts > t:
            break
        v = val
    return v


# ----------------------------------------------------------------------
# Theorem-6 comparisons
# ----------------------------------------------------------------------
def fluid_ratio(makespan, fluid_makespan: Optional[float] = None) -> float:
    """Makespan over the Theorem-6 fluid PM bound (≥ 1.0; 1.0 = optimal).

    Accepts either two floats or a single object exposing ``makespan``
    and ``fluid_makespan`` (a :class:`~repro_torch.api.schedule.Schedule` or
    :class:`~repro_torch.api.schedule.RunReport`).
    """
    if fluid_makespan is None:
        obj = makespan
        makespan, fluid_makespan = obj.makespan, obj.fluid_makespan
    if fluid_makespan <= 0:
        return math.inf if makespan > 0 else 1.0
    return float(makespan) / float(fluid_makespan)


def pm_reference_timeline(capacity: float, fluid_makespan: float) -> Steps:
    """p*(t): the fluid PM optimum engages the whole capacity until the
    Theorem-6 makespan, then nothing (conservation — Lemma 4 keeps the
    allocation exactly at p(t) while work remains)."""
    return [(0.0, float(capacity)), (float(fluid_makespan), 0.0)]


def l2_share_deviation(
    measured: Steps,
    reference: Steps,
    *,
    normalize: bool = True,
) -> float:
    """L2 distance between two share step functions.

    ``sqrt(∫ (p̂ − p*)² dt)``, normalized (default) by
    ``sqrt(∫ p*² dt)`` so 0.0 means identical and 1.0 means "as far from
    the optimum as the optimum is from zero" — comparable across
    problem scales and time units.
    """
    if not measured and not reference:
        return 0.0
    grid = sorted(
        {t for t, _ in measured} | {t for t, _ in reference}
    )
    if len(grid) < 2:
        return 0.0
    num = 0.0
    den = 0.0
    for a, b in zip(grid, grid[1:]):
        dt = b - a
        m = _value_at(measured, a)
        r = _value_at(reference, a)
        num += (m - r) ** 2 * dt
        den += r**2 * dt
    if not normalize:
        return math.sqrt(num)
    return math.sqrt(num / den) if den > 0 else math.sqrt(num)


def schedule_l2_deviation(schedule) -> float:
    """L2 deviation of a schedule's p̂(t) from its own fluid optimum."""
    return l2_share_deviation(
        schedule_share_timeline(schedule),
        pm_reference_timeline(schedule.capacity, schedule.fluid_makespan),
    )


# ----------------------------------------------------------------------
# Empirical-α residuals per shape bucket (§3's regression, bucketed)
# ----------------------------------------------------------------------
def alpha_residuals(
    points: Iterable[Tuple[object, int, float]], alpha: float
) -> Dict[object, Dict[str, float]]:
    """Residuals of the p^α throughput model per bucket.

    ``points`` are ``(bucket, engaged_devices, flops_per_second)``
    samples (one per dispatch).  Within each bucket the model says
    ``log rate = const + α·log devices``; the per-bucket intercept is
    fitted and the residual statistics of the measured points around it
    returned, plus a per-bucket α fit when the bucket saw ≥ 2 distinct
    device counts.  Large |mean| or rms flags a front class whose
    scaling deviates from the planner's α.
    """
    by_bucket: Dict[object, List[Tuple[int, float]]] = {}
    for bucket, g, r in points:
        if g >= 1 and r > 0:
            by_bucket.setdefault(bucket, []).append((int(g), float(r)))
    out: Dict[object, Dict[str, float]] = {}
    for bucket, pts in by_bucket.items():
        lg = np.log([g for g, _ in pts])
        lr = np.log([r for _, r in pts])
        resid = lr - alpha * lg
        resid -= resid.mean()  # per-bucket intercept
        stats = {
            "n": float(len(pts)),
            "mean_abs": float(np.abs(resid).mean()),
            "rms": float(np.sqrt((resid**2).mean())),
        }
        if len({g for g, _ in pts}) >= 2:
            stats["alpha_fit"] = float(np.polyfit(lg, lr, 1)[0])
        out[bucket] = stats
    return out


def execution_alpha_residuals(report, symb) -> Dict[str, Dict[str, float]]:
    """Per shape-bucket α residuals of an executed run.

    Buckets are the padded ``(mp, nbp)`` shape classes of
    ``repro_torch.kernels.ops.padded_shape`` — the unit at which dispatches
    batch, so each bucket's samples share a kernel signature.
    """
    from repro_torch.kernels.ops import padded_shape

    by_interval: Dict[Tuple[float, float], List] = {}
    for e in report.trace:
        by_interval.setdefault((e.t_start, e.t_end), []).append(e)
    pts = []
    for (t0, t1), evs in by_interval.items():
        if t1 - t0 <= 1e-9:
            continue
        sn = symb.supernodes[evs[0].front]
        mp, nbp = padded_shape(sn.m, sn.nb)
        pts.append(
            (
                f"{mp}x{nbp}",
                evs[0].dispatch_devices,
                sum(e.flops for e in evs) / (t1 - t0),
            )
        )
    return alpha_residuals(pts, report.plan_alpha)


# ----------------------------------------------------------------------
# Device utilization / occupancy
# ----------------------------------------------------------------------
def device_utilization(
    spans: Sequence[Span],
    n_devices: int,
    horizon: Optional[float] = None,
) -> Dict[str, object]:
    """Busy fraction per device lane and overall occupancy.

    A ``run`` span occupies lanes ``[device, device + devices_used)``
    for its duration; overlapping dispatch intervals on one lane are
    merged before integrating (batched fronts share an interval).
    Returns ``{"per_device": [...], "occupancy": float, "horizon": t}``
    where occupancy is mean engaged-lanes over capacity — the measured
    counterpart of the online scheduler's utilization integral.

    The window is the spans' own, since the bus clock does not start at a
    run's start: from the earliest ``run`` span's start to the latest one's
    end, or, given ``horizon``, the ``horizon`` seconds that end at the
    latest end (a run's makespan picks out the newest run of a bus that
    holds several).  Busy time is counted inside the window.
    """
    runs = [s for s in spans if s.name == "run"]
    t_hi = max((s.t1 for s in runs), default=0.0)
    if horizon is None:
        horizon = t_hi - min((s.t0 for s in runs), default=0.0)
    t_lo = t_hi - horizon
    lanes: List[List[Tuple[float, float]]] = [[] for _ in range(n_devices)]
    for s in runs:
        if s.t1 <= t_lo:
            continue
        d0 = max(int(s.device), 0)
        width = max(int(s.attrs.get("devices_used", 1)), 1)
        for lane in range(d0, min(d0 + width, n_devices)):
            lanes[lane].append((max(s.t0, t_lo), s.t1))
    per_device: List[float] = []
    for ivs in lanes:
        busy = 0.0
        end = -math.inf
        for t0, t1 in sorted(ivs):
            if t1 <= end:
                continue
            busy += t1 - max(t0, end)
            end = t1
        per_device.append(busy / horizon if horizon > 0 else 0.0)
    occupancy = float(np.mean(per_device)) if per_device else 0.0
    return {
        "per_device": per_device,
        "occupancy": occupancy,
        "horizon": float(horizon),
    }


# ----------------------------------------------------------------------
# One-call summary
# ----------------------------------------------------------------------
def efficiency_summary(report, problem=None) -> Dict[str, float]:
    """The efficiency block of a :class:`~repro_torch.api.schedule.RunReport`.

    Always includes ``fluid_ratio``; adds ``l2_share_deviation`` when
    the realized schedule has share entries, and utilization when the
    report recorded it.  All values are JSON-safe floats.
    """
    out: Dict[str, float] = {"fluid_ratio": fluid_ratio(report)}
    sched = getattr(report, "schedule", None)
    if sched is not None and getattr(sched, "entries", None):
        out["l2_share_deviation"] = schedule_l2_deviation(sched)
    util = getattr(report, "metrics", {}).get("utilization")
    if util is not None:
        out["utilization"] = float(util)
    return out


__all__ = [
    "alpha_residuals",
    "device_utilization",
    "efficiency_summary",
    "execution_alpha_residuals",
    "fluid_ratio",
    "fold_share_timeline",
    "l2_share_deviation",
    "measured_share_timeline",
    "pm_reference_timeline",
    "schedule_l2_deviation",
    "schedule_share_timeline",
]
