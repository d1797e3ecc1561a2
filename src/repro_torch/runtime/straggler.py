"""Straggler mitigation via the paper's *heterogeneous* scheduling (§6.2).

A straggling node is a node whose effective speed dropped: the platform
becomes heterogeneous.  Detection: per-node step-time history, robust
z-score against the fleet median.  Mitigation: recompute allocations
treating node speeds as processor counts — a node at relative speed σ
contributes σ·p effective processors, and the paper's two-node
heterogeneous machinery (Algorithm 12 / PM shares on Σσ_i·p) redistributes
the malleable tasks accordingly.  This is exactly the paper's perspective
§8: "more heterogeneous nodes, for which the value of α differs" — we keep
α global and fold slowdown into capacity.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.core.hetero import hetero_fptas
from repro_torch.online.events import SetNodeSpeed


@dataclass
class StragglerDetector:
    n_nodes: int
    window: int = 16
    threshold: float = 3.0  # robust z-score
    history: Dict[int, List[float]] = field(default_factory=dict)

    def record(self, node: int, step_time: float) -> None:
        h = self.history.setdefault(node, [])
        h.append(step_time)
        if len(h) > self.window:
            h.pop(0)

    def node_speeds(self) -> np.ndarray:
        """Relative speed per node (1.0 = fleet median)."""
        med_time = np.median(
            [np.median(h) for h in self.history.values() if h] or [1.0]
        )
        speeds = np.ones(self.n_nodes)
        for i, h in self.history.items():
            if h:
                speeds[i] = med_time / np.median(h)
        return speeds

    def stragglers(self) -> List[int]:
        times = {i: np.median(h) for i, h in self.history.items() if h}
        if len(times) < 2:
            return []
        vals = np.array(list(times.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-12
        return [
            i
            for i, v in times.items()
            if 0.6745 * (v - med) / mad > self.threshold
        ]


@dataclass
class StragglerInjector:
    """Bridge detector → online scheduler: straggler observations become
    SetNodeSpeed events in the discrete-event core, so mitigation is the
    same O(n) Lemma-4 re-share every other runtime event gets (instead of
    this module's ad-hoc two-pod rebalancing loop).

    ``emit(t)`` returns the speed edits newly implied by the detector's
    state at time ``t`` (only changes are emitted, so repeated polling is
    idempotent); ``inject(scheduler, t)`` pushes them into a scheduler.
    """

    detector: StragglerDetector
    tol: float = 0.05  # suppress sub-5% speed jitter
    _last: Dict[int, float] = field(default_factory=dict)

    def emit(self, t: float) -> List[Tuple[float, SetNodeSpeed]]:
        speeds = self.detector.node_speeds()
        out: List[Tuple[float, SetNodeSpeed]] = []
        for node in range(self.detector.n_nodes):
            s = float(min(speeds[node], 1.0))
            if abs(s - self._last.get(node, 1.0)) > self.tol:
                self._last[node] = s
                out.append((t, SetNodeSpeed(node, s)))
        return out

    def inject(self, scheduler, t: float) -> int:
        """Push the pending speed edits; returns how many were emitted."""
        evs = self.emit(t)
        for at, payload in evs:
            scheduler.inject(at, payload)
        return len(evs)


@dataclass(frozen=True)
class FrontDelays:
    """Deterministic per-front dispatch delays — the executor-side
    straggler injection.

    The detector above observes stragglers; this is how experiments
    *create* them: ``delays[front] = seconds`` stretches that front's
    kernel dispatch as if its device were slow, in both executor modes
    (the ``delay_fn`` contract of
    :class:`repro_torch.runtime.executor.PlanExecutor`).  Under the wave
    runner the whole wave stalls behind the barrier; under the async
    futures runner only the front's ancestors wait — which is exactly
    the A/B ``benchmarks.bench_async`` measures.
    """

    delays: Mapping[int, float]

    def __call__(self, front: int) -> float:
        return float(self.delays.get(int(front), 0.0))

    def total(self) -> float:
        return float(sum(self.delays.values()))

    @classmethod
    def random(
        cls,
        fronts: Sequence[int],
        n_stragglers: int,
        delay: float,
        seed: int = 0,
    ) -> "FrontDelays":
        """Pick ``n_stragglers`` distinct fronts uniformly and delay each
        by ``delay`` seconds (seeded, so A/B runs hit the same fronts)."""
        rng = np.random.default_rng(seed)
        picks = rng.choice(
            np.asarray(list(fronts)),
            size=min(n_stragglers, len(fronts)),
            replace=False,
        )
        return cls(delays={int(s): float(delay) for s in picks})


def rebalance_two_pods(
    task_lengths: Sequence[float],
    pod_devices: int,
    speeds: Sequence[float],
    alpha: float,
    lam: float = 1.05,
):
    """Repartition independent tasks over two pods with measured speeds
    (σ₀, σ₁): effective capacities p = σ₀·pod_devices, q = σ₁·pod_devices;
    Algorithm 12 gives a λ-approximate split."""
    p = speeds[0] * pod_devices
    q = speeds[1] * pod_devices
    return hetero_fptas(task_lengths, p, q, alpha, lam)
