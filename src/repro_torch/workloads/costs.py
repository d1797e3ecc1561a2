"""Platform-calibrated costs: op DAG → task lengths, footprints, α.

The zoo builders annotate ops with platform-independent counts (flops,
HBM bytes, weight bytes, activation bytes).  A :class:`Calibration`
turns them into what the scheduling stack consumes:

* **task lengths** — per-task roofline seconds
  ``max(flops / flop_rate, bytes / mem_bw)``;
* **per-platform α** — the malleable-speedup exponent measured for the
  platform family (the paper's calibrated range is 0.85–0.95 on its
  shared-memory machine; accelerator meshes batch better and sit at the
  top of the range, oversubscribed CPU hosts at the bottom);
* **memory footprints** — the per-request *activation* residency in the
  multifrontal three-phase model (:class:`~repro_torch.core.memory.Footprints`):
  the working set is front-resident while the task runs and the output
  activation is the contribution block handed to the parent.  Weights
  are platform-resident, not per-request — their total is reported in
  the workload meta instead of the admission footprint.

``hlo_flop_scale`` is the reference's measured corrective (it compiles the
reduced model in JAX and walks its HLO); the port has no flop counter
over its models yet, so it raises (ROADMAP queue 1 items 10 and 11) and only
``estimator="analytic"`` is offered.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.memory import Footprints

from .graph import Treeified


@dataclass(frozen=True)
class Calibration:
    """One platform family's cost parameters."""

    name: str
    alpha: float  # malleable speedup exponent p^α
    flop_rate: float  # flops/s at share 1.0
    mem_bw: float  # HBM bytes/s at share 1.0

    def __post_init__(self) -> None:
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")
        if self.flop_rate <= 0 or self.mem_bw <= 0:
            raise ValueError("rates must be positive")

    def seconds(self, flops: float, nbytes: float) -> float:
        """Roofline time of one task at share 1."""
        return max(flops / self.flop_rate, nbytes / self.mem_bw)


# One entry per platform family.  ``h100``: ``flop_rate`` is the dense bf16
# ``torch.matmul`` rate at 8192³ (1.3777 ms for 2·8192³ operations) and
# ``mem_bw`` the HBM bandwidth of a 1 GiB device-to-device copy (0.7118 ms
# for the bytes read plus written), medians of 7 CUDA-event timings by
# ``chip_smoke.py`` phase 10 (d) on an "NVIDIA H100 80GB HBM3, 700.00 W"
# card; the script fails when either drifts past 1.5x.  Its α is the
# reference's accelerator-family value, not measured on the card.  The CPU
# rows are the reference's conservative host.
CALIBRATIONS: Dict[str, Calibration] = {
    "cpu": Calibration("cpu", alpha=0.85, flop_rate=5e10, mem_bw=2.5e10),
    "h100": Calibration("h100", alpha=0.95, flop_rate=7.980e14, mem_bw=3.017e12),
    # a forged / host-backed mesh: accelerator-style batching (high α)
    # at host execution rates
    "host-mesh": Calibration("host-mesh", alpha=0.9, flop_rate=1e11, mem_bw=5e10),
}


def calibration_for(platform=None) -> Calibration:
    """Pick the calibration matching a :class:`~repro_torch.api.platform.Platform`.

    DeviceMesh whose first device is a CUDA device → ``h100``; DeviceMesh
    over CPU lanes (or with no device to take: ``DeviceMesh()`` on a host
    without CUDA) → ``host-mesh``; shared-memory and multicore platforms
    → ``cpu``.  A :class:`~repro_torch.api.platform.MixedCluster`
    resolves to its *fastest* node's calibration — lengths are then
    expressed on the fast node and the per-node α of the slow node
    lives on the platform (``node_alphas``), where the ``hetero-mixed``
    policy reads it.
    """
    if platform is None:
        return CALIBRATIONS["cpu"]
    if isinstance(platform, Calibration):
        return platform
    # duck-typed to avoid importing repro_torch.api at module import time
    kind = getattr(platform, "name", "")
    if kind == "mixed":
        cals = [calibration_for(sub) for sub in platform.subplatforms()]
        return max(cals, key=lambda c: c.flop_rate)
    if kind == "mesh":
        try:
            devs = platform.devices()
        except RuntimeError:  # DeviceMesh() without a CUDA device
            devs = []
        if devs and getattr(devs[0], "type", "cpu") == "cuda":
            return CALIBRATIONS["h100"]
        return CALIBRATIONS["host-mesh"]
    return CALIBRATIONS["cpu"]


def task_lengths(tf: Treeified, cal: Calibration) -> np.ndarray:
    """Per-task roofline seconds under ``cal`` (virtual roots stay 0)."""
    flops = tf.flops / cal.flop_rate
    membound = tf.bytes / cal.mem_bw
    return np.maximum(flops, membound)


def task_footprints(tf: Treeified, itemsize: int = 2) -> Footprints:
    """Per-request activation footprints in the three-phase model.

    ``front``  — resident while the task runs: its input activations
    (the children's handed-off outputs are accounted by *their* CB
    phase, so the front is the task's own working set: output + an
    equal-order scratch term);
    ``cb``     — the output activation handed to the parent;
    ``factor`` — zero: a serving request leaves nothing resident after
    its tree completes (weights are platform-resident, see module doc).
    """
    del itemsize  # byte counts are already materialized by the builders
    front = 2.0 * tf.out_bytes
    cb = tf.out_bytes.copy()
    factor = np.zeros_like(front)
    return Footprints(front, factor, cb)


def hlo_flop_scale(cfg, shape=None, attn_block: int = 64) -> float:
    """The reference's measured HLO/analytic flop ratio: not ported.

    The reference compiles the reduced config's prefill step in JAX and
    walks its optimized HLO; the port has the models (``repro_torch.models``)
    but no flop counter over them (ROADMAP queue 1 item 11) yet.
    """
    raise NotImplementedError(
        "hlo_flop_scale needs the port's models and a flop counter over them "
        "(ROADMAP queue 1 items 10 and 11); use estimator='analytic'"
    )


def mixed_calibrations(platform) -> Optional[Tuple[Calibration, ...]]:
    """Per-node calibrations of a mixed platform (None when uniform)."""
    if getattr(platform, "name", "") != "mixed":
        return None
    return tuple(calibration_for(sub) for sub in platform.subplatforms())


def effective_alpha(platform=None, alpha: Optional[float] = None) -> float:
    """The α a workload problem is built with: explicit wins, else the
    platform calibration's."""
    if alpha is not None:
        a = float(alpha)
        if not 0.0 < a <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {a}")
        return a
    return calibration_for(platform).alpha


def speed_ratio(a: Calibration, b: Calibration) -> float:
    """Relative work rate of ``a`` vs ``b`` (used for mixed node speeds:
    lengths are expressed on the primary node, the other node's speed is
    its flop-rate ratio)."""
    return a.flop_rate / b.flop_rate


def total_param_bytes(tf: Treeified) -> float:
    return float(tf.param_bytes.sum())


def bottleneck(tf: Treeified, cal: Calibration) -> str:
    """Whole-workload roofline verdict (mirrors the dry-run field)."""
    t_c = tf.flops.sum() / cal.flop_rate
    t_m = tf.bytes.sum() / cal.mem_bw
    return "t_compute" if t_c >= t_m else "t_memory"


__all__ = [
    "CALIBRATIONS",
    "Calibration",
    "bottleneck",
    "calibration_for",
    "effective_alpha",
    "hlo_flop_scale",
    "mixed_calibrations",
    "speed_ratio",
    "task_footprints",
    "task_lengths",
    "total_param_bytes",
]
