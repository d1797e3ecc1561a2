"""Workload frontend: model computation graphs → malleable task trees.

graph   Op / OpGraph IR, series contraction, tree-ification
costs   per-platform Calibration, task lengths, activation footprints
zoo     builders (moe_dispatch / pipeline / serving_pod / sparse_solver)
        and the ``analyze`` dispatch front door

Submodules load lazily (PEP 562): importing :mod:`repro_torch.workloads` is
cheap, and nothing here is imported by the sparse path at all — the
model zoo only loads when a workload is actually built.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

_GRAPH = frozenset({"Op", "OpGraph", "Treeified", "treeify"})
_COSTS = frozenset(
    {
        "CALIBRATIONS",
        "Calibration",
        "calibration_for",
        "effective_alpha",
        "hlo_flop_scale",
        "task_footprints",
        "task_lengths",
    }
)
_ZOO = frozenset(
    {
        "Workload",
        "analyze",
        "default_workload",
        "moe_dispatch",
        "pipeline",
        "serving_pod",
        "sparse_solver",
    }
)

__all__ = sorted(_GRAPH | _COSTS | _ZOO)

if TYPE_CHECKING:  # pragma: no cover - static analysis only
    from .costs import (  # noqa: F401
        CALIBRATIONS,
        Calibration,
        calibration_for,
        effective_alpha,
        hlo_flop_scale,
        task_footprints,
        task_lengths,
    )
    from .graph import Op, OpGraph, Treeified, treeify  # noqa: F401
    from .zoo import (  # noqa: F401
        Workload,
        analyze,
        default_workload,
        moe_dispatch,
        pipeline,
        serving_pod,
        sparse_solver,
    )


def __getattr__(name: str):
    if name in _GRAPH:
        from repro_torch.workloads import graph as _m
    elif name in _COSTS:
        from repro_torch.workloads import costs as _m
    elif name in _ZOO:
        from repro_torch.workloads import zoo as _m
    else:
        raise AttributeError(f"module 'repro_torch.workloads' has no attribute {name!r}")
    return getattr(_m, name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
