"""Sharding hooks for model code (port of ``repro.distributed.constraints``).

Model code calls ``shard_over_dp(x)`` / ``constrain(x, ...)`` at the tensors
where the reference pins a sharding (MoE dispatch, post-embedding
activations).  Without an installed mesh the hooks return ``x`` itself, as
the reference's do: that is every run on one card, and the CPU tests.

A mesh (``set_active_mesh`` / ``active_mesh``) is accepted and kept, but
the port has no sharding rules yet (ROADMAP item 10c: ``distributed/
sharding.py`` and ``launch/mesh.py`` over ``torch.distributed``), so
``constrain`` raises ``NotImplementedError`` under one instead of quietly
leaving the tensor unsharded.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence, Union

import torch

Axis = Union[None, str, Sequence[str]]

_STATE = threading.local()


def set_active_mesh(mesh: Optional[Any]) -> None:
    _STATE.mesh = mesh


def get_active_mesh() -> Optional[Any]:
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def active_mesh(mesh: Any):
    prev = get_active_mesh()
    set_active_mesh(mesh)
    try:
        yield mesh
    finally:
        set_active_mesh(prev)


def constrain(x: torch.Tensor, *spec: Axis) -> torch.Tensor:
    """``x`` itself without a mesh; raises under one (ROADMAP item 10c)."""
    mesh = get_active_mesh()
    if mesh is None:
        return x
    raise NotImplementedError(
        f"constrain{spec}: a mesh is installed ({mesh!r}), but the port has no "
        "sharding rules yet (ROADMAP item 10c: distributed/sharding and "
        "launch/mesh over torch.distributed)"
    )


def shard_over_dp(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Pin ``dim`` to the data-parallel axes (pod+data)."""
    spec: list = [None] * x.ndim
    spec[dim] = ("pod", "data")
    return constrain(x, *spec)


def shard_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    spec: list = [None] * x.ndim
    spec[dim] = "model"
    return constrain(x, *spec)
