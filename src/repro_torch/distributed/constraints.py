"""Sharding hooks for model code (port of ``repro.distributed.constraints``).

Model code calls ``shard_over_dp(x)`` / ``constrain(x, ...)`` at the tensors
where the reference pins a sharding (MoE dispatch, post-embedding
activations).  Without an installed mesh the hooks return ``x`` itself, as
the reference's do: that is every run on one device, and most CPU tests.

Under a mesh (``active_mesh(mesh)``, a named ``DeviceMesh``) ``constrain``
does what ``with_sharding_constraint`` does in the reference: the spec's
axes the mesh lacks are dropped, and so is an axis whose size does not
divide the tensor dim; the tensor, a DTensor, is then redistributed to the
spec's placements (:func:`repro_torch.distributed.sharding.placements`).
A plain tensor under a mesh is an error.

Where DTensor has no sharding strategy for an op that the reference leaves
to XLA's propagation (or a wrong or slow one), :func:`on_shards` runs a
function on each rank's shards over declared placements (``local_map``):
attention, the loss's gather, MoE dispatch, gather and combine, the GLA
and SSD scans, the causal conv.  :func:`pad_end` and :func:`zeros_like`
make DTensors from local tensors where DTensor's own rule fails in some
torch releases.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

Axis = Union[None, str, Sequence[str]]

class _State:
    """The installed mesh.  Process-wide, not per thread: autograd runs a
    CUDA backward (and the recompute of a checkpointed layer) on its own
    device thread, which must see the mesh the forward ran under."""

    mesh: Optional[Any] = None


_STATE = _State()


def set_active_mesh(mesh: Optional[Any]) -> None:
    _STATE.mesh = mesh


def get_active_mesh() -> Optional[Any]:
    return _STATE.mesh


@contextlib.contextmanager
def active_mesh(mesh: Any):
    """Install ``mesh`` for the block.  Under a mesh, plain tensors that
    meet DTensors in an op (positions, masks, fresh accumulators: what the
    reference's traced program holds as constants) count as replicated
    (``implicit_replication``), as XLA replicates a constant."""
    prev = get_active_mesh()
    set_active_mesh(mesh)
    try:
        if mesh is None:
            yield mesh
        else:
            with implicit_replication():
                yield mesh
    finally:
        set_active_mesh(prev)


def _filter_axis(axis: Axis, names) -> Axis:
    if axis is None:
        return None
    if isinstance(axis, str):
        return axis if axis in names else None
    present = tuple(a for a in axis if a in names)
    return present if present else None


def _caller() -> str:
    """The first function outside this module on the stack."""
    f = sys._getframe(1)
    while f is not None and f.f_globals.get("__name__") == __name__:
        f = f.f_back
    return "?" if f is None else f"{f.f_globals.get('__name__')}.{f.f_code.co_name}"


def _need_dtensor(x, mesh) -> None:
    if not isinstance(x, DTensor):
        raise TypeError(
            f"{_caller()}: a mesh is installed ({mesh!r}), but the tensor of shape "
            f"{tuple(x.shape)} is a plain tensor; under a mesh the model's tensors are "
            "DTensors (place the parameters and the batch with distribute_tensor)")


def constrain(x: torch.Tensor, *spec: Axis) -> torch.Tensor:
    """``x`` itself without a mesh; under one, ``x`` (a DTensor)
    redistributed to ``spec`` where the dims divide."""
    mesh = get_active_mesh()
    if mesh is None:
        return x
    _need_dtensor(x, mesh)
    from .sharding import P, axis_sizes, dp_flat, placements

    sizes = axis_sizes(mesh)
    dims = []
    for i, ax in enumerate(spec):
        if ax is not None:
            ax = dp_flat((ax,) if isinstance(ax, str) else tuple(ax), tuple(sizes))
        ax = _filter_axis(ax, sizes)
        if ax is not None:
            total = 1
            for a in (ax,) if isinstance(ax, str) else ax:
                total *= sizes[a]
            if x.shape[i] % total != 0 or x.shape[i] < total:
                ax = None
        dims.append(ax)
    place = placements(P(*dims), mesh)
    # where x is already so placed, x itself: no autograd node (a no-op
    # redistribute still adds one, and reorders the gradient's sums)
    return x if tuple(x.placements) == place else x.redistribute(mesh, place)


def on_shards(fn: Callable, args: Sequence, dims: Sequence, out_dims: Sequence):
    """``fn(*args)`` on each rank's shards (``local_map``), for a function
    whose batch rows and heads (or positions) are independent.  ``dims[i]``
    is (the dim of ``args[i]`` held on the DP axes, the dim held on
    "model"), None where it has none; a None arg passes through.  Without a
    mesh, ``fn`` itself.  Under one each arg (a DTensor) is so held where
    the axes divide the sizes (read from the first arg that has each dim)
    and replicated elsewhere, and ``fn``'s outputs, one per ``out_dims``
    entry, are placed the same way."""
    mesh = get_active_mesh()
    if mesh is None:
        return fn(*args)
    from .sharding import axis_sizes, dp_axes

    sizes = axis_sizes(mesh)
    b = next((a.shape[d[0]] for a, d in zip(args, dims) if a is not None and d[0] is not None), 0)
    h = next((a.shape[d[1]] for a, d in zip(args, dims) if a is not None and d[1] is not None), 0)
    dp = [a for a in dp_axes(mesh) if sizes[a] > 1]
    dp_total = 1
    for a in dp:
        dp_total *= sizes[a]
    on_dp = b >= dp_total and b % dp_total == 0
    on_tp = sizes.get("model", 1) > 1 and h >= sizes["model"] and h % sizes["model"] == 0

    def place(bd, hd, grad=False):
        """An arg's placements; with ``grad``, its gradient's: an arg with no
        batch (or head) dim meets every rank's rows (or heads), so its
        gradient is a partial sum over the axis that splits them."""
        out = []
        for a in mesh.mesh_dim_names:
            if a in dp and on_dp:
                out.append(Shard(bd) if bd is not None else Partial() if grad else Replicate())
            elif a == "model" and on_tp:
                out.append(Shard(hd) if hd is not None else Partial() if grad else Replicate())
            else:
                out.append(Replicate())
        return tuple(out)

    ins = []
    for a, d in zip(args, dims):
        if a is not None:
            _need_dtensor(a, mesh)
            if tuple(a.placements) != place(*d):
                a = a.redistribute(mesh, place(*d))
        ins.append(a)
    outs = tuple(place(*d) for d in out_dims)
    return local_map(fn, out_placements=outs if len(outs) > 1 else list(outs[0]),
                     in_placements=tuple(None if a is None else place(*d)
                                         for a, d in zip(ins, dims)),
                     in_grad_placements=tuple(None if a is None else place(*d, grad=True)
                                              for a, d in zip(ins, dims)),
                     device_mesh=mesh)(*ins)


def pad_end(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with ``n`` zero slots appended on ``dim`` (``F.pad``).  A
    DTensor is padded on each rank's shard, ``dim`` first gathered if it is
    split (DTensor's ``constant_pad_nd`` rule fails in some torch
    releases)."""
    pad = [0, 0] * (x.ndim - 1 - dim) + [0, n]
    if not isinstance(x, DTensor):
        return torch.nn.functional.pad(x, pad)
    place = tuple(Replicate() if p == Shard(dim) else p for p in x.placements)
    x = x.redistribute(x.device_mesh, place)
    shape = list(x.shape)
    shape[dim] += n
    return DTensor.from_local(torch.nn.functional.pad(x.to_local(), pad), x.device_mesh, place,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def zeros_like(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Zeros of ``x``'s shape (a DTensor's: its placements), in ``dtype``."""
    if not isinstance(x, DTensor):
        return torch.zeros_like(x, dtype=dtype)
    return DTensor.from_local(torch.zeros_like(x.to_local(), dtype=dtype), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape, stride=x.stride())


def mesh_axis_size(name: str) -> int:
    """The size of axis ``name`` of the installed mesh (1 without a mesh or
    without the axis)."""
    mesh = get_active_mesh()
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def shard_over_dp(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Pin ``dim`` to the data-parallel axes (pod+data)."""
    spec: list = [None] * x.ndim
    spec[dim] = ("pod", "data")
    return constrain(x, *spec)


def shard_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    spec: list = [None] * x.ndim
    spec[dim] = "model"
    return constrain(x, *spec)
