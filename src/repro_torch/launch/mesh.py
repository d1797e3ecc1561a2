"""Production meshes (port of ``repro.launch.mesh``) over
``torch.distributed``.

Defined as functions (never module-level constants) so importing this
module never touches process-group state: the launchers, the dry run and
the tests create (or find) the default group first.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The 16×16 ``("data", "model")`` mesh, or 2×16×16 ``("pod", "data",
    "model")`` with ``multi_pod``, over the default group, which must have
    256 or 512 ranks to match."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise RuntimeError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a default process group "
            f"of {need} ranks (torchrun --nnodes ... so that the world size is {need}); "
            f"the default group has {have if have is not None else 'not been created'}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def _one_rank_group(device: torch.device) -> None:
    """A one-rank default group (NCCL for CUDA, gloo for the CPU) on a
    ``HashStore``: no address, port or environment is needed."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            device_id=device if device.type == "cuda" else None)


def make_smoke_mesh(device) -> DeviceMesh:
    """A 1×1 ``("data", "model")`` mesh over ``device``.  Without a default
    group it first makes a one-rank one (see :func:`smoke_mesh` for one
    that is destroyed again)."""
    device = torch.device(device)
    if not dist.is_initialized():
        _one_rank_group(device)
    if dist.get_world_size() != 1:
        raise RuntimeError(
            f"make_smoke_mesh: the default group has {dist.get_world_size()} ranks; "
            "a 1x1 mesh needs a one-rank world")
    return init_device_mesh(device.type, (1, 1), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def smoke_mesh(device) -> Iterator[DeviceMesh]:
    """:func:`make_smoke_mesh` for the block; the one-rank group it makes
    is destroyed after it (a group found already made is kept)."""
    made = not dist.is_initialized()
    try:
        yield make_smoke_mesh(device)
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def model_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The mesh the model runs on: a (pod, data, model) mesh as its 2-D
    (dp, model) view, pod and data flattened into one ``dp`` dim (pod
    major: the slices of the ("pod", "data") tuple axis; the pod axis
    carries only DP); any other mesh as it is.  DTensor's strategy search
    grows with the mesh's rank, and on three dims it did not finish one
    attention op of a toy model in 20 CPU-minutes."""
    names = mesh.mesh_dim_names or ()
    if "pod" not in names:
        return mesh
    mesh["pod", "data"]._flatten("dp")
    return mesh["dp", "model"]


def mesh_devices(mesh) -> int:
    """The number of devices of a mesh."""
    return math.prod(mesh.shape)


def parse_mesh(text: Optional[str]) -> Optional[Tuple[int, ...]]:
    """A launcher's ``--mesh`` ("2x2", "2x1x2") as a shape; None for None."""
    return None if not text else tuple(int(n) for n in text.lower().split("x"))


@contextlib.contextmanager
def launcher_mesh(multi_pod: bool, device, shape: Optional[Sequence[int]] = None
                  ) -> Iterator[Tuple[DeviceMesh, torch.device, Tuple[int, ...]]]:
    """The mesh a launcher runs on for the block, as ``(mesh, device,
    shape)``: the model's view of it (:func:`model_mesh`), this rank's
    device and the mesh's shape.

    The default group is the one that exists; else, under ``torchrun``
    (``WORLD_SIZE`` > 1), the one its environment describes, on the card
    ``LOCAL_RANK``; else a one-rank group.  A group made here is destroyed
    after the block.  The mesh is the production one, 16×16 (2×16×16 with
    ``multi_pod``), on a world of 256 (512) ranks, and the 1×1 mesh on one
    rank; ``shape`` (a launcher's ``--mesh``, a cut of the production
    mesh with as many dims) names another whose size is the world's.
    ``--multi-pod`` outside a 512-rank world raises, as does a shape that
    does not fit the world; before any group is made."""
    full, names = PRODUCTION_SHAPES[multi_pod]
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if shape is None:
        if multi_pod and world != math.prod(full):
            raise RuntimeError(
                f"--multi-pod needs the 2x16x16 mesh: a default group of 512 ranks (e.g. "
                f"torchrun --nnodes 64 --nproc-per-node 8), or --mesh with 3 dims; this "
                f"world has {world}")
        shape = full if world == math.prod(full) else (1, 1) if world == 1 else None
        if shape is None:
            raise RuntimeError(f"a launcher runs on 1 or 256 ranks (512 with --multi-pod), or "
                               f"on a --mesh of the world's size; this world has {world}")
    shape = tuple(shape)
    if len(shape) != len(full) or math.prod(shape) != world:
        raise RuntimeError(
            f"--mesh {'x'.join(map(str, shape))}: a cut of the {'x'.join(map(str, full))} "
            f"mesh needs {len(full)} dims whose product is the world's {world} ranks")
    device = torch.device(device)
    made = not dist.is_initialized()
    if made and world > 1:  # started by torchrun: the group of its environment
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    elif made:
        _one_rank_group(device)
    elif device.type == "cuda" and world > 1:  # a group of ranks: this rank's card
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        mesh = init_device_mesh(device.type, shape, mesh_dim_names=names)
        yield model_mesh(mesh), device, shape
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
