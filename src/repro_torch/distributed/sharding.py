"""Named-sharding rules: parameter / batch / cache specs, and their DTensor
placements (port of ``repro.distributed.sharding``).

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod.  The pod axis only ever carries data parallelism (a front/task
never spans pods — the paper's 𝓡 constraint mapped to the boundary between
hosts), so DP axes are ``("pod", "data")`` when the pod axis exists.

Parameter rules are path-based over the leaf names of the model trees;
stacked per-layer tensors get a leading None for the layer axis
automatically (specs are right-aligned to the tensor rank).

Decode-cache policy:
  * kv_heads ≥ TP degree  → shard cache heads on "model"
  * kv_heads < TP degree  → shard cache *sequence* on "model"
    (flash-decoding style: the partial softmax is combined across ranks)

A spec is a :class:`PartitionSpec`: a tuple with one entry per tensor dim
(trailing dims may be left out), each ``None``, an axis name or a tuple of
axis names.  :func:`placements` turns it into a DTensor placement per mesh
dim; :func:`named` does so over a tree.  A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, or any object
with ``axis_names`` and a ``shape`` mapping (the rules read nothing else).
A mesh may hold the DP axes flattened into one ``dp`` dim (the model's view
of a (pod, data, model) mesh): a spec's pod and data axes then name it.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any, Dict, Mapping, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard

if TYPE_CHECKING:  # the rules read a config's fields only; importing the
    # models here would load the model zoo with every executor import
    from repro_torch.models.config import ModelConfig, ShapeCell

PyTree = Any


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of names (a
    tuple of one name is that name, as JAX's ``PartitionSpec`` keeps it)."""

    def __new__(cls, *dims):
        return super().__new__(cls, (d[0] if isinstance(d, tuple) and len(d) == 1 else d
                                     for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# leaf-name → spec of the *trailing* dims (right-aligned; leading dims None)
_COL = ("wq", "wk", "wv", "w_gate", "w_up", "shared_gate", "shared_up",
        "cm_k", "w_r", "w_k", "w_v", "w_g", "w_z", "w_x")
_ROW = ("wo", "w_down", "shared_down", "cm_v", "w_o", "w_out")
_REP2 = ("router", "w_b", "w_c", "w_dt", "w_lora_a", "w_lora_b",
         "frontend_proj", "conv_w", "cm_r")
_BIAS_COL = ("bq", "bk", "bv", "b_up")


def _leaf_spec(path: Tuple[str, ...], ndim: int, moe_sharding: str = "tp") -> P:
    name = path[-1]
    in_moe = "moe" in path
    if name == "embed":
        tail = ("model", None)
    elif name == "lm_head":
        tail = (None, "model")
    elif in_moe and name in ("w_gate", "w_up", "w_down") and moe_sharding == "ep":
        tail = ("model", None, None)  # (E, D, F): expert parallelism
    elif in_moe and name in ("w_gate", "w_up"):
        tail = (None, None, "model")  # (E, D, F): TP on the expert hidden
    elif in_moe and name == "w_down":
        tail = (None, "model", None)
    elif name in _COL:
        tail = (None, "model")
    elif name in _ROW:
        tail = ("model", None)
    elif name in _REP2:
        tail = tuple(None for _ in range(min(ndim, 2)))
    elif name in _BIAS_COL:
        tail = ("model",)
    else:  # norms, scalars, small vectors: replicated
        tail = ()
    tail = tail[:ndim]
    return P(*([None] * (ndim - len(tail)) + list(tail)))


def _map_leaves(tree: Mapping, fn, path: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """Nested dicts of ``fn(path, leaf)`` over a nested mapping."""
    return {k: _map_leaves(v, fn, path + (k,)) if isinstance(v, Mapping) else fn(path + (k,), v)
            for k, v in tree.items()}


def param_pspecs(cfg: ModelConfig, params_shape: Mapping) -> Dict[str, Any]:
    """Spec tree (nested dicts) matching a parameter tree: a ``ParamTree``,
    ``param_specs(cfg)`` or its ``to_dict()``."""
    return _map_leaves(params_shape,
                       lambda path, leaf: _leaf_spec(path, leaf.ndim, cfg.moe_sharding))


# ----------------------------------------------------------------------
def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a mesh-like object."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


DP_FLAT = "dp"  # a mesh dim holding the DP axes ("pod", "data") flattened, pod major


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data", DP_FLAT) if a in axis_names(mesh))


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def _batch_axis(shape: ShapeCell, mesh) -> Optional[Tuple[str, ...]]:
    b, dp = shape.global_batch, _dp_size(mesh)
    return dp_axes(mesh) if b % max(dp, 1) == 0 and b >= dp else None


def batch_pspecs(cfg: ModelConfig, shape: ShapeCell, mesh) -> Dict[str, P]:
    bspec = _batch_axis(shape, mesh)
    specs = {"tokens": P(bspec, None)}
    if cfg.family == "vlm":
        specs["patches"] = P(bspec, None, None)
    if cfg.family == "audio":
        specs["frames"] = P(bspec, None, None)
    return specs


def cache_pspecs(cfg: ModelConfig, shape: ShapeCell, mesh, cache_shapes: Mapping[str, Any]
                 ) -> Dict[str, P]:
    """Specs for the decode cache (see the module docstring's policy)."""
    bspec = _batch_axis(shape, mesh)
    tp = axis_sizes(mesh).get("model", 1)
    heads_shard = cfg.n_kv_heads % tp == 0 and cfg.n_kv_heads >= tp

    out: Dict[str, P] = {}
    for name, leaf in cache_shapes.items():
        nd = leaf.ndim
        if name in ("k", "v", "xk", "xv", "ak", "av"):
            # (L|G, B, S, Hkv, Dh)
            if heads_shard:
                out[name] = P(None, bspec, None, "model", None)
            else:
                out[name] = P(None, bspec, "model", None, None)
        elif name == "s" and nd == 5:  # (L, B, H, dk, dv)
            h = leaf.shape[2]
            hspec = "model" if h % tp == 0 else None
            out[name] = P(None, bspec, hspec, None, None)
        elif name in ("tm_last", "cm_last"):  # (L, B, D)
            out[name] = P(None, bspec, "model")
        elif name == "conv":  # (L, B, K-1, C)
            c = leaf.shape[-1]
            out[name] = P(None, bspec, None, "model" if c % tp == 0 else None)
        else:  # pos, src_len scalars
            out[name] = P()
    return out


# ----------------------------------------------------------------------
def placements(spec: Sequence, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` if the dim's name stands at tensor dim ``d`` of the spec,
    else ``Replicate()``.  A tuple entry such as ``("pod", "data")`` shards
    one tensor dim over several mesh dims, the first named the major one
    (JAX's order); they must come in the mesh's order, which is the order
    in which DTensor splits a dim held by several mesh dims.  A mesh dim of
    size 1 holds the whole dim, which is ``Replicate()`` (the same slices;
    DTensor's view rules refuse some reshapes of a dim "sharded" one way)."""
    names = axis_names(mesh)
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = dp_flat(() if entry is None else (entry,) if isinstance(entry, str)
                       else tuple(entry), names)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: axis {a!r} is not in the mesh {names}")
            if a in where:
                raise ValueError(f"spec {spec}: axis {a!r} is used twice")
            where[a] = d
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
    sizes = axis_sizes(mesh)
    return tuple(Shard(where[a]) if a in where and sizes[a] > 1 else Replicate()
                 for a in names)


def dp_flat(axes: Tuple[str, ...], names: Sequence[str]) -> Tuple[str, ...]:
    """``axes`` on a mesh whose DP axes are flattened into one ``dp`` dim
    (:func:`repro_torch.launch.mesh.model_mesh`): the pod and data axes
    become that dim; on any other mesh, ``axes`` as they are."""
    if DP_FLAT not in names or not any(a in ("pod", "data") for a in axes):
        return axes
    return (DP_FLAT,) + tuple(a for a in axes if a not in ("pod", "data"))


def named(mesh, tree_of_pspecs: PyTree) -> PyTree:
    """The same tree with each spec replaced by its placements."""
    if isinstance(tree_of_pspecs, PartitionSpec):
        return placements(tree_of_pspecs, mesh)
    return {k: named(mesh, v) for k, v in tree_of_pspecs.items()}


def activation_pspec(mesh) -> P:
    """(B, T, D) activations: batch over DP axes, D replicated."""
    return P(dp_axes(mesh), None, None)


def local_shard(t, mesh, place):
    """This rank's shard of ``t`` (the whole tensor) under ``place``: a
    view of ``t`` (DTensor's split: chunks of ceil(size / n), mesh dims in
    order)."""
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    shape, offset = _compute_local_shape_and_global_offset(t.shape, mesh.shape,
                                                           mesh.get_coordinate(), place)
    for d, (o, n) in enumerate(zip(offset, shape)):
        t = t.narrow(d, o, n)
    return t


def from_whole(t, mesh, place, device=None):
    """``t``, the same values on every rank, as a DTensor with placements
    ``place``: each rank cuts its own shard and moves only that to
    ``device`` (``t``'s own by default).  No collective; where the shard is
    the whole tensor on its device (a mesh of one device), no copy either."""
    from torch.distributed.tensor import DTensor

    local = local_shard(t.detach(), mesh, place).to(device or t.device).contiguous()
    return DTensor.from_local(local, mesh, place, run_check=False, shape=t.shape,
                              stride=t.new_empty(t.shape, device="meta").stride())


def place_tensor(t, spec, mesh, device=None):
    """:func:`from_whole` with the placements of ``spec``."""
    return from_whole(t, mesh, placements(spec, mesh), device)


def distribute(tree: Mapping, spec_tree: Mapping, mesh, device=None) -> Dict[str, Any]:
    """Nested dicts of DTensors: each tensor of ``tree`` placed on ``mesh``
    by its spec in ``spec_tree`` (:func:`place_tensor`: every rank passes
    the same tree, from one seed, and keeps its own shards on ``device``).
    A tree built on the host goes to the card shard by shard, so no rank
    ever holds a whole parameter there."""
    return {k: distribute(v, spec_tree[k], mesh, device) if isinstance(v, Mapping)
            else place_tensor(v, spec_tree[k], mesh, device) for k, v in tree.items()}


def to_spec(x, spec, mesh):
    """``x`` placed by ``spec`` on ``mesh``: a DTensor redistributed, a
    plain tensor (the same on every rank) placed by :func:`place_tensor`."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements(spec, mesh))
    return place_tensor(x, spec, mesh)
