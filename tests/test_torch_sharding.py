"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's: the twin of ``tests/test_sharding.py`` (each of its four
tests over the ten archs), spec parity, and the DTensor placements against
``NamedSharding.devices_indices_map`` on forged meshes of 8 devices.

Specs are compared as tuples, exactly.  The placements are compared slice
for slice: for each mesh coordinate, the slice of the global tensor that
DTensor gives the rank there (``_compute_local_shape_and_global_offset``)
against the slice JAX gives the device there.  JAX forges its 8 CPU
devices in a subprocess (the flag must precede its first call, as
``tests/test_dryrun.py`` does); the port's side needs no process group
(``placements`` reads a mesh's axis names and sizes only).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

from repro.configs import ARCHS as R_ARCHS
from repro.distributed import sharding as rsh
from repro.models import SHAPES as R_SHAPES
from repro.models import cell_is_runnable as r_cell_is_runnable
from repro.models import decode_input_specs as r_decode_input_specs
from repro.models import param_specs as r_param_specs
from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding as sh
from repro_torch.models import SHAPES, cell_is_runnable, decode_input_specs, param_specs
from repro_torch.models.common import tree_items
from repro_torch.models.model import batch_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}
PRODUCTION_AXES = (("data", "model"), ("pod", "data", "model"))


class FakeMesh:
    """The reference test's stand-in: axis names and sizes only."""

    def __init__(self, axes, sizes=AXIS_SIZES):
        self.axis_names = tuple(axes)
        self.shape = {a: sizes[a] for a in axes}


def _spec_leaves(tree, prefix=()):
    return [(path, spec) for path, spec in _walk(tree, prefix)]


def _walk(tree, prefix):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _check_divisible(specs, shapes, where):
    for path, arr in shapes:
        spec = specs[path]
        dims = list(spec) + [None] * (len(arr.shape) - len(spec))
        for i, ax in enumerate(dims):
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else ax
            total = int(np.prod([AXIS_SIZES[a] for a in axes]))
            assert arr.shape[i] % total == 0, (where, path, i, arr.shape[i], axes)


# ----------------------------------------------------------------------
# twins of tests/test_sharding.py
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_divisible(name):
    cfg = ARCHS[name]
    shapes = param_specs(cfg)
    specs = dict(_spec_leaves(sh.param_pspecs(cfg, shapes)))
    leaves = tree_items(shapes)
    assert sorted(specs) == sorted(path for path, _ in leaves)
    _check_divisible(specs, leaves, name)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_and_batch_specs_divisible(name):
    cfg = ARCHS[name]
    for axes in PRODUCTION_AXES:
        mesh = FakeMesh(axes)
        for shape in SHAPES:
            if not cell_is_runnable(cfg, shape):
                continue
            bs = batch_specs(cfg, shape)
            bp = sh.batch_pspecs(cfg, shape, mesh)
            _check_divisible({(k,): bp[k] for k in bs}, [((k,), v) for k, v in bs.items()],
                             f"{name}/{shape.name}/batch")
            if shape.kind == "decode":
                cache = decode_input_specs(cfg, shape)["cache"]
                cp = sh.cache_pspecs(cfg, shape, mesh, cache)
                _check_divisible({(k,): v for k, v in cp.items()},
                                 [((k,), v) for k, v in cache.items()],
                                 f"{name}/{shape.name}/cache")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_padded_heads_divide_tp(name):
    cfg = ARCHS[name]
    assert cfg.padded_n_heads % 16 == 0 or cfg.padded_n_heads == cfg.n_heads
    assert cfg.padded_n_heads % cfg.n_kv_heads == 0
    assert cfg.padded_vocab() % 16 == 0


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_skip_matrix_documented(name):
    runnable = [s.name for s in SHAPES if cell_is_runnable(ARCHS[name], s)]
    assert runnable == [s.name for s in R_SHAPES if r_cell_is_runnable(R_ARCHS[name], s)]
    assert len(runnable) == (4 if ARCHS[name].subquadratic else 3)
    total = sum(cell_is_runnable(c, s) for c in ARCHS.values() for s in SHAPES)
    assert total == 32  # 40 cells − 8 documented long_500k skips
    assert sorted(n for n, c in ARCHS.items() if c.subquadratic) == ["rwkv6-1.6b",
                                                                     "zamba2-2.7b"]


# ----------------------------------------------------------------------
# parity with the reference's specs
# ----------------------------------------------------------------------
def _ref_leaves(tree):
    import jax

    return {tuple(str(getattr(p, "key", p)) for p in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, rsh.P))}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_pspecs_match_reference(name):
    rcfg = R_ARCHS[name]
    want = _ref_leaves(rsh.param_pspecs(rcfg, r_param_specs(rcfg)))
    got = dict(_spec_leaves(sh.param_pspecs(ARCHS[name], param_specs(ARCHS[name]))))
    assert sorted(got) == sorted(want)
    for path, spec in want.items():
        assert tuple(got[path]) == tuple(spec), (path, got[path], spec)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_batch_and_cache_pspecs_match_reference(name):
    cfg, rcfg = ARCHS[name], R_ARCHS[name]
    for axes in PRODUCTION_AXES:
        mesh = FakeMesh(axes)
        assert sh.dp_axes(mesh) == rsh.dp_axes(mesh)
        assert tuple(sh.activation_pspec(mesh)) == tuple(rsh.activation_pspec(mesh))
        for shape, rshape in zip(SHAPES, R_SHAPES):
            if not cell_is_runnable(cfg, shape):
                continue
            got = sh.batch_pspecs(cfg, shape, mesh)
            want = rsh.batch_pspecs(rcfg, rshape, mesh)
            assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
            if shape.kind == "decode":
                got = sh.cache_pspecs(cfg, shape, mesh, decode_input_specs(cfg, shape)["cache"])
                want = rsh.cache_pspecs(rcfg, rshape, mesh,
                                        r_decode_input_specs(rcfg, rshape)["cache"])
                assert {k: tuple(v) for k, v in got.items()} == {
                    k: tuple(v) for k, v in want.items()}, (name, shape.name, axes)


# ----------------------------------------------------------------------
# DTensor placements against JAX's device index map
# ----------------------------------------------------------------------
FORGED = (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")))

_JAX_SIDE = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.load(sys.stdin)
out = []
for shape, axes, spec, gshape in cases:
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), tuple(axes))
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    m = NamedSharding(mesh, spec).devices_indices_map(tuple(gshape))
    out.append({str(d.id): [[s.start or 0, gshape[i] if s.stop is None else s.stop]
                            for i, s in enumerate(idx)] for d, idx in m.items()})
print(json.dumps(out))
"""


def _cases():
    """(mesh shape, axis names, spec, global shape) of every parameter leaf
    of every arch at full width, and of every batch and decode cache."""
    cases = []
    for shape, axes in FORGED:
        mesh = FakeMesh(axes, dict(zip(axes, shape)))
        for name in sorted(ARCHS):
            cfg = ARCHS[name]
            shapes = dict(tree_items(param_specs(cfg)))
            for path, spec in _spec_leaves(sh.param_pspecs(cfg, param_specs(cfg))):
                cases.append((shape, axes, spec, tuple(shapes[path].shape)))
            for cell in SHAPES:
                if not cell_is_runnable(cfg, cell):
                    continue
                bs = batch_specs(cfg, cell)
                for k, spec in sh.batch_pspecs(cfg, cell, mesh).items():
                    cases.append((shape, axes, spec, tuple(bs[k].shape)))
                if cell.kind == "decode":
                    cache = decode_input_specs(cfg, cell)["cache"]
                    for k, spec in sh.cache_pspecs(cfg, cell, mesh, cache).items():
                        cases.append((shape, axes, spec, tuple(cache[k].shape)))
    return cases


def test_placements_match_devices_indices_map():
    cases = _cases()
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    payload = json.dumps([[list(s), list(a), [list(e) if isinstance(e, tuple) else e
                                              for e in spec], list(g)]
                          for s, a, spec, g in cases])
    out = subprocess.run([sys.executable, "-c", _JAX_SIDE], input=payload, capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(want) == len(cases)
    for (shape, axes, spec, gshape), w in zip(cases, want):
        mesh = FakeMesh(axes, dict(zip(axes, shape)))
        place = sh.placements(spec, mesh)
        for dev in range(int(np.prod(shape))):
            coord = [int(c) for c in np.unravel_index(dev, shape)]
            local, offset = _compute_local_shape_and_global_offset(
                torch.Size(gshape), shape, coord, place)
            got = [[o, o + n] for o, n in zip(offset, local)]
            assert got == w[str(dev)], (shape, axes, spec, gshape, dev, got, w[str(dev)])


def test_placements_of_tuple_axes_and_errors():
    mesh = FakeMesh(("pod", "data", "model"), {"pod": 2, "data": 4, "model": 2})
    from torch.distributed.tensor import Replicate, Shard

    assert sh.placements(sh.P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements(sh.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        sh.placements(sh.P("expert"), mesh)
    with pytest.raises(ValueError, match="used twice"):
        sh.placements(sh.P("model", "model"), mesh)
    one = FakeMesh(("data", "model"), {"data": 1, "model": 4})
    assert sh.placements(sh.P("data", "model"), one) == (Replicate(), Shard(1))
