"""Dry run of the production meshes (port of ``repro.launch.dryrun``).

For one (architecture × shape × mesh) cell, in one process: a fake process
group of 256 or 512 ranks (``torch.testing``'s ``fake`` backend) is made
the default group, the production mesh is built over it, and the cell's
step (train, prefill or decode) runs once under ``FakeTensorMode`` with the
parameters, the optimizer state, the batch and the cache as DTensors placed
by :mod:`repro_torch.distributed.sharding`.  Nothing is allocated: every
tensor is fake, every collective returns at once.  What the rank runs is
counted, and its live storages tracked, by :mod:`repro_torch.launch.hlocost`.

The train step is the reference's dry-run step: gradients accumulated over
the microbatches in f32, in the ZeRO-1 layout of :func:`_opt_pspecs` (the
moments and accumulators sharded also over the DP axes), the optimizer in
that layout, the parameters gathered back to their own placements.  One
microbatch runs, counted M times (the reference's trip count).  The step
runs twice, the first time uncounted: it fills DTensor's sharding cache,
whose misses run ops on global-shaped stand-ins (``lower_s`` holds both).

Keys kept from the reference: ``status``, ``chips``, ``kind``,
``microbatches``, ``lower_s`` (host seconds of the traced step), the
per-rank ``arg_bytes``, ``out_bytes`` and ``peak_bytes`` (the tracker's
peak over the step, arguments included), ``hlo_flops``, ``hlo_bytes``,
``collective_bytes``, ``collectives``, ``model_flops_chip``,
``model_hlo_ratio``, ``t_compute``, ``t_memory``, ``t_collective`` and
``bottleneck``; added: ``attention_bytes``.  Dropped, being XLA's or the
TPU's: ``compile_s``, ``temp_bytes`` and ``alias_bytes`` (XLA's buffer
assignment), ``bf16_legalization_bytes``, ``convert_bytes``,
``peak_bytes_tpu_est`` and ``t_memory_tpu`` (corrections of XLA:CPU's
legalisation for a TPU), ``xla_cost_flops_once`` (XLA's own cost
analysis) and ``unknown_trip_whiles`` (the port has no while loops).

On the 2×16×16 mesh the step runs on its (dp, model) view
(:func:`repro_torch.launch.mesh.model_mesh`): pod and data flattened into
one DP dim of 32, the same shards as the ("pod", "data") axes.

The fake group must be the default group, so a cell wants a process of its
own (the CLI, or a subprocess as the tests and ``chip_smoke.py`` run it):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun

Tensors are fake CUDA tensors on a CUDA mesh; ``--device cpu`` makes them
fake CPU tensors on a CPU mesh, for a machine without a card.  A
fake tensor cannot launch the flash kernel: attention in a prefill cell is
counted as ``blocked_attention``, the program the reference's dry run
lowers.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch.distributed.constraints import active_mesh, zeros_like
from repro_torch.distributed.sharding import (
    P,
    batch_pspecs,
    cache_pspecs,
    dp_axes,
    param_pspecs,
    placements,
    to_spec,
)
from repro_torch.launch.hlocost import attention_scan_bytes, count_costs, uncounted
from repro_torch.launch.mesh import make_production_mesh, mesh_devices, model_mesh
from repro_torch.launch.roofline import model_flops, terms
from repro_torch.models.common import ParamTree, tree_at, tree_from_items, tree_items
from repro_torch.models.config import SHAPES, cell_is_runnable, shape_by_name
from repro_torch.models.model import (
    batch_specs,
    build_decode_fn,
    build_loss_fn,
    build_prefill_fn,
    decode_input_specs,
    param_specs,
)
from repro_torch.train.optimizer import OptConfig, adamw_update
from repro_torch.train.train_step import _split

SKIP_REASON = "long_500k requires sub-quadratic attention (DESIGN.md)"


def _opt_pspecs(pspecs: Dict[str, Any], params_shape, mesh) -> Dict[str, Any]:
    """ZeRO-1: the moments sharded also over the DP axes, on the first
    replicated dim that the DP size divides."""
    dp = dp_axes(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp_total = math.prod(sizes[a] for a in dp)

    def z(spec, leaf):
        dims = list(spec) + [None] * (leaf.ndim - len(spec))
        for i, d in enumerate(dims):
            if d is None and leaf.shape[i] % dp_total == 0 and leaf.shape[i] >= dp_total:
                dims[i] = dp
                break
        return P(*dims)

    mom = tree_from_items((path, z(tree_at(pspecs, path), leaf))
                          for path, leaf in tree_items(params_shape))
    return {"mu": mom, "nu": mom, "step": P()}


def _fake(like: torch.Tensor, spec, mesh, device, dtype=None) -> DTensor:
    """A DTensor of ``like``'s global shape placed by ``spec``, each rank's
    shard an empty tensor (fake under ``FakeTensorMode``)."""
    place = placements(spec, mesh)
    local, _ = _compute_local_shape_and_global_offset(like.shape, mesh.shape,
                                                      mesh.get_coordinate(), place,
                                                      skip_offset=True)
    t = torch.empty(local, dtype=dtype or like.dtype, device=device)
    return DTensor.from_local(t, mesh, place, run_check=False, shape=like.shape,
                              stride=torch.empty(like.shape, device="meta").stride())


def _fake_tree(tree, specs, mesh, device, dtype=None) -> Dict[str, Any]:
    return tree_from_items((path, _fake(leaf, tree_at(specs, path), mesh, device, dtype))
                           for path, leaf in tree_items(tree))


def _leaves(*trees):
    """The tensors of trees (nested dicts) and of bare tensors."""
    for tree in trees:
        if isinstance(tree, torch.Tensor):
            yield tree
        else:
            yield from (t for _, t in tree_items(tree))


def _local_bytes(*trees) -> int:
    """Bytes of this rank's shards of the trees' tensors."""
    return sum(t.to_local().numel() * t.element_size() for t in _leaves(*trees))


def _redistribute(tree, specs, mesh) -> Dict[str, Any]:
    return tree_from_items((path, to_spec(t, tree_at(specs, path), mesh))
                           for path, t in tree_items(tree))


def default_microbatches(cfg, shape, mesh) -> int:
    """The reference's rule: one-row microbatches for large models."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    per_dp = shape.global_batch // math.prod(sizes[a] for a in dp_axes(mesh))
    big = cfg.n_params > 8e9
    return max(1, min(16 if big else 8, per_dp))


def _ensure_fake_group(world: int) -> None:
    """Make the fake group of ``world`` ranks the default group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"dry run: the default group is a {dist.get_backend()} group; the dry run "
                "makes a fake one and wants a process of its own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()  # the other mesh's fake group
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


class _HostArithmetic(TorchDispatchMode):
    """Runs the host's own index arithmetic for real under the fake mode:
    an ``arange`` on the CPU, and any op whose tensors are all real CPU
    tensors.  DTensor's sharding propagation computes shard offsets so
    (``tolist()`` of an ``arange``), which a fake tensor cannot give; the
    step's own tensors are all fake but for its CPU positions (an
    ``arange``: T integers)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ts = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if ts:
            host = all(not isinstance(t, FakeTensor) and t.device.type == "cpu" for t in ts)
        else:
            dev = kwargs.get("device")
            host = (func._overloadpacket is torch.ops.aten.arange
                    and (dev is None or torch.device(dev).type == "cpu"))
        if host:
            with unset_fake_temporarily(), uncounted():
                return func(*args, **kwargs)
        return func(*args, **kwargs)


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    microbatches: int = 0,
    attn_block: int = 512,
    donate: bool = True,
    device: str = "cuda",
) -> Dict[str, Any]:
    """One cell's JSON record (see the module docstring for the keys).
    The caches are placed by :func:`cache_pspecs`' policy; the reference's
    ``decode_cache_policy`` argument, which nothing reads there, is left
    out."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = configs.get(arch)
    shape = shape_by_name(shape_name)
    if not cell_is_runnable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": SKIP_REASON}
    _ensure_fake_group(512 if multi_pod else 256)
    dev = torch.device(device)
    full_mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    n_chips = mesh_devices(full_mesh)
    mesh = model_mesh(full_mesh)
    t0 = time.time()

    params_shape = param_specs(cfg, dtype=torch.bfloat16)
    pspecs = param_pspecs(cfg, params_shape)
    with FakeTensorMode(allow_non_fake_inputs=True), active_mesh(mesh):
        params = ParamTree(_fake_tree(params_shape, pspecs, mesh, dev))
        if shape.kind == "train":
            bspecs = batch_specs(cfg, shape)
            bps = batch_pspecs(cfg, shape, mesh)
            batch = {k: _fake(v, bps[k], mesh, dev) for k, v in bspecs.items()}
            ops = _opt_pspecs(pspecs, params_shape, mesh)
            opt = {"mu": _fake_tree(params_shape, ops["mu"], mesh, dev, torch.float32),
                   "nu": _fake_tree(params_shape, ops["nu"], mesh, dev, torch.float32),
                   "step": _fake(torch.empty((), dtype=torch.int32), P(), mesh, dev)}
            if microbatches == 0:
                microbatches = default_microbatches(cfg, shape, mesh)
            args = (params, opt, batch)
            step = _train_step(cfg, ops["mu"], pspecs, mesh, microbatches, attn_block, donate)
        elif shape.kind == "prefill":
            bspecs = batch_specs(cfg, shape)
            bps = batch_pspecs(cfg, shape, mesh)
            batch = {k: _fake(v, bps[k], mesh, dev) for k, v in bspecs.items()}
            args = (params, batch)
            step = _prefill_step(cfg, shape, mesh, attn_block)
        else:  # decode
            dspecs = decode_input_specs(cfg, shape)
            cps = cache_pspecs(cfg, shape, mesh, dspecs["cache"])
            cache = {k: _fake(v, cps[k], mesh, dev) for k, v in dspecs["cache"].items()}
            token = _fake(dspecs["token"], P(None, None), mesh, dev)
            args = (params, cache, token)
            step = _decode_step(cfg, cps, mesh)
        arg_bytes = _local_bytes(*args)
        # a warm-up run fills DTensor's sharding cache, so that the counted
        # run holds the rank's own ops only (see hlocost.CostCounter)
        with count_costs() as warm, _HostArithmetic(), uncounted():
            step(*args, counter=warm)
        with count_costs() as counter, _HostArithmetic():
            counter.track(*[t.to_local() for t in _leaves(*args)])
            out = step(*args, counter=counter)
        peak = counter.peak_bytes
        out_bytes = _local_bytes(*out[:-1] if shape.kind == "train" else out)
    t_lower = time.time() - t0

    summary = counter.summary
    flops, bytes_hbm = summary.flops, summary.bytes
    mf_chip = model_flops(cfg, shape) / n_chips
    result = {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "status": "ok",
        "chips": n_chips,
        "kind": shape.kind,
        "microbatches": microbatches if shape.kind == "train" else None,
        "lower_s": round(t_lower, 1),
        # memory (per rank, bytes)
        "arg_bytes": arg_bytes,
        "out_bytes": out_bytes,
        "peak_bytes": peak,
        # per-rank roofline inputs and terms (seconds)
        "hlo_flops": flops,
        "hlo_bytes": bytes_hbm,
        "attention_bytes": attention_scan_bytes(summary),
        "collective_bytes": summary.collective_total,
        "collectives": dict(summary.collective_bytes),
        "model_flops_chip": mf_chip,
        "model_hlo_ratio": mf_chip / flops if flops else 0.0,
        **terms(flops, bytes_hbm, summary.collective_total),
    }
    t = {k: result[k] for k in ("t_compute", "t_memory", "t_collective")}
    result["bottleneck"] = max(t, key=t.get)
    return result


def _train_step(cfg, grad_specs, pspecs, mesh, microbatches, attn_block, donate):
    loss_fn = build_loss_fn(cfg, remat=True, attn_block=attn_block)
    opt_cfg = OptConfig()

    def step(params, opt, batch, counter):
        items = tree_items(params)
        leaves = [p for _, p in items]
        for p in leaves:
            p.requires_grad_(True)
        # the ZeRO-sharded f32 accumulator
        acc = [zeros_like(p, torch.float32).redistribute(
            mesh, placements(tree_at(grad_specs, path), mesh)) for path, p in items]
        mb = _split(batch, microbatches)[0]
        with counter.loop(microbatches), torch.enable_grad():
            loss = loss_fn(params, mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            with torch.no_grad():
                acc = [a + g.redistribute(mesh, a.placements) / microbatches
                       for a, g in zip(acc, grads)]
        for p in leaves:
            p.requires_grad_(False)
        grads = tree_from_items((path, a) for (path, _), a in zip(items, acc))
        # the optimizer in the ZeRO layout; only the parameters go back
        params_z = _redistribute(tree_from_items(items), grad_specs, mesh)
        new_p, new_s, stats = adamw_update(params_z, grads, opt, opt_cfg)
        new_p = _redistribute(new_p, pspecs, mesh)
        if donate:  # written into the arguments' storage, as a donated buffer
            with torch.no_grad():
                for (path, p) in items:
                    p.copy_(tree_at(new_p, path))
            new_p = tree_from_items(items)
        return new_p, new_s, {**stats, "loss": loss.detach() / microbatches}

    return step


def _prefill_step(cfg, shape, mesh, attn_block):
    prefill = build_prefill_fn(cfg, remat=False, attn_block=attn_block)

    def step(params, batch, counter):
        del counter
        logits, cache = prefill(params, batch)
        cps = cache_pspecs(cfg, shape, mesh, cache)
        return logits, {k: to_spec(v, cps[k], mesh) for k, v in cache.items()}

    return step


def _decode_step(cfg, cps, mesh):
    decode = build_decode_fn(cfg)

    def step(params, cache, token, counter):
        del counter
        logits, cache = decode(params, cache, token)
        return logits, {k: to_spec(v, cps[k], mesh) for k, v in cache.items()}

    return step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--attn-block", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' and the mesh's device type")
    args = ap.parse_args()

    cells = []
    if args.all:
        for arch in configs.ARCHS:
            for s in SHAPES:
                cells.append((arch, s.name))
    else:
        cells.append((args.arch, args.shape))
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failed = False
    for arch, shape in cells:
        for mp in meshes:
            try:
                r = run_cell(arch, shape, multi_pod=mp, microbatches=args.microbatches,
                             attn_block=args.attn_block, device=args.device)
            except Exception as e:  # noqa: BLE001 — recorded per cell, as the reference does
                r = {"arch": arch, "shape": shape, "multi_pod": mp,
                     "status": "error", "error": f"{type(e).__name__}: {e}",
                     "trace": traceback.format_exc()[-2000:]}
                print(r["trace"], file=sys.stderr, flush=True)
                failed = True
            tag = "pod2" if mp else "pod1"
            print(json.dumps({k: v for k, v in r.items() if k != "trace"}), flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                with open(os.path.join(args.out, f"{arch}__{shape}__{tag}.json"), "w") as f:
                    json.dump(r, f, indent=1)
    if dist.is_initialized():
        dist.destroy_process_group()
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
