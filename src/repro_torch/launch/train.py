"""Training launcher (port of ``repro.launch.train``).

The reference runs this process per host of a TPU fleet on its production
mesh; ``--smoke`` runs the same program on a 1×1 mesh at the arch's reduced
config.  So does the port: under a default group of 256 ranks (or 512 with
``--multi-pod``; ``torchrun`` starts it) it trains on the production mesh
(16×16 or 2×16×16), one card per rank; in one process it trains on the
1×1 smoke mesh over one device, ``cuda:0`` unless ``--device cpu`` is passed
(it raises without a card otherwise).  ``--mesh`` cuts the production mesh
to a world of another size (``--mesh 2x2`` on 4 ranks, ``2x1x2`` with
``--multi-pod``).  ``--multi-pod`` outside a 512-rank world raises.
Parameters and batches are DTensors placed by ``distributed.sharding``'s
rules; the step is ``build_train_step`` (plain DP×TP, no ZeRO, as the
reference's launcher).

One card cannot hold the production cell (train_4k: 256 × 4096 tokens, the
full depth), so four cuts are printed: the mesh (``cut: mesh 16x16 -> 1x1``,
outside ``--smoke``), and the flags ``--global-batch``, ``--seq`` and
``--layers`` (the depth), whose defaults are the reference's values.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --smoke --steps 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --layers 12 --seq 4096 --global-batch 2
  torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train --arch qwen3-4b
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke --mesh 2x2

Parameters are f32 from seed 0 (the reference's ``PRNGKey(0)``; not its
numbers): drawn on the card on a mesh of one device; on a larger mesh
drawn on the host, where every rank draws the same tree, and placed shard
by shard, so no card holds a whole parameter (the host holds the f32 tree
while placing it).  The data is ``SyntheticTokens`` seed 0; an async
checkpoint is taken every ``--ckpt-every`` (the reference's 50) steps under
``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig, SyntheticTokens, place, with_extras
from repro_torch.distributed.constraints import active_mesh
from repro_torch.distributed.sharding import batch_pspecs, distribute, param_pspecs
from repro_torch.launch.mesh import PRODUCTION_SHAPES, launcher_mesh, mesh_devices, parse_mesh
from repro_torch.models.common import ParamTree
from repro_torch.models.config import ShapeCell, shape_by_name
from repro_torch.models.transformer import init_params, resolve_device
from repro_torch.runtime import StragglerDetector
from repro_torch.train import OptConfig, build_train_step
from repro_torch.train.optimizer import init_opt_state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Train ``--steps`` steps; print and return the per-step losses and
    wall times (s, synchronised), the cuts, the tokens per step, the peak
    ``max_memory_allocated`` (bytes; None on the CPU) and the final
    ``state`` (``params`` and ``opt``, what a checkpoint holds)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, global batch 4 x 64 tokens")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="a cut of the production mesh whose size is the world's, e.g. 2x2 "
                         "(2x1x2 with --multi-pod)")
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="default cuda:0; 'cpu' to run on the CPU")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="cut of the shape's global batch (default: the shape's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="cut of the shape's sequence length (default: the shape's)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut of the depth (default: the config's)")
    args = ap.parse_args(argv)
    with launcher_mesh(args.multi_pod, resolve_device(args.device),
                       parse_mesh(args.mesh)) as (mesh, device, mesh_shape):
        return _train(args, mesh, device, mesh_shape)


def _train(args, mesh, device: torch.device, mesh_shape) -> Dict[str, object]:
    cfg = configs.get(args.arch)
    shape = shape_by_name(args.shape)
    if args.smoke:
        cfg = cfg.reduced()
        global_batch, seq, attn_block = 4, 64, 32
    else:
        global_batch, seq, attn_block = shape.global_batch, shape.seq_len, 512
    cuts = {}
    full = PRODUCTION_SHAPES[args.multi_pod][0]
    if not args.smoke and mesh_shape != full:
        cuts["mesh"] = tuple("x".join(map(str, s)) for s in (full, mesh_shape))
        print("cut: mesh {} -> {}".format(*cuts["mesh"]))
    for name, flag, have in (("global_batch", args.global_batch, global_batch),
                             ("seq", args.seq, seq), ("layers", args.layers, cfg.n_layers)):
        if flag is not None and flag != have:
            cuts[name] = (have, flag)
            print(f"cut: {name} {have} -> {flag}")
    global_batch = args.global_batch or global_batch
    seq = args.seq or seq
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    params = init_params(cfg, 0, device=device if mesh_devices(mesh) == 1 else "cpu")
    params = ParamTree(distribute(params.to_dict(), param_pspecs(cfg, params), mesh, device))
    opt = init_opt_state(params)
    bspecs = batch_pspecs(cfg, ShapeCell(shape.name, seq, global_batch, "train"), mesh)
    if device.type == "cuda":  # the peak from here: the state, then the steps
        torch.cuda.reset_peak_memory_stats(device)
    step_fn = build_train_step(
        cfg,
        OptConfig(warmup_steps=5, total_steps=max(args.steps, 10)),
        microbatches=args.microbatches,
        attn_block=attn_block,
    )
    data = SyntheticTokens(DataConfig(cfg.vocab_size, seq, global_batch))
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    det = StragglerDetector(n_nodes=1)

    losses, walls = [], []
    with active_mesh(mesh):
        for step in range(args.steps):
            batch = place(with_extras(data.batch_at(step), cfg), device, bspecs, mesh)
            _sync(device)
            t0 = time.perf_counter()
            params, opt, stats = step_fn(params, opt, batch)
            loss = stats["loss"]  # a DTensor's own value may be a rank's partial sum
            loss = float(loss.full_tensor() if isinstance(loss, DTensor) else loss)
            _sync(device)
            wall = time.perf_counter() - t0
            det.record(0, wall)
            losses.append(loss)
            walls.append(wall)
            print(f"step {step:4d} loss {loss:8.4f} ({wall * 1e3:.0f} ms)", flush=True)
            if ck and step and step % args.ckpt_every == 0:
                ck.save(step, {"params": params, "opt": opt}, async_save=True)
    if ck:
        ck.wait()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    print("done")
    return {"losses": losses, "step_s": walls, "peak_bytes": peak, "device": str(device),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "tokens_per_step": global_batch * seq, "cuts": cuts, "cfg": cfg,
            "global_batch": global_batch, "seq": seq, "microbatches": args.microbatches,
            "state": {"params": params, "opt": opt}}


if __name__ == "__main__":
    main()
