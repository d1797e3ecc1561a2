"""Training launcher on one card (port of ``repro.launch.train``).

The reference runs this process per host of a TPU fleet on its production
mesh; ``--smoke`` runs the same program on a 1×1 mesh at the arch's reduced
config.  The port has no mesh yet (ROADMAP item 10c): it trains on one
device, ``cuda:0`` unless ``--device cpu`` is passed (it raises without a
card otherwise), and ``--multi-pod`` raises.  One card cannot hold the
production cell (train_4k: 256 × 4096 tokens, the full depth), so three
cuts are flags whose defaults are the reference's values: ``--global-batch``,
``--seq`` and ``--layers`` (the depth); each cut is printed.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --smoke --steps 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --layers 12 --seq 4096 --global-batch 2

Parameters are f32 from seed 0 (the reference's ``PRNGKey(0)``; not its
numbers), the data ``SyntheticTokens`` seed 0, an async checkpoint every
50 steps under ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch import configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig, SyntheticTokens, place, with_extras
from repro_torch.models.config import shape_by_name
from repro_torch.models.transformer import resolve_device
from repro_torch.runtime import StragglerDetector
from repro_torch.train import OptConfig, build_train_step, init_train_state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Train ``--steps`` steps; print and return the per-step losses and
    wall times (s, synchronised), the cuts, the tokens per step and the
    peak ``max_memory_allocated`` (bytes; None on the CPU)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, global batch 4 x 64 tokens")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None, help="default cuda:0; 'cpu' to run on the CPU")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="cut of the shape's global batch (default: the shape's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="cut of the shape's sequence length (default: the shape's)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut of the depth (default: the config's)")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod: the production meshes are ROADMAP item 10c (not ported)")
    device = resolve_device(args.device)

    cfg = configs.get(args.arch)
    shape = shape_by_name(args.shape)
    if args.smoke:
        cfg = cfg.reduced()
        global_batch, seq, attn_block = 4, 64, 32
    else:
        global_batch, seq, attn_block = shape.global_batch, shape.seq_len, 512
    cuts = {}
    for name, flag, have in (("global_batch", args.global_batch, global_batch),
                             ("seq", args.seq, seq), ("layers", args.layers, cfg.n_layers)):
        if flag is not None and flag != have:
            cuts[name] = (have, flag)
            print(f"cut: {name} {have} -> {flag}")
    global_batch = args.global_batch or global_batch
    seq = args.seq or seq
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    params, opt = init_train_state(cfg, 0, device=device)
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
    for step in range(args.steps):
        batch = place(with_extras(data.batch_at(step), cfg), device)
        _sync(device)
        t0 = time.perf_counter()
        params, opt, stats = step_fn(params, opt, batch)
        loss = float(stats["loss"])
        _sync(device)
        wall = time.perf_counter() - t0
        det.record(0, wall)
        losses.append(loss)
        walls.append(wall)
        print(f"step {step:4d} loss {loss:8.4f} ({wall * 1e3:.0f} ms)", flush=True)
        if ck and step and step % 50 == 0:
            ck.save(step, {"params": params, "opt": opt}, async_save=True)
    if ck:
        ck.wait()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    print("done")
    return {"losses": losses, "step_s": walls, "peak_bytes": peak, "device": str(device),
            "tokens_per_step": global_batch * seq, "cuts": cuts, "cfg": cfg,
            "global_batch": global_batch, "seq": seq, "microbatches": args.microbatches}


if __name__ == "__main__":
    main()
