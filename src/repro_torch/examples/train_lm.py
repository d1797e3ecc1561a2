"""End-to-end training example: train a ~100M-param model for a few hundred
steps with the full substrate — synthetic packed data, AdamW, grad
accumulation, checkpoint/restart, straggler monitor (the twin of the
reference's ``examples/train_lm.py``, with its flags and defaults).

It trains on the first of the devices, in f32, parameters from seed 0 (the
reference's ``PRNGKey(0)``; not its numbers).  Under grad the models take
``blocked_attention``, so the flash kernel does not run here.
``--ckpt-dir`` defaults to ``repro_torch_ckpt`` under the temporary
directory (the reference's ``/tmp/repro_ckpt``, renamed so that the two
packages' checkpoints do not mix).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
(defaults to a quick 40-step run; --steps 300 reproduces the loss curve)
      PYTHONPATH=src python -m repro_torch.examples.train_lm --cpu-lanes 1 --steps 3
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS
from repro_torch.data import DataConfig, SyntheticTokens, place, with_extras
from repro_torch.examples import add_device_flag, resolve_devices
from repro_torch.launch.train import _sync
from repro_torch.models.transformer import init_params
from repro_torch.runtime import StragglerDetector
from repro_torch.train import OptConfig, build_train_step, init_opt_state


def hundred_m_config():
    """A ~100M-parameter member of the qwen3 family."""
    return dataclasses.replace(
        ARCHS["qwen3-4b"],
        name="qwen3-100m",
        n_layers=8,
        d_model=640,
        n_heads=10,
        n_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=32_768,
        tie_embeddings=False,
        tp_degree=1,
    )


def main(argv: Optional[Sequence[str]] = None,
         devices: Optional[Sequence] = None) -> Dict[str, object]:
    """Train; return the loss, lr and wall (s, synchronised) of every step
    run, the parameter count, the step resumed from and the peak
    ``max_memory_allocated`` (bytes; None off the card)."""
    ap = add_device_flag(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_devices(devices, args.cpu_lanes)[0]

    cfg = hundred_m_config()
    params = init_params(cfg, 0, device=device)
    n_params_true = sum(p.numel() for p in params.parameters())
    print(f"model {cfg.name}: {n_params_true/1e6:.1f}M params")

    opt_cfg = OptConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    opt = init_opt_state(params)
    step_fn = build_train_step(cfg, opt_cfg, microbatches=2, remat=True, attn_block=128)
    data = SyntheticTokens(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch, seed=0)
    )
    ck = Checkpointer(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and ck.latest_step() is not None:
        start, restored = ck.restore({"params": params, "opt": opt}, device=device)
        params, opt = restored["params"], restored["opt"]
        print(f"resumed from step {start}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    det = StragglerDetector(n_nodes=1)
    losses, lrs, walls = [], [], []
    t_all = time.perf_counter()
    for step in range(start, args.steps):
        batch = place(with_extras(data.batch_at(step), cfg), device)
        _sync(device)
        t0 = time.perf_counter()
        params, opt, stats = step_fn(params, opt, batch)
        loss = float(stats["loss"])
        _sync(device)
        dt = time.perf_counter() - t0
        det.record(0, dt)
        losses.append(loss)
        lrs.append(float(stats["lr"]))
        walls.append(dt)
        if step % 10 == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq / dt
            print(f"step {step:4d}  loss {loss:7.4f}  lr {lrs[-1]:.2e}"
                  f"  {dt*1e3:7.1f} ms  {tok_s/1e3:6.1f} ktok/s")
        if step and step % 100 == 0:
            ck.save(step, {"params": params, "opt": opt}, async_save=True)
    ck.wait()
    ck.save(args.steps, {"params": params, "opt": opt})
    total = time.perf_counter() - t_all
    print(f"done in {total:.1f}s; checkpoints at {args.ckpt_dir}")
    return {
        "n_params": n_params_true,
        "start": start,
        "losses": losses,
        "lrs": lrs,
        "step_s": walls,
        "total_s": total,
        "tokens_per_step": args.batch * args.seq,
        "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "device": str(device),
        "ckpt_dir": args.ckpt_dir,
    }


if __name__ == "__main__":
    main()
