"""Serving launcher on one card (port of ``repro.launch.serve``): two-pod
request placement (§6) + prefill + greedy decode.  ``--smoke`` runs the
same program at the arch's reduced config.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --smoke --device cpu

Runs on ``cuda:0`` and raises without a card unless ``--device cpu`` is
passed.  Parameters are f32 (``init_params``' default) from seed 0, the
batch from seed 1.  No mesh: the reference's production mesh (and
``launch/mesh.py``) is ROADMAP item 10c.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.models import build_decode_fn, build_prefill_fn, init_params, random_batch
from repro_torch.models.transformer import resolve_device
from repro_torch.serve import Request, place_two_pods_equal

CACHE_KEYS = ("k", "v", "ak", "av", "xk", "xv")  # the caches with a sequence axis


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Serve ``--batch`` random prompts of ``--prompt`` tokens and
    ``--gen`` greedy tokens each; print and return the generated tokens
    (B, gen) and the prefill and decode wall times (s, synchronised)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="default cuda:0; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    full_cfg = configs.get(args.arch)
    cfg = full_cfg.reduced() if args.smoke else full_cfg

    reqs = [Request(i, args.prompt) for i in range(args.batch)]
    mk, placement = place_two_pods_equal(full_cfg, reqs, 256, alpha=0.9)
    print(f"§6 placement across pods: {placement} (projected mk {mk:.3g})")

    params = init_params(cfg, 0, device=device)
    prefill = build_prefill_fn(cfg, remat=False, attn_block=32 if args.smoke else 512)
    decode = build_decode_fn(cfg)
    batch = random_batch(cfg, args.batch, args.prompt, torch.Generator(device).manual_seed(1))

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    _sync(device)
    t1 = time.perf_counter()
    for kk in CACHE_KEYS:
        if kk in cache:
            cache[kk] = F.pad(cache[kk], (0, 0, 0, 0, 0, args.gen))
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    outs = [tok]
    for _ in range(args.gen - 1):
        logits, cache = decode(params, cache, tok)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        outs.append(tok)
    gen = torch.cat(outs, dim=1).cpu().numpy()
    t2 = time.perf_counter()
    print(f"generated {gen.shape[0]}×{gen.shape[1]} tokens on {device}: prefill "
          f"{(t1 - t0) * 1e3:.0f} ms, decode {(t2 - t1) * 1e3:.0f} ms")
    return {"tokens": gen, "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "placement": placement, "projected_makespan": mk}


if __name__ == "__main__":
    main()
