"""Serving example: batched requests through prefill + decode with the §6
two-pod placement deciding which pod (sub-mesh) takes which request (the
twin of the reference's ``examples/serve_lm.py``).

The model is qwen2.5-3b's reduced config with random f32 weights from seed
0 (the reference's ``PRNGKey(0)``; not its numbers), on the first of the
devices.  On the card the prefill's attention is the flash kernel and the
greedy decode step is the server's (``launch.serve``): one eager step,
then the step captured once as a CUDA graph and replayed; on CPU lanes
both run the plain path (blocked attention, eager steps).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm
      PYTHONPATH=src python -m repro_torch.examples.serve_lm --cpu-lanes 1
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import ARCHS
from repro_torch.examples import add_device_flag, resolve_devices
from repro_torch.launch.serve import _decode_graph, _greedy, _sync
from repro_torch.models import build_decode_fn, build_prefill_fn, init_params, random_batch
from repro_torch.models.decode import pad_caches
from repro_torch.serve import Request, place_two_pods, place_two_pods_equal


def main(argv: Optional[Sequence[str]] = None,
         devices: Optional[Sequence] = None) -> Dict[str, object]:
    args = add_device_flag(argparse.ArgumentParser(description=__doc__.splitlines()[0])
                           ).parse_args(argv)
    device = resolve_devices(devices, args.cpu_lanes)[0]
    full_cfg = ARCHS["qwen2.5-3b"]
    cfg = full_cfg.reduced()
    params = init_params(cfg, 0, device=device)

    # --- admission planning: place 8 requests across two pods (§6.1/§6.2)
    reqs = [Request(i, prompt_tokens=int(2 ** (7 + i % 4))) for i in range(8)]
    mk_eq, pl_eq = place_two_pods_equal(full_cfg, reqs, pod_devices=256, alpha=0.9)
    mk_het, pl_het = place_two_pods(full_cfg, reqs, 256, 192, alpha=0.9, lam=1.05)
    print("request placement (equal pods, Alg 11): ", pl_eq)
    print("request placement (256 vs degraded 192, Alg 12):", pl_het)
    print(f"projected makespans: equal {mk_eq:.3g}, degraded {mk_het:.3g}\n")

    # --- run pod 0's batch: prefill then greedy decode
    batch = random_batch(cfg, 4, 32, torch.Generator(device).manual_seed(0))
    prefill = build_prefill_fn(cfg, remat=False, attn_block=16)
    decode = build_decode_fn(cfg)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    # leave room for generation
    gen_len = 16
    cache = pad_caches(cache, gen_len)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    outs = [tok.clone()]
    if device.type == "cuda":
        graph = _decode_graph(decode, params, cache, tok)
        outs.append(tok.clone())
        for _ in range(gen_len - 2):
            graph.replay()
            outs.append(tok.clone())
    else:
        for _ in range(gen_len - 1):
            _greedy(decode, params, cache, tok)
            outs.append(tok.clone())
    gen = torch.cat(outs, dim=1).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"generated {gen.shape} tokens in {dt*1e3:.0f} ms "
          f"({gen.size/dt:.0f} tok/s on {device})")
    print("sample:", gen[0][:12], "...")
    return {
        "placement_equal": pl_eq,
        "placement_degraded": pl_het,
        "makespan_equal": mk_eq,
        "makespan_degraded": mk_het,
        "tokens": gen,
        "prefill_logits": logits[:, -1].float().cpu().numpy(),
        "wall_s": dt,
        "device": str(device),
    }


if __name__ == "__main__":
    main()
