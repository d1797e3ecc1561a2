"""Serving launcher (port of ``repro.launch.serve``): two-pod request
placement (§6) + prefill + greedy decode.  ``--smoke`` runs the same
program at the arch's reduced config.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --smoke --device cpu
  torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.serve --arch qwen3-4b
  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --smoke --mesh 2x2

As the reference, it runs under a mesh: the 16×16 production mesh under a
default group of 256 ranks (``torchrun``), a cut of it of the world's size
with ``--mesh``, else the 1×1 smoke mesh over one device, ``cuda:0``
unless ``--device cpu`` is passed (it raises without a card otherwise);
outside ``--smoke`` a cut mesh is printed as a cut.  Parameters (f32,
``init_params``' default, seed 0: on the card on a mesh of one device, else
drawn on the host and placed shard by shard), the batch (seed 1) and the
caches are DTensors placed by ``distributed.sharding``'s rules; on the card
the prefill's attention is the flash kernel on each rank's heads.

On the card the greedy decode step is captured once as a CUDA graph and
replayed: under DTensor each of the step's thousands of small ops costs
host dispatch, which eager decode pays every step (qwen3-4b f32 on one
H100: 223 ms a step eager, 20 ms replayed).  The first step runs eagerly
(capture's warm-up) and the capture follows it; ``decode_setup_s``, within
``decode_s``, is the time from the prefill's end to there.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch import configs
from repro_torch.distributed.constraints import active_mesh, mesh_axis_size
from repro_torch.distributed.sharding import (
    batch_pspecs,
    cache_pspecs,
    distribute,
    param_pspecs,
    to_spec,
)
from repro_torch.launch.mesh import PRODUCTION_SHAPES, launcher_mesh, mesh_devices, parse_mesh
from repro_torch.models import build_decode_fn, build_prefill_fn, init_params, random_batch
from repro_torch.models.common import ParamTree
from repro_torch.models.config import ShapeCell
from repro_torch.models.decode import pad_caches
from repro_torch.models.transformer import resolve_device
from repro_torch.serve import Request, place_two_pods_equal


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
    ap.add_argument("--mesh", default=None,
                    help="a cut of the 16x16 mesh whose size is the world's, e.g. 2x2")
    args = ap.parse_args(argv)
    with launcher_mesh(False, resolve_device(args.device),
                       parse_mesh(args.mesh)) as (mesh, device, mesh_shape):
        return _serve(args, mesh, device, mesh_shape)


def _greedy(decode, params, cache, tok) -> None:
    """One greedy decode step in place: the cache's tensors and ``tok``
    (B, 1) are overwritten with the next state and token."""
    logits, new = decode(params, cache, tok)
    for k, v in new.items():
        if v is not cache[k]:
            cache[k].copy_(v)
    tok.copy_(logits[:, -1:].argmax(-1).to(torch.int32))


def _decode_graph(decode, params, cache, tok) -> torch.cuda.CUDAGraph:
    """:func:`_greedy` captured as one CUDA graph, after one step run
    eagerly on a side stream (capture's warm-up, a real step): each replay
    is the next step, on the same buffers, with no host dispatch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _greedy(decode, params, cache, tok)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        _greedy(decode, params, cache, tok)
    return graph


def _serve(args, mesh, device: torch.device, mesh_shape) -> Dict[str, object]:
    full_cfg = configs.get(args.arch)
    cfg = full_cfg.reduced() if args.smoke else full_cfg

    reqs = [Request(i, args.prompt) for i in range(args.batch)]
    mk, placement = place_two_pods_equal(full_cfg, reqs, 256, alpha=0.9)
    print(f"§6 placement across pods: {placement} (projected mk {mk:.3g})")

    cuts = {}
    full = PRODUCTION_SHAPES[False][0]
    if not args.smoke and mesh_shape != full:
        cuts["mesh"] = tuple("x".join(map(str, s)) for s in (full, mesh_shape))
        print("cut: mesh {} -> {}".format(*cuts["mesh"]))
    params = init_params(cfg, 0, device=device if mesh_devices(mesh) == 1 else "cpu")
    params = ParamTree(distribute(params.to_dict(), param_pspecs(cfg, params), mesh, device))
    prefill = build_prefill_fn(cfg, remat=False, attn_block=32 if args.smoke else 512)
    decode = build_decode_fn(cfg)
    cell = ShapeCell("serve", args.prompt, args.batch, "prefill")
    batch = random_batch(cfg, args.batch, args.prompt, torch.Generator(device).manual_seed(1))
    specs = batch_pspecs(cfg, cell, mesh)
    batch = {k: to_spec(v, specs[k], mesh) for k, v in batch.items()}

    with active_mesh(mesh):
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        _sync(device)
        t1 = time.perf_counter()
        cache = pad_caches(cache, args.gen, multiple=mesh_axis_size("model"))
        specs = cache_pspecs(cfg, cell, mesh, cache)
        cache = {k: to_spec(v, specs[k], mesh) for k, v in cache.items()}
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        outs = [tok.clone()]
        setup = 0.0
        if device.type == "cuda" and args.gen > 1:
            graph = _decode_graph(decode, params, cache, tok)
            outs.append(tok.clone())
            _sync(device)
            setup = time.perf_counter() - t1
            for _ in range(args.gen - 2):
                graph.replay()
                outs.append(tok.clone())
        else:
            for _ in range(args.gen - 1):
                _greedy(decode, params, cache, tok)
                outs.append(tok.clone())
        gen = torch.cat(outs, dim=1).full_tensor().cpu().numpy()
    t2 = time.perf_counter()
    print(f"generated {gen.shape[0]}×{gen.shape[1]} tokens on {device}: prefill "
          f"{(t1 - t0) * 1e3:.0f} ms, decode {(t2 - t1) * 1e3:.0f} ms")
    return {"tokens": gen, "prefill_s": t1 - t0, "decode_s": t2 - t1, "decode_setup_s": setup,
            "placement": placement, "projected_makespan": mk, "cuts": cuts,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}


if __name__ == "__main__":
    main()
