"""Readings that the limit of a cell's check is set from, in one process.

    python3 bench/limits.py --workload <cell> --first-seed <n> --seeds 12 \
        --control-seeds 3 --fault-seeds 3 --out limits.json

At the cell's own size and on its chips: one set-up, then for each seed
the program's factor of that seed's first matrix, judged by the reference
as a run judges it (the lower reading); the control, the program's own
float32 path in the place of the configuration's float64 (the upper
reading); and three planted faults, each judged the same way:

* ``stale``: a refactorization that returns the previous factor;
* ``half``: every batched dispatch factors half of its fronts and returns
  the rest as they came;
* ``altered``: one entry of one front's panel changed by a part in a
  million where it is produced.

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from pathlib import Path

import run


def half_batches(executor_module):
    """Patch the executor's batched kernel to factor half of each batch."""
    real = executor_module.batched_front_factor

    def half(fronts, nbp):
        keep = (fronts.shape[0] + 1) // 2
        out = fronts.clone()
        out[:keep] = real(fronts[:keep].contiguous(), nbp)
        return out

    executor_module.batched_front_factor = half
    return lambda: setattr(executor_module, "batched_front_factor", real)


def altered(fact, seed: int):
    """A copy of ``fact`` with one panel entry changed by a part in 1e6."""
    import numpy as np

    out = copy.copy(fact)
    out.panels = list(fact.panels)
    s = int(np.random.default_rng(seed).integers(len(out.panels)))
    p = out.panels[s].copy()
    p[-1, 0] += 1e-6 * np.abs(p).max()
    out.panels[s] = p
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--out", type=Path, required=True)
    args = p.parse_args(argv)
    for var, rel in run.CACHE_DIRS.items():
        os.environ[var] = str(run.REPO / rel)
    sys.path.insert(0, str(run.REPO / "src"))

    import torch

    import repro_torch.runtime.executor as executor_module
    from repro_torch.runtime.executor import PlanExecutor

    cell = run.Cell(run.Harness(run.REPO), args.workload)
    seeds = [args.first_seed + i for i in range(args.seeds)]
    t = time.perf_counter()
    ex, analyze_s = cell.build(seeds[0], 0)
    ex32 = PlanExecutor(ex.symb, ex.plan, devices=ex.devices, dtype=torch.float32, mode=ex.mode)
    ex.warmup()
    ex32.warmup()
    print(f"[limits] {args.workload}: set-up {time.perf_counter() - t:.1f} s", flush=True)
    out = {"workload": args.workload, "card": run.power_limit(), "program": [], "control": [],
           "stale": [], "half": [], "altered": []}

    def factor(executor, seed, k=0):
        t = time.perf_counter()
        fact, _ = executor.run(cell.op.matrix(seed, k), warmup=False)
        cell.synchronize()
        return fact, time.perf_counter() - t

    def record(kind, seed, value, seconds=None):
        out[kind].append({"seed": seed, "residual": value, "seconds": seconds})
        print(f"[limits] {kind:8s} seed {seed}: {value!r}"
              + (f" ({seconds:.3f} s)" if seconds is not None else ""), flush=True)

    for i, seed in enumerate(seeds):
        fact, sec = factor(ex, seed)
        record("program", seed, cell.judge(seed, 0, fact), sec)
        if i < args.fault_seeds:
            record("stale", seed, cell.judge(seed, 1, fact))
            record("altered", seed, cell.judge(seed, 0, altered(fact, seed)))
        del fact
    for seed in seeds[: args.control_seeds]:
        fact, sec = factor(ex32, seed)
        record("control", seed, cell.judge(seed, 0, fact), sec)
        del fact
    restore = half_batches(executor_module)
    try:
        for seed in seeds[: args.fault_seeds]:
            fact, sec = factor(ex, seed)
            record("half", seed, cell.judge(seed, 0, fact), sec)
            del fact
    finally:
        restore()
    summary = {
        "lower": max(r["residual"] for r in out["program"]),
        **{f"least_{k}": min(r["residual"] for r in out[k])
           for k in ("control", "stale", "half", "altered") if out[k]},
        "limit": cell.cfg["check"]["residual_limit"],
    }
    out["summary"] = summary
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
