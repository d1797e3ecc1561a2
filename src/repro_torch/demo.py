"""The paper's application end to end through ``repro_torch.api``: matrix →
ordering → symbolic → PM plan → factorization executed on the card →
‖LLᵀ−A‖ check.  The twin of the JAX package's
``examples/multifrontal_demo.py``.

For each matrix: tree stats, PM vs PROPORTIONAL/DIVISIBLE projected
makespans (§7), discretized plan efficiency — all policies resolved from
the same registry.  The first matrix is then factorized in f64 by the
malleable-plan executor (``Session.execute``) on every CUDA device, running
the hand-written frontal kernels, with a measured-vs-projected makespan
report and an empirical α re-fit; a residual above 1e-12 raises.

Run:  PYTHONPATH=src python -m repro_torch.demo
      PYTHONPATH=src python -m repro_torch.demo --cpu-lanes 4   # no card
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api import DeviceMesh, Session
from repro_torch.sparse import (
    grid_laplacian_2d,
    grid_laplacian_3d,
    min_degree,
    nested_dissection_2d,
    random_spd,
)

ALPHA = 0.9
RESIDUAL_MAX = 1e-12  # f64


def demo(name, a, perm=None, ndev=256, devices: Optional[Sequence] = None,
         execute=False, warmup=True) -> Optional[float]:
    """Plan (and with ``execute``, factorize) one matrix; returns the
    factor's residual max|LLᵀ−A|/max|A| when executed.  ``warmup=False``
    skips the executor's untimed warmup (for a process already warm)."""
    session = Session(DeviceMesh(devices, plan_devices=ndev))
    t0 = time.time()
    session.analyze(a, alpha=ALPHA, ordering=perm)
    t_sym = time.time() - t0
    symb = session.problem.symb
    mk = {p: session.plan(policy=p).schedule.makespan
          for p in ("pm", "proportional", "divisible")}
    session.plan(policy="greedy")
    plan = session.schedule
    print(f"{name:14s} n={symb.n:6d} fronts={symb.n_supernodes:5d} "
          f"maxfront={max(s.m for s in symb.supernodes):4d} "
          f"| PM {mk['pm']:9.3g}"
          f"  PROP +{100*(mk['proportional']/mk['pm']-1):5.1f}%  "
          f"DIV +{100*(mk['divisible']/mk['pm']-1):6.1f}% "
          f"| plan eff {plan.efficiency():.2f} | symbolic {t_sym*1e3:.0f}ms",
          flush=True)
    if not execute:
        return None
    run = session.execute(dtype=torch.float64, warmup=warmup)
    dense = session.problem.matrix.toarray()
    l = run.artifact.to_dense_l()
    rel = float(np.abs(l @ l.T - dense).max() / np.abs(dense).max())
    devs = session.platform.devices()
    print(f"--- executed {name} (greedy PM plan, f64, {len(devs)} device(s): "
          f"{devs[0]})")
    print("\n".join("    " + ln for ln in run.detail.summary().splitlines()))
    print(f"    residual    ‖LLᵀ−A‖/‖A‖ = {rel:.2e}"
          f"  ({'OK' if rel <= RESIDUAL_MAX else 'FAIL'})", flush=True)
    if rel > RESIDUAL_MAX:
        raise AssertionError(f"{name}: residual {rel:.3e} > {RESIDUAL_MAX}")
    return rel


def main(devices: Optional[Sequence] = None, warmup: bool = True) -> float:
    """The four matrices of the reference demo; ``devices`` defaults to
    every CUDA device (raises without one).  Returns the first matrix's
    residual."""
    rng = np.random.default_rng(0)
    rel = demo("grid 23x23", grid_laplacian_2d(23), nested_dissection_2d(23),
               devices=devices, execute=True, warmup=warmup)
    demo("grid 41x41", grid_laplacian_2d(41), nested_dissection_2d(41))
    demo("grid 8x8x8", grid_laplacian_3d(8))
    a = random_spd(400, 5.0, rng)
    demo("rand-spd 400", a, min_degree(a))
    return rel


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-lanes", type=int, default=0,
                    help="run on this many CPU lanes (plain kernel versions) "
                         "instead of the CUDA devices")
    args = ap.parse_args()
    main([torch.device("cpu")] * args.cpu_lanes if args.cpu_lanes else None)
