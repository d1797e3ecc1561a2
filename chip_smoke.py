"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    PYTHONPATH=src python3 chip_smoke.py      # (PYTHONPATH optional)

Builds the hand-written kernels from ``src/repro_torch/csrc`` and drives the
port's main path, the paper's application: sparse SPD matrix → ordering →
symbolic analysis → PM plan → ``PlanExecutor`` factoring every front on the
card → ‖LLᵀ−A‖ check.

1. card and build: ``nvidia-smi`` name and power limit, build time;
2. each kernel against its plain PyTorch version on the card, f32 and f64,
   at the main path's shapes, with CUDA-event times beside the plain
   version's, a library yardstick's and the bound;
3. main path, 2-D Poisson 200×200 (nested dissection), f64, async runner;
4. large-front route, random SPD n=2500 (minimum degree), f64;
   then phase 3's plan once more under torch.profiler (device time by
   kernel, busy share);
5. modes: async and waves bit-identical (grid 60, f64); f32 grid 100.

Launch counters are set to 0 just before each main-path run (phases 3 and
4, after the executor's untimed warmup) and read just after: every kernel
must have run on the main path, and no plain version.  Any failed
check raises.  The line before the last is the kernels' JSON; the last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

# H100 SXM data sheet (dense): FP32 67 TFLOP/s, FP64 tensor core 67 TFLOP/s
# (34 without), HBM3 3.35 TB/s.  The bound takes the best rate for the type.
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 5e-5, torch.float64: 1e-11}
TOL_LARGE = {torch.float32: 1e-4, torch.float64: 1e-11}  # panel + SYRK route


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 7, warm: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after ``warm`` untimed runs."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def rel_err(x: torch.Tensor, y: torch.Tensor) -> tuple[float, float]:
    """(max-abs error, max-abs error relative to max(1, max|y|))."""
    err = float((x - y).abs().max())
    return err, err / max(1.0, float(y.abs().max()))


def spd_batch(gen, b: int, m: int, dtype) -> torch.Tensor:
    x = torch.randn(b, m, m, generator=gen, dtype=torch.float64)
    a = x @ x.transpose(1, 2) + m * torch.eye(m, dtype=torch.float64)
    return a.to(dtype).cuda()


def partial_factor_flops(m: int, nb: int) -> float:
    i = np.arange(nb, dtype=np.float64)
    mi = m - i
    return float(np.sum(mi**2 + mi + 1.0))


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_b = nbytes / PEAK_BYTES * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ----------------------------------------------------------------------
def phase_kernels(fc) -> dict:
    """Every kernel against its plain version on the card; returns the
    per-kernel record at the main path's f64 shape."""
    from repro_torch.kernels.ref import panel_factor_ref

    gen = torch.Generator().manual_seed(0)
    rec = {}
    for dtype in (torch.float32, torch.float64):
        size = torch.finfo(dtype).bits // 8
        for b, mp, nbp in [(32, 256, 128), (4, 1024, 256)]:
            f = spd_batch(gen, b, mp, dtype)
            got = fc.front_factor(f, nbp)
            torch.cuda.synchronize()
            want = fc.front_factor_plain(f, nbp)
            err, rel = rel_err(torch.tril(got), torch.tril(want))
            ms = cuda_ms(lambda: fc.front_factor(f, nbp))
            plain_ms = cuda_ms(lambda: fc.front_factor_plain(f, nbp), reps=3, warm=1)

            def lib_front():  # torch.linalg composition of the same function
                a11 = f[:, :nbp, :nbp]
                l11 = torch.linalg.cholesky(a11)
                l21 = torch.linalg.solve_triangular(
                    l11, f[:, nbp:, :nbp].transpose(1, 2), upper=False
                ).transpose(1, 2)
                return l11, l21, torch.baddbmm(f[:, nbp:, nbp:], l21, l21.transpose(1, 2), alpha=-1)

            lib_ms = cuda_ms(lib_front)
            bnd, by = bound(2.0 * b * mp * mp * size, b * partial_factor_flops(mp, nbp), dtype)
            print(f"front_factor {str(dtype)[6:]} B={b} mp={mp} nbp={nbp}: "
                  f"max_abs_err {err:.3e} rel {rel:.3e}  ms {ms:.4f}  plain_ms {plain_ms:.3f}  "
                  f"library_ms {lib_ms:.4f}  bound_ms {bnd:.5f} ({by})", flush=True)
            check(rel <= TOL[dtype], f"front_factor {dtype} {b}x{mp}: rel err {rel}")
            if dtype == torch.float64 and mp == 256:
                rec["front_factor"] = dict(
                    shape=[b, mp, mp], nbp=nbp, dtype="float64", max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                )
        for mp, nb in [(1152, 128), (1152, 256)]:
            s = spd_batch(gen, 1, mp, dtype)[0, :, :nb].contiguous()
            got = fc.panel_factor(s)
            torch.cuda.synchronize()
            want = fc.panel_factor_plain(s)
            err, rel = rel_err(torch.tril(got), torch.tril(want))
            _, rel_ref = rel_err(torch.tril(got), panel_factor_ref(s))
            ms = cuda_ms(lambda: fc.panel_factor(s))
            plain_ms = cuda_ms(lambda: fc.panel_factor_plain(s), reps=3, warm=1)
            lib_ms = cuda_ms(lambda: panel_factor_ref(s))
            flops = nb**3 / 3.0 + (mp - nb) * nb * nb
            bnd, by = bound(2.0 * mp * nb * size, flops, dtype)
            print(f"panel_factor {str(dtype)[6:]} mp={mp} nb={nb}: max_abs_err {err:.3e} "
                  f"rel {rel:.3e} (vs torch.linalg {rel_ref:.3e})  ms {ms:.4f}  "
                  f"plain_ms {plain_ms:.3f}  library_ms {lib_ms:.4f}  bound_ms {bnd:.5f} ({by})",
                  flush=True)
            check(rel <= TOL_LARGE[dtype], f"panel_factor {dtype} {mp}x{nb}: rel err {rel}")
            check(rel_ref <= TOL_LARGE[dtype], f"panel_factor {dtype} {mp}x{nb} vs oracle: {rel_ref}")
            if dtype == torch.float64 and nb == 256:
                rec["panel_factor"] = dict(
                    shape=[mp, nb], dtype="float64", max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                )
        for m, k, tile in [(1024, 128, 256), (896, 256, 128)]:
            c = torch.randn(m, m, generator=gen, dtype=torch.float64).to(dtype).cuda()
            a = torch.randn(m, k, generator=gen, dtype=torch.float64).to(dtype).cuda()
            got = fc.syrk_downdate(c, a, tile)
            torch.cuda.synchronize()
            err, rel = rel_err(got, fc.syrk_downdate_plain(c, a))
            _, rel64 = rel_err(got.double(), c.double() - a.double() @ a.double().T)
            ms = cuda_ms(lambda: fc.syrk_downdate(c, a, tile))
            plain_ms = cuda_ms(lambda: fc.syrk_downdate_plain(c, a))
            lib_ms = cuda_ms(lambda: torch.addmm(c, a, a.T, alpha=-1))
            bnd, by = bound((2.0 * m * m + m * k) * size, 2.0 * m * m * k, dtype)
            print(f"syrk_downdate {str(dtype)[6:]} M={m} K={k} tile={tile}: max_abs_err {err:.3e} "
                  f"rel {rel:.3e} (vs f64 product {rel64:.3e})  ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
                  f"library_ms {lib_ms:.4f}  bound_ms {bnd:.5f} ({by})", flush=True)
            check(rel <= TOL_LARGE[dtype], f"syrk_downdate {dtype} M={m}: rel err {rel}")
            check(rel64 <= TOL_LARGE[dtype], f"syrk_downdate {dtype} M={m} vs f64: {rel64}")
            if dtype == torch.float64 and m == 1024:
                rec["syrk_downdate"] = dict(
                    shape=[m, k], tile=tile, dtype="float64", max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                )
    return rec


def sparse_l(fact) -> sp.csr_matrix:
    """The factor as a scipy sparse matrix, from the supernodal panels."""
    rows, cols, vals = [], [], []
    for sn, panel in zip(fact.symb.supernodes, fact.panels):
        r = np.broadcast_to(sn.rows[:, None], panel.shape)
        c = np.broadcast_to(sn.cols[None, :], panel.shape)
        keep = r >= c
        rows.append(r[keep])
        cols.append(c[keep])
        vals.append(panel[keep])
    n = fact.symb.n
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)
    )


def residual(fact, a: sp.csr_matrix) -> float:
    """max|LLᵀ − A| / max|A|."""
    lm = sparse_l(fact)
    r = (lm @ lm.T - a).tocsr()
    return float(np.abs(r.data).max(initial=0.0) / np.abs(a.data).max())


def drive(name: str, ap, dtype, mode: str = "async", counters=None):
    """analyze → make_plan → PlanExecutor on the default (CUDA) devices.

    The executor's warmup (library load, one identity front per shape
    class) runs first and untimed; then ``counters.reset_counters()``, when
    given, so the launch counts are the run's own."""
    from repro_torch.runtime import PlanExecutor
    from repro_torch.sparse import analyze, make_plan

    t0 = time.perf_counter()
    symb = analyze(ap, relax=2)
    plan = make_plan(symb.task_tree(), 256, 0.9)
    ex = PlanExecutor(symb, plan, dtype=dtype, mode=mode)
    ex.warmup()
    torch.cuda.synchronize()
    if counters is not None:
        counters.reset_counters()
    t1 = time.perf_counter()
    fact, report = ex.run(ap, warmup=False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[{name}] n={symb.n} fronts={symb.n_supernodes} analyze+plan+warmup {t1 - t0:.2f} s, "
          f"run wall {t2 - t1:.3f} s, measured makespan {report.measured_makespan:.3f} s, "
          f"n_dispatches {report.n_dispatches}", flush=True)
    print(report.summary(), flush=True)
    return fact, report, t2 - t1, (symb, plan)


def profile_run(name: str, ap, symb, plan, dtype) -> dict:
    """One more run of the same plan under torch.profiler: device time by
    kernel and copy, and the device's busy share of the run's wall time
    (sums over streams, so overlapping work counts twice)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import PlanExecutor

    ex = PlanExecutor(symb, plan, dtype=dtype)
    ex.warmup()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.run(ap, warmup=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e6
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[{name} profiled] wall {wall:.3f} s, device time {busy:.4f} s, "
          f"busy share {busy / wall:.4f}", flush=True)
    for k, v in top:
        print(f"    {v * 1e3:10.3f} ms  {k[:90]}", flush=True)
    return {"wall_s": wall, "device_s": busy, "busy_share": busy / wall,
            "device_s_by_name": {k[:60]: v for k, v in top}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import repro_torch.kernels.frontal_cholesky as fc
    from repro_torch.sparse import (
        grid_laplacian_2d,
        min_degree,
        nested_dissection_2d,
        permute_symmetric,
        random_spd,
    )

    smi = nvidia_smi()
    print(f"[1] card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    lib = fc.build_library()
    fc.load_library()
    print(f"[1] built {lib.relative_to(fc.BUILD_DIR.parents[1])} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    rec = phase_kernels(fc)

    # ---- main path: each run with its counters set to 0 just before ----
    g = 200
    ap = permute_symmetric(grid_laplacian_2d(g), nested_dissection_2d(g))
    fact, report, wall, (symb, plan) = drive("3 poisson200 f64", ap, torch.float64, counters=fc)
    launches3, plain3 = dict(fc.LAUNCHES), dict(fc.PLAIN_RUNS)
    res = residual(fact, ap)
    print(f"[3] residual max|LL^T-A|/max|A| = {res:.3e}; launches {launches3}; "
          f"plain {plain3}", flush=True)
    check(res <= 1e-12, f"phase 3 residual {res}")
    check(launches3["front_factor"] > 0, "phase 3: front_factor never launched")
    check(all(v == 0 for v in plain3.values()), f"phase 3: plain versions ran: {plain3}")

    t0 = time.perf_counter()
    a = random_spd(2500, 8.0, np.random.default_rng(0))
    ap4 = permute_symmetric(a, min_degree(a))
    print(f"[4] min_degree ordering {time.perf_counter() - t0:.1f} s", flush=True)
    fact4, report4, wall4, _ = drive("4 random_spd2500 f64", ap4, torch.float64, counters=fc)
    launches4, plain4 = dict(fc.LAUNCHES), dict(fc.PLAIN_RUNS)
    res4 = residual(fact4, ap4)
    launches = {k: launches3[k] + launches4[k] for k in launches3}
    print(f"[4] residual {res4:.3e}; launches {launches4}; main path total {launches}; "
          f"plain {plain4}", flush=True)
    check(res4 <= 1e-12, f"phase 4 residual {res4}")
    check(launches4["panel_factor"] >= 3, "phase 4: panel_factor launched < 3 times")
    check(launches4["syrk_downdate"] >= 3, "phase 4: syrk_downdate launched < 3 times")
    check(all(v == 0 for v in plain4.values()), f"phase 4: plain versions ran: {plain4}")
    # where phase 3's time goes: the same plan once more, under the profiler
    prof3 = profile_run("3 poisson200 f64", ap, symb, plan, torch.float64)

    # ---- modes on the card -------------------------------------------
    g = 60
    ap5 = permute_symmetric(grid_laplacian_2d(g), nested_dissection_2d(g))
    fa, *_ = drive("5 poisson60 f64 async", ap5, torch.float64, "async")
    fw, *_ = drive("5 poisson60 f64 waves", ap5, torch.float64, "waves")
    same = all(np.array_equal(x, y) for x, y in zip(fa.panels, fw.panels))
    print(f"[5] async == waves bit for bit: {same}", flush=True)
    check(same, "phase 5: async and waves panels differ")
    g = 100
    ap6 = permute_symmetric(grid_laplacian_2d(g), nested_dissection_2d(g))
    f32, *_ = drive("5 poisson100 f32 async", ap6, torch.float32)
    res6 = residual(f32, ap6)
    print(f"[5] f32 residual {res6:.3e}", flush=True)
    check(res6 <= 1e-5, f"phase 5 f32 residual {res6}")

    replaces = {
        "front_factor": "src/repro/kernels/frontal_cholesky.py:98",
        "panel_factor": "src/repro/kernels/frontal_cholesky.py:145",
        "syrk_downdate": "src/repro/kernels/frontal_cholesky.py:173",
    }
    kernels = [
        {
            "name": k,
            "route": "cuda",
            "source": "src/repro_torch/csrc/frontal_cholesky.cu",
            "replaces": replaces[k],
            "launches": launches[k],
            **rec[k],
        }
        for k in fc.KERNELS
    ]
    print(json.dumps({
        "e2e": {
            "poisson200_f64_async": {"wall_s": wall, "makespan_s": report.measured_makespan,
                                     "n_dispatches": report.n_dispatches, "residual": res,
                                     "profiled": prof3},
            "random_spd2500_f64_async": {"wall_s": wall4, "makespan_s": report4.measured_makespan,
                                         "n_dispatches": report4.n_dispatches, "residual": res4},
        }
    }), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
