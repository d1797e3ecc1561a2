"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    PYTHONPATH=src python3 chip_smoke.py      # (PYTHONPATH optional)

Builds the hand-written kernels from ``src/repro_torch/csrc`` and drives the
port's main path, the paper's application: sparse SPD matrix → ordering →
symbolic analysis → PM plan → ``PlanExecutor`` factoring every front on the
card → ‖LLᵀ−A‖ check.

1. card and build: ``nvidia-smi`` name and power limit, build time;
2. each kernel against its plain PyTorch version on the card, f32 and f64,
   at the main path's shapes, with CUDA-event times (each call issued
   behind a spin of the card, so the events read the card's time, not the
   host's) beside the plain version's, a library yardstick's and the
   bound, and each row's kernel/library ratio (``syrk_downdate`` also
   with both calls issued to an idle card, and its time against K); the
   factor kernels' cluster size and how many such clusters the card holds
   at once.  ``syrk_downdate`` with uplo='L' (BLAS syrk, what the main
   path calls: its lower triangle is compared, its strictly-upper part
   must equal C) and with the default uplo=None (the reference's full
   result, compared on both triangles, also at K=40);
3. main path, 2-D Poisson 200×200 (nested dissection), f64, async runner;
4. large-front route, random SPD n=2500 (minimum degree), f64, then
   ``syrk_downdate`` alone at the (M, K) this run launched; then phase 3's
   plan once more under torch.profiler (device time by kernel, busy
   share);
5. modes: async and waves bit-identical (grid 60, f64); f32 grid 100;
6. the flash-attention kernels (their public entry point; phase 11 runs
   them inside the models) at qwen3-4b's attention widths (32 query heads,
   Dh=128) and its train_4k length: B=2, T=4096, causal f32 and bf16,
   causal bf16 and f32 at Dh=64, non-causal f32, causal f32 and bf16 at
   Dh=96 and at zamba2-2.7b's Dh=80 (both padded to 128 in the tensor-core
   kernels), causal f32 and bf16 at Dh=192 and 256 (the tensor-core
   kernels' wide tiles), causal f16 and f64 at Dh=128 (computed in f32),
   causal f32 and bf16 at Dh=76 (padded to 80), at Dh=320 and 512 (the
   cluster route: the head dim split over 2 blocks of 192 or 256 columns),
   causal f32 and bf16 at Dh=192 and at Dh=320 with B*H = 65600, T=64, and
   one case past the cluster's reach (Dh=4104, simt, B=1 T=256 H=2); each
   through the route its (dtype, Dh) names (the per-route counter is
   checked against the rule: tensor cores up to 256, the cluster route up
   to 4096, simt past it; each cluster case prints its blocks per cluster
   and how many such clusters the card holds at once), against its plain
   version, twice bit for bit, with CUDA-event times, the plain version's,
   ``scaled_dot_product_attention``'s (a yardstick the port never calls;
   on f16 and f64 inputs converted to f32 and back, the port's function)
   and the bound;
7. the facade at full size: ``Session(DeviceMesh(plan_devices=256))
   .analyze(Poisson 200).plan("greedy").execute(dtype=float64)``, its
   panels bit-identical to phase 3's; ``.optimize(max_front=64)`` on
   Poisson 60, bit-identical to the unoptimized run; ``repro_torch.demo``;
8. the online path: ``execute_online(phase 4's matrix, 256, 0.9,
   dtype=float64)`` (online run, projected plan, executor; its panels bit
   for bit phase 4's, the online run's host seconds apart from the rest
   of the call); ``Session(...).analyze(Poisson 60).plan("online")``
   executed async and waves (bit for bit each other and phase 5's);
   ``Session.simulate()`` and ``Session.serve`` of three Poisson arrivals
   of that Problem, two trees at once and the third queued (virtual time,
   on the host);
9. the serving cluster (``repro_torch.cluster``) on the card, f64: (a) two
   workers of two slots sharing ``cuda:0`` serve phase 5's Poisson 60
   (tenant 0) and phase 4's random SPD 2500 (tenant 1) at once, under
   ``torch.profiler`` (device time of the kernels against the run's wall
   and the scheduler loop's host seconds): every result ok, no front
   requeued, panels bit for bit phases 5 and 4's, the three frontal
   kernels launched by the workers, a dispatch of more than one front;
   (b) one worker killed after the first dispatch (heartbeat timeout 0.2
   s, 0.05 s per dispatch) on Poisson 60: a loss seen, the panels still
   phase 5's; (c) ``Session(DeviceMesh()).serve(stream, cluster=2)`` of
   phase 8c's three Poisson 60 arrivals, then ``RunReport.save_html``;
10. the workload front end: (a) ``Session(DeviceMesh(plan_devices=256))
   .analyze_workload("multifrontal")`` (``configs/multifrontal.py``: the
   63×63 grid, nested dissection, relax 2) planned greedy and executed in
   the config's f32 (residual ≤ 1e-5, panels bit for bit the same grid's
   through ``analyze``); (b) every config of ``ARCHS`` at its published
   widths and the pod qwen3-4b + rwkv6-1.6b: the ``h100`` calibration, a
   §4-valid PM plan, ``simulate`` equal to it (virtual time, on the host);
   (c) ``serve_online`` of eight qwen3-4b requests on a 256-device pod and
   two-pod placement; (d) the dense bf16 ``torch.matmul`` rate at 8192³
   and a 1 GiB copy's HBM bandwidth, each within 1.5x of the ``h100``
   constants of ``workloads/costs.py``;
11. the LM path (``repro_torch.models``): (a) ``repro_torch.launch.serve``
   serves qwen3-4b at full width (f32, 4 prompts of 1024 tokens, 32
   generated each), 36 flash launches and no plain run, its prefill and
   decode walls (the decode a CUDA graph, replayed) and peak memory, its
   tokens equal to eager decode's without a mesh; (b) the same model in bf16 and f32, the
   kernel path against blocked attention on the card (prefill logits and
   4 teacher-forced decode steps, within ``LM_TOL`` of max |logit|), the
   f32 kernel path under ``torch.profiler``; (c) every reduced arch in
   f32: forward (= the CPU's within 1e-4), loss, prefill + 3 decode steps
   within 2e-4 of the teacher-forced forward, flash launches as counted
   by ``flash_layers``;
12. the training path (``repro_torch.{train,data,checkpoint}``): (a)
   ``repro_torch.launch.train`` trains qwen3-4b at its published widths,
   depth cut to 12 layers, 2 x 4096 tokens in 2 microbatches, 3 steps in
   f32: finite losses, no flash launch and no plain run (under grad the
   models take ``blocked_attention``), step walls, tokens/s, model flop/s
   against 67 TFLOP/s, peak memory; one more step under ``torch.profiler``
   (busy share, device time of blocked attention, the optimizer, the other
   matmuls and the rest); (b) every reduced arch: a train step on the card
   against the CPU (loss 1e-5 relative, each gradient leaf 1e-4 of its
   max); qwen2.5-3b reduced overfits one batch; (c) an async checkpoint
   taken while the next in-place step runs, restored bit for bit, the
   resumed losses within 1e-6 of the uninterrupted run's;
13. the production meshes: (a) qwen3-4b (2 layers, full width) one train
   step without a mesh and one on ``make_smoke_mesh(cuda:0)``, bit for
   bit; (b) phase 11's f32 prefill on the 1x1 mesh (``DTensor.from_local``,
   no copy), logits bit for bit phase 11's, 36 flash launches through
   ``local_map``; (c) the dry run (``repro_torch.launch.dryrun``, fake CUDA
   tensors) of qwen3-4b train_4k on 16x16 and qwen2.5-3b train_4k on
   2x16x16, each in a subprocess, ``ok`` within the reference test's
   bounds.  Phases 11 (a) and 12 (a) run their launchers on the 1x1 mesh.

Launch counters are set to 0 just before each main-path run (phases 3 and
4 after the executor's untimed warmup; each run of phases 6 to 13,
whose executors and workers skip the warmup in the process phases 3-5
warmed) and
read just after: every kernel must have run on the main path, and no
plain version.  Any failed check raises.  The line before the last is the
kernels' JSON; the last line is ``{"ok": true, "device": {...}}``.  Exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import contextlib
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
PEAK_BF16_TENSOR = 989e12  # dense bf16 tensor cores
PEAK_TF32_TENSOR = 495e12  # dense TF32 tensor cores


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


QUEUE_CYCLES = 2_000_000  # about 1 ms of the card's clock


def cuda_ms(fn, reps: int = 7, warm: int = 2, queued: bool = True) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after ``warm`` untimed runs.

    ``queued``: each timed call is issued while the card spins for about
    1 ms (``torch.cuda._sleep``), so the events read the card's time for
    the call's work, not the host's time to issue it (which a call of tens
    of µs would otherwise be dominated by).  ``queued=False``: the call
    starts on an idle card, its host time included."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
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
def kernel_row(rows: dict, name: str, dtype, shape: dict, err: float, ms: float,
               plain_ms: float, lib_ms: float, bnd: float, by: str, main: bool) -> None:
    """Print one phase-2 row with its kernel/library ratio and file it:
    the main path's f64 shape as the kernel's record, the rest as its
    ``other_cases``."""
    row = dict(dtype=str(dtype)[6:], **shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bnd, bound_by=by, x_library=ms / lib_ms,
               x_bound=ms / bnd)
    print(f"    -> {name} {row['dtype']} {shape}: {ms / lib_ms:.2f}x library, "
          f"{ms / bnd:.1f}x bound", flush=True)
    rec = rows.setdefault(name, {})
    if main:
        rec.update(row)
    else:
        rec.setdefault("other_cases", []).append(row)


def syrk_case(fc, gen, dtype, m: int, k: int, tile: int, uplo="L") -> tuple:
    """``syrk_downdate`` at (M, K), uplo='L' (BLAS syrk: what the main path
    calls) or None (the reference's full result): the lower triangle (and,
    full, the strictly-upper part) against the plain version of the same
    ``uplo`` and an f64 product; uplo='L': the strictly-upper part equal to
    C; two calls bit for bit; returns (err, ms, plain_ms, library_ms,
    bound_ms, bound_by)."""
    size = torch.finfo(dtype).bits // 8
    c = torch.randn(m, m, generator=gen, dtype=torch.float64).to(dtype).cuda()
    a = torch.randn(m, k, generator=gen, dtype=torch.float64).to(dtype).cuda()
    got = fc.syrk_downdate(c, a, tile, uplo=uplo)
    torch.cuda.synchronize()
    want = fc.syrk_downdate_plain(c, a, uplo=uplo)
    want64 = c.double() - a.double() @ a.double().T
    err, rel = rel_err(torch.tril(got), torch.tril(want))
    _, rel64 = rel_err(torch.tril(got).double(), torch.tril(want64))
    if uplo == "L":
        upper_ok = torch.equal(torch.triu(got, 1), torch.triu(c, 1))
        upper = f"upper == C {upper_ok}"
    else:
        err_u, rel_u = rel_err(torch.triu(got, 1), torch.triu(want, 1))
        _, rel64_u = rel_err(torch.triu(got, 1).double(), torch.triu(want64, 1))
        err, upper_ok = max(err, err_u), max(rel_u, rel64_u) <= TOL_LARGE[dtype]
        upper = f"upper max_abs_err {err_u:.3e} rel {rel_u:.3e} (vs f64 product {rel64_u:.3e})"
    same = torch.equal(fc.syrk_downdate(c, a, tile, uplo=uplo), got)
    ms = cuda_ms(lambda: fc.syrk_downdate(c, a, tile, uplo=uplo))
    plain_ms = cuda_ms(lambda: fc.syrk_downdate_plain(c, a, uplo=uplo))
    lib_ms = cuda_ms(lambda: torch.addmm(c, a, a.T, alpha=-1))
    # the same calls each issued to an idle card: what a lone caller waits
    call_ms = cuda_ms(lambda: fc.syrk_downdate(c, a, tile, uplo=uplo), queued=False)
    lib_call_ms = cuda_ms(lambda: torch.addmm(c, a, a.T, alpha=-1), queued=False)
    # the function's least work (either uplo: A A^T is symmetric): read C
    # and A, write C; m(m+1)/2 entries of K products
    bnd, by = bound((2.0 * m * m + m * k) * size, float(m) * (m + 1) * k, dtype)
    print(f"syrk_downdate {str(dtype)[6:]} M={m} K={k} tile={tile} uplo={uplo}: lower max_abs_err "
          f"{err:.3e} rel {rel:.3e} (vs f64 product {rel64:.3e}), {upper}, "
          f"deterministic {same}  ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {lib_ms:.4f}  "
          f"bound_ms {bnd:.5f} ({by})  idle-card call: ms {call_ms:.4f} library_ms "
          f"{lib_call_ms:.4f}", flush=True)
    check(rel <= TOL_LARGE[dtype], f"syrk_downdate {dtype} M={m} K={k}: rel err {rel}")
    check(rel64 <= TOL_LARGE[dtype], f"syrk_downdate {dtype} M={m} K={k} vs f64: {rel64}")
    check(upper_ok, f"syrk_downdate {dtype} M={m} K={k} uplo={uplo}: strictly-upper part wrong")
    check(same, f"syrk_downdate {dtype} M={m} K={k}: two calls differ")
    return err, ms, plain_ms, lib_ms, bnd, by


def syrk_sweep(fc, gen, dtype) -> None:
    """What a ``syrk_downdate`` call's time is made of: the card's time at
    M=1024 for K from 32 to 512 (the slope is the K loop, the rest is fixed)
    and at M=128, K=32 (four tiles: launch and one CTA's chain), beside
    ``addmm`` and a copy of C (``clone``: the bytes' floor with a launch)."""
    for m, k in [(128, 32), (1024, 32), (1024, 128), (1024, 512)]:
        c = torch.randn(m, m, generator=gen, dtype=torch.float64).to(dtype).cuda()
        a = torch.randn(m, k, generator=gen, dtype=torch.float64).to(dtype).cuda()
        ms = cuda_ms(lambda: fc.syrk_downdate(c, a, 128, uplo="L"))
        lib_ms = cuda_ms(lambda: torch.addmm(c, a, a.T, alpha=-1))
        clone_ms = cuda_ms(c.clone)
        print(f"syrk_downdate sweep {str(dtype)[6:]} M={m} K={k}: ms {ms:.4f}  library_ms "
              f"{lib_ms:.4f}  clone_ms {clone_ms:.4f}", flush=True)


def large_front_syrk_shapes(symb) -> list:
    """(M, K) of every syrk_downdate the large-front route launches for
    ``symb``'s fronts: per outer panel of a padded front above
    VMEM_FRONT_MAX, M = trailing order, K = panel width."""
    from repro_torch.kernels import ops

    shapes = []
    for sn in symb.supernodes:
        mp, nbp = ops.padded_shape(len(sn.rows), len(sn.cols))
        if mp <= ops.VMEM_FRONT_MAX:
            continue
        for k0 in range(0, nbp, ops.OUTER_PANEL):
            pw = min(ops.OUTER_PANEL, nbp - k0)
            if mp - k0 - pw > 0:
                shapes.append((mp - k0 - pw, pw))
    return shapes


def phase_kernels(fc) -> dict:
    """Every kernel against its plain version on the card, f32 and f64;
    returns the per-kernel records (the main path's f64 shape first, the
    other shapes and types under ``other_cases``)."""
    from repro_torch.kernels.ref import panel_factor_ref

    gen = torch.Generator().manual_seed(0)
    rec, clusters = {}, []
    for dtype in (torch.float32, torch.float64):
        for mp in (256, 1024, 1152):
            cs, room = fc.cluster_room(mp, dtype, torch.device("cuda"))
            print(f"cluster {str(dtype)[6:]} mp={mp}: {cs} CTAs per cluster, "
                  f"{room} clusters resident at once", flush=True)
            clusters.append(dict(dtype=str(dtype)[6:], mp=mp, ctas=cs, max_active_clusters=room))
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
            kernel_row(rec, "front_factor", dtype, dict(shape=[b, mp, mp], nbp=nbp), err, ms,
                       plain_ms, lib_ms, bnd, by, dtype == torch.float64 and mp == 256)
        for mp, nb in [(1152, 128), (1152, 256), (1152, 512)]:
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
            kernel_row(rec, "panel_factor", dtype, dict(shape=[mp, nb]), err, ms, plain_ms,
                       lib_ms, bnd, by, dtype == torch.float64 and nb == 256)
        for m, k, tile in [(1024, 128, 256), (896, 256, 128)]:
            row = syrk_case(fc, gen, dtype, m, k, tile)
            kernel_row(rec, "syrk_downdate", dtype, dict(shape=[m, k], tile=tile, uplo="L"),
                       *row, dtype == torch.float64 and m == 1024)
        # the default, the reference's full result (off the main path), at
        # the same shapes and at a K that is not a multiple of 32
        for m, k, tile in [(1024, 128, 256), (896, 256, 128), (1024, 40, 256)]:
            row = syrk_case(fc, gen, dtype, m, k, tile, uplo=None)
            kernel_row(rec, "syrk_downdate", dtype, dict(shape=[m, k], tile=tile, uplo="full"),
                       *row, False)
        syrk_sweep(fc, gen, dtype)
    rec["front_factor"]["clusters"] = clusters
    return rec


# phase 6's cases: (dtype, causal, Dh, (B, T, H)); B=2, T=4096, H=32 unless
# given
FLASH_CASES = [
    (torch.float32, True, 128), (torch.bfloat16, True, 128), (torch.bfloat16, True, 64),
    (torch.float32, False, 128), (torch.float32, True, 96), (torch.bfloat16, True, 96),
    (torch.float32, True, 80), (torch.bfloat16, True, 80), (torch.float32, True, 64),
    (torch.float32, True, 192), (torch.bfloat16, True, 192),
    (torch.float32, True, 256), (torch.bfloat16, True, 256),
    # f16 and f64 run in f32 (the reference's semantics); Dh=76 padded to
    # 80; Dh=320 and 512 on the cluster route; B*H past 65535; simt past the
    # cluster's reach
    (torch.float16, True, 128), (torch.float64, True, 128),
    (torch.float32, True, 76), (torch.bfloat16, True, 76),
    (torch.float32, True, 320), (torch.bfloat16, True, 320),
    (torch.float32, True, 512), (torch.bfloat16, True, 512),
    (torch.float32, True, 192, (2, 64, 32800)), (torch.bfloat16, True, 192, (2, 64, 32800)),
    (torch.float32, True, 320, (2, 64, 32800)), (torch.bfloat16, True, 320, (2, 64, 32800)),
    (torch.float32, True, 4104, (1, 256, 2)),
]


def expected_route(dtype, dh: int) -> str:
    """The route rule, written out apart from ``route``: the tensor-core
    kernel of the type computed in up to a padded Dh of 256, the cluster
    route up to 4096, simt past it."""
    p = -(-dh // 8) * 8
    if p <= 256:
        return "wgmma_tma" if dtype == torch.bfloat16 else "mma_3xtf32"
    return "tc_cluster" if p <= 4096 else "simt"


def compare(got: torch.Tensor, want: torch.Tensor, rtol: float) -> tuple[float, float, float]:
    """(max |got - want|, max(|got - want| - rtol |want|), share of the
    elements not bit-equal), in f64, over chunks of 2^26 elements (the
    large-B*H outputs take GBs)."""
    err, excess, unequal = 0.0, -float("inf"), 0
    for g, w in zip(got.reshape(-1).split(1 << 26), want.reshape(-1).split(1 << 26)):
        d = (g.double() - w.double()).abs()
        err = max(err, float(d.max()))
        excess = max(excess, float((d - rtol * w.double().abs()).max()))
        unequal += int((g != w).sum())
    return err, excess, unequal / got.numel()


def phase_flash(fa) -> dict:
    """The flash-attention kernels at qwen3-4b's attention widths and
    train_4k length (and Dh=64, the other head dim of the repo's configs;
    Dh=80, zamba2-2.7b's (d_model 2560 over 32 heads), Dh=96 and Dh=76 run
    padded in the tensor-core kernels; Dh=192 and 256 in their wide tiles;
    Dh=320 and 512, wider than those, the cluster route; Dh=4104, past its
    reach, the simt kernel by 128-column chunks of O; f16 and f64 run in
    f32; B*H = 65600 at T=64).  For each case the public
    function runs once with the counters set to 0 (the path run: its route
    counter must read 1), then against its plain version on the same
    inputs, then timed.  Returns one record per route: its first case, the
    others under ``other_cases`` and the path runs' launches of that
    route."""
    gen = torch.Generator().manual_seed(1)
    gen_card = torch.Generator(device="cuda").manual_seed(2)  # the large-B*H inputs (GBs)
    qkv32 = {}
    recs = {}
    for dtype, causal, dh, *shape in FLASH_CASES:
        b, t, h = shape[0] if shape else (2, 4096, 32)
        if (b, t, h, dh) not in qkv32:
            if shape:  # the large-B*H inputs take GBs: only this shape's are kept
                for key in [key for key in qkv32 if key[2] > 32]:
                    del qkv32[key]
                torch.cuda.empty_cache()
            qkv32[(b, t, h, dh)] = [
                torch.randn(b, t, h, dh, generator=gen_card, device="cuda") if shape
                else torch.randn(b, t, h, dh, generator=gen).cuda() for _ in range(3)]
        q, k, v = (x.to(dtype) for x in qkv32[(b, t, h, dh)])
        route = fa.route(dtype, dh)
        room = ""
        if route == "tc_cluster":  # before the path run (sets the kernel's attributes)
            ctas, clusters = fa.cluster_room(dtype, dh, torch.device("cuda"))
            check(ctas == fa.cluster_shape(dh)[0] and clusters >= 1,
                  f"flash {dtype} Dh={dh}: cluster of {ctas}, {clusters} resident")
            room = f"; cluster {ctas} CTAs, {clusters} clusters resident at once"
        fa.reset_counters()
        got = fa.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        path_launches, path_plain = fa.LAUNCHES["flash_attention"], fa.PLAIN_RUNS["flash_attention"]
        routes = dict(fa.ROUTE_LAUNCHES)
        check(path_launches > 0, f"flash {dtype} causal={causal}: kernel never launched")
        check(path_plain == 0, f"flash {dtype} causal={causal}: plain version ran")
        check(routes == {r: int(r == route) for r in fa.ROUTES},
              f"flash {dtype} Dh={dh}: routes {routes}, expected {route}")
        check(route == expected_route(dtype, dh),
              f"flash {dtype} Dh={dh}: route {route}, the rule names {expected_route(dtype, dh)}")
        check(got.dtype == dtype and got.shape == q.shape, f"flash {dtype} Dh={dh}: output")
        want = fa.flash_attention_plain(q, k, v, causal)
        # f32 math (f32; f64, computed in f32 as the reference does): the
        # reference's attention tolerance.  bf16, f16: the same f32 math
        # (within that tolerance), then one rounding each, so element by
        # element at most 2 ulps of the element: eps * |want| + 2e-5
        rtol = (torch.finfo(dtype).eps if dtype in (torch.bfloat16, torch.float16) else 0.0)
        tol = 2e-5
        err, excess, not_equal = compare(got, want, rtol)  # excess must stay <= tol
        same = torch.equal(fa.flash_attention(q, k, v, causal), got)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal), reps=3, warm=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # the library call of the same function: f16 and f64 inputs converted
        # to f32 on the way in and back on the way out, as the port does
        # (SDPA in the input type itself computes another function: kept
        # apart as library_native_ms)
        lib_native_ms = None
        if dtype in (torch.float16, torch.float64):
            lib_ms = cuda_ms(lambda: sdpa(qt.float(), kt.float(), vt.float(),
                                          is_causal=causal).to(dtype))
            lib_native_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
        else:
            lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
        pairs = t * (t + 1) / 2 if causal else float(t * t)  # query-key pairs visited
        flops = 4.0 * b * h * dh * pairs
        nbytes = 4.0 * b * t * h * dh * (torch.finfo(dtype).bits // 8)
        # the least time for the same work on the card (the true Dh): bf16
        # and f16 inputs on the 16-bit tensor cores (an f32-accurate result
        # is reachable there: the bf16 route splits P in two terms); f32
        # math on f32 and f64 inputs (as the reference computes) the faster
        # of the CUDA cores and three TF32 products
        t_ops = (flops / PEAK_BF16_TENSOR if dtype in (torch.bfloat16, torch.float16)
                 else min(flops / PEAK_FLOPS[torch.float32], 3 * flops / PEAK_TF32_TENSOR))
        t_bytes = nbytes / PEAK_BYTES
        bnd, by = (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")
        # the kernel's own design, at the work it issues: Dh padded to a
        # multiple of 8; the tensor-core kernels run QK^T over it rounded up
        # to their k-step (16 wgmma, 8 mma.sync) and PV at the padded tile
        # width (64, 128, 192 or 256); the cluster route QK^T once and PV
        # over its blocks' shares (nc x 192 or 256 columns); bf16 runs PV
        # twice (P split in two), f32 three TF32 passes of each; simt f32
        # math on the CUDA cores, QK^T once per 128-column chunk of O
        dhp = fa.padded_dh(dh)
        dh_tile = next((w for w in (64, 128, 192, 256) if dhp <= w), dhp)
        chunks = -(-dhp // 128) if route == "simt" else 1
        nc, share = fa.cluster_shape(dh) if route == "tc_cluster" else (1, dh_tile)
        qk_width = {"wgmma_tma": -(-dhp // 16) * 16, "mma_3xtf32": dhp, "tc_cluster": nc * share,
                    "simt": dhp * chunks}[route]
        qk_flops = 2.0 * b * h * pairs * qk_width
        pv_flops = 2.0 * b * h * pairs * (dhp if route == "simt" else nc * share)
        bf16_route = fa.KERNEL_DTYPE[dtype] == torch.bfloat16
        design_ms = 1e3 * (
            (qk_flops + pv_flops) / PEAK_FLOPS[torch.float32] if route == "simt"
            else (qk_flops + 2 * pv_flops) / PEAK_BF16_TENSOR if bf16_route
            else 3 * (qk_flops + pv_flops) / PEAK_TF32_TENSOR)
        tile = {"simt": f" ({chunks} chunks of O)" if chunks > 1 else "",
                "tc_cluster": f" ({nc} shares of {share}{room})"}.get(route, f" (tile {dh_tile})")
        print(f"flash_attention {str(dtype)[6:]} causal={causal} B={b} T={t} H={h} Dh={dh} "
              f"route {route}{tile}: max_abs_err {err:.3e} (elementwise |err| <= {rtol:.4g}*|ref| + "
              f"{tol:.0e}: excess {excess:.3e}; not bit-equal {not_equal:.4f}; deterministic "
              f"{same})  ms {ms:.4f}  plain_ms {plain_ms:.3f}  library_ms {lib_ms:.4f}"
              + (f" (in f32; SDPA in {str(dtype)[6:]} {lib_native_ms:.4f})"
                 if lib_native_ms is not None else "") + "  "
              f"bound_ms {bnd:.4f} ({by})  design bound_ms {design_ms:.4f}  "
              f"x_library {ms / lib_ms:.2f}  launches {path_launches}", flush=True)
        check(excess <= tol, f"flash {dtype} Dh={dh} causal={causal}: err beyond {rtol}*|ref| "
              f"{excess} > {tol}")
        check(same, f"flash {dtype} Dh={dh} causal={causal}: two calls differ")
        check(ms >= bnd, f"flash {dtype} Dh={dh}: {ms} ms under the bound {bnd} ms")
        case = dict(dtype=str(dtype)[6:], causal=causal, shape=[b, t, h, dh], kernel=route,
                    dh_tile=dhp if route == "simt" else share, o_chunks=chunks,
                    max_abs_err=err, rtol=rtol, atol=tol, not_bit_equal=not_equal, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by,
                    design_bound_ms=design_ms, x_library=ms / lib_ms)
        if lib_native_ms is not None:
            case["library_native_ms"] = lib_native_ms
        if route == "tc_cluster":
            case.update(cluster_ctas=ctas, max_active_clusters=clusters)
        if route not in recs:
            recs[route] = dict(case, launches=0)
        else:
            recs[route].setdefault("other_cases", []).append(case)
        recs[route]["launches"] += path_launches
        del q, k, v, qt, kt, vt, got, want
    return recs


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


def counted(fc, what: str, run, kernels=("front_factor",)):
    """``run()`` with the frontal kernels' counters set to 0 just before and
    read just after: each of ``kernels`` must have launched, no plain
    version may have run.  Returns (run's result, launches)."""
    fc.reset_counters()
    out = run()
    torch.cuda.synchronize()
    launches, plain = dict(fc.LAUNCHES), dict(fc.PLAIN_RUNS)
    for k in kernels:
        check(launches[k] > 0, f"{what}: {k} never launched")
    check(all(v == 0 for v in plain.values()), f"{what}: plain versions ran: {plain}")
    return out, launches


def same_panels(f1, f2) -> bool:
    """Two factors of one symbolic analysis, bit for bit."""
    return len(f1.panels) == len(f2.panels) and all(
        np.array_equal(x, y) for x, y in zip(f1.panels, f2.panels))


def phase_facade(fc, fact3, report3, wall3: float) -> dict:
    """The facade at full size (Poisson 200, f64), then optimize on Poisson
    60, then the demo; counters set to 0 just before each run, read just
    after."""
    from repro_torch import demo
    from repro_torch.api import DeviceMesh, Session
    from repro_torch.sparse import grid_laplacian_2d, nested_dissection_2d

    g, g_opt = 200, 60
    t0 = time.perf_counter()
    sess = Session(DeviceMesh(plan_devices=256)).analyze(
        grid_laplacian_2d(g), alpha=0.9, ordering=nested_dissection_2d(g)).plan("greedy")
    t1 = time.perf_counter()
    # the process is warm from phases 3-5 (library loaded, every shape class
    # run), so each counted execute skips the executor's warmup: the counts
    # are the runs' own dispatches, and the wall compares with phase 3's
    rep, launches = counted(fc, "phase 7",
                            lambda: sess.execute(dtype=torch.float64, warmup=False))
    wall = time.perf_counter() - t1
    res = residual(rep.artifact, sess.problem.matrix)
    same = same_panels(rep.artifact, fact3)
    print(f"[7 session poisson200 f64] analyze+plan {t1 - t0:.2f} s, execute wall {wall:.3f} s "
          f"(warmup skipped; phase 3: {wall3:.3f} s), measured makespan {rep.makespan:.3f} s (phase 3: "
          f"{report3.measured_makespan:.3f} s), n_dispatches {rep.metrics['n_dispatches']:.0f}, "
          f"residual {res:.3e}, launches {launches}, panels == phase 3 bit for bit: {same}",
          flush=True)
    check(res <= 1e-12, f"phase 7 residual {res}")
    check(same, "phase 7: Session panels differ from phase 3's")

    def session60():
        return Session(DeviceMesh(plan_devices=256)).analyze(
            grid_laplacian_2d(g_opt), alpha=0.9, ordering=nested_dissection_2d(g_opt))

    plain_sess = session60().plan("greedy")
    n_fronts = plain_sess.problem.n
    base, base_launches = counted(
        fc, "phase 7 unoptimized", lambda: plain_sess.execute(dtype=torch.float64, warmup=False))
    opt_sess = session60().optimize(max_front=64).plan("greedy")
    opt, opt_launches = counted(
        fc, "phase 7 optimized", lambda: opt_sess.execute(dtype=torch.float64, warmup=False))
    same60 = same_panels(base.artifact, opt.artifact)
    n_opt = opt.metrics["n_dispatches"]
    # a finding, not a check: the unoptimized async runner already batches
    # same-shape fronts across the tree, so the optimized plan may dispatch more
    print(f"[7 optimize poisson60 f64] fronts {n_fronts} -> tasks {opt_sess.problem.n}; "
          f"dispatches {n_opt:.0f} optimized vs {base.metrics['n_dispatches']:.0f} unoptimized "
          f"(async, shape-class batching); makespan {opt.makespan:.3f} s vs {base.makespan:.3f} s; "
          f"front_factor launches {opt_launches['front_factor']} vs {base_launches['front_factor']}; "
          f"bit-identical: {same60}", flush=True)
    check(same60, "phase 7: optimized factor differs from the unoptimized one")

    demo_res, demo_launches = counted(fc, "phase 7 demo", lambda: demo.main(warmup=False))
    print(f"[7 demo] residual {demo_res:.3e}, launches {demo_launches}", flush=True)
    return {
        "session_poisson200_f64": {"wall_s": wall, "makespan_s": rep.makespan,
                                   "n_dispatches": rep.metrics["n_dispatches"],
                                   "residual": res, "launches": launches},
        "optimize_poisson60_f64": {"fronts": n_fronts, "tasks": opt_sess.problem.n,
                                   "dispatches_opt": n_opt,
                                   "dispatches_unopt": base.metrics["n_dispatches"],
                                   "makespan_opt_s": opt.makespan,
                                   "makespan_unopt_s": base.makespan,
                                   "launches_opt": opt_launches, "launches_unopt": base_launches},
        "demo": {"residual": demo_res, "launches": demo_launches},
    }


def phase_online(fc, ap4, symb4, fact4, fact5) -> dict:
    """The online path on the card (f64, planned for 256 devices; the
    executors skip their warmup: phases 4-5 ran every shape class):
    (a) ``execute_online`` on phase 4's matrix and symbolic analysis, the
    online run's host seconds (its report's ``host_s``) and the rest of
    the call (projected plan and executor) apart, its L panels
    bit for bit phase 4's; (b) ``Session.analyze(Poisson 60)
    .plan("online")`` then ``execute`` in async and waves mode, bit for bit
    each other and phase 5's factor; (c) ``Session.simulate()`` and
    ``Session.serve`` of a Poisson-arrival stream of the same Problem, at
    most two trees admitted at once (the host, in virtual time: two trees
    share the capacity and the third waits in the admission queue).  Counters set to 0 before each run on the
    card, read after: every frontal kernel of the path launched, no plain
    version ran."""
    from repro_torch.api import DeviceMesh, Session
    from repro_torch.online import execute_online, poisson_arrivals
    from repro_torch.sparse import grid_laplacian_2d, nested_dissection_2d

    t0 = time.perf_counter()
    (fact, rep, online), launches_a = counted(
        fc, "phase 8a", lambda: execute_online(ap4, symb4, 256, 0.9, dtype=torch.float64,
                                               warmup=False), kernels=fc.KERNELS)
    wall = time.perf_counter() - t0
    online.validate()
    res = residual(fact, ap4)
    same4 = same_panels(fact, fact4)
    print(f"[8a execute_online random_spd2500 f64] wall {wall:.3f} s: online run (host) "
          f"{online.host_s:.3f} s, projected plan + executor {wall - online.host_s:.3f} s "
          f"(executor's measured makespan {rep.measured_makespan:.3f} s); events "
          f"{online.n_events}, re-shares {online.n_reshares}, dispatches {rep.n_dispatches}, "
          f"residual {res:.3e}, launches {launches_a}, panels == "
          f"phase 4 bit for bit: {same4}", flush=True)
    check(res <= 1e-12, f"phase 8a residual {res}")
    check(same4, "phase 8a: execute_online panels differ from phase 4's")

    g = 60
    t0 = time.perf_counter()
    sess = Session(DeviceMesh(plan_devices=256)).analyze(
        grid_laplacian_2d(g), alpha=0.9, ordering=nested_dissection_2d(g))
    analyze_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess.plan("online")
    plan_s = time.perf_counter() - t0
    runs, launches_b, walls = {}, {}, {}
    for mode in ("async", "waves"):
        t3 = time.perf_counter()
        runs[mode], launches_b[mode] = counted(
            fc, f"phase 8b {mode}",
            lambda: sess.execute(dtype=torch.float64, mode=mode, warmup=False))
        walls[mode] = time.perf_counter() - t3
    res_b = residual(runs["async"].artifact, sess.problem.matrix)
    modes_same = same_panels(runs["async"].artifact, runs["waves"].artifact)
    same5 = same_panels(runs["async"].artifact, fact5)
    print(f"[8b session poisson60 online f64] analyze {analyze_s:.3f} s, plan('online') (host) "
          f"{plan_s:.3f} s, execute wall async {walls['async']:.3f} s / waves "
          f"{walls['waves']:.3f} s, makespan {runs['async'].makespan:.3f} / "
          f"{runs['waves'].makespan:.3f} s, dispatches "
          f"{runs['async'].metrics['n_dispatches']:.0f} / {runs['waves'].metrics['n_dispatches']:.0f}, "
          f"residual {res_b:.3e}, launches {launches_b}, async == waves {modes_same}, "
          f"== phase 5 {same5}", flush=True)
    check(res_b <= 1e-12, f"phase 8b residual {res_b}")
    check(modes_same, "phase 8b: async and waves panels differ")
    check(same5, "phase 8b: online-planned panels differ from phase 5's")

    t0 = time.perf_counter()
    sim = sess.simulate()
    sim_s = time.perf_counter() - t0
    arrivals = poisson_arrivals(3, 0.5 * sim.makespan, seed=8)
    t0 = time.perf_counter()
    served = sess.serve([(sess.problem, float(a)) for a in arrivals], max_concurrent=2)
    serve_s = time.perf_counter() - t0
    sim.detail.validate()
    served.detail.validate()
    futs = list(served.detail.futures.values())
    done = all(f.state == "done" for f in futs)
    overlap = any(f.t_admit < g.t_done and g.t_admit < f.t_done
                  for i, f in enumerate(futs) for g in futs[i + 1:])
    waited = sum(f.t_admit > f.t_submit for f in futs)
    print(f"[8c simulate + serve poisson60] simulate (host) {sim_s:.3f} s: makespan "
          f"{sim.makespan:.6g}, fluid ratio {sim.metrics['fluid_ratio']:.12f}, events "
          f"{sim.metrics['n_events']:.0f}; serve of 3 Poisson arrivals, two trees at a time "
          f"(host) {serve_s:.3f} s: makespan {served.makespan:.6g}, fluid ratio "
          f"{served.metrics['fluid_ratio']:.6f}, mean latency {served.metrics['mean_latency']:.6g}, "
          f"mean service {served.metrics['mean_service']:.6g}; all done {done}, two trees at "
          f"once {overlap}, queued {waited}", flush=True)
    check(sim.makespan == sess.schedule.makespan, "phase 8c: simulate differs from plan('online')")
    check(abs(sim.metrics["fluid_ratio"] - 1.0) <= 1e-9, "phase 8c: simulate off the fluid bound")
    check(done and served.metrics["mean_latency"] >= served.metrics["mean_service"],
          "phase 8c: serve")
    check(overlap and waited > 0, "phase 8c: the requests never shared the card or queued")
    total = {k: launches_a[k] + sum(launches_b[m][k] for m in launches_b) for k in fc.KERNELS}
    return {
        "launches": total,
        "execute_online_random_spd2500_f64": {
            "wall_s": wall, "online_host_s": online.host_s,
            "plan_and_executor_s": wall - online.host_s, "makespan_s": rep.measured_makespan,
            "n_events": online.n_events, "n_reshares": online.n_reshares,
            "n_dispatches": rep.n_dispatches, "residual": res, "launches": launches_a},
        "session_online_poisson60_f64": {
            "plan_online_host_s": plan_s, "residual": res_b,
            "execute_wall_s": walls, "launches": launches_b,
            "makespan_s": {m: runs[m].makespan for m in runs},
            "n_dispatches": {m: runs[m].metrics["n_dispatches"] for m in runs}},
        "simulate_serve_poisson60": {
            "simulate_host_s": sim_s, "simulate_makespan": sim.makespan,
            "simulate_fluid_ratio": sim.metrics["fluid_ratio"], "serve_host_s": serve_s,
            "serve_makespan": served.makespan, "serve_fluid_ratio": served.metrics["fluid_ratio"],
            "serve_mean_latency": served.metrics["mean_latency"],
            "serve_overlap": overlap, "serve_queued": waited},
    }


def timed_method(obj, name: str, acc: dict) -> None:
    """Wrap ``obj.name`` so each call adds its host seconds to
    ``acc[name]`` (the scheduler loop is the only caller: no lock)."""
    fn = getattr(obj, name)
    acc[name] = 0.0

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[name] += time.perf_counter() - t0

    setattr(obj, name, wrapped)


def phase_cluster(fc, ap4, fact4, ap5, fact5, sim_makespan: float,
                  device: torch.device) -> dict:
    """The serving cluster on ``device`` (``cuda:0``) in f64 (the library is built and
    every shape class ran in phases 3-5).  (a) two workers x two slots,
    Poisson 60 (tenant 0) and random SPD 2500 (tenant 1) submitted at
    once, heartbeat timeout 10 s, under ``torch.profiler`` (kernels' device
    seconds against the wall; the scheduler loop's re-share and dispatch
    host seconds by wrapping its methods); (b) worker 1 killed after the
    first dispatch (the reference test's timings) on Poisson 60;
    (c) ``Session(DeviceMesh()).serve(cluster=2)`` of three Poisson 60
    arrivals (seed 8, as phase 8c) and ``save_html``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import DeviceMesh, Problem, Session
    from repro_torch.cluster import LocalCluster, leaked_threads
    from repro_torch.kernels import _build
    from repro_torch.online import poisson_arrivals

    cuda0 = [device]
    p60 = Problem.from_symbolic(fact5.symb, 0.9, matrix=ap5, name="poisson60")
    spd = Problem.from_symbolic(fact4.symb, 0.9, matrix=ap4, name="random_spd2500")

    # (a) two tenants at once
    host = {}
    with LocalCluster(n_workers=2, slots_per_worker=2, devices=cuda0, dtype=torch.float64,
                      heartbeat_timeout=10.0) as cl:
        for name in ("_reshare", "_dispatch"):
            timed_method(cl.scheduler, name, host)
        client = cl.client()

        def run_a():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                futs = [client.submit(p, tenant=t, rid=t) for t, p in enumerate((p60, spd))]
                results = client.gather(futs, timeout=600.0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            return results, wall, prof

        (results, wall_a, prof), launches_a = counted(fc, "phase 9a", run_a, fc.KERNELS)
        stats_a = cl.scheduler.stats()
        sizes = [b for w in cl.workers for b in w.batch_sizes]
        mix = list(cl.scheduler.batch_tenant_mix)
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e6
    device_s = sum(by_name.values())
    kernel_s = sum(v for k, v in by_name.items() if "Memcpy" not in k and "Memset" not in k)
    ok_a = all(r.ok for r in results)
    check(ok_a, f"phase 9a: results not ok: {[r.error for r in results]}")
    same = [same_panels(results[0].factor, fact5), same_panels(results[1].factor, fact4)]
    res_a = [residual(results[0].factor, ap5), residual(results[1].factor, ap4)]
    print(f"[9a cluster 2 workers x 2 slots on cuda:0, poisson60 + random_spd2500 f64] wall "
          f"{wall_a:.3f} s (under torch.profiler, CUDA activity): device time {device_s:.4f} s "
          f"(kernels {kernel_s:.4f} s), busy share {device_s / wall_a:.4f}; scheduler loop host "
          f"seconds: re-share {host['_reshare']:.3f} s over {stats_a['n_reshares']} re-shares "
          f"({host['_reshare'] / max(stats_a['n_reshares'], 1) * 1e3:.2f} ms each), dispatch "
          f"(assembly, padding, send) {host['_dispatch']:.3f} s; dispatches "
          f"{stats_a['n_dispatches']}, requeued {stats_a['n_requeued']}, worker losses "
          f"{stats_a['n_worker_losses']}; fronts per dispatch max {max(sizes)} mean "
          f"{np.mean(sizes):.2f}, cross-tenant dispatches {sum(m > 1 for m in mix)}; "
          f"launches {launches_a}; residuals {res_a[0]:.3e} / {res_a[1]:.3e}; panels == "
          f"phases 5 / 4 bit for bit: {same}", flush=True)
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        print(f"    {v * 1e3:10.3f} ms  {k[:90]}", flush=True)
    check(stats_a["n_requeued"] == 0, f"phase 9a: {stats_a['n_requeued']} fronts requeued")
    check(all(same), f"phase 9a: cluster panels differ from phases 5 / 4: {same}")
    check(max(res_a) <= 1e-12, f"phase 9a residuals {res_a}")
    check(max(sizes) > 1, "phase 9a: no dispatch carried more than one front")
    check(not leaked_threads(), f"phase 9a: threads left: {leaked_threads()}")

    # (b) one worker killed after the first dispatch
    with LocalCluster(n_workers=2, slots_per_worker=2, devices=cuda0, dtype=torch.float64,
                      tick=0.002, heartbeat_interval=0.03, heartbeat_timeout=0.2,
                      dispatch_overhead_s=0.05) as cl:
        client = cl.client()

        def run_b():
            t0 = time.perf_counter()
            fut = client.submit(p60, rid=0)
            deadline = time.monotonic() + 60.0
            while cl.scheduler.stats()["n_dispatches"] < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            cl.workers[1].kill()
            (res,) = client.gather([fut], timeout=600.0)
            return res, time.perf_counter() - t0

        (res_b, wall_b), launches_b = counted(fc, "phase 9b", run_b)
        stats_b = cl.scheduler.stats()
    same_b = res_b.ok and same_panels(res_b.factor, fact5)
    print(f"[9b cluster, worker 1 killed after the first dispatch, poisson60 f64] wall "
          f"{wall_b:.3f} s; dispatches {stats_b['n_dispatches']}, worker losses "
          f"{stats_b['n_worker_losses']}, requeued {stats_b['n_requeued']}, capacity events "
          f"{stats_b['n_capacity_events']}; launches {launches_b}; panels == phase 5 bit for "
          f"bit: {same_b}", flush=True)
    check(res_b.ok, f"phase 9b: {res_b.error}")
    check(stats_b["n_worker_losses"] >= 1, "phase 9b: no worker loss seen")
    check(same_b, "phase 9b: panels differ from phase 5's after a worker loss")

    # (c) the facade
    arrivals = poisson_arrivals(3, 0.5 * sim_makespan, seed=8)
    sess = Session(DeviceMesh())

    def run_c():
        t0 = time.perf_counter()
        rep = sess.serve([(p60, float(a)) for a in arrivals], cluster=2, dtype=torch.float64)
        return rep, time.perf_counter() - t0

    (rep_c, wall_c), launches_c = counted(fc, "phase 9c", run_c)
    html = _build.BUILD_DIR / "phase9_report.html"
    rep_c.save_html(html)
    m = rep_c.metrics
    same_c = all(same_panels(f, fact5) for f in (rep_c.artifact or {}).values())
    print(f"[9c Session(DeviceMesh()).serve(cluster=2), 3 poisson60 arrivals f64] wall "
          f"{wall_c:.3f} s: {rep_c.kind}, requests {m['n_requests']:.0f}, failed "
          f"{m['n_failed']:.0f}, qps {m['qps']:.4f}, p50 {m['p50_latency']:.3f} s, p99 "
          f"{m['p99_latency']:.3f} s, dispatches {m['n_dispatches']:.0f}, re-shares "
          f"{m['n_reshares']:.0f}; launches {launches_c}; factors == phase 5 bit for bit: "
          f"{same_c}; save_html {html.stat().st_size} B", flush=True)
    check(rep_c.kind == "served" and m["n_failed"] == 0, "phase 9c: serve failed")
    check(m["p99_latency"] >= m["p50_latency"] > 0, "phase 9c: latencies")
    check(len(rep_c.artifact) == 3 and same_c, "phase 9c: factors differ from phase 5's")
    check(html.stat().st_size > 0, "phase 9c: save_html wrote nothing")
    sess.close()
    check(not leaked_threads(), f"phase 9: threads left: {leaked_threads()}")
    total = {k: launches_a[k] + launches_b[k] + launches_c[k] for k in fc.KERNELS}
    return {
        "launches": total,
        "cluster_poisson60_random_spd2500_f64": {
            "wall_s": wall_a, "device_s": device_s, "kernel_s": kernel_s,
            "busy_share": device_s / wall_a, "reshare_host_s": host["_reshare"],
            "dispatch_host_s": host["_dispatch"], "n_reshares": stats_a["n_reshares"],
            "n_dispatches": stats_a["n_dispatches"], "n_requeued": stats_a["n_requeued"],
            "max_batch": max(sizes), "mean_batch": float(np.mean(sizes)),
            "residuals": res_a, "launches": launches_a},
        "cluster_kill_poisson60_f64": {
            "wall_s": wall_b, "n_worker_losses": stats_b["n_worker_losses"],
            "n_requeued": stats_b["n_requeued"], "n_dispatches": stats_b["n_dispatches"],
            "launches": launches_b},
        "serve_cluster_poisson60x3_f64": {
            "wall_s": wall_c, "qps": m["qps"], "p50_latency_s": m["p50_latency"],
            "p99_latency_s": m["p99_latency"], "n_dispatches": m["n_dispatches"],
            "n_reshares": m["n_reshares"], "launches": launches_c},
    }


def measure_rates(reps: int = 7) -> dict:
    """The card's two calibration rates: the dense bf16 ``torch.matmul`` rate
    at 8192³ (2·n³ operations) and the HBM bandwidth of a 1 GiB
    device-to-device copy (bytes read plus written), each from the median of
    ``reps`` CUDA-event timings."""
    n, nbytes = 8192, 2**30
    gen = torch.Generator(device="cuda").manual_seed(10)
    a = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.bfloat16)
    c = torch.empty_like(a)
    mm_ms = cuda_ms(lambda: torch.matmul(a, b, out=c), reps=reps)
    src = torch.ones(nbytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    cp_ms = cuda_ms(lambda: dst.copy_(src), reps=reps)
    check(torch.equal(dst, src), "phase 10d: the copy differs from its source")
    return {"matmul_bf16_8192_ms": mm_ms, "flop_rate": 2.0 * n**3 / (mm_ms * 1e-3),
            "copy_1gib_ms": cp_ms, "mem_bw": 2.0 * nbytes / (cp_ms * 1e-3)}


def phase_workloads(fc) -> dict:
    """The workload front end on the card.  (a) The paper's own workload
    (``configs/multifrontal.py``: the 63×63 grid, nested dissection,
    relax 2) through ``Session(DeviceMesh(plan_devices=256))
    .analyze_workload("multifrontal").plan("greedy").execute`` in the
    config's dtype (f32), counters set to 0 just before and read just after;
    its panels bit for bit those of the same grid through ``analyze``.
    (b) Every config of ``ARCHS`` at its published widths, and the serving
    pod qwen3-4b + rwkv6-1.6b: the ``h100`` calibration, a PM plan, §4
    validity, ``simulate`` equal to the plan (virtual time, on the host).
    (c) ``serve_online`` of eight qwen3-4b requests (Poisson, seed 5) on
    a 256-device pod, SJF; two-pod placement at 256 / 128.  (d) The
    ``h100`` calibration's two rates measured again, each within 1.5x of
    the constant in ``workloads/costs.py``."""
    from repro_torch.api import DeviceMesh, Session
    from repro_torch.configs import ARCHS, SOLVER
    from repro_torch.online import poisson_arrivals
    from repro_torch.serve.pod_scheduler import (
        Request,
        place_two_pods,
        place_two_pods_equal,
        serve_online,
    )
    from repro_torch.sparse import grid_laplacian_2d, nested_dissection_2d
    from repro_torch.workloads.costs import CALIBRATIONS

    # (a) the paper's workload; the process is warm from phase 5's f32 run
    dtype = getattr(torch, SOLVER.dtype)
    t0 = time.perf_counter()
    sess = Session(DeviceMesh(plan_devices=256)).analyze_workload("multifrontal").plan("greedy")
    t1 = time.perf_counter()
    rep, launches = counted(fc, "phase 10a", lambda: sess.execute(dtype=dtype, warmup=False))
    wall = time.perf_counter() - t1
    res = residual(rep.artifact, sess.problem.matrix)
    g = SOLVER.grid
    ref_sess = Session(DeviceMesh(plan_devices=256)).analyze(
        grid_laplacian_2d(g), SOLVER.alpha, ordering=nested_dissection_2d(g),
        relax=SOLVER.relax).plan("greedy")
    ref, ref_launches = counted(fc, "phase 10a analyze",
                                lambda: ref_sess.execute(dtype=dtype, warmup=False))
    same = same_panels(rep.artifact, ref.artifact)
    meta = sess.schedule.meta["workload"]
    print(f"[10a analyze_workload('multifrontal') grid {g} {SOLVER.dtype}] fronts "
          f"{sess.problem.n}, analyze+plan {t1 - t0:.2f} s, execute wall {wall:.3f} s, measured "
          f"makespan {rep.makespan:.3f} s, n_dispatches {rep.metrics['n_dispatches']:.0f}, "
          f"residual {res:.3e}, launches {launches}; panels == analyze path bit for bit: {same} "
          f"(its launches {ref_launches['front_factor']})", flush=True)
    check(res <= 1e-5, f"phase 10a residual {res}")
    check(same, "phase 10a: analyze_workload panels differ from the analyze path's")
    check(meta["kind"] == "sparse" and meta["grid"] == g, f"phase 10a: workload meta {meta}")

    # (b) every config at its published widths, then the serving pod
    zoo = {}
    t0 = time.perf_counter()
    for spec in sorted(ARCHS) + [["qwen3-4b", "rwkv6-1.6b"]]:
        key = spec if isinstance(spec, str) else "pod:" + "+".join(spec)
        s = Session(DeviceMesh(plan_devices=256)).analyze_workload(spec)
        prob = s.problem
        wmeta = prob.meta["workload"]
        check(wmeta["calibration"] == "h100", f"phase 10b {key}: calibration {wmeta['calibration']}")
        sched = s.plan("pm").schedule
        sched.validate(prob)
        sim = s.simulate()
        check(abs(sim.makespan - sched.makespan) <= 1e-9 * sched.makespan,
              f"phase 10b {key}: simulate {sim.makespan} != plan {sched.makespan}")
        if not isinstance(spec, str):
            root = int(np.flatnonzero(np.asarray(prob.tree.parent) == -1)[0])
            check(prob.tree.lengths[root] == 0.0, f"phase 10b {key}: pod root costs time")
        zoo[key] = {"kind": wmeta["kind"], "shape": wmeta.get("shape"), "n_tasks": prob.n,
                    "n_ops": wmeta["n_ops"], "virtual_makespan_s": sched.makespan}
        print(f"[10b {key}] {wmeta['kind']} {wmeta.get('shape')}: n_tasks {prob.n}, n_ops "
              f"{wmeta['n_ops']}, virtual makespan {sched.makespan:.6e} s", flush=True)
    zoo_s = time.perf_counter() - t0

    # (c) the pod scheduler
    t0 = time.perf_counter()
    cfg = ARCHS["qwen3-4b"]
    reqs = [Request(i, 1024 * (1 + i % 4)) for i in range(8)]
    report = serve_online(cfg, reqs, poisson_arrivals(8, 0.2, seed=5), pod_devices=256,
                          alpha=0.9, admission="sjf")
    report.validate()
    check(all(f.state == "done" for f in report.futures.values()), "phase 10c: a request unfinished")
    check({f.rid for f in report.futures.values()} == set(range(8)), "phase 10c: request ids")
    mk_eq, place_eq = place_two_pods_equal(cfg, reqs, 256, 0.9)
    mk_pq, place_pq = place_two_pods(cfg, reqs, 256, 128, alpha=0.9)
    check(set(place_eq) <= {0, 1} and set(place_pq) <= {0, 1}, "phase 10c: placements")
    serve_s = time.perf_counter() - t0
    # serve_online's times are virtual seconds at its 1e12 flop/s request
    # rate; the two-pod makespans are in the requests' unit, prefill flops
    print(f"[10c serve_online qwen3-4b x8 sjf] virtual makespan {report.makespan:.6f} s, mean "
          f"latency {report.mean_latency():.6f} s, utilization {report.utilization:.4f}; two "
          f"pods (makespan in flops) 256/256 {mk_eq:.6e} {place_eq}, 256/128 {mk_pq:.6e} "
          f"{place_pq}; host {serve_s:.3f} s", flush=True)

    # (d) the calibration's rates against the constants
    rates = measure_rates()
    cal = CALIBRATIONS["h100"]
    print(f"[10d] {nvidia_smi()}: bf16 matmul 8192^3 {rates['matmul_bf16_8192_ms']:.4f} ms = "
          f"{rates['flop_rate']:.4e} flop/s (h100 constant {cal.flop_rate:.4e}); 1 GiB copy "
          f"{rates['copy_1gib_ms']:.4f} ms = {rates['mem_bw']:.4e} B/s (constant "
          f"{cal.mem_bw:.4e})", flush=True)
    for key, const in (("flop_rate", cal.flop_rate), ("mem_bw", cal.mem_bw)):
        ratio = rates[key] / const
        check(1 / 1.5 <= ratio <= 1.5, f"phase 10d: measured {key} is {ratio:.3f}x the constant")
    return {
        "launches": {k: launches[k] + ref_launches[k] for k in fc.KERNELS},
        "workload_multifrontal_f32": {
            "grid": g, "fronts": sess.problem.n, "wall_s": wall, "makespan_s": rep.makespan,
            "n_dispatches": rep.metrics["n_dispatches"], "residual": res, "launches": launches,
            "same_as_analyze": same},
        "workload_zoo": {
            "configs": zoo, "host_s": zoo_s,
            "serve_online_qwen3_4b": {"virtual_makespan_s": report.makespan,
                                      "virtual_mean_latency_s": report.mean_latency(),
                                      "utilization": report.utilization, "host_s": serve_s},
            "two_pods": {"equal_makespan_flops": mk_eq, "equal_placement": place_eq,
                         "p256_q128_makespan_flops": mk_pq, "p256_q128_placement": place_pq},
            "calibration": {**rates, "h100_flop_rate": cal.flop_rate,
                            "h100_mem_bw": cal.mem_bw, "card": nvidia_smi()}},
    }


# ----------------------------------------------------------------------
# phase 11: the LM path
# ----------------------------------------------------------------------
LM_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}  # kernel vs blocked, / max|logit|
GEMM_NAMES = ("gemm", "gemv", "cutlass", "xmma")


@contextlib.contextmanager
def blocked_attention_only(attention):
    """Test hook: every full-sequence attention of the models takes
    ``blocked_attention`` (``takes_flash`` answers no) inside the block."""
    takes_flash = attention.takes_flash
    attention.takes_flash = lambda *args, **kw: False
    try:
        yield
    finally:
        attention.takes_flash = takes_flash


def flash_layers(cfg, t_dec: int, t_enc: int = 0) -> int:
    """Flash launches of one forward or prefill on the card, written out
    apart from the models: each causal self-attention (dense, vlm, moe; the
    hybrid's shared block once per group), the audio encoder's layers and,
    where the memory has the decoder's length, its cross-attention."""
    if cfg.family in ("dense", "vlm", "moe"):
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // (cfg.hybrid_attn_every or cfg.n_layers)
    if cfg.family == "audio":
        return cfg.n_encoder_layers + cfg.n_layers * (2 if t_enc == t_dec else 1)
    return 0


def flash_counts(fa) -> dict:
    torch.cuda.synchronize()
    return {"launches": fa.LAUNCHES["flash_attention"], "plain": fa.PLAIN_RUNS["flash_attention"],
            "routes": {r: n for r, n in fa.ROUTE_LAUNCHES.items() if n}}


def device_time_by_group(prof) -> tuple[dict, int]:
    """Device seconds of a profile: the flash kernel, the matmuls (cuBLAS
    and CUTLASS), copies and memsets, the rest (elementwise, reductions,
    softmax, gathers); and the count of device kernels and copies."""
    groups = {"flash": 0.0, "matmul": 0.0, "copy": 0.0, "other": 0.0}
    count = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key, s = e.key.lower(), e.self_device_time_total / 1e6
        group = ("flash" if "flash" in key else "matmul" if any(n in key for n in GEMM_NAMES)
                 else "copy" if "memcpy" in key or "memset" in key else "other")
        groups[group] += s
        count += e.count
    return groups, count


def lm_bounds(cfg, params, b: int, t: int, dtype) -> dict:
    """The least time the card could take (ms) for a prefill of ``b`` x
    ``t`` tokens and for one decode step after it, from the shapes: every
    weight read once, the K/V cache written (prefill) or read (decode) once
    in ``dtype``; the layers' matmuls (2 flops per weight per token), the
    causal attention (4·H·Dh per query-key pair) and the tied head on the
    last token, at the type's data-sheet rate (f32 on the CUDA cores:
    matmuls run without TF32)."""
    size = torch.finfo(dtype).bits // 8
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    matmul_params = sum(p.numel() for p in params["layers"].parameters() if p.ndim == 3)
    kv = 2 * cfg.n_layers * b * cfg.n_kv_heads * cfg.resolved_head_dim * size  # per position
    attn = 4 * cfg.padded_n_heads * cfg.resolved_head_dim * cfg.n_layers * b
    head = 2 * cfg.d_model * cfg.padded_vocab() * b
    rate = PEAK_BF16_TENSOR if dtype == torch.bfloat16 else PEAK_FLOPS[torch.float32]
    pre_flops = 2 * matmul_params * b * t + attn * t * (t + 1) / 2 + head
    pre_ms, pre_by = max((1e3 * (weight_bytes + kv * t) / PEAK_BYTES, "bytes"),
                         (1e3 * pre_flops / rate, "operations"))
    dec_ms = 1e3 * (weight_bytes + kv * (t + 1)) / PEAK_BYTES  # the flops are ~1000x fewer
    return {"weight_bytes": weight_bytes, "prefill_bound_ms": pre_ms, "prefill_bound_by": pre_by,
            "prefill_flops": pre_flops, "decode_step_bound_ms": dec_ms}


def lm_serve_case(dec, cfg, params, tokens, t0: int, steps: int, cache_dtype):
    """Prefill of ``tokens[:, :t0]`` on the card, the caches padded by
    ``steps``, then ``steps`` teacher-forced decode steps: (prefill logits,
    [decode logits], prefill s, decode s)."""
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    logits, cache = dec.prefill(cfg, params, tokens[:, :t0], remat=False, cache_dtype=cache_dtype)
    torch.cuda.synchronize()
    t_pre = time.perf_counter()
    for kk in ("k", "v"):
        cache[kk] = torch.nn.functional.pad(cache[kk], (0, 0, 0, 0, 0, steps))
    outs = []
    for i in range(steps):
        out, cache = dec.decode_step(cfg, params, cache, tokens[:, t0 + i : t0 + i + 1])
        outs.append(out)
    torch.cuda.synchronize()
    return logits, outs, t_pre - t_start, time.perf_counter() - t_pre


def eager_serve_tokens(cfg, batch, prompt, gen, device):
    """``launch.serve``'s greedy tokens without a mesh, decoded eagerly:
    its parameters (seed 0), prompts (seed 1) and attention block."""
    from repro_torch.models import build_decode_fn, build_prefill_fn, init_params, random_batch
    from repro_torch.models.decode import pad_caches

    params = init_params(cfg, 0, device=device)
    prompts = random_batch(cfg, batch, prompt, torch.Generator(device).manual_seed(1))
    logits, cache = build_prefill_fn(cfg, remat=False, attn_block=512)(params, prompts)
    cache = pad_caches(cache, gen, multiple=1)
    decode = build_decode_fn(cfg)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    outs = [tok]
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, tok)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        outs.append(tok)
    return torch.cat(outs, dim=1).cpu().numpy()


def phase_lm(fa) -> dict:
    """11. The LM path (``repro_torch.models``, ``launch/serve.py``).

    (a) ``repro_torch.launch.serve.main`` for qwen3-4b at full width (f32
    params from seed 0, as the reference launcher's), ``--batch 4 --prompt
    1024 --gen 32``: the prefill and decode walls, the peak of
    ``max_memory_allocated``; flash counters set to 0 just before, read
    just after: 36 launches (one per layer, ``mma_3xtf32``), no plain run.
    Its decode (one CUDA graph on the 1x1 mesh, replayed) gives the tokens
    of eager decode without a mesh, from the same parameters and prompts.
    (b) The same model in bf16 (``wgmma_tma``) and in f32: prefill of 4 x
    1024 tokens and 4 teacher-forced decode steps, once on the kernel path
    and once with every attention forced onto ``blocked_attention`` (the
    test hook ``blocked_attention_only``, 0 launches there); their logits
    within ``LM_TOL`` of max |logit| (f32 decisive); the f32 kernel path
    once more under ``torch.profiler``: device time of flash, the matmuls,
    copies and the rest against the wall, prefill and decode apart.
    (c) All ten ``cfg.reduced()`` archs in f32 (MoE at capacity 8, the
    reference test's): forward (flash launches as ``flash_layers`` says,
    logits within 1e-4 of the same params' forward on the CPU), loss, and
    prefill of 12 tokens + 3 decode steps, each within the reference's
    2e-4 of the teacher-forced forward."""
    import dataclasses
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve
    from repro_torch.models import attention, build_loss_fn, forward, init_params, random_batch
    from repro_torch.models import decode as dec
    from repro_torch.models.weights import params_from_numpy, params_to_numpy

    cuda = torch.device("cuda", 0)
    cfg = ARCHS["qwen3-4b"]
    out = {}

    # (a) the server at full width
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fa.reset_counters()
    res = serve.main(["--arch", "qwen3-4b", "--batch", "4", "--prompt", "1024", "--gen", "32"])
    counts = flash_counts(fa)
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    replay_ms = (res["decode_s"] - res["decode_setup_s"]) / 30 * 1e3
    print(f"[11a serve qwen3-4b f32 B=4 prompt 1024 gen 32] {nvidia_smi()}: prefill "
          f"{res['prefill_s']:.4f} s, decode {res['decode_s']:.4f} s (31 steps, "
          f"{res['decode_s'] / 31 * 1e3:.2f} ms/step; of it the first step and the graph's "
          f"capture {res['decode_setup_s']:.4f} s, then {replay_ms:.2f} ms a replayed step), "
          f"peak allocated {peak / 2**30:.3f} GiB (held before {base / 2**30:.3f}); "
          f"flash {counts}", flush=True)
    check(counts["launches"] == cfg.n_layers and counts["routes"] == {"mma_3xtf32": 36},
          f"phase 11a: flash launches {counts}, expected 36 on mma_3xtf32")
    check(counts["plain"] == 0, f"phase 11a: plain flash ran {counts}")
    check(toks.shape == (4, 32) and ((0 <= toks) & (toks < cfg.padded_vocab())).all(),
          f"phase 11a: tokens {toks.shape}")
    out["serve_qwen3_4b_f32"] = {
        "batch": 4, "prompt": 1024, "gen": 32, "prefill_s": res["prefill_s"],
        "decode_s": res["decode_s"], "decode_setup_s": res["decode_setup_s"],
        "decode_replay_ms": replay_ms, "peak_allocated_bytes": peak, "held_before_bytes": base,
        "flash": counts, "card": nvidia_smi()}
    del res
    # the server's decode (a CUDA graph on the 1x1 mesh) against eager decode
    # without a mesh, from the same parameters and prompts
    gc.collect()
    torch.cuda.empty_cache()
    want = eager_serve_tokens(cfg, 4, 1024, 32, cuda)
    same = bool(np.array_equal(toks, want))
    print(f"[11a] tokens == eager decode without a mesh: {same}", flush=True)
    check(same, "phase 11a: the server's tokens differ from eager decode without a mesh")
    out["serve_qwen3_4b_f32"]["tokens_equal_eager"] = same
    route_launches = dict.fromkeys(fa.ROUTES, 0)
    route_launches["mma_3xtf32"] += counts["launches"]

    # (b) kernel against blocked attention at full width, bf16 then f32
    t0, steps = 1024, 4
    tokens = random_batch(cfg, 4, t0 + steps, torch.Generator(cuda).manual_seed(1))["tokens"]
    out["kernel_vs_blocked"] = {}
    for dtype in (torch.bfloat16, torch.float32):
        gc.collect()
        torch.cuda.empty_cache()
        params = init_params(cfg, torch.Generator(cuda).manual_seed(0), dtype=dtype, device=cuda)
        runs = {}
        for path in ("kernel", "blocked"):
            fa.reset_counters()
            with blocked_attention_only(attention) if path == "blocked" else contextlib.nullcontext():
                runs[path] = lm_serve_case(dec, cfg, params, tokens, t0, steps, dtype)
            runs[path] += (flash_counts(fa),)
        rt = fa.route(dtype, cfg.resolved_head_dim)
        bounds = lm_bounds(cfg, params, 4, t0, dtype)
        kc, bc = runs["kernel"][4], runs["blocked"][4]
        check(kc["launches"] == cfg.n_layers and kc["routes"] == {rt: cfg.n_layers}
              and kc["plain"] == 0, f"phase 11b {dtype}: kernel path flash {kc}")
        check(bc["launches"] == 0 and bc["plain"] == 0, f"phase 11b {dtype}: blocked path {bc}")
        route_launches[rt] += kc["launches"]
        scale = float(runs["blocked"][0].float().abs().max())
        errs = [float((runs["kernel"][0].float() - runs["blocked"][0].float()).abs().max()) / scale]
        for got, want in zip(runs["kernel"][1], runs["blocked"][1]):
            errs.append(float((got.float() - want.float()).abs().max())
                        / float(want.float().abs().max()))
        finite = all(bool(torch.isfinite(x).all()) for r in runs.values() for x in [r[0], *r[1]])
        name = str(dtype)[6:]
        print(f"[11b qwen3-4b {name} B=4 T={t0}] kernel path: prefill {runs['kernel'][2]:.4f} s, "
              f"{steps} decode steps {runs['kernel'][3]:.4f} s; blocked path: prefill "
              f"{runs['blocked'][2]:.4f} s, decode {runs['blocked'][3]:.4f} s; max|logit| "
              f"{scale:.4f}; |kernel - blocked| / max|logit|: prefill {errs[0]:.3e}, decode "
              f"{', '.join(f'{e:.3e}' for e in errs[1:])} (tolerance {LM_TOL[dtype]:.0e}); "
              f"flash {kc}; weights {bounds['weight_bytes'] / 1e9:.3f} GB, bound: prefill "
              f"{bounds['prefill_bound_ms']:.4f} ms ({bounds['prefill_bound_by']}), decode "
              f"{bounds['decode_step_bound_ms']:.4f} ms a step (bytes)", flush=True)
        check(finite, f"phase 11b {name}: non-finite logits")
        check(max(errs) <= LM_TOL[dtype], f"phase 11b {name}: kernel vs blocked {max(errs)}")
        rec = {"prefill_s": {p: r[2] for p, r in runs.items()},
               "decode_4_steps_s": {p: r[3] for p, r in runs.items()},
               "max_abs_logit": scale, "rel_err_prefill": errs[0], "rel_err_decode": errs[1:],
               "tolerance": LM_TOL[dtype], "flash": kc, **bounds}
        if dtype == torch.float32:  # where the time goes: the kernel path under the profiler
            prof_rec = {}
            for part in ("prefill", "decode"):
                fa.reset_counters()
                if part == "prefill":
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        t_start = time.perf_counter()
                        _, cache = dec.prefill(cfg, params, tokens[:, :t0], remat=False,
                                               cache_dtype=dtype)
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t_start
                    for kk in ("k", "v"):
                        cache[kk] = torch.nn.functional.pad(cache[kk], (0, 0, 0, 0, 0, steps))
                else:
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        t_start = time.perf_counter()
                        for i in range(steps):
                            _, cache = dec.decode_step(cfg, params, cache,
                                                       tokens[:, t0 + i : t0 + i + 1])
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t_start
                route_launches[rt] += flash_counts(fa)["launches"]
                groups, n_kernels = device_time_by_group(prof)
                busy = sum(groups.values())
                prof_rec[part] = {"wall_s": wall, "device_s": busy, "busy_share": busy / wall,
                                  "device_s_by_group": groups, "device_kernels": n_kernels}
                print(f"[11b profiled f32 {part}] wall {wall:.4f} s, device {busy:.4f} s, busy "
                      f"share {busy / wall:.4f}, {n_kernels} device kernels and copies: " + ", ".join(
                          f"{g} {s * 1e3:.3f} ms" for g, s in groups.items()), flush=True)
            del cache
            rec["profile"] = prof_rec
        out["kernel_vs_blocked"][name] = rec
        if dtype == torch.float32:  # phase 13 (b) prefills the same under the 1x1 mesh
            out["f32_prefill"] = (tokens[:, :t0], runs["kernel"][0], runs["kernel"][2])
        del params, runs

    # (c) every architecture, reduced, f32
    out["reduced_archs"] = {}
    for name in sorted(ARCHS):
        cfg_r = ARCHS[name].reduced()
        if cfg_r.moe:
            cfg_r = dataclasses.replace(cfg_r, moe=dataclasses.replace(cfg_r.moe,
                                                                       capacity_factor=8.0))
        params = init_params(cfg_r, torch.Generator(cuda).manual_seed(0), device=cuda)
        batch = random_batch(cfg_r, 2, 15, torch.Generator(cuda).manual_seed(1))
        t_enc = batch["frames"].shape[1] if "frames" in batch else 0
        fa.reset_counters()
        logits, aux = forward(cfg_r, params, batch["tokens"], extra=batch, remat=False,
                              attn_block=8)
        loss = float(build_loss_fn(cfg_r, remat=False, attn_block=8)(params, batch))
        fwd_counts = flash_counts(fa)  # the forward's and the loss's
        cpu_params = params_from_numpy(cfg_r, params_to_numpy(params), "cpu")
        cpu_logits, _ = forward(cfg_r, cpu_params, batch["tokens"].cpu(),
                                extra={k: v.cpu() for k, v in batch.items()}, remat=False,
                                attn_block=8)
        _, cpu_err = rel_err(logits.cpu(), cpu_logits)
        # prefill 12 + 3 decode steps against the teacher-forced forward
        toks, t_p = batch["tokens"], 12
        extra = {k: (v[:, :t_p] if k == "frames" else v) for k, v in batch.items() if k != "tokens"}
        fa.reset_counters()
        _, cache = dec.prefill(cfg_r, params, toks[:, :t_p], extra=extra, remat=False,
                               attn_block=8, cache_dtype=torch.float32)
        pre_counts = flash_counts(fa)
        for kk in ("k", "v", "ak", "av", "xk", "xv"):
            if kk in cache:
                cache[kk] = torch.nn.functional.pad(cache[kk], (0, 0, 0, 0, 0, 3))
        dec_errs = []
        fa.reset_counters()
        for i in range(3):
            got, cache = dec.decode_step(cfg_r, params, cache, toks[:, t_p + i : t_p + i + 1])
            full, _ = forward(cfg_r, params, toks[:, : t_p + i + 1], extra=extra, remat=False,
                              attn_block=8)
            dec_errs.append(float((full[:, -1] - got[:, 0]).abs().max()))
        tf_counts = flash_counts(fa)
        launches = fwd_counts["launches"] + pre_counts["launches"] + tf_counts["launches"]
        route_launches["mma_3xtf32"] += launches
        want_fwd, want_pre = 2 * flash_layers(cfg_r, 15, t_enc), flash_layers(cfg_r, t_p, t_p)
        want_tf = sum(flash_layers(cfg_r, t_p + i + 1, t_p) for i in range(3))
        print(f"[11c {name} reduced f32] loss {loss:.6f}, aux {float(aux):.3e}; card vs CPU "
              f"forward {cpu_err:.3e}; decode vs teacher-forced forward "
              f"{', '.join(f'{e:.3e}' for e in dec_errs)}; flash launches forward + loss "
              f"{fwd_counts['launches']} (expected {want_fwd}), prefill {pre_counts['launches']} "
              f"({want_pre}), teacher-forced forwards {tf_counts['launches']} ({want_tf})",
              flush=True)
        check(bool(torch.isfinite(logits).all()) and np.isfinite(loss), f"phase 11c {name}: finite")
        check(cpu_err <= 1e-4, f"phase 11c {name}: card vs CPU forward {cpu_err}")
        check(max(dec_errs) < 2e-4, f"phase 11c {name}: decode continuation {dec_errs}")
        check((fwd_counts["launches"], pre_counts["launches"], tf_counts["launches"])
              == (want_fwd, want_pre, want_tf), f"phase 11c {name}: flash launches")
        check(all(c["plain"] == 0 for c in (fwd_counts, pre_counts, tf_counts)),
              f"phase 11c {name}: plain flash ran")
        check(cfg_r.family == "ssm" or launches > 0, f"phase 11c {name}: flash never launched")
        out["reduced_archs"][name] = {"loss": loss, "aux": float(aux), "card_vs_cpu": cpu_err,
                                      "decode_vs_forward": dec_errs, "flash_launches": launches}
        del params, cpu_params, cache
    out["flash_route_launches"] = route_launches
    return out


# ----------------------------------------------------------------------
# phase 12: the training path
# ----------------------------------------------------------------------
TRAIN_LAYERS = 12  # qwen3-4b's depth cut from 36: p, g, mu, nu in f32 + a 4096-token microbatch
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-4, "resume": 1e-6}  # (b) loss rel, grad / leaf max; (c)
BWD_PREFIX = "autograd::engine::evaluate_function: "


@contextlib.contextmanager
def train_ranges():
    """Profiler ranges around each ``blocked_attention`` call and each
    ``adamw_update`` of the train step (the module attributes are wrapped
    inside the block, so the models and the step call the wrappers)."""
    from torch.profiler import record_function

    from repro_torch.models import attention
    from repro_torch.train import train_step

    saved = {(attention, "blocked_attention"): attention.blocked_attention,
             (train_step, "adamw_update"): train_step.adamw_update}

    def ranged(name, fn):
        def wrapper(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return wrapper

    try:
        for (mod, name), fn in saved.items():
            setattr(mod, name, ranged(name, fn))
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def _with_descendants(ev):
    """An event and the events under it, without CUDA runtime calls (their
    ids count in another space than the ops')."""
    if ev.name.startswith("cu"):
        return
    yield ev
    for c in ev.cpu_children:
        yield from _with_descendants(c)


def train_time_by_group(prof) -> tuple[dict, dict]:
    """Device seconds of a profiled train step by group, each kernel and
    copy on the device timeline once, through the op that launched it:
    blocked attention (ops under a ``blocked_attention`` range, its remat
    recompute included, or under a backward node whose forward thread and
    sequence number its ops recorded), the optimizer (under ``adamw_update``), the other matmuls
    (cuBLAS / CUTLASS by name), copies and memsets, the rest; the busy time
    (the union of their intervals) and the counts behind the attribution."""
    ranges = ("blocked_attention", "adamw_update")
    cpu = torch.autograd.DeviceType.CPU
    events = [e for e in prof.events() if e.device_type == cpu and not e.name.startswith("cu")]
    attn_roots = [e for e in events if e.name == ranges[0]]
    # sequence numbers count per thread: the remat recompute's (on the
    # autograd thread) are not the numbers of the nodes backward runs
    seqs = {(d.thread, d.sequence_nr) for r in attn_roots for d in _with_descendants(r)
            if d.sequence_nr >= 0}
    attn_bwd = [e for e in events if e.name.startswith(BWD_PREFIX)
                and (e.fwd_thread, e.sequence_nr) in seqs]
    attn_fwd = {d.id for r in attn_roots for d in _with_descendants(r)}
    attn = attn_fwd | {d.id for r in attn_bwd for d in _with_descendants(r)}
    opt = {d.id for r in events if r.name == ranges[1] for d in _with_descendants(r)}
    groups = {"blocked_attention": 0.0, "optimizer": 0.0, "matmul": 0.0, "copy": 0.0,
              "other": 0.0}
    attn_fwd_s, spans = 0.0, []
    for k in prof.profiler.kineto_results.events():
        if k.device_type() == cpu or k.name() in ranges:  # host events; the ranges' annotations
            continue
        op, key, dur = k.linked_correlation_id(), k.name().lower(), k.duration_ns() / 1e9
        group = ("blocked_attention" if op in attn else "optimizer" if op in opt
                 else "matmul" if any(n in key for n in GEMM_NAMES)
                 else "copy" if "memcpy" in key or "memset" in key else "other")
        groups[group] += dur
        attn_fwd_s += dur if op in attn_fwd else 0.0
        spans.append((k.start_ns(), k.start_ns() + k.duration_ns()))
    union, reach = 0, -1
    for start, end in sorted(spans):
        union += max(0, end - max(start, reach))
        reach = max(reach, end)
    return groups, {"device_events": len(spans), "device_busy_s": union / 1e9,
                    "blocked_attention_forward_s": attn_fwd_s,
                    "attention_ranges": len(attn_roots), "attention_backward_nodes": len(attn_bwd)}


def _grads_close(got: dict, want: dict) -> float:
    """max over leaves of |got - want| / max|want| (the card's against the CPU's)."""
    worst = 0.0
    for (pg, g), (pw, w) in zip(got, want):
        check(pg == pw, f"gradient trees differ: {pg} vs {pw}")
        scale = float(w.abs().max())
        err = float((g.cpu() - w).abs().max())
        worst = max(worst, err / scale if scale else (0.0 if err == 0 else float("inf")))
    return worst


def phase_train(fa) -> dict:
    """12. The training path (``repro_torch.{train,data,checkpoint}``,
    ``launch/train.py``).

    (a) ``repro_torch.launch.train.main`` for qwen3-4b at its published
    widths, depth cut to ``TRAIN_LAYERS``, ``--seq 4096 --global-batch 2
    --microbatches 2 --steps 3``, f32 (no TF32): every loss finite; flash
    counters set to 0 just before, read just after: no launch and no plain
    run (under grad the models take ``blocked_attention``, as the
    reference trains through XLA's); step walls, tokens/s, model flop/s
    (``launch/roofline.model_flops``) against 67 TFLOP/s, peak
    ``max_memory_allocated``; the launcher runs on its 1x1 mesh (DTensor
    parameters and batch).  Then one more step of the same program on the
    1x1 mesh under ``torch.profiler``: busy share and device time by group.
    (b) Each of the ten ``cfg.reduced()`` archs: one step (microbatches 2)
    on cuda:0 and on the CPU from the same seeded weights and tokens: loss
    within 1e-5 relative, each gradient leaf within 1e-4 of its max |g|,
    parameters after the update within 2·lr; qwen2.5-3b reduced, 8 steps on
    one batch: the loss falls.
    (c) qwen3-4b reduced: 4 steps, ``save(4, async_save=True)``, step 5 at
    once (in place, while the thread writes), steps 6-7; a restore into
    fresh tensors equals the state at the save bit for bit, and steps 5-7
    from it give the uninterrupted losses within 1e-6 relative; the last
    loss is below the first.  Its tokens are drawn from 64 of the model's
    512 ids: uniform tokens over all 512 leave the model about 0.02 nats
    to learn, less than the loss moves from batch to batch."""
    import gc
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, SyntheticTokens, place, with_extras
    from repro_torch.distributed.constraints import active_mesh
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import smoke_mesh
    from repro_torch.launch.roofline import model_flops
    from repro_torch.models import init_params
    from repro_torch.models.common import tree_items
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.model import param_specs
    from repro_torch.models.weights import params_from_numpy, params_to_numpy
    from repro_torch.train import (
        OptConfig,
        adamw_update,
        build_train_step,
        build_value_and_grad,
        init_opt_state,
        init_train_state,
    )

    cuda = torch.device("cuda", 0)
    out = {}

    t_part = time.perf_counter()
    part_s = out["part_s"] = {}

    def part(name: str) -> None:
        nonlocal t_part
        part_s[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    # (a) the launcher at full width, depth cut
    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--arch", "qwen3-4b", "--layers", str(TRAIN_LAYERS), "--seq", "4096",
            "--global-batch", "2", "--microbatches", "2", "--steps", "3"]
    fa.reset_counters()
    res = launch_train.main(argv)
    counts = flash_counts(fa)
    cfg = res["cfg"]
    flops = model_flops(cfg, ShapeCell("train_cut", res["seq"], res["global_batch"], "train"))
    n_params = sum(p.numel() for p in param_specs(cfg).parameters())
    steady = min(res["step_s"][1:])
    rec = {"argv": argv, "layers": cfg.n_layers, "params": n_params, "losses": res["losses"],
           "step_s": res["step_s"], "tokens_per_step": res["tokens_per_step"],
           "tokens_per_s": [res["tokens_per_step"] / s for s in res["step_s"]],
           "model_flops_per_step": flops,
           "model_flops_per_s": [flops / s for s in res["step_s"]],
           "peak_bytes": res["peak_bytes"], "flash": counts, "cuts": res["cuts"]}
    print(f"[12a qwen3-4b train f32, {cfg.n_layers} layers, {n_params / 1e9:.3f} B params, "
          f"{res['global_batch']} x {res['seq']} tokens, 2 microbatches] losses "
          f"{', '.join(f'{x:.4f}' for x in res['losses'])}; step walls "
          f"{', '.join(f'{x:.3f}' for x in res['step_s'])} s; best {steady:.3f} s = "
          f"{res['tokens_per_step'] / steady:.0f} tokens/s, model flop/s {flops / steady:.4e} "
          f"({flops / steady / PEAK_FLOPS[torch.float32]:.3f} of 67 TFLOP/s; model flops "
          f"{flops:.4e} a step); peak allocated {res['peak_bytes'] / 1e9:.3f} GB; flash "
          f"launches {counts['launches']}, plain {counts['plain']}", flush=True)
    check(all(np.isfinite(res["losses"])), f"phase 12a: losses {res['losses']}")
    check(counts["launches"] == 0 and counts["plain"] == 0,
          f"phase 12a: flash ran under grad: {counts}")
    check(res["peak_bytes"] <= 60e9, f"phase 12a: peak {res['peak_bytes']} B past 60 GB")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    part("a_launcher")

    # where a step's time goes: one more step of the launcher's program on
    # its 1x1 mesh, profiled (the process is warm from the launcher's steps)
    step_fn = build_train_step(cfg, OptConfig(warmup_steps=5, total_steps=10), microbatches=2,
                               attn_block=512)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 4096, 2))
    with smoke_mesh(cuda) as mesh:
        params, opt, batch = mesh_train_state(cfg, data.batch_at(0), mesh)
        fa.reset_counters()
        torch.cuda.synchronize()
        with active_mesh(mesh), train_ranges(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_start = time.perf_counter()
            params, opt, stats = step_fn(params, opt, batch)
            loss = float(stats["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
    groups, meta = train_time_by_group(prof)
    busy = meta["device_busy_s"]
    prof_counts = flash_counts(fa)
    # the matmuls outside attention: 6 flops per parameter and token (the
    # tied head included) + the layers' remat forward, 2 per parameter
    check(groups["matmul"] > 0 and groups["blocked_attention"] > 0,
          f"phase 12a: the profile holds no matmul or no attention: {groups}")
    layer_params = sum(p.numel() for p in param_specs(cfg)["layers"].parameters())
    mm_flops = (6 * n_params + 2 * layer_params) * rec["tokens_per_step"]
    rec["profile"] = {"wall_s": wall, "busy_share": busy / wall, "device_s_by_group": groups,
                      **meta, "loss": loss, "matmul_flops": mm_flops,
                      "matmul_flops_per_s": mm_flops / groups["matmul"]}
    print(f"[12a profiled step] wall {wall:.4f} s, device busy {busy:.4f} s (the union of "
          f"{meta['device_events']} kernels and copies; their durations sum to "
          f"{sum(groups.values()):.4f} s), busy share {busy / wall:.4f} ("
          f"{meta['attention_ranges']} blocked_attention calls, "
          f"{meta['attention_backward_nodes']} of their backward nodes; their forwards "
          f"{meta['blocked_attention_forward_s'] * 1e3:.3f} ms): " + ", ".join(
              f"{g} {t * 1e3:.3f} ms" for g, t in groups.items())
          + f"; the other matmuls' {mm_flops:.4e} flop at {mm_flops / groups['matmul']:.4e} "
          f"flop/s", flush=True)
    check(np.isfinite(loss) and prof_counts["launches"] == 0 and prof_counts["plain"] == 0,
          f"phase 12a profiled step: loss {loss}, flash {prof_counts}")
    out["launcher_full_width"] = rec
    del params, opt, stats, batch, prof
    gc.collect()
    torch.cuda.empty_cache()
    part("a_profile")

    # (b) card against CPU, every reduced arch
    out["card_vs_cpu"] = {}
    ocfg = OptConfig(lr=1e-3, warmup_steps=0)
    for name in sorted(ARCHS):
        cfg_r = ARCHS[name].reduced()
        host = params_to_numpy(init_params(cfg_r, 0, device="cpu"))
        batch = with_extras(SyntheticTokens(DataConfig(cfg_r.vocab_size, 16, 4, seed=1))
                            .batch_at(0), cfg_r)
        vg = build_value_and_grad(cfg_r, microbatches=2, remat=True, attn_block=8)
        runs = {}
        fa.reset_counters()
        for dev in (cuda, torch.device("cpu")):
            params = params_from_numpy(cfg_r, host, dev)
            loss, grads = vg(params, place(batch, dev))
            params, _, _ = adamw_update(params, grads, init_opt_state(params), ocfg)
            runs[dev.type] = (float(loss), tree_items(grads), tree_items(params))
        counts = flash_counts(fa)
        (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = runs["cuda"], runs["cpu"]
        loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
        grad_err = _grads_close(g_gpu, g_cpu)
        p_err = max(float((a.cpu() - b).abs().max()) for (_, a), (_, b) in zip(p_gpu, p_cpu))
        print(f"[12b {name} reduced] loss card {l_gpu:.6f} CPU {l_cpu:.6f} ({loss_err:.3e} rel); "
              f"grads {grad_err:.3e} of the leaf max; params after the update {p_err:.3e} "
              f"(2 lr {2 * ocfg.lr:g}); flash {counts['launches']}", flush=True)
        check(loss_err <= TRAIN_TOL["loss"], f"phase 12b {name}: loss {loss_err}")
        check(grad_err <= TRAIN_TOL["grad"], f"phase 12b {name}: grads {grad_err}")
        check(p_err <= 2 * ocfg.lr, f"phase 12b {name}: params after the update {p_err}")
        check(counts["launches"] == 0 and counts["plain"] == 0, f"phase 12b {name}: flash {counts}")
        out["card_vs_cpu"][name] = {"loss_rel": loss_err, "grad_rel": grad_err,
                                    "params_after_update": p_err}
    cfg_r = ARCHS["qwen2.5-3b"].reduced()
    params, opt = init_train_state(cfg_r, 0, device=cuda)
    step = build_train_step(cfg_r, OptConfig(lr=5e-3, warmup_steps=0), attn_block=8)
    batch = place(SyntheticTokens(DataConfig(cfg_r.vocab_size, 16, 4, seed=2)).batch_at(0), cuda)
    losses = [float(step(params, opt, batch)[2]["loss"]) for _ in range(8)]
    print(f"[12b qwen2.5-3b reduced, 8 steps on one batch] losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}", flush=True)
    check(losses[-1] < losses[0], f"phase 12b: the loss did not fall: {losses}")
    out["overfit_losses"] = losses
    part("b_card_vs_cpu")

    # (c) restart on the card, the async save taken while the next step runs
    cfg_r = ARCHS["qwen3-4b"].reduced()
    data = SyntheticTokens(DataConfig(64, 16, 4, seed=3))  # 64 of the model's 512 tokens
    step = build_train_step(cfg_r, OptConfig(lr=3e-3, warmup_steps=0), microbatches=2,
                            attn_block=8)
    folder = _build.BUILD_DIR / "phase12_ckpt"
    shutil.rmtree(folder, ignore_errors=True)
    ck = Checkpointer(str(folder))
    params, opt = init_train_state(cfg_r, 0, device=cuda)
    full = []
    for i in range(7):
        if i == 4:
            at_save = [(p, t.clone()) for p, t in tree_items({"params": params, "opt": opt})]
            ck.save(4, {"params": params, "opt": opt}, async_save=True)
        params, opt, stats = step(params, opt, place(with_extras(data.batch_at(i), cfg_r), cuda))
        full.append(float(stats["loss"]))
    ck.wait()
    example = {"params": param_specs(cfg_r), "opt": init_opt_state(param_specs(cfg_r))}
    saved_step, restored = ck.restore(example)
    same = [(pa == pb and a.dtype == b.dtype and a.device == b.device and torch.equal(a, b))
            for (pa, a), (pb, b) in zip(at_save, tree_items(restored))]
    params2, opt2 = restored["params"], restored["opt"]
    resumed = []
    for i in range(4, 7):
        params2, opt2, stats = step(params2, opt2, place(with_extras(data.batch_at(i), cfg_r),
                                                         cuda))
        resumed.append(float(stats["loss"]))
    resume_err = max(abs(a - b) / abs(b) for a, b in zip(resumed, full[4:]))
    print(f"[12c restart] losses {', '.join(f'{x:.6f}' for x in full)}; restored step "
          f"{saved_step}, {sum(same)} of {len(same)} tensors bit for bit the state at the save; "
          f"resumed {', '.join(f'{x:.6f}' for x in resumed)} ({resume_err:.3e} rel)", flush=True)
    check(saved_step == 4 and len(same) == len(tree_items(example)) and all(same),
          "phase 12c: the restored state differs from the state at the save")
    check(resume_err <= TRAIN_TOL["resume"], f"phase 12c: resumed losses {resume_err}")
    check(full[-1] < full[0], f"phase 12c: the loss did not fall: {full}")
    shutil.rmtree(folder, ignore_errors=True)
    out["restart"] = {"losses": full, "resumed": resumed, "resume_rel": resume_err}
    part("c_restart")
    print(f"[12] seconds by part: {part_s}", flush=True)
    return out


# ----------------------------------------------------------------------
# phase 13: the production meshes
# ----------------------------------------------------------------------
MESH_LAYERS = 2  # phase 13 (a): qwen3-4b's depth cut to 2, its widths whole
DRYRUN_CELLS = (("qwen3-4b", "train_4k", False), ("qwen2.5-3b", "train_4k", True))


def mesh_train_state(cfg, host_batch, mesh, device=None):
    """``init_params(cfg, 0)`` on the card (``init_train_state``'s), placed on
    ``mesh`` by ``param_pspecs``, the optimizer state made from them, and
    the host batch placed by ``batch_pspecs`` (the launcher's placement)."""
    from repro_torch.data import place, with_extras
    from repro_torch.distributed.sharding import batch_pspecs, distribute, param_pspecs
    from repro_torch.models import init_params
    from repro_torch.models.common import ParamTree
    from repro_torch.models.config import ShapeCell
    from repro_torch.train import init_opt_state

    device = device or torch.device("cuda", 0)
    params = init_params(cfg, 0, device=device)
    params = ParamTree(distribute(params.to_dict(), param_pspecs(cfg, params), mesh))
    b, t = host_batch["tokens"].shape
    specs = batch_pspecs(cfg, ShapeCell("train_cut", t, b, "train"), mesh)
    return params, init_opt_state(params), place(with_extras(host_batch, cfg), device, specs, mesh)


def start_dryruns() -> list:
    """Each of ``DRYRUN_CELLS`` in a subprocess of its own (its fake group
    of 256 or 512 ranks must be the default group; fake CUDA tensors),
    all started together: [(cell, process, start)]."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    procs = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape]
        procs.append(((arch, shape, multi_pod),
                      subprocess.Popen(cmd + (["--multi-pod"] if multi_pod else []),
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                       env=env),
                      time.perf_counter()))
    return procs


def phase_mesh(fa, f32_prefill, dryruns) -> dict:
    """13. The production meshes (``distributed.sharding``, ``launch.mesh``,
    ``launch.hlocost``, ``launch.dryrun``).

    (a) qwen3-4b at its published widths, depth cut to ``MESH_LAYERS``,
    2 x 4096 tokens in 2 microbatches, f32: one ``build_train_step`` step
    without a mesh, then one from the same seed and tokens on
    ``make_smoke_mesh(cuda:0)`` (DTensor parameters, batch and optimizer
    state): the loss and every parameter after the step equal bit for bit
    (else the first leaf that differs is named).  (b) Phase 11's f32
    qwen3-4b prefill (4 x 1024 tokens, all 36 layers; its parameters
    drawn again from phase 11's seed on cuda:0) on the 1x1 mesh, the
    parameters and tokens placed by ``sharding.distribute`` (each rank's
    shard made a DTensor with ``DTensor.from_local``: no copy): the logits equal phase 11's bit for bit; flash counters set to
    0 just before, read just after: 36 launches on each rank's heads
    (``local_map``), no plain run.  (c) The dry run of qwen3-4b train_4k
    on 16x16 and qwen2.5-3b train_4k on 2x16x16, started before (a), each
    in its subprocess: their JSON lines and host seconds; each must be
    ``ok`` with the reference test's bounds (peak < 16e9 B a rank,
    ``model_hlo_ratio`` > 0.2)."""
    import dataclasses
    import gc

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, SyntheticTokens, place, with_extras
    from repro_torch.distributed.constraints import active_mesh
    from repro_torch.distributed.sharding import (
        batch_pspecs, distribute, param_pspecs, place_tensor)
    from repro_torch.launch.mesh import smoke_mesh
    from repro_torch.models import decode as dec
    from repro_torch.models import init_params
    from repro_torch.models.common import ParamTree, tree_items
    from repro_torch.models.config import ShapeCell
    from repro_torch.train import OptConfig, build_train_step, init_train_state

    cuda = torch.device("cuda", 0)
    out = {}
    try:
        # (a) one train step without a mesh and on the 1x1 mesh
        cfg = dataclasses.replace(ARCHS["qwen3-4b"], n_layers=MESH_LAYERS)
        host_batch = SyntheticTokens(DataConfig(cfg.vocab_size, 4096, 2)).batch_at(0)
        step = build_train_step(cfg, OptConfig(warmup_steps=5, total_steps=10), microbatches=2,
                                attn_block=512)

        def one_step(mesh):
            if mesh is None:
                params, opt = init_train_state(cfg, 0, device=cuda)
                batch = place(with_extras(host_batch, cfg), cuda)
            else:
                params, opt, batch = mesh_train_state(cfg, host_batch, mesh)
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            with active_mesh(mesh):
                params, opt, stats = step(params, opt, batch)
                loss = stats["loss"]
                loss = float(loss.full_tensor() if isinstance(loss, DTensor) else loss)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
            leaves = [(path, p.to_local() if isinstance(p, DTensor) else p)
                      for path, p in tree_items(params)]
            return loss, leaves, wall

        gc.collect()
        torch.cuda.empty_cache()
        loss_a, plain, wall_plain = one_step(None)
        with smoke_mesh(cuda) as mesh:
            loss_m, meshed, wall_mesh = one_step(mesh)
        differ = [(".".join(path), float((a.float() - b.float()).abs().max()))
                  for (path, a), (_, b) in zip(plain, meshed) if not torch.equal(a, b)]
        print(f"[13a qwen3-4b train f32, {MESH_LAYERS} layers, 2 x 4096 tokens] loss without a "
              f"mesh {loss_a!r}, on the 1x1 mesh {loss_m!r}; step wall {wall_plain:.4f} s "
              f"without, {wall_mesh:.4f} s on the mesh (first step of each); {len(plain)} "
              f"parameters, {len(differ)} differ"
              + (f": first {differ[0][0]} by {differ[0][1]:.3e}" if differ else ""), flush=True)
        check(loss_a == loss_m, f"phase 13a: loss {loss_a!r} != {loss_m!r} on the mesh")
        check(not differ, f"phase 13a: parameters differ on the mesh, first {differ[:1]}")
        out["train_step"] = {"layers": MESH_LAYERS, "loss": loss_a, "wall_s": wall_plain,
                             "wall_mesh_s": wall_mesh, "leaves": len(plain)}
        del plain, meshed
        gc.collect()
        torch.cuda.empty_cache()

        # (b) phase 11's f32 prefill on the 1x1 mesh
        tokens, want, wall11 = f32_prefill
        cfg = ARCHS["qwen3-4b"]
        params = init_params(cfg, torch.Generator(cuda).manual_seed(0), dtype=torch.float32,
                             device=cuda)
        with smoke_mesh(cuda) as mesh:
            # DTensor.from_local of each rank's shard: here the whole tensor
            dparams = ParamTree(distribute(params.to_dict(), param_pspecs(cfg, params), mesh))
            same_memory = all(d.to_local().data_ptr() == p.data_ptr() for (_, d), (_, p)
                              in zip(tree_items(dparams), tree_items(params)))
            cell = ShapeCell("prefill_cut", tokens.shape[1], tokens.shape[0], "prefill")
            dtokens = place_tensor(tokens, batch_pspecs(cfg, cell, mesh)["tokens"], mesh)
            fa.reset_counters()
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            with active_mesh(mesh):
                logits, cache = dec.prefill(cfg, dparams, dtokens, remat=False,
                                            cache_dtype=torch.float32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
            counts = flash_counts(fa)
            got = logits.to_local()
        same = bool(torch.equal(got, want))
        print(f"[13b qwen3-4b prefill f32 B=4 T=1024 on the 1x1 mesh] {nvidia_smi()}: wall "
              f"{wall:.4f} s (phase 11's kernel path {wall11:.4f} s); logits == phase 11's bit "
              f"for bit: {same} (max |diff| {float((got - want).abs().max()):.3e}); parameters "
              f"made DTensors without a copy: {same_memory}; flash {counts}", flush=True)
        check(same, "phase 13b: the prefill's logits on the mesh differ from phase 11's")
        check(same_memory, "phase 13b: DTensor.from_local copied a parameter")
        check(counts["launches"] == cfg.n_layers and counts["plain"] == 0,
              f"phase 13b: flash {counts}, expected {cfg.n_layers} launches and no plain run")
        out["prefill"] = {"wall_s": wall, "phase11_wall_s": wall11, "flash": counts,
                          "card": nvidia_smi()}
        del params, dparams, logits, cache, got
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the dry-run cells
        out["dryrun"] = []
        for cell, proc, t_start in dryruns:
            stdout, stderr = proc.communicate(timeout=900)
            host_s = time.perf_counter() - t_start
            lines = [line for line in stdout.splitlines() if line.startswith("{")]
            check(proc.returncode == 0 and lines,
                  f"phase 13c {cell}: exit {proc.returncode}: {stderr[-2000:]}")
            rec = json.loads(lines[-1])
            print(f"[13c dry run {cell[0]} {cell[1]} {'2x16x16' if cell[2] else '16x16'}] host "
                  f"{host_s:.1f} s (start to exit, the cells in parallel): {lines[-1]}",
                  flush=True)
            check(rec["status"] == "ok", f"phase 13c {cell}: {rec.get('error', rec)}")
            check(rec["chips"] == (512 if cell[2] else 256), f"phase 13c {cell}: chips")
            check(rec["peak_bytes"] < 16e9 and rec["model_hlo_ratio"] > 0.2,
                  f"phase 13c {cell}: peak {rec['peak_bytes']}, ratio {rec['model_hlo_ratio']}")
            out["dryrun"].append({**rec, "host_s": host_s})
    finally:
        for _, proc, _ in dryruns:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import repro_torch.kernels.frontal_cholesky as fc
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.sparse import (
        grid_laplacian_2d,
        min_degree,
        nested_dissection_2d,
        permute_symmetric,
        random_spd,
    )

    start = time.perf_counter()
    phase_s = {}

    def stamp(phase: str) -> None:
        """Print and keep the seconds since the start at each phase."""
        phase_s[phase] = time.perf_counter() - start
        print(f"[t+{phase_s[phase]:.1f} s] phase {phase}", flush=True)

    smi = nvidia_smi()
    print(f"[1] card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    lib = _build.build_library()
    _build.load_library()
    print(f"[1] built {lib.relative_to(_build.BUILD_DIR.parents[1])} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    stamp("2")
    rec = phase_kernels(fc)

    # ---- main path: each run with its counters set to 0 just before ----
    stamp("3")
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

    stamp("4")
    t0 = time.perf_counter()
    a = random_spd(2500, 8.0, np.random.default_rng(0))
    ap4 = permute_symmetric(a, min_degree(a))
    print(f"[4] min_degree ordering {time.perf_counter() - t0:.1f} s", flush=True)
    fact4, report4, wall4, (symb4, _) = drive("4 random_spd2500 f64", ap4, torch.float64,
                                               counters=fc)
    launches4, plain4 = dict(fc.LAUNCHES), dict(fc.PLAIN_RUNS)
    res4 = residual(fact4, ap4)
    launches = {k: launches3[k] + launches4[k] for k in launches3}
    print(f"[4] residual {res4:.3e}; launches {launches4}; main path total {launches}; "
          f"plain {plain4}", flush=True)
    check(res4 <= 1e-12, f"phase 4 residual {res4}")
    check(launches4["panel_factor"] >= 3, "phase 4: panel_factor launched < 3 times")
    check(launches4["syrk_downdate"] >= 3, "phase 4: syrk_downdate launched < 3 times")
    check(all(v == 0 for v in plain4.values()), f"phase 4: plain versions ran: {plain4}")
    shapes4 = large_front_syrk_shapes(symb4)
    check(len(shapes4) == launches4["syrk_downdate"],
          f"phase 4: {launches4['syrk_downdate']} syrk launches, {len(shapes4)} shapes")
    # syrk_downdate alone at the (M, K) phase 4 launches (after the run: not counted)
    gen4 = torch.Generator().manual_seed(4)
    rec["syrk_downdate"]["phase4_cases"] = []
    for m4, k4 in sorted(set(shapes4)):
        err, ms, plain_ms, lib_ms, bnd, by = syrk_case(fc, gen4, torch.float64, m4, k4, 128)
        print(f"    -> syrk_downdate float64 phase-4 shape M={m4} K={k4} "
              f"({shapes4.count((m4, k4))} launches): {ms / lib_ms:.2f}x library", flush=True)
        rec["syrk_downdate"]["phase4_cases"].append(dict(
            dtype="float64", shape=[m4, k4], launches=shapes4.count((m4, k4)), max_abs_err=err,
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by,
            x_library=ms / lib_ms))
    # where phase 3's time goes: the same plan once more, under the profiler
    prof3 = profile_run("3 poisson200 f64", ap, symb, plan, torch.float64)

    # ---- modes on the card -------------------------------------------
    stamp("5")
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

    # ---- the flash-attention kernel, then the facade -------------------
    stamp("6")
    rec["flash_attention"] = phase_flash(flash)
    stamp("7")
    e2e7 = phase_facade(fc, fact, report, wall)
    launches7 = e2e7["session_poisson200_f64"]["launches"]
    stamp("8")
    e2e8 = phase_online(fc, ap4, symb4, fact4, fa)
    launches8 = e2e8.pop("launches")
    stamp("9")
    e2e9 = phase_cluster(fc, ap4, fact4, ap5, fa,
                         e2e8["simulate_serve_poisson60"]["simulate_makespan"],
                         torch.device("cuda", 0))
    launches9 = e2e9.pop("launches")
    stamp("10")
    e2e10 = phase_workloads(fc)
    launches10 = e2e10.pop("launches")
    stamp("11")
    e2e11 = phase_lm(flash)
    launches11 = e2e11.pop("flash_route_launches")
    f32_prefill = e2e11.pop("f32_prefill")
    stamp("12")
    e2e12 = phase_train(flash)
    stamp("13")
    e2e13 = phase_mesh(flash, f32_prefill, start_dryruns())
    launches13 = e2e13["prefill"]["flash"]["routes"]
    stamp("end")

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
            "path": "PlanExecutor: phases 3 + 4 + 7 (Session.execute, Poisson 200) + 8 "
                    "(execute_online, random SPD 2500; plan('online') Poisson 60, async and "
                    "waves); cluster workers: phase 9 (Poisson 60 + random SPD 2500, a worker "
                    "killed, Session.serve(cluster=2)); phase 10 (Session.analyze_workload("
                    "'multifrontal') executed in f32, and the same grid through analyze)",
            "launches": launches[k] + launches7[k] + launches8[k] + launches9[k]
                        + launches10[k],
            "launches_by_phase": {"3": launches3[k], "4": launches4[k], "7": launches7[k],
                                  "8": launches8[k], "9": launches9[k], "10": launches10[k]},
            **rec[k],
        }
        for k in fc.KERNELS
    ]
    kernels += [
        {
            "name": f"flash_attention/{route}",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:77",
            "path": "phase 6 (the kernel entry point) + phase 11 (the LM path: qwen3-4b served "
                    "through repro_torch.launch.serve on its 1x1 mesh, its f32 and bf16 "
                    "prefills, every reduced arch's forward, loss and prefill) + phase 13 (the "
                    "f32 prefill on the 1x1 mesh, each rank's heads through local_map)",
            **rec["flash_attention"][route],
            "launches": rec["flash_attention"][route]["launches"] + launches11[route]
                        + launches13.get(route, 0),
            "launches_by_phase": {"6": rec["flash_attention"][route]["launches"],
                                  "11": launches11[route], "13": launches13.get(route, 0)},
        }
        for route in flash.ROUTES
    ]
    print(json.dumps({
        "e2e": {
            "poisson200_f64_async": {"wall_s": wall, "makespan_s": report.measured_makespan,
                                     "n_dispatches": report.n_dispatches, "residual": res,
                                     "profiled": prof3},
            "random_spd2500_f64_async": {"wall_s": wall4, "makespan_s": report4.measured_makespan,
                                         "n_dispatches": report4.n_dispatches, "residual": res4},
            **e2e7,
            **e2e8,
            **e2e9,
            **e2e10,
            "lm": e2e11,
            "train": e2e12,
            "mesh": e2e13,
        },
        "phase_start_s": phase_s,
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
