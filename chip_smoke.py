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
6. the flash-attention kernels (their public entry point: nothing in the
   package calls it) at qwen3-4b's attention widths (32 query heads,
   Dh=128) and its train_4k length: B=2, T=4096, causal f32 and bf16,
   causal bf16 and f32 at Dh=64, non-causal f32, causal f32 and bf16 at
   Dh=96 and at zamba2-2.7b's Dh=80 (both padded to 128 in the tensor-core
   kernels), causal f32 and bf16 at Dh=192 and 256 (the tensor-core
   kernels' wide tiles), causal f16 and f64 at Dh=128 (computed in f32),
   causal f32 and bf16 at Dh=76 (padded to 80) and at Dh=320 (the simt
   kernel by 128-column chunks of O), causal f32 and bf16 at Dh=192 with
   B*H = 65600, T=64; each through the route its (dtype, Dh) names (the
   per-route counter is checked; every Dh up to 256 on a tensor-core
   route), against its plain version, twice bit for bit, with CUDA-event
   times, the plain version's,
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
   phase 8c's three Poisson 60 arrivals, then ``RunReport.save_html``.

Launch counters are set to 0 just before each main-path run (phases 3 and
4 after the executor's untimed warmup; each run of phases 6, 7, 8 and 9,
whose executors and workers skip the warmup in the process phases 3-5
warmed) and
read just after: every kernel must have run on the main path, and no
plain version.  Any failed check raises.  The line before the last is the
kernels' JSON; the last line is ``{"ok": true, "device": {...}}``.  Exits
non-zero without a CUDA device.
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
    # 80; Dh=320 on the simt kernel's column chunks; B*H past 65535
    (torch.float16, True, 128), (torch.float64, True, 128),
    (torch.float32, True, 76), (torch.bfloat16, True, 76),
    (torch.float32, True, 320), (torch.bfloat16, True, 320),
    (torch.float32, True, 192, (2, 64, 32800)), (torch.bfloat16, True, 192, (2, 64, 32800)),
]


def phase_flash(fa) -> dict:
    """The flash-attention kernels at qwen3-4b's attention widths and
    train_4k length (and Dh=64, the other head dim of the repo's configs;
    Dh=80, zamba2-2.7b's (d_model 2560 over 32 heads), Dh=96 and Dh=76 run
    padded in the tensor-core kernels; Dh=192 and 256 in their wide tiles;
    Dh=320, wider than those, takes the simt kernel by 128-column chunks of
    O; f16 and f64 run in f32; B*H = 65600 at T=64).  For each case the public
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
            qkv32[(b, t, h, dh)] = [
                torch.randn(b, t, h, dh, generator=gen_card, device="cuda") if shape
                else torch.randn(b, t, h, dh, generator=gen).cuda() for _ in range(3)]
        q, k, v = (x.to(dtype) for x in qkv32[(b, t, h, dh)])
        route = fa.route(dtype, dh)
        fa.reset_counters()
        got = fa.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        path_launches, path_plain = fa.LAUNCHES["flash_attention"], fa.PLAIN_RUNS["flash_attention"]
        routes = dict(fa.ROUTE_LAUNCHES)
        check(path_launches > 0, f"flash {dtype} causal={causal}: kernel never launched")
        check(path_plain == 0, f"flash {dtype} causal={causal}: plain version ran")
        check(routes == {r: int(r == route) for r in fa.ROUTES},
              f"flash {dtype} Dh={dh}: routes {routes}, expected {route}")
        check((route == "simt") == (fa.padded_dh(dh) > 256),
              f"flash {dtype} Dh={dh}: route {route}, tensor cores take every Dh up to 256")
        check(got.dtype == dtype and got.shape == q.shape, f"flash {dtype} Dh={dh}: output")
        want = fa.flash_attention_plain(q, k, v, causal)
        diff = (got.double() - want.double()).abs()
        err = float(diff.max())
        not_equal = float((got != want).float().mean())  # share of elements not bit-equal
        # f32 math (f32; f64, computed in f32 as the reference does): the
        # reference's attention tolerance.  bf16, f16: the same f32 math
        # (within that tolerance), then one rounding each, so element by
        # element at most 2 ulps of the element: eps * |want| + 2e-5
        rtol = (torch.finfo(dtype).eps if dtype in (torch.bfloat16, torch.float16) else 0.0)
        tol = 2e-5
        excess = float((diff - rtol * want.double().abs()).max())  # must stay <= tol
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
        # width (64, 128, 192 or 256); wgmma_tma runs PV twice (P split in
        # two), mma_3xtf32 three TF32 passes of each, simt f32 math on the
        # CUDA cores, QK^T once per 128-column chunk of O (Dh past 256)
        dhp = fa.padded_dh(dh)
        dh_tile = next((w for w in (64, 128, 192, 256) if dhp <= w), dhp)
        chunks = 1 if dhp <= 256 else -(-dhp // 128)
        qk_flops = 2.0 * b * h * pairs * {"wgmma_tma": -(-dhp // 16) * 16, "mma_3xtf32": dhp,
                                          "simt": dhp * chunks}[route]
        pv_flops = 2.0 * b * h * pairs * (dhp if route == "simt" else dh_tile)
        design_ms = 1e3 * {"wgmma_tma": (qk_flops + 2 * pv_flops) / PEAK_BF16_TENSOR,
                           "mma_3xtf32": 3 * (qk_flops + pv_flops) / PEAK_TF32_TENSOR,
                           "simt": (qk_flops + pv_flops) / PEAK_FLOPS[torch.float32]}[route]
        tile = (f" ({chunks} chunks of O)" if chunks > 1 else "") if route == "simt" \
            else f" (tile {dh_tile})"
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
                    dh_tile=dhp if route == "simt" else dh_tile, o_chunks=chunks,
                    max_abs_err=err, rtol=rtol, atol=tol, not_bit_equal=not_equal, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by,
                    design_bound_ms=design_ms, x_library=ms / lib_ms)
        if lib_native_ms is not None:
            case["library_native_ms"] = lib_native_ms
        if route not in recs:
            recs[route] = dict(case, launches=0)
        else:
            recs[route].setdefault("other_cases", []).append(case)
        recs[route]["launches"] += path_launches
        del q, k, v, qt, kt, vt, got, want, diff
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
    stamp("end")
    launches9 = e2e9.pop("launches")

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
                    "killed, Session.serve(cluster=2))",
            "launches": launches[k] + launches7[k] + launches8[k] + launches9[k],
            "launches_by_phase": {"3": launches3[k], "4": launches4[k], "7": launches7[k],
                                  "8": launches8[k], "9": launches9[k]},
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
            "path": "kernel entry point (no caller in src/repro)",
            **rec["flash_attention"][route],
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
