"""Where the frontal kernels' time goes, phase by phase, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.frontal_split [--out FILE]

``factor_slab`` (``csrc/frontal_cholesky.cu``) runs, per 128-column block,
(A1) the warp factor of each 32×32 diagonal sub-block, (A2+A3) the solve
of the rows below it inside the block and the block's downdate, (B) the
rows below the block, (C) the trailing downdate.  This script builds
variants of the source with one phase left out (a compile-time switch
inserted by text edits into a copy; the numbers they compute are
meaningless) and one with all four left out (loads, stores and barriers
only), each by its own ``nvcc`` started together, and times
``front_factor`` and ``panel_factor`` alone (no wrapper, no copy: CUDA
events around 20 launches on an identity input, after 3 warm-ups) at the
shapes ``chip_smoke.py`` phase 2 uses.  A phase's share is the full
kernel's time less the time of the variant without it.

Needs a CUDA device and ``nvcc``; builds under ``build/repro_torch/split``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ._build import BUILD_DIR, NVCC_FLAGS, _nvcc, CSRC

# text edit -> the phase bit that turns it off
_SWITCHES = {
    "if (tid < 32) {": "if (!(FC_SKIP & 1) && tid < 32) {",
    "    solve_rows(D + base * DLD, DLD, nbelow, D, rinv, sb);":
        "    if (!(FC_SKIP & 2)) solve_rows(D + base * DLD, DLD, nbelow, D, rinv, sb);",
    "    if (nbelow) {": "    if (!(FC_SKIP & 2) && nbelow) {",
    "    solve_below(a + off, lda, lo, hi, D, rinv, X);":
        "    if (!(FC_SKIP & 4)) solve_below(a + off, lda, lo, hi, D, rinv, X);",
    "    trailing_downdate(a, lda, off, t0,": "    if (!(FC_SKIP & 8)) trailing_downdate(a, lda, off, t0,",
}
VARIANTS = {"full": 0, "without A1": 1, "without A2+A3": 2, "without B": 4, "without C": 8,
            "loads, stores, barriers": 15}
SHAPES = [  # (name, kernel, shape, nbp)
    ("front B=32 256^2 nbp=128", "front_factor", (32, 256), 128),
    ("front B=4 1024^2 nbp=256", "front_factor", (4, 1024), 256),
    ("panel 1152x128", "panel_factor", (1152, 128), None),
    ("panel 1152x256", "panel_factor", (1152, 256), None),
    ("panel 1152x512", "panel_factor", (1152, 512), None),
]


def build_variants() -> dict:
    """Compile one library per variant (all nvcc calls at once)."""
    src = (CSRC / "frontal_cholesky.cu").read_text()
    for old, new in _SWITCHES.items():
        if src.count(old) != 1:
            raise RuntimeError(f"frontal_split: expected one {old!r} in the source")
        src = src.replace(old, new)
    out = BUILD_DIR / "split"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "frontal_cholesky_split.cu"
    cu.write_text(src)
    procs = {}
    for name, bits in VARIANTS.items():
        so = out / f"fc_skip{bits}.so"
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, f"-DFC_SKIP={bits}", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"frontal_split: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def kernel_us(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps * 1e3


def split(libs: dict) -> list:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for dtype, suffix in ((torch.float64, "f64"), (torch.float32, "f32")):
        for name, kernel, shape, nbp in SHAPES:
            if nbp is None:
                x = torch.eye(shape[0], device="cuda", dtype=dtype)[:, : shape[1]].contiguous()
            else:
                x = torch.eye(shape[1], device="cuda", dtype=dtype).repeat(shape[0], 1, 1)
            us = {}
            for var, lib in libs.items():
                fn = getattr(lib, f"{kernel}_{suffix}")
                if nbp is None:
                    fn.argtypes = [vp, ci, ci, vp]
                    args = (x.data_ptr(), shape[0], shape[1], stream)
                else:
                    fn.argtypes = [vp, ci, ci, ci, vp]
                    args = (x.data_ptr(), shape[0], shape[1], nbp, stream)

                def launch(fn=fn, args=args):
                    rc = fn(*args)
                    if rc:
                        raise RuntimeError(f"frontal_split: {kernel}_{suffix} failed ({rc})")

                us[var] = kernel_us(launch)
            full = us["full"]
            share = {p: full - us[f"without {p}"] for p in ("A1", "A2+A3", "B", "C")}
            rows.append(dict(dtype=suffix, case=name, full_us=full,
                             base_us=us["loads, stores, barriers"], phase_us=share))
            print(f"{suffix} {name}: full {full:.1f} us; " + ", ".join(
                f"{p} {v:.1f}" for p, v in share.items())
                + f"; loads+stores+barriers alone {us['loads, stores, barriers']:.1f} us",
                flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("frontal_split: needs a CUDA device")
    rows = split(build_variants())
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
