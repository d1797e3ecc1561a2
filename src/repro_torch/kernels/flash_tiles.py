"""A/B of the f32 flash route's tiles past 128 Dh-columns, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_tiles [--out FILE]

The 3xTF32 kernel (``csrc/flash_attention.cu``, ``flash_tf32_kernel``)
holds a Q tile and two K/V stages in shared memory, rows padded by 4
floats.  At 192 and 256 columns two layouts fit a block's 227 KiB:

* ``rows 128`` (the source as it is): 128 query rows in 8 warps, K/V
  tiles of 32 keys (192 columns) or 16 keys (256);
* ``rows 64``: 64 query rows in 4 warps, K/V tiles of 32 keys at both
  (the source's ``tf32_rows`` and ``tf32_keys`` changed by text edits in a
  copy).

Each variant is built from that copy by its own ``nvcc`` (with ``-Xptxas
-v``: each kernel's registers and spills are printed), all started
together, under ``build/repro_torch/flash_tiles``.  Each is held against
the plain version (max-abs, the route's 2e-5 bar) and timed by CUDA events
around 5 launches of the C entry alone (no wrapper), in the order A, B, B,
A, three times; the median per variant is reported, at B=2 T=4096 H=32
causal.  Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from . import flash_attention as fa
from ._build import BUILD_DIR, CSRC, NVCC_FLAGS, SIGNATURES, _nvcc

_ROWS64 = {
    "__host__ __device__ constexpr int tf32_rows() { return TQ; }":
        "__host__ __device__ constexpr int tf32_rows() { return DH <= 128 ? TQ : 64; }",
    "__host__ __device__ constexpr int tf32_keys() { return DH <= 128 ? 64 : DH <= 192 ? 32 : 16; }":
        "__host__ __device__ constexpr int tf32_keys() { return DH <= 128 ? 64 : 32; }",
}
VARIANTS = {"rows 128": {}, "rows 64": _ROWS64}
DHS = (192, 256)
ENTRY = "flash_attention_3xtf32_f32"


def build_variants() -> dict:
    """One library per variant (all nvcc calls at once); prints ptxas's
    report of each."""
    src = (CSRC / "flash_attention.cu").read_text()
    out = BUILD_DIR / "flash_tiles"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits.items():
            if text.count(old) != 1:
                raise RuntimeError(f"flash_tiles: expected one {old!r} in the source")
            text = text.replace(old, new)
        cu, so = out / f"flash_tiles_{i}.cu", out / f"flash_tiles_{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"flash_tiles: nvcc failed for {name}:\n{log}")
        print(f"--- ptxas, {name} ---\n" + "\n".join(
            line for line in log.splitlines() if "entry function" in line or "Used" in line
            or "spill" in line), flush=True)
        lib = ctypes.CDLL(str(so))
        getattr(lib, ENTRY).argtypes = SIGNATURES[ENTRY]
        getattr(lib, ENTRY).restype = ctypes.c_int
        libs[name] = lib
    return libs


def ab(libs: dict) -> list:
    b, t, h = 2, 4096, 32
    gen = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for dh in DHS:
        q, k, v = (torch.randn(b, t, h, dh, generator=gen, device="cuda") for _ in range(3))
        want = fa.flash_attention_plain(q, k, v, True)
        outs = {name: torch.empty_like(q) for name in libs}

        def call(name):
            rc = getattr(libs[name], ENTRY)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[name].data_ptr(), b, t, h, dh, 1,
                dh**-0.5, *q.stride(), *k.stride(), *v.stride(), stream)
            if rc:
                raise RuntimeError(f"flash_tiles: {ENTRY} ({name}) failed ({rc})")

        times = {name: [] for name in libs}
        names = list(libs)
        for name in names:
            call(name)
        for _ in range(3):
            for name in names + names[::-1]:
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(5):
                    call(name)
                t1.record()
                torch.cuda.synchronize()
                times[name].append(t0.elapsed_time(t1) / 5)
        for name in names:
            err = float((outs[name] - want).abs().max())
            ms = statistics.median(times[name])
            rows.append(dict(variant=name, dh=dh, ms=ms, runs_ms=times[name], max_abs_err=err))
            print(f"f32 B={b} T={t} H={h} Dh={dh} causal, {name}: {ms:.4f} ms "
                  f"(runs {', '.join(f'{x:.4f}' for x in times[name])}), max_abs_err {err:.3e}",
                  flush=True)
            if err > 2e-5:
                raise AssertionError(f"flash_tiles: {name} Dh={dh} err {err} > 2e-5")
        del q, k, v, want, outs
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_tiles: needs a CUDA device")
    rows = ab(build_variants())
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
