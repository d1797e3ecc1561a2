"""Build, load and launch the port's CUDA kernel library.

Every ``repro_torch/csrc/*.cu`` source is compiled for ``sm_90a`` by its
own ``nvcc`` call, all started together, and the objects are linked into
one shared library with a plain C interface, at first use, into
``build/repro_torch/<hash>/`` at the repository root (the hash covers every
source's bytes and the flags), and loaded with ``ctypes``.
Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "frontal_cholesky.cu", CSRC / "flash_attention.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# flags of one call that builds a shared library from sources
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# the same flags for one source's object file
COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)

_VP, _CI, _CF, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
# C entry point -> argument types (each returns an int error code)
SIGNATURES = {
    **{
        f"{name}_{t}": args
        for t in ("f32", "f64")
        for name, args in (
            ("front_factor", [_VP, _CI, _CI, _CI, _VP]),
            ("panel_factor", [_VP, _CI, _CI, _VP]),
            # c, a, out, m, k, lower (uplo='L' when not 0), stream
            ("syrk_downdate", [_VP, _VP, _VP, _CI, _CI, _CI, _VP]),
            # mp, out: CTAs per cluster, out: clusters resident at once, stream
            ("front_cluster_room", [_CI, _PI, _PI, _VP]),
            # src, src row stride, dst (float64), dst row stride, pos (int32), n, stream
            ("extend_add", [_VP, _CLL, _VP, _CLL, _VP, _CI, _VP]),
        )
    },
    # q, k, v, out, B, T, H, Dh, causal, scale, 4 strides each of q, k, v, stream
    **{
        f"flash_attention_{t}": [_VP] * 4 + [_CI] * 5 + [_CF] + [_CLL] * 12 + [_VP]
        for t in ("f32", "bf16", "wgmma_bf16", "3xtf32_f32", "cluster_bf16", "cluster_f32")
    },
    # padded Dh, out: CTAs per cluster, out: clusters resident at once, stream
    **{f"flash_cluster_room_{t}": [_CI, _PI, _PI, _VP] for t in ("bf16", "f32")},
}

_LIB = None
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def library_path(sources: Sequence[Path] = SOURCES) -> Path:
    """Where the library built from ``sources`` (as they are now) lives."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / "librepro_torch_kernels.so"


def _run(cmds: Sequence[Sequence[str]]) -> None:
    """Run the commands at once; raise with the first failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build_library() -> Path:
    """Compile every CUDA source (one ``nvcc`` each, all at once) and link
    them, unless a library for them exists already."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in SOURCES]
    _run([[_nvcc(), *COMPILE_FLAGS, "-o", str(obj), str(src)]
          for src, obj in zip(SOURCES, objs)])
    tmp = out.with_name(f"{out.name}.{tag}.tmp")
    _run([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; bind its entry points."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = _CI
            lib.kernel_error_string.argtypes = [_CI]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


# the current stream as a cudaStream_t without building a Stream object
# (which costs more host time than the rest of a launch); the public call
# where torch lacks it
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as a ``cudaStream_t``."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream; raise
    if it reports an error (a refused launch never runs, and a later
    synchronize would not say so)."""
    lib = _LIB or load_library()
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = _raw_stream(index)
    if index == current:
        rc = getattr(lib, entry)(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} ({rc})")
