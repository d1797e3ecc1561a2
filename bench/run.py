"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (its file is given
there), a traffic mix (``bench/traffic/<traffic>.json``) and the chips it
needs.  Each metric is read by ``bench/metrics/<metric>.py``; the
configuration's operator comes from ``bench/families/<family>.py``.  So a
new configuration, traffic mix or metric is a new file and an entry in
``BENCHMARK.json``, and no file here changes.

One run: set-up (the CUDA context, the kernel library, the inputs, the
analysis and the plan through ``repro_torch.api.Session``, the executor
and its warmup), then a closed loop of factorizations with new values and
the same pattern for ``--seconds`` (the one in progress finishes), then the
check of a sample of the window's factors against the matrices rebuilt
from the seed (``bench/reference.py``).  With ``--trace 1`` the window runs
under ``torch.profiler`` and the per-layer metrics are printed instead of
the end-to-end ones.  The last line of standard output is the result.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
# top-level modules that may not be loaded in a run: the JAX stack and the
# JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NAME_CHARS = 160  # of a device operation's name in the breakdown
# every cache of the program and its libraries, at fixed paths in the checkout
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
    "TRITON_CACHE_DIR": "build/triton",
    "CUDA_CACHE_PATH": "build/cuda_cache",
}
_IMPORTED = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


# ----------------------------------------------------------------------
# discovery: everything by name, under a root that holds BENCHMARK.json
def load_module(path: Path) -> ModuleType:
    """The module in the file ``path``, loaded once per process."""
    path = Path(path).resolve()
    name = "bench_" + "".join(c if c.isalnum() else "_" for c in str(path))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


class Harness:
    """The benchmark's files under ``root`` (the checkout's root)."""

    def __init__(self, root: Path = REPO) -> None:
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / self.spec["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def family(self, name: str) -> ModuleType:
        return load_module(self.bench / "families" / f"{name}.py")

    def reader(self, metric: str) -> Callable:
        return load_module(self.bench / "metrics" / f"{metric}.py").read

    def metrics(self, cell: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics ``cell`` reports."""
        e2e = [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]
        if kind == "end_to_end":
            return e2e
        moved = {m["name"] for m in e2e}
        return [
            m for m in self.spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])
        ]


# ----------------------------------------------------------------------
def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def peak_memory(devices) -> int:
    import torch

    return max(
        (int(torch.cuda.max_memory_allocated(d)) for d in devices if d.type == "cuda"),
        default=0,
    )


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def peaks_for(harness: Harness, devices) -> Optional[dict]:
    """The data sheet's peaks for the card, or None for an unknown one."""
    import torch

    if devices[0].type != "cuda":
        return None
    table = json.loads((harness.bench / "peaks.json").read_text())
    return table.get(torch.cuda.get_device_name(devices[0]))


class Cell:
    """One cell: its configuration, traffic, operator and devices.

    ``devices`` defaults to the cell's chips (``cuda:0`` ...); tests pass
    CPU lanes and a smaller grid through ``config_overrides``.
    """

    def __init__(self, harness: Harness, name: str, *, devices: Optional[Sequence] = None,
                 config_overrides: Optional[dict] = None) -> None:
        import torch

        self.harness = harness
        self.spec = harness.cell(name)
        self.cfg = {**harness.config(self.spec["config"]), **(config_overrides or {})}
        self.traffic = harness.traffic(self.spec["traffic"])
        self.family = harness.family(self.cfg["family"])
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(int(self.spec["chips"]))]
        self.devices = [torch.device(d) for d in devices]
        self.op = self.family.Operator(self.cfg)

    def build(self, seed: int, k: int):
        """Session → analysis → plan of the ``k``-th matrix → the executor
        that ``Session.execute`` builds from them; and the seconds of
        analysis and plan."""
        import torch

        from repro_torch.api import DeviceMesh, Session
        from repro_torch.runtime.executor import PlanExecutor

        cfg = self.cfg
        t = time.perf_counter()
        sess = (
            Session(DeviceMesh(self.devices, plan_devices=int(cfg["plan_devices"])))
            .analyze(self.op.matrix(seed, k, original_order=True), float(cfg["alpha"]),
                     ordering=self.op.perm, relax=int(cfg["relax"]))
            .plan(cfg["policy"])
        )
        analyze_s = time.perf_counter() - t
        ex = PlanExecutor(sess.problem.symb, sess.schedule.to_execution_plan(),
                          devices=sess.platform.devices(),
                          dtype=getattr(torch, cfg["dtype"]), mode=cfg["mode"])
        return ex, analyze_s

    def judge(self, seed: int, k: int, fact) -> float:
        """The reference's residual of ``fact`` as the factor of the
        ``k``-th matrix of ``seed``."""
        ref = load_module(self.harness.bench / "reference.py")
        x = ref.probes(self.op.n, int(self.cfg["check"]["probes"]), self.family.rng(seed, k, 1))
        panels = [(sn.rows, sn.cols, p) for sn, p in zip(fact.symb.supernodes, fact.panels)]
        return ref.residual(panels, self.op.matrix(seed, k), x)

    def synchronize(self) -> None:
        import torch

        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def run_cell(
    harness: Harness,
    cell_name: str,
    seed: int,
    seconds: float,
    trace: bool,
    *,
    devices: Optional[Sequence] = None,
    config_overrides: Optional[dict] = None,
    log=sys.stderr,
) -> dict:
    """One run of one cell; returns the result line as a dict."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    # -- set-up -----------------------------------------------------------
    steps = {"imports": process_age()}
    cell = Cell(harness, cell_name, devices=devices, config_overrides=config_overrides)
    cfg, op, devices = cell.cfg, cell.op, cell.devices
    check = cfg["check"]
    steps["inputs"] = process_age()
    for d in devices:
        if d.type == "cuda":
            torch.zeros(1, device=d)  # the context
    cell.synchronize()
    steps["context"] = process_age()
    ex, analyze_s = cell.build(seed, 0)
    steps["analyze"] = process_age()
    ex.warmup()
    cell.synchronize()
    steps["warmup"] = setup_s = process_age()
    ends = list(steps.values())
    print(f"[bench] {cell_name} seed {seed}: set-up {setup_s:.3f} s ("
          + ", ".join(f"{n} {t - b:.3f}" for (n, t), b in zip(steps.items(), [0.0] + ends))
          + f"; analyze+plan {analyze_s:.3f}), {ex.symb.n_supernodes} fronts", file=log, flush=True)

    # -- the window: a closed loop, one caller ----------------------------
    sample_rng = np.random.default_rng([seed % (1 << 64), 1 << 20])
    keep: Dict[int, object] = {}  # reservoir sample of the window's factors
    dispatches, times = [], []
    timeline = load_module(harness.bench / "timeline.py")
    with contextlib.ExitStack() as stack:
        if trace:
            import repro_torch

            sampler = stack.enter_context(
                timeline.HostSampler(Path(repro_torch.__file__).resolve().parent))
            prof = stack.enter_context(
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        with record_function(timeline.WINDOW_RANGE):
            t0 = t = time.perf_counter()
            k = 0
            while True:
                a = op.matrix(seed, k)
                if cell.traffic["reanalyze"]:
                    ex, _ = cell.build(seed, k)
                fact, rep = ex.run(a, warmup=False)
                times.append(time.perf_counter() - t)
                t = time.perf_counter()
                dispatches.append(rep.n_dispatches)
                if len(keep) < int(check["sample"]):
                    keep[k] = fact
                else:
                    j = int(sample_rng.integers(0, k + 1))
                    if j < int(check["sample"]):
                        del keep[sorted(keep)[j]]
                        keep[k] = fact
                del fact, rep
                k += 1
                if t - t0 >= seconds:
                    break
            window_s = t - t0
    count = len(times)
    print(f"[bench] window {window_s:.3f} s, {count} factorizations: "
          + " ".join(f"{x:.3f}" for x in times), file=log, flush=True)

    # -- after the window -------------------------------------------------
    memory_peak = peak_memory(devices)
    del ex
    if any(d.type == "cuda" for d in devices):
        torch.cuda.empty_cache()

    dtrace = None
    if trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            dtrace = timeline.read_chrome_trace(path, t0, sampler)

    ctx = SimpleNamespace(
        config=cfg, count=count, window_s=window_s,
        setup_s=setup_s, analyze_s=analyze_s, dispatches=dispatches, trace=dtrace,
        peaks=peaks_for(harness, devices), least=None,
    )
    if trace:
        counts = load_module(harness.bench / "counts.py")
        ctx.least = counts.least_work(op.matrix(seed, 0), np.dtype(cfg["dtype"]).itemsize)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in harness.metrics(cell_name, kind):
        value = harness.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # -- the check: the sampled factors against the rebuilt matrices ------
    t_check = time.perf_counter()
    checks = {
        f"residual.{k}": {"value": cell.judge(seed, k, keep.pop(k)),
                          "limit": float(check["residual_limit"])}
        for k in sorted(keep)
    }
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    print(f"[bench] check of {len(checks)} factors {time.perf_counter() - t_check:.3f} s",
          file=log, flush=True)

    device = {
        "platform": "gpu" if devices[0].type == "cuda" else devices[0].type,
        "kind": torch.cuda.get_device_name(devices[0]) if devices[0].type == "cuda" else "cpu",
        "count": len(set(devices)),
        "memory_peak_bytes": memory_peak,
    }
    result = {
        "correct": bool(checks) and failed == 0,
        "attempted": count,
        "failed": failed,
        "metrics": metrics,
        "device": device,
    }
    if dtrace is not None:
        device["busy_s"] = dtrace.busy_s
        device["window_s"] = dtrace.window_s
        result["breakdown"] = {
            "device_ops": [[n[:NAME_CHARS], s] for n, s in dtrace.device_ops],
            "idle_gaps": [[n, s] for n, s in dtrace.idle_gaps],
        }
    result["checks"] = checks
    if devices[0].type == "cuda":
        print(f"[bench] card: {power_limit()}", file=log, flush=True)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=log, flush=True)
    return result


# ----------------------------------------------------------------------
def parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(REPO / rel)
    sys.path.insert(0, str(REPO / "src"))
    harness = Harness(REPO)
    chips = int(harness.cell(args.workload)["chips"])

    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"bench: the cell needs {chips} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    result = run_cell(harness, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"bench: loaded in the measured process: {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
