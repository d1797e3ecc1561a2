"""The harness on the CPU: discovery by name, the check's control and its
faults, the contract's static rules and the JAX-free rule.  The last test
needs the card and skips without one."""
from __future__ import annotations

import ast
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import limits
import run

REPO = run.REPO
SMALL = {"grid": [12, 12]}
CELL = "diffusion3d-40.refactor"
CPU = ["cpu"]


def small_run(harness=None, cell=CELL, seconds=0.0, overrides=None, trace=False):
    return run.run_cell(harness or run.Harness(REPO), cell, 2**31 + 7, seconds, trace,
                        devices=CPU, config_overrides={**SMALL, **(overrides or {})})


# -- discovery -----------------------------------------------------------
def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(REPO / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "bench/configs/diffusion3d-40.json").read_text())
    cfg.update(name="diffusion3d-6", grid=[6, 6, 6])
    (tmp_path / "bench/configs/diffusion3d-6.json").write_text(json.dumps(cfg))
    (tmp_path / "bench/traffic/fresh.json").write_text(
        json.dumps({"why": "a new session per factorization", "reanalyze": True}))
    (tmp_path / "bench/metrics/executor.fronts.py").write_text(
        "def read(ctx):\n    return float(ctx.count)\n")
    spec["configs"].append({"name": "diffusion3d-6", "source": "test", "reduced": ["grid"],
                            "file": "bench/configs/diffusion3d-6.json", "why": "test"})
    spec["workloads"].append({"name": "diffusion3d-6.fresh", "config": "diffusion3d-6",
                              "traffic": "fresh", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "executor.fronts", "unit": "count", "better": "higher",
                              "source": "program_counter", "layer": "executor", "moves": "factor_s",
                              "workloads": ["diffusion3d-6.fresh"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    h = run.Harness(tmp_path)
    out = run.run_cell(h, "diffusion3d-6.fresh", 11, 0.0, True, devices=CPU)
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"executor.dispatches", "executor.fronts"}
    assert {p: p.read_bytes() for p in before} == before  # no file there was edited
    assert [m["name"] for m in h.metrics("diffusion3d-6.fresh", "end_to_end")] == ["factor_s", "setup_s"]


def test_each_cell_reports_its_metrics():
    h = run.Harness(REPO)
    for cell in h.spec["workloads"]:
        e2e = [m["name"] for m in h.metrics(cell["name"], "end_to_end")]
        layer = h.metrics(cell["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer + h.metrics(cell["name"], "end_to_end"):
            assert callable(h.reader(m["name"]))


# -- the check: a sound run, its control and the faults ------------------
def test_sound_run_is_correct():
    out = small_run(seconds=0.2)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert all(c["value"] < 1e-14 for c in out["checks"].values())
    assert set(out["metrics"]) == {"factor_s", "setup_s"}


def test_control_in_float32_is_not_correct():
    """The program's own float32 path in the float64 configuration's place."""
    out = small_run(overrides={"dtype": "float32"})
    assert not out["correct"]
    assert all(1e-9 < c["value"] < 1e-5 for c in out["checks"].values())


def test_stale_factor_is_not_correct(monkeypatch):
    """A refactorization that returns the previous factor unchanged."""
    from repro_torch.runtime.executor import PlanExecutor

    real, first = PlanExecutor.run, []

    def stale(self, a, warmup=True):
        fact, rep = real(self, a, warmup)
        first.append(fact)
        return first[0], rep

    monkeypatch.setattr(PlanExecutor, "run", stale)
    for seconds in (1.0, 4.0, 16.0):  # a window of two factorizations or more
        first.clear()
        out = small_run(seconds=seconds)
        if out["attempted"] >= 2:
            break
    assert out["attempted"] >= 2 and not out["correct"]
    assert out["checks"]["residual.0"]["value"] < 1e-14  # the first is sound


def test_half_of_each_batch_left_out_is_not_correct():
    import repro_torch.runtime.executor as executor_module

    restore = limits.half_batches(executor_module)
    try:
        out = small_run()
    finally:
        restore()
    assert not out["correct"]


def test_one_altered_entry_is_not_correct(monkeypatch):
    from repro_torch.runtime.executor import PlanExecutor

    real = PlanExecutor.run

    def altered(self, a, warmup=True):
        fact, rep = real(self, a, warmup)
        return limits.altered(fact, 5), rep

    monkeypatch.setattr(PlanExecutor, "run", altered)
    assert not small_run()["correct"]


def test_missing_program_gives_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELL, "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


# -- the JAX-free rule ----------------------------------------------------
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("repro_torch.fake", "reprox", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, object())
    assert set(run.forbidden_modules()) & {"repro", "jax", "flax"} == set()
    monkeypatch.setitem(sys.modules, "repro.sparse", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert {"repro", "jax"} <= set(run.forbidden_modules())


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted((REPO / "bench").rglob("*.py"))
    assert files
    for path in files:
        tops = imported_tops(path)
        assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, path
    for name in ("reference.py", "counts.py", "families/grid_diffusion.py"):
        assert "repro_torch" not in imported_tops(REPO / "bench" / name), name


# -- the contract's static rules -----------------------------------------
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    raw = (REPO / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    spec = json.loads(raw)
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16 and 1 <= len(spec["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p for p in spec["paths"])
    assert all(line_ok(w) and not w.startswith("/") for w in spec["command"])
    rs = spec["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert line_ok(c["source"]) and line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        assert (REPO / c["file"]).is_file()
        assert not any(re.search(r"(_dim|_rank)$|hidden|intermediate|latent|head", k)
                       for k in c["reduced"])
        assert set(c["reduced"]) <= set(json.loads((REPO / c["file"]).read_text())["reduced"])
    cells = spec["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and line_ok(w["why"])
        assert NAME.match(w["traffic"]) and (REPO / "bench/traffic" / f"{w['traffic']}.json").is_file()
    assert {w["config"] for w in cells} == set(configs)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and line_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", [])) <= {w["name"] for w in cells}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


# -- on the card ----------------------------------------------------------
@pytest.mark.gpu
def test_traced_run_on_the_card(cuda):
    out = run.run_cell(run.Harness(REPO), CELL, 2**31 + 9, 0.5, True,
                       devices=[cuda], config_overrides={"grid": [60, 60]})
    assert out["correct"] and out["device"]["platform"] == "gpu"
    names = {m["name"] for m in run.Harness(REPO).metrics(CELL, "per_layer")}
    assert set(out["metrics"]) == names
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert 0 < out["metrics"]["kernels_roofline"]["value"] <= 100
    assert 0 < out["metrics"]["factor_mfu"]["value"] <= 100
    assert all(math.isfinite(v["value"]) for v in out["metrics"].values())
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]
