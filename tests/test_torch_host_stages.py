"""The executor's host stages, its copy and GC counters, and the bounded
bus they are published on (``repro_torch.runtime.executor.STAGES``,
``repro_torch.obs.events.CAPACITY``).

The port runs on CPU lanes (the kernels' plain versions).  What a run
records is checked against what the run did: the main thread's stages
against its wall time, the bytes against sums over the supernodes from
``padded_shape``, the spans of two runs against each other, the profiler's
chrome trace against the stage names, and the benchmark's traced run
against its nine readers of these counters.
"""
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.api as tapi
import repro_torch.obs as obs
import repro_torch.runtime.executor as executor_module
import repro_torch.sparse as tsparse
from repro_torch.kernels.ops import padded_shape
from repro_torch.obs import events as obs_events
from repro_torch.runtime import PlanExecutor
from repro_torch.runtime.executor import STAGES

REPO = Path(__file__).resolve().parents[1]
CPU4 = [torch.device("cpu")] * 4
MAIN = ("scan", "assemble", "pad", "wait", "extract", "report")
COUNTERS = (
    "repro_executor_stage_seconds_total",
    "repro_executor_copy_bytes_total",
    "repro_host_gc_seconds_total",
)


@pytest.fixture(autouse=True)
def fresh_obs():
    obs.enable()
    obs.reset()
    yield
    obs.enable()
    obs.reset()


@pytest.fixture(scope="module")
def grid15():
    a = tsparse.grid_laplacian_2d(15)
    ap = tsparse.permute_symmetric(a, tsparse.nested_dissection_2d(15))
    symb = tsparse.analyze(ap, relax=1)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    return ap, symb, plan


@pytest.fixture(scope="module")
def fused15(grid15):
    """The same grid's plan over an amalgamated tree, and its provenance."""
    ap, symb, _ = grid15
    sess = tapi.Session(tapi.DeviceMesh(CPU4, plan_devices=8)).load(
        tapi.Problem.from_symbolic(symb, 0.9, matrix=ap))
    sess.optimize(max_front=64).plan("greedy")
    assert sess.problem.n < symb.n_supernodes
    return sess.schedule.to_execution_plan(), sess.problem.provenance


def executor(grid, mode="async", **kw):
    _, symb, plan = grid
    return PlanExecutor(symb, plan, devices=CPU4, dtype=torch.float64, mode=mode, **kw)


def counter(name, **labels):
    c = obs.REGISTRY.get(name)
    return None if c is None else c.value_of(**labels)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["async", "waves"])
@pytest.mark.parametrize("fused", [False, True])
def test_main_thread_stages_cover_the_run(grid15, fused15, mode, fused):
    """Self time: the main thread is in one stage at a time, from the
    start of ``run`` to its report, so its stages sum to the run's wall
    time (the workers' ``transfer`` overlaps the main thread's ``wait`` on
    the async path; the wave path transfers on the main thread).  On the
    fused async path a worker assembles, pads and extracts its group, and
    counts all of it as ``transfer``, not as the main thread's stages."""
    if fused:
        plan, prov = fused15
        ex = PlanExecutor(grid15[1], plan, devices=CPU4, dtype=torch.float64, mode=mode,
                          provenance=prov)
    else:
        ex = executor(grid15, mode)
    ex.run(grid15[0], warmup=True)
    obs.reset()
    t = time.perf_counter()
    _, rep = ex.run(grid15[0], warmup=False)
    wall = time.perf_counter() - t
    sec = rep.host.seconds
    assert set(sec) == set(STAGES) and all(v >= 0.0 for v in sec.values())
    main = sum(sec[s] for s in MAIN) + (sec["transfer"] if mode == "waves" else 0.0)
    assert 0.9 * wall <= main <= wall
    assert sec["assemble"] > 0 and sec["extract"] > 0 and sec["report"] > 0
    if mode == "async":
        assert sec["transfer"] > 0 and sec["wait"] > 0
    assert (sec["pad"] == 0) == (fused and mode == "async")
    workers = {s.name for s in obs.BUS.spans(cat="dispatch") if s.device >= 0}
    assert workers == ({"transfer"} if mode == "async" else set())
    for stage in STAGES:
        assert counter(COUNTERS[0], stage=stage) == sec[stage]


def test_warmup_adds_nothing(grid15):
    ex = executor(grid15)
    ex.warmup()
    assert all(obs.REGISTRY.get(name) is None for name in COUNTERS)
    assert obs.BUS.spans(cat="dispatch") == []
    _, cold = ex.run(grid15[0], warmup=True)
    _, warm = ex.run(grid15[0], warmup=False)
    assert cold.host.copied_bytes == warm.host.copied_bytes
    assert cold.host.useful_bytes == warm.host.useful_bytes
    assert counter(COUNTERS[1], kind="copied") == 2 * warm.host.copied_bytes


@pytest.mark.parametrize("mode", ["async", "waves"])
@pytest.mark.parametrize("large_from", [None, 128])
@pytest.mark.parametrize("fused", [False, True])
def test_copied_and_useful_bytes_are_the_supernodes_sums(grid15, fused15, monkeypatch, mode,
                                                         large_from, fused):
    """Every front is assembled on its lane from the run's values, which
    cross once a lane (the lower triangle's entries, float64; the four
    CPU lanes are one device), and only its (m, nb) panel comes back; its
    Schur block stays on the lane.  Nothing padded crosses, so all of it
    is useful.  ``large_from`` lowers the large route's threshold so both
    routes run; ``fused`` runs the amalgamated plan's group dispatches,
    which count as the plain plan's dispatches do."""
    if large_from is not None:
        monkeypatch.setattr(executor_module, "VMEM_FRONT_MAX", large_from)
    limit = executor_module.VMEM_FRONT_MAX
    if fused:
        plan, prov = fused15
        ex = PlanExecutor(grid15[1], plan, devices=CPU4, dtype=torch.float64, mode=mode,
                          provenance=prov)
    else:
        ex = executor(grid15, mode)
    _, rep = ex.run(grid15[0], warmup=False)
    item = np.dtype(np.float64).itemsize
    sns = grid15[1].supernodes
    lower = sp.tril(grid15[0]).tocsc()
    copied = lower.nnz * 8 * len(set(CPU4)) + sum(sn.m * sn.nb for sn in sns) * item
    n_large = sum(padded_shape(sn.m, sn.nb)[0] > limit for sn in sns)
    assert (n_large > 0) == (large_from is not None)
    assert rep.host.copied_bytes == rep.host.useful_bytes == copied
    assert counter(COUNTERS[1], kind="copied") == counter(COUNTERS[1], kind="useful") == copied


def test_consecutive_runs_lie_end_to_end(grid15):
    ex = executor(grid15)
    ex.run(grid15[0], warmup=True)
    obs.reset()
    ex.run(grid15[0], warmup=False)
    first = obs.BUS.spans()
    first_points = obs.BUS.events()
    ex.run(grid15[0], warmup=False)
    second = obs.BUS.spans()[len(first):]
    assert {(s.cat, s.name) for s in first} == {(s.cat, s.name) for s in second}
    assert max(s.t1 for s in first) <= min(s.t0 for s in second)
    assert max(e.t for e in first_points) <= min(e.t for e in obs.BUS.events()[len(first_points):])
    # the report's per-front spans lie inside their run's stage spans
    for run in (first, second):
        stages = [s for s in run if s.cat == "dispatch"]
        fronts = [s for s in run if s.cat == "front"]
        lo, hi = min(s.t0 for s in stages), max(s.t1 for s in stages)
        assert all(lo <= s.t0 <= s.t1 <= hi for s in fronts)
    # on the bus clock: epoch + t is the perf_counter of the instant
    assert obs.BUS.epoch + max(s.t1 for s in second) <= time.perf_counter()


def test_utilization_window_is_the_spans_own(grid15):
    """Spans on the bus clock start after set-up, and a bus holds several
    runs: occupancy is measured over the spans' own window, or over the
    given makespan ending at the newest span, so it reads as one run."""
    def span(sid, t0, t1, dev):
        return obs.Span(sid, "run", "front", sid, dev, t0, t1, attrs={"devices_used": 1})

    one = [span(0, 0.0, 1.0, 0), span(1, 0.5, 2.0, 1), span(2, 1.0, 2.0, 0)]
    base = obs.device_utilization(one, 4)
    assert base["occupancy"] == pytest.approx(3.5 / 8) and base["horizon"] == 2.0
    late = [span(s.sid, s.t0 + 7.0, s.t1 + 7.0, s.device) for s in one]
    twice = late + [span(s.sid + 3, s.t0 + 2.0, s.t1 + 2.0, s.device) for s in late]
    for spans, horizon in ((late, None), (twice, None), (twice, 2.0)):
        u = obs.device_utilization(spans, 4, horizon)
        assert u["occupancy"] == pytest.approx(base["occupancy"])
        assert u["per_device"] == pytest.approx(base["per_device"])

    ex = executor(grid15)
    ex.run(grid15[0], warmup=True)
    obs.reset()
    ex.run(grid15[0], warmup=False)
    n_first = len(obs.BUS.spans(cat="front"))
    _, rep = ex.run(grid15[0], warmup=False)
    fronts = obs.BUS.spans(cat="front")
    newest = obs.device_utilization(fronts[n_first:], 4, rep.measured_makespan)
    on_bus = obs.device_utilization(fronts, 4, rep.measured_makespan)
    assert 0.0 < on_bus["occupancy"] <= 1.0
    assert on_bus["per_device"] == pytest.approx(newest["per_device"])


def test_bus_keeps_the_newest_records_past_its_capacity():
    cap = obs_events.CAPACITY
    assert cap == 1 << 17
    bus = obs_events.EventBus()
    for i in range(cap + 10):
        bus.span("x", float(i), float(i) + 0.5, cat="t", key=i)
    for i in range(cap + 7):
        bus.point("p", float(i), t=float(i))
    spans, events = bus.spans(), bus.events()
    assert len(spans) == len(events) == cap and len(bus) == 2 * cap
    assert [s.key for s in spans[:2]] == [10, 11] and spans[-1].key == cap + 9
    assert events[0].value == 7.0 and events[-1].value == float(cap + 6)
    assert bus.dropped == 17
    bus.clear()
    assert bus.dropped == 0 and len(bus) == 0


@pytest.mark.parametrize("mode", ["async", "waves"])
def test_disabled_obs_records_nothing_and_keeps_the_bits(grid15, mode):
    ex = executor(grid15, mode)
    on, rep_on = ex.run(grid15[0], warmup=False)
    obs.reset()
    obs.disable()
    try:
        off, rep_off = ex.run(grid15[0], warmup=False)
        assert len(obs.BUS) == 0 and obs.BUS.dropped == 0
        assert obs.REGISTRY.names() == []
    finally:
        obs.enable()
    for a, b in zip(on.panels, off.panels):
        np.testing.assert_array_equal(a, b)
    # the report keeps its totals either way
    assert rep_off.host.copied_bytes == rep_on.host.copied_bytes > 0


def test_profiler_trace_holds_the_stage_ranges(grid15, tmp_path):
    ex = executor(grid15)
    ex.run(grid15[0], warmup=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex.run(grid15[0], warmup=False)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    for stage in MAIN:
        assert f"executor.{stage}" in names
    # the profiler is off again: no range is opened
    assert not torch.autograd.profiler._is_profiler_enabled


# ----------------------------------------------------------------------
NEW_METRICS = (
    "executor.scan_ms", "executor.assemble_ms", "executor.pad_ms", "executor.extract_ms",
    "executor.wait_ms", "executor.report_ms", "executor.copy_mb", "executor.copy_useful",
    "host.gc_ms",
)


def test_benchmark_traced_run_prints_the_host_metrics():
    """``bench/run.py``'s traced run on CPU lanes, a small grid: the nine
    readers of the executor's counters report."""
    spec = importlib.util.spec_from_file_location("bench_run_for_tests", REPO / "bench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    out = run.run_cell(run.Harness(REPO), "diffusion3d-40.refactor", 2**31 + 7, 0.0, True,
                       devices=["cpu"], config_overrides={"grid": [12, 12]})
    assert out["correct"]
    metrics = out["metrics"]
    assert set(NEW_METRICS) <= set(metrics)
    for name in NEW_METRICS:
        assert math.isfinite(metrics[name]["value"]) and metrics[name]["value"] >= 0.0
    assert metrics["executor.copy_mb"]["value"] > 0
    assert 0 < metrics["executor.copy_useful"]["value"] <= 100
    spec_json = json.loads((REPO / "BENCHMARK.json").read_text())
    units = {m["name"]: m["unit"] for m in spec_json["per_layer"]}
    assert all(metrics[name]["unit"] == units[name] for name in NEW_METRICS)
