"""The port's telemetry layer (``repro_torch.obs``) against the JAX
package's: twins of the cases of ``tests/test_obs.py`` that had none (its
serve and elastic telemetry cases are twinned in
``tests/test_torch_online.py``).

* the event bus and the metrics registry — copies, so each twin runs the
  same calls on both packages and their results (spans, tracks,
  Prometheus text, snapshots) must be equal;
* efficiency — p̂(t) folding, the Theorem-6 fluid ratio, L2 deviation, α
  residuals, device utilization: equal to the reference's on the same
  seeded inputs;
* the one chrome-trace vocabulary — both packages' slice key sets equal,
  exactly, on a planned schedule and an executed run;
* executor integration — an async run (the reference on CPU JAX, the port
  on CPU lanes: the kernels' plain versions) publishes well-formed spans
  whose aggregates match its ExecutionReport, the same span names, metric
  names and counter tracks as the reference's run; ``obs.disable()``
  leaves the port's factors bit-identical while recording nothing;
* the dashboard — HTTP routes on localhost, ``serve(dashboard_port=0)``
  and the static HTML report, for both packages.
"""
import json
import math
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.core.trees as rtrees
import repro.obs as robs
import repro.obs.trace as rtrace
import repro.sparse as rsparse
import repro_torch.api as tapi
import repro_torch.core.trees as ttrees
import repro_torch.obs as tobs
import repro_torch.obs.trace as ttrace
import repro_torch.sparse as tsparse
from repro.core.pm import tree_equivalent_lengths

ALPHA = 0.9
SEED = 1234  # the conftest ``rng`` fixture's seed

REF = SimpleNamespace(name="ref", obs=robs, api=rapi, trees=rtrees, sparse=rsparse,
                      trace=rtrace)
PORT = SimpleNamespace(name="port", obs=tobs, api=tapi, trees=ttrees, sparse=tsparse,
                       trace=ttrace)


@pytest.fixture(autouse=True)
def fresh_obs():
    for o in (robs, tobs):
        o.enable()
        o.reset()
    yield
    for o in (robs, tobs):
        o.enable()
        o.reset()


def twin(run):
    """``run(P, rng)`` for the reference and the port, each with a fresh
    generator of the same seed; the two results' ``repr`` must be equal.
    Returns the port's result."""
    ref = run(REF, np.random.default_rng(SEED))
    port = run(PORT, np.random.default_rng(SEED))
    assert repr(port) == repr(ref)
    return port


def grid_problem(P, g: int = 9):
    a = P.sparse.grid_laplacian_2d(g)
    return P.api.Problem.from_matrix(
        a, ALPHA, ordering=P.sparse.nested_dissection_2d(g), name=f"grid{g}"
    )


# What the port's executor publishes beyond the reference's vocabulary:
# its host stages as spans of category ``dispatch``, and three counters
PORT_STAGE_SPANS = {("dispatch", stage) for stage in (
    "scan", "assemble", "pad", "wait", "extract", "report", "transfer")} | {
    ("analyze", stage) for stage in ("compress", "etree", "patterns", "supernodes")}
PORT_COUNTERS = {"repro_executor_stage_seconds_total", "repro_executor_copy_bytes_total",
                 "repro_host_gc_seconds_total", "repro_executor_large_seconds_total",
                 "repro_executor_large_bytes_total", "repro_executor_large_fronts_total",
                 "repro_executor_kept_bytes_total", "repro_executor_kept_blocks_total",
                 "repro_executor_small_fronts_total", "repro_executor_small_kept_bytes_total",
                 "repro_sparse_analyze_seconds_total",
                 "repro_sparse_supervariable_width"}


def mesh(P, n: int):
    """The reference's ``DeviceMesh(plan_devices=n)`` on its CPU device;
    the port's n CPU lanes."""
    if P is REF:
        return rapi.DeviceMesh(plan_devices=n)
    return tapi.DeviceMesh([torch.device("cpu")] * n)


def test_obs_exports_match_reference():
    assert sorted(tobs.__all__) == sorted(robs.__all__)
    for name in robs.__all__:
        assert hasattr(tobs, name)


# ----------------------------------------------------------------------
# Event bus
# ----------------------------------------------------------------------
def test_bus_begin_end_round_trip():
    def run(P, _):
        bus = P.obs.EventBus()
        sid = bus.begin("run", cat="front", key=3, device=2, t=1.0, flops=5.0)
        assert bus.open_spans() == [sid]
        sp = bus.end(sid, t=2.5, batched=2)
        assert bus.open_spans() == []
        assert (sp.name, sp.cat, sp.key, sp.device) == ("run", "front", 3, 2)
        assert sp.t0 == 1.0 and sp.t1 == 2.5 and sp.duration == 1.5
        assert sp.attrs == {"flops": 5.0, "batched": 2}
        assert bus.spans(cat="front", name="run") == [sp]
        return sp

    twin(run)


def test_bus_orphan_end_raises():
    for P in (REF, PORT):
        bus = P.obs.EventBus()
        with pytest.raises(KeyError):
            bus.end(999)


def test_bus_disabled_publishes_nothing():
    def run(P, _):
        bus = P.obs.EventBus()
        P.obs.disable()
        try:
            sid = bus.begin("run")
            assert sid == -1
            assert bus.end(sid) is None  # the disabled handshake is silent
            bus.span("run", 0.0, 1.0)
            bus.point("queue_depth", 4.0)
            assert len(bus) == 0 and bus.open_spans() == []
        finally:
            P.obs.enable()
        return sid, len(bus)

    twin(run)


def test_bus_counter_tracks_sorted_by_time():
    def run(P, _):
        bus = P.obs.EventBus()
        bus.point("queue_depth", 2.0, t=5.0)
        bus.point("queue_depth", 3.0, t=1.0)
        bus.point("marker", t=2.0)  # value-less: not a counter sample
        tracks = bus.counter_tracks()
        assert tracks == {"queue_depth": [(1.0, 3.0), (5.0, 2.0)]}
        return tracks

    twin(run)


def test_bus_subscribe_streams_and_unsubscribes():
    def run(P, _):
        bus = P.obs.EventBus()
        seen = []
        unsub = bus.subscribe(seen.append)
        bus.span("run", 0.0, 1.0)
        bus.point("capacity", 8.0, t=0.5)
        assert [type(x).__name__ for x in seen] == ["Span", "Event"]
        unsub()
        bus.span("run", 1.0, 2.0)
        assert len(seen) == 2
        return [type(x).__name__ for x in seen]

    twin(run)


def test_bus_mixed_clocks_are_tagged():
    def run(P, _):
        bus = P.obs.EventBus()
        bus.span("run", 0.0, 1.0, clock=P.obs.VIRTUAL)
        bus.span("run", 0.0, 1.0, clock=P.obs.WALL)
        clocks = {s.clock for s in bus.spans()}
        assert clocks == {P.obs.VIRTUAL, P.obs.WALL}
        return sorted(clocks)

    twin(run)


# ----------------------------------------------------------------------
# Metrics registry
# ----------------------------------------------------------------------
def test_counter_labels_and_monotonicity():
    def run(P, _):
        reg = P.obs.Registry()
        c = reg.counter("repro_requests_total", "requests", unit="1")
        c.inc()
        c.inc(2.0, tenant=3)
        c.inc(1.0, tenant=3)
        assert c.value == 1.0
        assert c.value_of(tenant=3) == 3.0
        with pytest.raises(ValueError):
            c.inc(-1.0)
        text = reg.prometheus()
        assert "# TYPE repro_requests_total counter" in text
        assert 'repro_requests_total{tenant="3"} 3' in text
        return text

    twin(run)


def test_gauge_track_series():
    def run(P, _):
        reg = P.obs.Registry()
        g = reg.gauge("repro_queue_depth", "depth", track=True)
        g.set(2.0, t=0.5)
        g.set(5.0, t=1.5)
        assert g.value == 5.0
        assert g.track() == [(0.5, 2.0), (1.5, 5.0)]
        return g.track(), reg.snapshot()

    twin(run)


def test_histogram_prometheus_semantics():
    def run(P, _):
        reg = P.obs.Registry()
        h = reg.histogram("repro_lat", "latency", unit="s", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 5.0, float("nan")):
            h.observe(v)
        assert h.count == 4  # NaN observations are dropped
        assert h.mean() == pytest.approx((0.05 + 0.5 + 0.5 + 5.0) / 4)
        assert h.quantile(0.5) == 1.0  # bucket-resolved upper bound
        lines = h.prometheus()
        assert 'repro_lat_bucket{le="0.1"} 1' in lines
        assert 'repro_lat_bucket{le="1"} 3' in lines
        assert 'repro_lat_bucket{le="+Inf"} 4' in lines
        assert any(l.startswith("repro_lat_sum ") for l in lines)
        assert "repro_lat_count 4" in lines
        return lines

    twin(run)


def test_registry_kind_conflict_and_snapshot():
    def run(P, _):
        reg = P.obs.Registry()
        reg.counter("repro_x", "a counter").inc()
        with pytest.raises(TypeError):
            reg.gauge("repro_x")
        snap = reg.snapshot()
        json.dumps(snap)  # JSON-safe by contract
        assert snap["repro_x"]["values"]["total"] == 1.0
        return snap

    twin(run)


def test_disabled_registry_records_nothing():
    def run(P, _):
        reg = P.obs.Registry()
        P.obs.disable()
        try:
            reg.counter("repro_c").inc()
            reg.gauge("repro_g", track=True).set(3.0)
            reg.histogram("repro_h").observe(1.0)
            assert reg.counter("repro_c").value == 0.0
            assert reg.gauge("repro_g").value == 0.0
            assert reg.histogram("repro_h").count == 0
        finally:
            P.obs.enable()
        return reg.snapshot()

    twin(run)


# ----------------------------------------------------------------------
# Efficiency: p̂(t), the fluid bound, α residuals, utilization
# ----------------------------------------------------------------------
def test_fold_share_timeline():
    def run(P, _):
        steps = P.obs.fold_share_timeline(
            [(0.0, 2.0, 4.0), (1.0, 3.0, 2.0), (5.0, 5.0, 9.0)]
        )
        assert steps == [(0.0, 4.0), (1.0, 6.0), (2.0, 2.0), (3.0, 0.0)]
        return steps

    twin(run)


def test_l2_deviation_zero_iff_identical():
    def run(P, _):
        ref = P.obs.pm_reference_timeline(8.0, 10.0)
        assert P.obs.l2_share_deviation(ref, ref) == 0.0
        half = [(0.0, 4.0), (20.0, 0.0)]  # half the share, twice as long
        dev = P.obs.l2_share_deviation(half, ref)
        assert dev > 0.3
        return dev, P.obs.l2_share_deviation(half, ref, normalize=False)

    twin(run)


def test_schedule_l2_deviation_fluid_pm_is_zero():
    def run(P, rng):
        tree = P.trees.random_assembly_tree(60, rng)
        sched = P.api.Session(P.api.SharedMemory(16)).load(tree, ALPHA).plan("pm").schedule
        dev = P.obs.schedule_l2_deviation(sched)
        assert dev == pytest.approx(0.0, abs=1e-6)
        return dev, P.obs.schedule_share_timeline(sched)

    twin(run)


def test_fluid_ratio_zero_noise_single_tree():
    """fluid_ratio == 1.0 within 1e-9 on the zero-noise single-tree case
    (the online PM loop *is* the fluid optimum)."""
    def run(P, rng):
        tree = P.trees.random_assembly_tree(80, rng)
        rep = P.api.Session(P.api.SharedMemory(24)).load(tree, ALPHA).simulate(policy="pm")
        assert abs(P.obs.fluid_ratio(rep) - 1.0) < 1e-9
        assert abs(rep.metrics["fluid_ratio"] - 1.0) < 1e-9
        fluid = tree_equivalent_lengths(tree, ALPHA)[tree.root] / 24**ALPHA
        assert P.obs.fluid_ratio(rep.makespan, fluid) == pytest.approx(1.0, abs=1e-9)
        return P.obs.fluid_ratio(rep), P.obs.efficiency_summary(rep)

    twin(run)


def test_alpha_residuals_recover_perfect_model():
    def run(P, _):
        pts = [("64x32", g, 3.0 * g**ALPHA) for g in (1, 2, 4, 8)] + [
            ("128x64", g, 7.0 * g**ALPHA) for g in (2, 8)
        ]
        out = P.obs.alpha_residuals(pts, ALPHA)
        for bucket in ("64x32", "128x64"):
            assert out[bucket]["rms"] == pytest.approx(0.0, abs=1e-12)
            assert out[bucket]["alpha_fit"] == pytest.approx(ALPHA, abs=1e-12)
        return out

    twin(run)


def test_device_utilization_merges_overlaps():
    def run(P, _):
        def mk(sid, t0, t1, dev, used):
            return P.obs.Span(sid, "run", "front", sid, dev, t0, t1,
                              attrs={"devices_used": used})

        spans = [
            mk(0, 0.0, 1.0, 0, 2),  # lanes 0,1
            mk(1, 0.5, 1.0, 0, 2),  # batched twin: same lanes, overlap merged
            mk(2, 1.0, 2.0, 2, 1),  # lane 2
        ]
        u = P.obs.device_utilization(spans, 4, horizon=2.0)
        assert u["per_device"] == pytest.approx([0.5, 0.5, 0.5, 0.0])
        assert u["occupancy"] == pytest.approx(0.375)
        assert u["horizon"] == 2.0
        return u

    twin(run)


# ----------------------------------------------------------------------
# One trace vocabulary: both legacy emitters, plus the bus view
# ----------------------------------------------------------------------
def test_schedule_trace_key_set_regression():
    assert ttrace.SLICE_KEYS == rtrace.SLICE_KEYS
    assert ttrace.PHASE_ORDER == rtrace.PHASE_ORDER

    def run(P, _):
        prob = grid_problem(P, 9)
        sched = P.api.Session(P.api.SharedMemory(8)).load(prob).plan("greedy").schedule
        trace = sched.to_trace()
        assert trace
        for ev in trace:
            assert set(ev) == P.trace.SLICE_KEYS
            assert ev["ph"] == "X"
        return trace

    twin(run)


def _async_run(P):
    """One instrumented async execution of the 9×9 grid (CPU, f32),
    captured before any reset."""
    P.obs.enable()
    P.obs.reset()
    rep = (
        P.api.Session(mesh(P, 8))
        .load(grid_problem(P, 9))
        .plan("greedy")
        .execute(mode="async", warmup=False)
    )
    reg = P.obs.get_registry()
    return {
        "rep": rep,
        "spans": P.obs.BUS.spans(),
        "open": P.obs.BUS.open_spans(),
        "tracks": P.obs.BUS.counter_tracks(),
        "snapshot": reg.snapshot(),
        "bus_trace": P.obs.from_bus(P.obs.BUS),
        "report_trace": rep.detail.to_trace(),
    }


@pytest.fixture(scope="module")
def async_runs():
    return {"ref": _async_run(REF), "port": _async_run(PORT)}


def test_execution_trace_key_set_regression(async_runs):
    for name, P in (("ref", REF), ("port", PORT)):
        trace = async_runs[name]["report_trace"]
        assert trace
        for ev in trace:
            assert set(ev) == P.trace.SLICE_KEYS
            assert ev["ph"] == "X"
    key_sets = {name: {frozenset(ev) for ev in async_runs[name]["report_trace"]}
                for name in ("ref", "port")}
    assert key_sets["port"] == key_sets["ref"]
    # the same fronts, in the same plan
    assert sorted(ev["name"] for ev in async_runs["port"]["report_trace"]) == sorted(
        ev["name"] for ev in async_runs["ref"]["report_trace"])


def test_async_run_spans_well_formed(async_runs):
    names = {}
    for name, P in (("ref", REF), ("port", PORT)):
        run = async_runs[name]
        spans = run["spans"]
        assert run["open"] == []  # every begin() was matched
        fronts = [s for s in spans if s.cat == "front"]
        assert fronts and {s.name for s in fronts} <= set(P.trace.PHASE_ORDER)
        by_key = {}
        for s in fronts:
            by_key.setdefault(s.key, {})[s.name] = s
        n_run = 0
        for key, phases in by_key.items():
            r = phases.get("run")
            assert r is not None, f"{name}: front {key} has no run span"
            n_run += 1
            assert math.isfinite(r.t0) and r.t1 >= r.t0 >= 0.0
            assert r.attrs["devices_used"] >= 1
            if "submit" in phases:  # submit ends where the run starts
                assert phases["submit"].t1 == pytest.approx(r.t0, abs=1e-9)
            if "ready" in phases:  # ready ends at (or before) dispatch
                assert phases["ready"].t1 <= r.t0 + 1e-9
        assert n_run == len(run["rep"].detail.trace)
        names[name] = {(s.cat, s.name) for s in spans}
    assert names["port"] == names["ref"] | PORT_STAGE_SPANS
    assert not names["ref"] & PORT_STAGE_SPANS


def test_async_run_counters_match_report(async_runs):
    for name in ("ref", "port"):
        rep, snap = async_runs[name]["rep"], async_runs[name]["snapshot"]
        trace = rep.detail.trace
        assert snap["repro_fronts_completed_total"]["values"]["total"] == len(trace)
        assert (
            snap["repro_dispatches_total"]["values"]["total"]
            == rep.detail.n_dispatches
        )
        n_ready = sum(1 for e in trace if not math.isnan(e.t_ready))
        assert snap["repro_ready_latency_seconds"]["count"] == n_ready
        widths = snap["repro_batch_width"]
        assert widths["sum"] == len(trace)
        assert snap["repro_peak_resident_bytes"]["values"]["value"] == (
            rep.detail.measured_peak_bytes
        )
    port, ref = set(async_runs["port"]["snapshot"]), set(async_runs["ref"]["snapshot"])
    assert port == ref | PORT_COUNTERS and not ref & PORT_COUNTERS
    host = async_runs["port"]["rep"].detail.host
    snap = async_runs["port"]["snapshot"]
    assert snap["repro_executor_copy_bytes_total"]["values"]['{kind="copied"}'] == (
        host.copied_bytes
    )
    assert snap["repro_host_gc_seconds_total"]["values"]["total"] == host.gc_seconds


def test_async_run_live_counter_tracks(async_runs):
    for name in ("ref", "port"):
        tracks = async_runs[name]["tracks"]
        for track in ("queue_depth", "resident_bytes"):
            assert track in tracks and tracks[track]
            ts = [t for t, _ in tracks[track]]
            assert ts == sorted(ts)
        assert all(v >= 0 for _, v in tracks["resident_bytes"])
    assert sorted(async_runs["port"]["tracks"]) == sorted(async_runs["ref"]["tracks"])


def test_bus_trace_has_lanes_phases_and_counters(async_runs):
    for name, P in (("ref", REF), ("port", PORT)):
        events = async_runs[name]["bus_trace"]
        json.dumps(events)  # perfetto-loadable JSON
        phs = {e["ph"] for e in events}
        assert phs == {"M", "X", "C"}
        metas = [e for e in events if e["ph"] == "M"]
        assert events[: len(metas)] == metas
        names = {e["args"]["process_name"] for e in metas}
        assert "host" in names
        assert any(n.startswith("device") for n in names)
        for e in events:
            if e["ph"] == "X":
                assert set(e) == P.trace.SLICE_KEYS and e["dur"] > 0
        counters = {e["name"] for e in events if e["ph"] == "C"}
        assert "queue_depth" in counters and "resident_bytes" in counters


def test_run_report_metrics_have_no_null_values(async_runs):
    for name in ("ref", "port"):
        for k, v in async_runs[name]["rep"].metrics.items():
            assert v is not None, k
            assert not (isinstance(v, float) and math.isnan(v)), k
    # the port's metric names are the reference's
    assert sorted(async_runs["port"]["rep"].metrics) == sorted(async_runs["ref"]["rep"].metrics)


def test_utilization_and_efficiency_from_bus(async_runs):
    for name, P in (("ref", REF), ("port", PORT)):
        spans = async_runs[name]["spans"]
        u = P.obs.device_utilization([s for s in spans if s.cat == "front"], 8)
        assert 0.0 < u["occupancy"] <= 1.0
        assert len(u["per_device"]) == 8
        summary = P.obs.efficiency_summary(async_runs[name]["rep"])
        assert summary["fluid_ratio"] >= 0.0
        json.dumps(summary)
    port = async_runs["port"]
    # the port's field names, through the padded-shape buckets
    res = tobs.execution_alpha_residuals(port["rep"].detail,
                                         port["rep"].artifact.symb)
    assert res and all(set(v) >= {"n", "mean_abs", "rms"} for v in res.values())
    assert sorted(tobs.efficiency_summary(port["rep"])) == sorted(
        robs.efficiency_summary(async_runs["ref"]["rep"]))


# ----------------------------------------------------------------------
# Zero-overhead disable: bit-identical factors, silent instruments
# ----------------------------------------------------------------------
def test_disable_leaves_factors_bit_identical():
    prob = grid_problem(PORT, 7)

    def run():
        tobs.reset()
        rep = (
            tapi.Session(mesh(PORT, 4))
            .load(prob)
            .plan("greedy")
            .execute(mode="async", warmup=False)
        )
        return rep.artifact.to_dense_l()

    on = run()
    tobs.disable()
    try:
        off = run()
        assert len(tobs.BUS) == 0
        assert tobs.get_registry().names() == []
    finally:
        tobs.enable()
    np.testing.assert_array_equal(on, off)


# ----------------------------------------------------------------------
# Dashboard: HTTP routes, static HTML, trace file
# ----------------------------------------------------------------------
def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as resp:
        assert resp.status == 200
        return resp.read()


def test_dashboard_routes():
    def run(P, rng):
        tree = P.trees.random_assembly_tree(40, rng)
        P.api.Session(P.api.SharedMemory(8)).load(tree, ALPHA).simulate(policy="pm")
        dash = P.obs.Dashboard(0, context={"subtitle": "test run"})
        try:
            assert dash.host == "127.0.0.1"
            page = _get(dash.url).decode()
            assert "<html" in page and "test run" in page
            prom = _get(dash.url + "metrics").decode()
            assert "# TYPE" in prom
            snap = json.loads(_get(dash.url + "metrics.json"))
            assert isinstance(snap, dict)
            trace = json.loads(_get(dash.url + "trace.json"))
            assert trace["traceEvents"]
            with pytest.raises(urllib.error.HTTPError):
                _get(dash.url + "nope")
        finally:
            dash.stop()
        return sorted(snap), sorted({e["ph"] for e in trace["traceEvents"]})

    twin(run)


def test_serve_dashboard_port_lifecycle():
    def run(P, rng):
        tree = P.trees.random_assembly_tree(30, rng)
        sess = P.api.Session(P.api.SharedMemory(8))
        rep = sess.serve([(P.api.Problem.from_tree(tree, ALPHA), 0.0)], dashboard_port=0)
        assert sess.dashboard is not None
        try:
            page = _get(sess.dashboard.url).decode()
            assert "<html" in page
            # post-run context carries the run's makespan
            assert sess.dashboard.context["makespan"] == rep.makespan
            context = dict(sess.dashboard.context)
        finally:
            sess.close()
        assert sess.dashboard is None
        return context

    twin(run)


def test_save_html_and_trace_files(tmp_path):
    def run(P, rng):
        tree = P.trees.random_assembly_tree(40, rng)
        rep = P.api.Session(P.api.SharedMemory(8)).load(tree, ALPHA).simulate(policy="pm")
        html_path = rep.save_html(tmp_path / f"{P.name}.html")
        doc = open(html_path).read()
        assert "<html" in doc and "repro" in doc
        trace_path = tmp_path / f"{P.name}.trace.json"
        P.obs.save_trace(P.obs.from_bus(P.obs.BUS), trace_path)
        loaded = json.loads(open(trace_path).read())
        assert loaded["displayTimeUnit"] == "ms"
        assert loaded["traceEvents"]
        return rep.summary(), loaded["traceEvents"]

    twin(run)
