"""The port's serving cluster (``repro_torch.cluster``): twins of every case
of ``tests/test_cluster.py``, run on CPU workers
(``devices=[torch.device("cpu")]``: the kernels' plain versions).

Comm codec, framing, faults and retry; heartbeat loss and rejoin (the
Theorem-6 capacity path); worker death mid-front; scheduler
checkpoint/restore; cross-tenant continuous batching; clean drain and
shutdown on the inproc and TCP backends; the ``Session.serve(cluster=)``
facade.  The numeric twins hold the cluster's factors bit for bit against
the port's own single-process executor (``Session(...).execute``), the
claim the reference makes of itself; one more test holds the port's
cluster factor against the reference's single-process executor within
the kernels' tolerance (1e-11 relative in f64, 5e-5 in f32, as in
``tests/test_kernels.py``).  The reference's cluster output is never the
oracle: it is flaky under load (ROADMAP queue 3).

Robust to a loaded host without checking less: every leak check waits,
with a deadline, for the port's threads to exit (their names start with
``repro_torch-``, so the reference's threads in the same process never
count), and the cases that do not test failure detection use the
heartbeat timeout of the reference's numeric tests (10 s), so a stalled
heartbeat is not taken for a dead worker.  Failure-detection cases keep
the reference's short timings.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.cluster as rcluster
import repro.sparse as rsparse
import repro_torch.cluster as tcluster
import repro_torch.cluster.scheduler as tscheduler
import repro_torch.kernels.frontal_cholesky as fc
import repro_torch.sparse as tsparse
from repro_torch.api import DeviceMesh, Problem, Session
from repro_torch.cluster import (
    ClusterClient,
    ClusterScheduler,
    CommError,
    FaultInjector,
    LocalCluster,
    RetryPolicy,
    Worker,
    connect,
    decode,
    encode,
    leaked_threads,
    listen,
    open_socket_count,
)

ALPHA = 0.9
CPU = [torch.device("cpu")]

# Sim-mode knobs: fast virtual work, heartbeats quick enough that a
# kill is noticed inside the test budget (the reference's timings).
FAST = dict(tick=0.002, work_rate=200.0)
HB = dict(heartbeat_interval=0.03, heartbeat_timeout=0.2)
# cases that test no failure detection: the reference numeric tests'
# timeout, so a heartbeat stalled by a loaded host is not a death
CALM = dict(heartbeat_interval=0.03, heartbeat_timeout=10.0)


def _trees(rng, n, tasks=3):
    return [
        Problem.from_lengths(rng.uniform(0.5, 2.0, size=tasks), ALPHA)
        for _ in range(n)
    ]


def _wait(pred, timeout=20.0, tick=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(tick)
    return pred()


def no_leaks(timeout=10.0) -> list:
    """The port's live cluster threads once they had ``timeout`` seconds
    to exit (a stop joins them, but a loaded host may finish a daemon
    thread's last loop after the join's own deadline)."""
    _wait(lambda: not leaked_threads(), timeout=timeout)
    return leaked_threads()


def _grid_problem(pkg=tsparse, api=None):
    """A matrix whose elimination tree is an actual tree (min_degree on
    the 8x8 Poisson grid gives ~45 supernodes; natural order collapses
    to one)."""
    api = api or Problem
    return api.from_matrix(
        pkg.grid_laplacian_2d(8, 8), ALPHA, ordering=pkg.min_degree
    )


def _single_process(prob, dtype):
    """The port's own single-process executor on CPU lanes."""
    return (
        Session(DeviceMesh(CPU * 4))
        .load(prob)
        .plan("greedy")
        .execute(dtype=dtype, warmup=False)
        .artifact
    )


# ----------------------------------------------------------------------
# Comm layer: codec, framing, faults, retry
# ----------------------------------------------------------------------
def test_codec_roundtrip_ndarray_bit_exact(rng):
    """ndarrays survive the wire envelope bit-for-bit (raw bytes, not
    repr) — the transport must not be able to perturb factors; the
    port's frames are the reference's, byte for byte."""
    for dtype in (np.float64, np.float32, np.int32):
        a = rng.standard_normal((7, 5)).astype(dtype)
        msg = {"op": "x", "a": a, "nested": {"b": [a[0], "s", 3]}}
        wire = encode(msg)
        assert wire == rcluster.encode(msg)
        out = decode(wire)
        assert out["a"].dtype == a.dtype
        assert out["a"].tobytes() == a.tobytes()
        assert out["nested"]["b"][0].tobytes() == a[0].tobytes()
        assert out["nested"]["b"][1:] == ["s", 3]


def test_codec_pickle_fallback_for_problems(rng):
    p = _trees(rng, 1)[0]
    q = decode(encode({"problem": p}))["problem"]
    assert np.allclose(q.tree.lengths, p.tree.lengths)
    assert q.alpha == p.alpha
    # device data never rides the wire: workers convert at their edge
    with pytest.raises(TypeError, match="numpy"):
        encode({"fronts": torch.zeros(2, 2)})


@pytest.mark.parametrize("scheme", ["inproc", "tcp"])
def test_comm_roundtrip_and_close(scheme):
    address = f"{scheme}://{'comm-rt' if scheme == 'inproc' else '127.0.0.1:0'}"
    got = []

    def serve(comm):
        while True:
            msg = comm.recv(timeout=1.0)
            if msg is None:
                continue
            got.append(msg)
            if msg.get("op") == "bye":
                return
            comm.send({"echo": msg["n"] * 2})

    def handler(comm):
        threading.Thread(target=serve, args=(comm,), daemon=True).start()

    listener = listen(address, handler)
    try:
        comm = connect(listener.address)
        for n in range(3):
            comm.send({"op": "ping", "n": n})
            assert comm.recv(timeout=2.0) == {"echo": n * 2}
        comm.send({"op": "bye"})
        assert _wait(lambda: len(got) == 4, timeout=5.0)
        comm.close()
    finally:
        listener.close()
    assert [m["op"] for m in got] == ["ping", "ping", "ping", "bye"]


def test_fault_injector_drop_and_fail():
    faults = FaultInjector()
    faults.drop(2, op="heartbeat")
    faults.fail(1, op="data")
    assert faults.check({"op": "heartbeat"}) == "drop"
    assert faults.check({"op": "heartbeat"}) == "drop"
    assert faults.check({"op": "heartbeat"}) == "ok"  # budget spent
    assert faults.check({"op": "other"}) == "ok"  # op filter holds
    assert faults.check({"op": "data"}) == "fail"
    assert faults.dropped == 2 and faults.failed == 1


def test_connect_retry_backoff_exhaustion():
    """No listener: connect retries with exponential backoff then raises
    CommError naming the attempt count."""
    t0 = time.perf_counter()
    with pytest.raises(CommError, match="after 3 attempts"):
        connect(
            "inproc://nobody-listening",
            retry=RetryPolicy(retries=2, backoff=0.02, factor=2.0),
        )
    assert time.perf_counter() - t0 >= 0.05


# ----------------------------------------------------------------------
# Cluster end-to-end (sim mode): serve, batch, drain clean
# ----------------------------------------------------------------------
def test_inproc_cluster_serves_multi_tenant_stream(rng):
    with LocalCluster(
        n_workers=2, slots_per_worker=2, devices=CPU, **FAST, **CALM
    ) as cl:
        client = cl.client()
        futs = [
            client.submit(p, tenant=i % 3, rid=i)
            for i, p in enumerate(_trees(rng, 9))
        ]
        results = client.gather(futs, timeout=30.0)
        assert all(r.ok for r in results)
        assert sorted(r.rid for r in results) == list(range(9))
        assert {r.tenant for r in results} == {0, 1, 2}
        assert all(r.wait >= 0.0 and r.exec_time > 0.0 for r in results)
        stats = cl.scheduler.stats()
        assert stats["n_done"] == 9 and stats["n_reshares"] >= 1
        cl.drain()
    assert no_leaks() == []


def test_qos_weights_skew_fair_admission_toward_heavy_tenant():
    """Weighted fair share end-to-end: with tenant 0 weighing 4x, its
    backlog is admitted ~4x as often, so its mean wait drops below the
    equal-weight tenant's on the same one-at-a-time pool."""
    with LocalCluster(
        n_workers=1,
        slots_per_worker=1,
        admission="fair",
        max_concurrent=1,
        qos_weights={0: 4.0, 1: 1.0},
        devices=CPU,
        **FAST,
        **CALM,
    ) as cl:
        client = cl.client()
        futs = [
            client.submit(
                Problem.from_lengths([1.0, 1.0, 1.0], ALPHA),
                tenant=i % 2,
                rid=i,
            )
            for i in range(8)
        ]
        results = client.gather(futs, timeout=60.0)
        assert all(r.ok for r in results)
        wait = {
            t: np.mean([r.wait for r in results if r.tenant == t])
            for t in (0, 1)
        }
        assert wait[0] < wait[1]
        cl.drain()
    assert no_leaks() == []


def test_cross_tenant_batching_merges_fronts(rng):
    """Same-shape ready fronts from *different tenants* ride one
    dispatch (continuous batching), and turning batching off forbids
    it."""
    def run(batching):
        with LocalCluster(
            n_workers=1, slots_per_worker=4, batching=batching, devices=CPU,
            **FAST, **CALM,
        ) as cl:
            client = cl.client()
            futs = [
                client.submit(p, tenant=i, rid=i)
                for i, p in enumerate(_trees(rng, 6, tasks=2))
            ]
            assert all(r.ok for r in client.gather(futs, timeout=30.0))
            return cl.scheduler.stats()["n_dispatches"], list(
                cl.scheduler.batch_tenant_mix
            )

    n_batched, mix = run(True)
    n_single, _ = run(False)
    assert n_batched < n_single
    assert any(n > 1 for n in mix)
    assert no_leaks() == []


def test_tcp_cluster_end_to_end(rng):
    """The same protocol over real sockets: length-prefixed frames,
    ndarray envelopes, clean socket teardown."""
    with LocalCluster(
        n_workers=2, scheme="tcp", devices=CPU, **FAST, **CALM
    ) as cl:
        assert cl.scheduler.address.startswith("tcp://127.0.0.1:")
        client = cl.client()
        futs = [
            client.submit(p, tenant=i % 2, rid=i)
            for i, p in enumerate(_trees(rng, 6))
        ]
        assert all(r.ok for r in client.gather(futs, timeout=30.0))
        cl.drain()
    assert _wait(lambda: open_socket_count(cl) == 0, timeout=5.0)
    assert no_leaks() == []


# ----------------------------------------------------------------------
# Failure paths: heartbeats, worker death, restart
# ----------------------------------------------------------------------
def test_dropped_heartbeats_mark_worker_dead_then_rejoin():
    """Drop enough heartbeats and the failure detector fires a capacity
    event; a late heartbeat re-admits the worker with a second capacity
    event."""
    sched = ClusterScheduler(
        "inproc://hb-drop", heartbeat_timeout=0.15, tick=0.002
    )
    w = Worker("inproc://hb-drop", slots=2, heartbeat_interval=0.03)
    faults = w.comm.faults
    try:
        assert _wait(lambda: sched.total_slots() == 2, timeout=5.0)
        faults.drop(50, op="heartbeat")
        assert _wait(lambda: sched.stats()["n_worker_losses"] == 1, 10.0)
        assert sched.total_slots() == 0
        # Faults exhausted -> heartbeats flow again -> rejoin.
        assert _wait(lambda: sched.total_slots() == 2, timeout=10.0)
        assert sched.stats()["n_capacity_events"] >= 2
        assert faults.dropped == 50
    finally:
        w.stop()
        sched.stop()
    assert no_leaks() == []


def test_worker_killed_mid_front_requeues_and_reshares(rng):
    """Kill a worker holding in-flight fronts: its batches requeue, the
    Lemma-4 re-share runs on the shrunk pool (elastic capacity event),
    and every tree still completes."""
    with LocalCluster(
        n_workers=2,
        slots_per_worker=2,
        devices=CPU,
        tick=0.002,
        work_rate=10.0,
        heartbeat_interval=0.03,
        heartbeat_timeout=0.12,
    ) as cl:
        client = cl.client()
        futs = [
            client.submit(p, tenant=i % 2, rid=i)
            for i, p in enumerate(_trees(rng, 8, tasks=4))
        ]
        _wait(lambda: cl.scheduler.stats()["n_dispatches"] >= 2, timeout=10.0)
        cl.workers[0].kill()
        results = client.gather(futs, timeout=60.0)
        assert all(r.ok for r in results)
        stats = cl.scheduler.stats()
        assert stats["n_worker_losses"] >= 1
        assert stats["n_requeued"] >= 1
        # The elastic controller saw the pool shrink 4 -> 2.
        devices = [d for _, d in cl.scheduler.capacity_steps]
        assert devices[-1] == 2 and 4 in devices
    assert no_leaks() == []


def test_scheduler_restart_resumes_queued_tenants(rng):
    """checkpoint() on a scheduler with a backlog and restore() into a
    fresh one: every queued tenant's tree is served after the restart."""
    sched = ClusterScheduler("inproc://restart-a", **FAST)
    client = ClusterClient("inproc://restart-a")
    for i, p in enumerate(_trees(rng, 5)):
        client.submit(p, tenant=i % 2, rid=i)
    _wait(lambda: sched.stats()["n_pending"] + sched.stats()["n_admitted"] == 5)
    sched.stop()  # no worker ever joined: all five are still queued
    state = sched.checkpoint()
    client.close()
    assert len(state) == 5

    sched2 = ClusterScheduler("inproc://restart-b", **FAST)
    sched2.restore(state)
    w = Worker("inproc://restart-b", slots=2, heartbeat_interval=0.03)
    try:
        assert _wait(lambda: len(sched2.records) == 5, timeout=30.0)
        assert sorted(r.rid for r in sched2.records) == list(range(5))
        assert {r.tenant for r in sched2.records} == {0, 1}
    finally:
        w.stop()
        sched2.stop()
    assert no_leaks() == []


def test_client_futures_fail_on_scheduler_loss(rng):
    """Scheduler dies with requests in flight: pending futures resolve
    ok=False instead of hanging the client forever."""
    sched = ClusterScheduler("inproc://dies", tick=0.002)
    client = ClusterClient("inproc://dies")
    futs = [client.submit(p, rid=i) for i, p in enumerate(_trees(
        np.random.default_rng(0), 3))]
    sched.stop()
    results = client.gather(futs, timeout=10.0)
    assert all(not r.ok for r in results)
    assert any("lost" in (r.error or "") for r in results)
    client.close()
    assert no_leaks() == []


def test_client_futures_fail_when_scheduler_dies_before_reading(monkeypatch):
    """The same loss when the scheduler's reader has not yet read the
    client's hello (a loaded host delays that thread): ``stop()`` hangs up
    every connection it accepted, so the futures still resolve ok=False.
    This is why the reference's twin fails under a loaded test run: its
    client hangs until the gather times out, and its receive thread leaks
    into the later cases' leak checks (ROADMAP queue 3)."""
    reader = ClusterScheduler._reader

    def slow_reader(self, comm):
        time.sleep(0.05)
        return reader(self, comm)

    monkeypatch.setattr(tscheduler.ClusterScheduler, "_reader", slow_reader)
    sched = ClusterScheduler("inproc://dies-unread", tick=0.002)
    client = ClusterClient("inproc://dies-unread")
    futs = [client.submit(p, rid=i) for i, p in enumerate(_trees(
        np.random.default_rng(0), 3))]
    sched.stop()
    results = client.gather(futs, timeout=10.0)
    assert all(not r.ok for r in results)
    assert all("lost" in (r.error or "") for r in results)
    client.close()
    assert no_leaks() == []


def test_local_cluster_needs_devices_without_cuda(monkeypatch):
    """``devices=None`` is every CUDA device; with none it raises before
    starting anything: the CPU is never taken on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalCluster(n_workers=1)
    assert no_leaks() == []


def test_cluster_exports_match_reference():
    assert sorted(tcluster.__all__) == sorted(rcluster.__all__)
    for name in rcluster.__all__:
        assert hasattr(tcluster, name)


# ----------------------------------------------------------------------
# Numeric mode: factors bit-identical to the single-process path
# ----------------------------------------------------------------------
@pytest.mark.slow
def test_numeric_cluster_factors_bit_identical():
    """Three tenants submit the same sparse problem; the cluster's
    cross-tenant-batched factors match the port's single-process
    executor bit for bit (f64), through the plain versions only."""
    prob = _grid_problem()
    ref = _single_process(prob, torch.float64).to_dense_l()
    fc.reset_counters()
    with LocalCluster(
        n_workers=2,
        slots_per_worker=2,
        devices=CPU,
        dtype=torch.float64,
        tick=0.002,
        heartbeat_interval=0.03,
        heartbeat_timeout=10.0,  # a stalled heartbeat is not a death
    ) as cl:
        client = cl.client()
        futs = [client.submit(prob, tenant=t, rid=t) for t in range(3)]
        results = client.gather(futs, timeout=300.0)
        assert all(r.ok for r in results)
        for r in results:
            assert r.factor is not None
            assert r.factor.panels[0].dtype == np.float64
            assert np.array_equal(r.factor.to_dense_l(), ref)
        # no front failed and came back: every dispatch landed once
        assert cl.scheduler.stats()["n_requeued"] == 0
        assert any(b > 1 for w in cl.workers for b in w.batch_sizes)
    assert fc.PLAIN_RUNS["front_factor"] > 0
    assert all(v == 0 for v in fc.LAUNCHES.values())
    assert no_leaks() == []


@pytest.mark.slow
def test_numeric_worker_kill_factors_survive():
    """Kill a worker mid-factorization: requeued fronts re-execute on
    the survivor and the factor is still bit-identical (determinism is
    a property of the assembly order, not the dispatch history)."""
    prob = _grid_problem()
    ref = _single_process(prob, torch.float64).to_dense_l()
    with LocalCluster(
        n_workers=2,
        slots_per_worker=2,
        devices=CPU,
        dtype=torch.float64,
        tick=0.002,
        heartbeat_interval=0.03,
        heartbeat_timeout=0.2,
        dispatch_overhead_s=0.05,  # keep fronts in flight long enough
    ) as cl:
        client = cl.client()
        futs = [client.submit(prob, tenant=t, rid=t) for t in range(2)]
        _wait(lambda: cl.scheduler.stats()["n_dispatches"] >= 1, timeout=60.0)
        cl.workers[1].kill()
        results = client.gather(futs, timeout=300.0)
        assert all(r.ok for r in results)
        assert cl.scheduler.stats()["n_worker_losses"] >= 1
        for r in results:
            assert np.array_equal(r.factor.to_dense_l(), ref)
    assert no_leaks() == []


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 5e-5)])
def test_numeric_cluster_matches_reference_single_process(dtype, tol):
    """The port's cluster factor against the reference's single-process
    ``Session(SharedMemory(4)).load(prob).plan("greedy").execute()`` (CPU
    JAX, x64 for f64) on the same matrix: within the kernels' tolerance,
    relative to max(1, max|L|)."""
    rprob = _grid_problem(rsparse, rapi.Problem)
    x64 = dtype == torch.float64
    jax.config.update("jax_enable_x64", x64)
    try:
        want = (
            rapi.Session(rapi.SharedMemory(4))
            .load(rprob)
            .plan("greedy")
            .execute()
            .artifact.to_dense_l()
        )
    finally:
        jax.config.update("jax_enable_x64", False)
    prob = _grid_problem()
    with LocalCluster(
        n_workers=2, slots_per_worker=2, devices=CPU, dtype=dtype,
        tick=0.002, **CALM,
    ) as cl:
        client = cl.client()
        (res,) = client.gather([client.submit(prob, rid=0)], timeout=300.0)
    assert res.ok
    got = res.factor.to_dense_l()
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < tol
    dense = prob.matrix.toarray()
    assert np.abs(got @ got.T - dense).max() / np.abs(dense).max() < 10 * tol
    assert no_leaks() == []


# ----------------------------------------------------------------------
# Session facade
# ----------------------------------------------------------------------
def test_session_serve_cluster_report(rng):
    """Session.serve(cluster=...) returns a served RunReport whose
    schedule spans reconstruct the dispatch history and whose metrics
    carry the QPS/latency split."""
    from repro_torch.api import SharedMemory
    from repro_torch.online import poisson_arrivals

    trees = _trees(rng, 6)
    arrivals = poisson_arrivals(len(trees), 4.0, rng)
    stream = [
        (p, float(a), i % 2)
        for i, (p, a) in enumerate(zip(trees, arrivals))
    ]
    with Session(SharedMemory(4)) as sess:
        with LocalCluster(
            n_workers=2, slots_per_worker=2, devices=CPU, **FAST, **CALM
        ) as cl:
            report = sess.serve(stream, cluster=cl)
    assert report.kind == "served"
    assert report.metrics["n_requests"] == 6
    assert report.metrics["n_failed"] == 0
    assert report.metrics["qps"] > 0
    assert report.metrics["p99_latency"] >= report.metrics["p50_latency"] > 0
    assert report.schedule is not None and len(report.schedule.entries) > 0
    assert report.schedule.policy == "cluster-pm"
    assert no_leaks() == []


def test_session_serve_dashboard_lifecycle(rng):
    """Repeated serve(dashboard_port=0) must not collide on ports, and
    closing the session tears the dashboard down.  The session's platform
    is two CPU lanes (``DeviceMesh``), the reference's ``SharedMemory(2)``
    capacity: ``cluster=1`` starts its worker on the platform's devices,
    and a platform without devices would mean every CUDA device."""
    stream = [(p, 0.0, 0) for p in _trees(rng, 2)]
    sess = Session(DeviceMesh(CPU * 2))
    try:
        for _ in range(2):  # second serve reuses no stale server/port
            report = sess.serve(stream, cluster=1, dashboard_port=0)
            assert report.metrics["n_failed"] == 0
    finally:
        sess.close()
    assert sess.dashboard is None
    live = [t.name for t in threading.enumerate()
            if "dashboard" in t.name and t.name.startswith("repro_torch-")]
    assert live == []
    assert no_leaks() == []


def test_session_serve_cluster_numeric_artifacts(tmp_path):
    """A numeric tree served through ``serve(cluster=2)`` on CPU lanes in
    f64 returns its factorization in ``report.artifact[rid]``, equal bit
    for bit to ``execute``'s on the same platform.  Its report has no
    fluid bound (no calibrated work rate), and still renders: its summary
    and ``save_html`` (where the reference's formatting of the missing
    bound raises)."""
    prob = _grid_problem()
    sess = Session(DeviceMesh(CPU * 2))
    report = sess.serve([(prob, 0.0)], cluster=2, dtype=torch.float64)
    assert report.metrics["n_failed"] == 0
    assert report.fluid_makespan is None and "fluid LB n/a" in report.summary()
    assert "<html" in open(report.save_html(tmp_path / "served.html")).read()
    want = sess.load(prob).plan("greedy").execute(
        dtype=torch.float64, warmup=False).artifact
    got = report.artifact[0]
    assert all(np.array_equal(x, y) for x, y in zip(got.panels, want.panels))
    assert no_leaks() == []


def test_kernel_counters_exact_under_many_worker_threads():
    """The frontal counters are shared by every worker thread of every
    cluster in the process: 16 threads (more than the cores here) counting
    at once, with a short switch interval, lose no update."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    fronts = torch.eye(128, dtype=torch.float64)[None]
    fc.reset_counters()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            futs = [pool.submit(fc.front_factor, fronts, 128) for _ in range(64)]
            outs = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(old)
    assert fc.PLAIN_RUNS["front_factor"] == 64
    assert all(torch.equal(o, outs[0]) for o in outs)
