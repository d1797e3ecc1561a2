"""The port's online scheduler, request serving and elastic replanning
against the JAX package's: twins of ``tests/test_online.py`` (the pod
scheduler's ``serve_online`` among them), of ``tests/test_runtime.py``'s
heartbeat, elastic and two-pod placement cases and of
``tests/test_obs.py``'s serve and elastic telemetry cases.

Each twin draws its inputs from the same seeded numpy generator once per
package and runs the reference and the port side by side.  The scheduling
modules are copies, so their results must be equal exactly: online
reports (event times, shares, futures, counters) and plans are compared
through the ``repr`` of their fields, which spells every float out in
full.  ``execute_online`` runs the reference on CPU JAX in x64 and the
port on CPU lanes in f64 (the kernels' plain versions): factors within
1e-11, and async equal to waves bit for bit inside the port.
"""
import dataclasses
import warnings
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.core as rcore
import repro.obs as robs
import repro.online as ronline
import repro.online.scheduler as rscheduler
import repro.runtime as rruntime
import repro.sparse as rsparse
import repro.sparse.plan as rplan
import repro_torch.api as tapi
import repro_torch.core as tcore
import repro_torch.obs as tobs
import repro_torch.online as tonline
import repro_torch.runtime as truntime
import repro_torch.sparse as tsparse
import repro_torch.sparse.plan as tplan

ALPHA = 0.9
NDEV = 64
SEED = 1234  # the conftest ``rng`` fixture's seed
CPU4 = [torch.device("cpu")] * 4

REF = SimpleNamespace(name="ref", core=rcore, online=ronline, runtime=rruntime,
                      plan=rplan, sparse=rsparse, api=rapi, obs=robs,
                      OnlineScheduler=rscheduler.OnlineScheduler)
PORT = SimpleNamespace(name="port", core=tcore, online=tonline, runtime=truntime,
                       plan=tplan, sparse=tsparse, api=tapi, obs=tobs,
                       OnlineScheduler=tonline.OnlineScheduler)


@pytest.fixture(autouse=True)
def fresh_obs():
    for o in (robs, tobs):
        o.enable()
        o.reset()
    yield
    for o in (robs, tobs):
        o.enable()
        o.reset()


def report_key(rep) -> str:
    """Every number an online run produced, spelled out in full."""
    futures = sorted((k, dataclasses.astuple(f)) for k, f in rep.futures.items())
    pieces = sorted((lab, [(p.t0, p.t1, p.share) for p in ps])
                    for lab, ps in rep.schedule.pieces.items())
    return repr((rep.alpha, rep.policy, rep.makespan, rep.n_events, rep.n_reshares,
                 rep.utilization, futures, pieces, list(rep.capacity_steps),
                 sorted(rep.eq_nominal.items())))


def plan_key(plan) -> str:
    return repr(([dataclasses.astuple(t) for t in plan.tasks], plan.makespan,
                 plan.fluid_makespan, plan.total_devices, plan.alpha, plan.strategy))


def twin(run):
    """``run(P, rng)`` for the reference and the port, each with a fresh
    generator of the same seed; the two results' ``repr`` must be equal.
    Returns the port's result."""
    ref = run(REF, np.random.default_rng(SEED))
    port = run(PORT, np.random.default_rng(SEED))
    assert repr(port) == repr(ref)
    return port


def pod_modules(P):
    """(configs, serve) of the package ``P`` stands for."""
    import repro.configs as rconfigs
    import repro.serve as rserve
    import repro_torch.configs as tconfigs
    import repro_torch.serve as tserve

    return (tconfigs, tserve) if P is PORT else (rconfigs, rserve)


# ----------------------------------------------------------------------
# Fidelity to the static PM plan
# ----------------------------------------------------------------------
def test_zero_noise_single_tree_reproduces_pm_fluid():
    def run(P, rng):
        keys = []
        for n in (1, 7, 50, 150):
            tree = P.core.random_assembly_tree(n, rng)
            sched = P.OnlineScheduler(NDEV, ALPHA)
            fut = sched.submit(tree)
            report = sched.run()
            fluid = P.core.tree_equivalent_lengths(tree, ALPHA)[tree.root] / NDEV**ALPHA
            assert report.makespan == pytest.approx(fluid, rel=1e-6)
            assert fut.state == "done"
            report.validate()
            keys.append(report_key(report))
        return keys

    twin(run)


def test_zero_noise_chain_and_star():
    def run(P, rng):
        sched = P.OnlineScheduler(8, ALPHA)
        sched.submit(P.core.chain_tree(12))
        chain = sched.run()
        assert chain.makespan == pytest.approx(12.0 / 8**ALPHA, rel=1e-9)
        tree = P.core.star_tree(rng.uniform(1, 3, size=6))
        sched = P.OnlineScheduler(8, ALPHA)
        sched.submit(tree)
        rep = sched.run()
        rep.validate()
        eq = P.core.tree_equivalent_lengths(tree, ALPHA)[tree.root]
        assert rep.makespan == pytest.approx(eq / 8**ALPHA, rel=1e-9)
        return report_key(chain), report_key(rep)

    twin(run)


# ----------------------------------------------------------------------
# §4 validity + lower bound under random event traces
# ----------------------------------------------------------------------
def test_schedule_valid_under_random_event_traces():
    def run(P, _):
        keys = []
        for seed in range(4):
            rng = np.random.default_rng(seed)
            tree = P.core.random_assembly_tree(int(rng.integers(10, 60)), rng)
            sched = P.OnlineScheduler(
                P.online.ProcessorPool(16), ALPHA,
                noise=P.online.LognormalNoise(0.5, seed=seed),
            )
            sched.submit(tree)
            t = 0.0
            for _ in range(int(rng.integers(1, 5))):
                t += float(rng.uniform(0.05, 0.5))
                if rng.random() < 0.5:
                    sched.inject(t, P.online.SetCapacity(float(rng.integers(4, 17))))
                else:
                    sched.inject(t, P.online.SetNodeSpeed(
                        int(rng.integers(0, 16)), float(rng.uniform(0, 1))))
            report = sched.run()
            assert all(f.state == "done" for f in report.futures.values())
            report.validate()
            assert report.makespan >= report.fluid_lower_bound() - 1e-9
            keys.append(report_key(report))
        return keys

    twin(run)


def test_multitree_arrivals_valid_and_bounded():
    def run(P, rng):
        trees = [P.core.random_assembly_tree(25, rng) for _ in range(5)]
        arrivals = P.online.poisson_arrivals(5, 0.4, seed=7)
        reqs = [P.online.TreeRequest(t, arrival=float(a), tenant=i % 2, rid=i)
                for i, (t, a) in enumerate(zip(trees, arrivals))]
        report = P.online.serve_trees(reqs, 32, ALPHA, admission="fifo", max_concurrent=2,
                                      noise=P.online.LognormalNoise(0.4, seed=1))
        report.validate()
        for k, fut in report.futures.items():
            assert fut.state == "done"
            assert fut.t_done >= report.tree_lower_bound(k) - 1e-9
            assert fut.latency >= fut.service - 1e-12
        assert 0 < report.utilization <= 1 + 1e-9
        return report_key(report), list(arrivals), report.mean_latency()

    twin(run)


# ----------------------------------------------------------------------
# Share policies and admission
# ----------------------------------------------------------------------
def test_online_pm_beats_frozen_baselines_under_noise():
    def run(P, rng):
        trees = [P.core.random_assembly_tree(35, rng) for _ in range(6)]
        noise = P.online.LognormalNoise(0.5, seed=11)
        mean, keys = {}, []
        for policy in ("pm", "static", "static-proportional"):
            reqs = [P.online.TreeRequest(t, arrival=0.0, rid=i) for i, t in enumerate(trees)]
            rep = P.online.serve_trees(reqs, 32, 0.85, policy=policy, admission="fifo",
                                       max_concurrent=1, noise=noise)
            rep.validate()
            mean[policy] = rep.mean_service()
            keys.append(report_key(rep))
        assert mean["pm"] < mean["static"]
        assert mean["pm"] < mean["static-proportional"]
        return mean, keys

    twin(run)


def test_static_policy_forces_sequential_service():
    def run(P, _):
        sched = P.OnlineScheduler(16, ALPHA, policy="static",
                                  admission=P.online.AdmissionQueue("fifo", 4))
        assert sched.admission.max_concurrent == 1
        return sched.admission.max_concurrent, sorted(P.online.SHARE_POLICIES)

    twin(run)


def test_sjf_admits_by_equivalent_length():
    def run(P, rng):
        trees = [P.core.random_assembly_tree(n, rng) for n in (60, 8, 30)]
        reqs = [P.online.TreeRequest(t, arrival=0.0, rid=i) for i, t in enumerate(trees)]
        rep = P.online.serve_trees(reqs, 32, ALPHA, admission="sjf", max_concurrent=1)
        admit_order = sorted(rep.futures, key=lambda k: rep.futures[k].t_admit)
        assert admit_order == sorted(rep.eq_nominal, key=rep.eq_nominal.get)
        reqs = [P.online.TreeRequest(t, arrival=0.0, rid=i) for i, t in enumerate(trees)]
        fifo = P.online.serve_trees(reqs, 32, ALPHA, admission="fifo", max_concurrent=1)
        assert rep.mean_latency() <= fifo.mean_latency() + 1e-9
        return report_key(rep), report_key(fifo)

    twin(run)


def test_fair_share_prefers_starved_tenant():
    def run(P, rng):
        reqs = [P.online.TreeRequest(P.core.random_assembly_tree(25, rng), 0.0, tenant=0, rid=i)
                for i in range(3)]
        late = P.online.TreeRequest(P.core.random_assembly_tree(25, rng), 0.3, tenant=1, rid=9)
        t_done, keys = {}, []
        for adm in ("fifo", "fair"):
            rep = P.online.serve_trees([*reqs, late], 32, ALPHA, admission=adm,
                                       max_concurrent=1)
            t_done[adm] = [f.t_done for f in rep.futures.values() if f.tenant == 1][0]
            keys.append(report_key(rep))
        assert t_done["fair"] < t_done["fifo"]
        return keys

    twin(run)


def test_fifo_preserves_arrival_order():
    def run(P, rng):
        trees = [P.core.random_assembly_tree(20, rng) for _ in range(4)]
        reqs = [P.online.TreeRequest(t, arrival=0.1 * i, rid=i) for i, t in enumerate(trees)]
        rep = P.online.serve_trees(reqs, 16, ALPHA, admission="fifo", max_concurrent=1)
        admits = [rep.futures[k].t_admit for k in sorted(rep.futures)]
        assert admits == sorted(admits)
        return report_key(rep)

    twin(run)


# ----------------------------------------------------------------------
# Failures: the state machine's failed path
# ----------------------------------------------------------------------
def test_task_failure_with_retry_completes():
    def run(P, rng):
        tree = P.core.random_assembly_tree(20, rng)
        big = int(np.argmax(tree.lengths))
        base = P.OnlineScheduler(16, ALPHA)
        base.submit(tree)
        mk_clean = base.run().makespan
        sched = P.OnlineScheduler(16, ALPHA)
        fut = sched.submit(tree)
        sched.inject(mk_clean * 0.2, P.online.TaskFailure(0, big, retry=True))
        report = sched.run()
        assert fut.state == "done"
        report.validate()
        assert report.makespan >= mk_clean - 1e-9
        return mk_clean, report_key(report)

    twin(run)


def test_task_failure_without_retry_fails_future():
    def run(P, rng):
        tree = P.core.random_assembly_tree(20, rng)
        sched = P.OnlineScheduler(16, ALPHA)
        fut = sched.submit(tree)
        sched.inject(1e-3, P.online.TaskFailure(0, int(np.argmax(tree.lengths)), retry=False))
        report = sched.run()
        assert fut.state == "failed"
        with pytest.raises(P.online.OnlineFailure):
            fut.result()
        report.validate()
        return report_key(report)

    twin(run)


# ----------------------------------------------------------------------
# Event-core rewiring: elastic + straggler
# ----------------------------------------------------------------------
def test_elastic_online_matches_theorem6_inversion():
    def run(P, rng):
        tree = P.core.random_assembly_tree(70, rng)
        events = [P.runtime.ElasticEvent(0.4, 40), P.runtime.ElasticEvent(1.2, 64),
                  P.runtime.ElasticEvent(2.0, 16)]
        ctl = P.runtime.ElasticController(64)
        for ev in events:
            ctl.capacity_change(ev.time, ev.devices)
        mk, report = P.runtime.run_elastic_online(tree, ALPHA, 64, events)
        assert mk == pytest.approx(ctl.pm_makespan(tree, ALPHA), rel=1e-9)
        report.validate()
        sched = P.OnlineScheduler(64, ALPHA)
        sched.submit(tree)
        for t, payload in ctl.online_events():
            sched.inject(t, payload)
        again = sched.run()
        assert again.makespan == pytest.approx(mk, rel=1e-12)
        return mk, report_key(report), report_key(again)

    twin(run)


def test_run_elastic_schedule_through_event_core():
    def run(P, rng):
        tree = P.core.random_assembly_tree(40, rng)
        mk_plain, plain = P.runtime.run_elastic_schedule(tree, ALPHA, 64, [])
        mk_fail, plans = P.runtime.run_elastic_schedule(
            tree, ALPHA, 64, [P.runtime.ElasticEvent(time=mk_plain * 0.4, devices=32)])
        assert len(plans) >= 2
        assert mk_fail >= mk_plain - 1e-9
        return mk_plain, mk_fail, [plan_key(p) for p in plain + plans]

    twin(run)


def test_straggler_injector_slows_online_run():
    def run(P, rng):
        det = P.runtime.StragglerDetector(n_nodes=8)
        for _ in range(12):
            for node in range(8):
                det.record(node, 1.0 + (3.0 if node == 7 else 0.0) + rng.normal() * 0.01)
        inj = P.runtime.StragglerInjector(det)
        tree = P.core.random_assembly_tree(40, rng)
        healthy = P.OnlineScheduler(P.online.ProcessorPool(8), ALPHA)
        healthy.submit(tree)
        mk_healthy = healthy.run().makespan
        slow = P.OnlineScheduler(P.online.ProcessorPool(8), ALPHA)
        slow.submit(tree)
        assert inj.inject(slow, mk_healthy * 0.1) >= 1
        assert inj.inject(slow, mk_healthy * 0.2) == 0
        rep = slow.run()
        rep.validate()
        assert rep.makespan > mk_healthy
        return mk_healthy, report_key(rep)

    twin(run)


# ----------------------------------------------------------------------
# Replay bridge + waves tolerance
# ----------------------------------------------------------------------
def test_waves_tolerance_groups_drifted_starts():
    def run(P, _):
        mk = 100.0
        tasks = [
            P.plan.PlannedTask(task=0, label=0, devices=2, start=0.0, end=1.0),
            P.plan.PlannedTask(task=1, label=1, devices=2, start=3e-8, end=1.0),
            P.plan.PlannedTask(task=2, label=2, devices=2, start=50.0, end=60.0),
            P.plan.PlannedTask(task=3, label=3, devices=2, start=50.0 + 2e-8, end=60.0),
        ]
        plan = P.plan.ExecutionPlan(tasks=tasks, makespan=mk, fluid_makespan=mk,
                                    total_devices=4, alpha=ALPHA)
        waves = plan.waves()
        assert [len(w) for w in waves] == [2, 2]
        assert [t.task for t in waves[0]] == [0, 1]
        return [[t.task for t in w] for w in waves]

    twin(run)


def test_plan_from_online_respects_precedence():
    def run(P, rng):
        tree = P.core.random_assembly_tree(30, rng)
        plan, report = P.online.run_online_plan(
            tree, 16, ALPHA, noise=P.online.LognormalNoise(0.3, seed=2))
        assert plan.strategy == "online-pm"
        by_task = {t.task: t for t in plan.tasks}
        for i in range(tree.n):
            p = int(tree.parent[i])
            if p >= 0:
                assert by_task[i].end <= by_task[p].start + 1e-9
        assert plan.makespan == pytest.approx(report.makespan, rel=1e-12)
        assert all(1 <= t.devices <= 16 for t in plan.tasks if tree.lengths[t.task] > 0)
        again = P.online.plan_from_online(tree, report, 16)
        assert plan_key(again) == plan_key(plan)
        return plan_key(plan), report_key(report)

    twin(run)


def test_execute_online_factorizes():
    """The full loop, online run → projected plan → executor, in f64: the
    port on CPU lanes against the reference in x64 (factors within 1e-11,
    equal online reports and plans), async and waves bit for bit."""
    def matrix(P):
        a = P.sparse.grid_laplacian_2d(9)
        ap = P.sparse.permute_symmetric(a, P.sparse.nested_dissection_2d(9))
        return ap, P.sparse.analyze(ap, relax=1)

    ap, symb = matrix(REF)
    jax.config.update("jax_enable_x64", True)
    try:
        ref, ref_exec, ref_online = ronline.execute_online(
            ap, symb, 8, ALPHA, noise=ronline.LognormalNoise(0.3, seed=3))
    finally:
        jax.config.update("jax_enable_x64", False)
    tap, tsymb = matrix(PORT)
    runs = {
        mode: tonline.execute_online(tap, tsymb, 8, ALPHA, noise=tonline.LognormalNoise(0.3, seed=3),
                                     mode=mode, devices=CPU4, dtype=torch.float64)
        for mode in ("async", "waves")
    }
    fact, exec_report, online_report = runs["async"]
    assert exec_report.interpret and len(exec_report.trace) == tsymb.n_supernodes
    assert report_key(online_report) == report_key(ref_online)
    online_report.validate()
    dense = tap.toarray()
    l = fact.to_dense_l()
    assert np.abs(l @ l.T - dense).max() / np.abs(dense).max() < 1e-12
    assert fact.panels[0].dtype == np.float64
    for got, want, wave in zip(fact.panels, ref.panels, runs["waves"][0].panels):
        assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-11
        np.testing.assert_array_equal(got, wave)
    assert exec_report.n_dispatches > 0 and ref_exec.n_dispatches > 0


def test_execute_online_needs_devices_without_cuda(monkeypatch):
    """No CUDA device and no ``devices=``: it raises before the online run,
    as the executor does; the CPU is never taken on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = tsparse.grid_laplacian_2d(5)
    symb = tsparse.analyze(a, relax=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tonline.execute_online(a, symb, 8, ALPHA)


def test_online_exports_match_reference():
    """The reference's names (its deprecation shim aside: ``OnlineScheduler``
    is a plain export here) and the elastic names of ``runtime``."""
    assert sorted(tonline.__all__) == sorted(ronline.__all__)
    for name in ronline.__all__:
        assert hasattr(tonline, name)
    assert tonline.OnlineScheduler is tonline.scheduler.OnlineScheduler
    for name in ("ElasticController", "ElasticEvent", "HeartbeatMonitor",
                 "run_elastic_online", "run_elastic_schedule"):
        assert getattr(truntime, name) is getattr(truntime.elastic, name)


def test_online_report_records_its_host_seconds():
    """The port's report also carries the wall seconds of ``run()`` (what a
    caller reads to split an ``execute_online`` call into the online run
    and the rest); it takes no part in comparing reports."""
    tree = tcore.random_assembly_tree(50, np.random.default_rng(SEED))
    reports = []
    for _ in range(2):
        sched = tonline.OnlineScheduler(NDEV, ALPHA)
        sched.submit(tree)
        reports.append(sched.run())
    assert all(r.host_s > 0 for r in reports)
    assert dataclasses.replace(reports[0], host_s=1.0) == reports[0]


# ----------------------------------------------------------------------
# tests/test_runtime.py: heartbeat and elastic
# ----------------------------------------------------------------------
def test_heartbeat_detects_failure():
    def run(P, _):
        hb = P.runtime.HeartbeatMonitor(n_nodes=4, timeout=2.0)
        for t in (0.0, 1.0, 2.0):
            for n in range(4):
                if not (n == 2 and t > 0.5):
                    hb.beat(n, t)
        assert hb.dead(3.0) == [2]
        assert 2 not in hb.alive(3.0)
        return hb.dead(3.0), hb.alive(3.0), sorted(hb.last_seen.items())

    twin(run)


def test_elastic_profile_and_invariance():
    def run(P, rng):
        tree = P.core.random_assembly_tree(80, rng)
        ctl = P.runtime.ElasticController(initial_devices=64)
        ctl.capacity_change(1.0, 48)
        ctl.capacity_change(3.0, 64)
        prof = ctl.profile()
        assert prof.p_at(0.5) == 64 and prof.p_at(2.0) == 48 and prof.p_at(5.0) == 64
        eq = P.core.tree_equivalent_lengths(tree, ALPHA)[tree.root]
        mk = ctl.pm_makespan(tree, ALPHA)
        assert mk == pytest.approx(prof.time_for_work(eq, ALPHA))
        assert mk >= eq / 64**ALPHA - 1e-9
        return mk, list(prof.steps), [dataclasses.astuple(e) for e in ctl.events]

    twin(run)


def test_run_elastic_schedule_converges():
    def run(P, rng):
        tree = P.core.random_assembly_tree(60, rng)
        alpha = 0.85
        mk_plain, _ = P.runtime.run_elastic_schedule(tree, alpha, 64, [])
        mk_fail, plans = P.runtime.run_elastic_schedule(
            tree, alpha, 64, [P.runtime.ElasticEvent(time=mk_plain * 0.3, devices=32)])
        assert mk_fail >= mk_plain - 1e-9
        assert len(plans) >= 2
        prof = P.core.Profile.of([(mk_plain * 0.3, 64.0), (np.inf, 32.0)])
        eq = P.core.tree_equivalent_lengths(tree, alpha)[tree.root]
        assert mk_fail >= prof.time_for_work(eq, alpha) - 1e-9
        return mk_plain, mk_fail, [plan_key(p) for p in plans]

    twin(run)


def test_residual_tree_matches_reference():
    """``_residual_tree`` (the work left at an elastic event) as the
    reference computes it."""
    def run(P, rng):
        tree = P.core.random_assembly_tree(30, rng)
        plan = P.plan.make_plan(tree, 16, ALPHA)
        left = P.runtime.elastic._residual_tree(tree, plan, plan.makespan * 0.5)
        return left.parent.tolist(), left.lengths.tolist(), left.labels.tolist()

    twin(run)


# ----------------------------------------------------------------------
# tests/test_obs.py: serve and elastic telemetry
# ----------------------------------------------------------------------
def test_serve_publishes_virtual_spans_and_admission_metrics():
    def run(P, rng):
        t1 = P.core.random_assembly_tree(30, rng)
        t2 = P.core.random_assembly_tree(40, rng)
        p1 = P.api.Problem.from_tree(t1, ALPHA, name="t1")
        p2 = P.api.Problem.from_tree(t2, ALPHA, name="t2")
        rep = P.api.Session(P.api.SharedMemory(8)).serve(
            [(p1, 0.0, 0), (p2, 0.1, 1)], admission="fair", max_concurrent=1)
        obs = P.obs
        trees = obs.BUS.spans(cat="tree", name="run")
        assert len(trees) == 2
        assert all(s.clock == obs.VIRTUAL for s in trees)
        tasks = obs.BUS.spans(cat="task", name="run")
        assert len(tasks) == t1.n + t2.n
        reg = obs.get_registry()
        admit = reg.counter("repro_admission_requests_total")
        assert admit.value_of(tenant=0) == 1.0
        assert admit.value_of(tenant=1) == 1.0
        assert reg.histogram("repro_admission_wait_seconds").count == 2
        util = reg.gauge("repro_online_utilization").value
        assert 0.0 < util <= 1.0
        assert "capacity" in obs.BUS.counter_tracks()
        assert rep.metrics["fluid_ratio"] >= 1.0 - 1e-12
        return (report_key(rep.detail), sorted(rep.metrics.items()), util,
                [(s.t0, s.t1) for s in trees], sorted((s.t0, s.t1) for s in tasks))

    twin(run)


def test_elastic_run_publishes_plan_segments():
    def run(P, _):
        tree = P.core.balanced_tree(depth=4, arity=2)
        mk, plans = P.runtime.run_elastic_schedule(
            tree, ALPHA, 8, [P.runtime.ElasticEvent(time=0.05, devices=4)])
        obs = P.obs
        segs = obs.BUS.spans(cat="plan", name="run")
        assert len(segs) == len(plans)
        assert all(s.clock == obs.VIRTUAL for s in segs)
        assert segs[-1].t1 == pytest.approx(mk)
        replans = obs.get_registry().counter("repro_elastic_replans_total").value
        assert replans == len(plans)
        return mk, replans, [(s.t0, s.t1) for s in segs]

    twin(run)


def test_validate_agrees_with_reference():
    """The §4 audit (``ExplicitSchedule.validate``) passes and fails where
    the reference's does: on a noisy multi-tree run, and on copies of its
    schedule with one share raised past the capacity and with a parent
    started before its child ends."""
    def run(P, rng):
        trees = [P.core.random_assembly_tree(30, rng) for _ in range(3)]
        reqs = [P.online.TreeRequest(t, arrival=0.2 * i, rid=i) for i, t in enumerate(trees)]
        rep = P.online.serve_trees(reqs, 16, ALPHA, max_concurrent=2,
                                   noise=P.online.LognormalNoise(0.3, seed=4))
        tree, prof = rep.combined_tree(), rep.profile()
        verdicts = []
        for edit in ("none", "share", "precedence"):
            sched = P.core.ExplicitSchedule(rep.schedule.alpha,
                                            {k: list(v) for k, v in rep.schedule.pieces.items()})
            if edit == "share":  # one piece over the whole pool
                lab = max(sched.pieces, key=lambda k: len(sched.pieces[k]))
                p = sched.pieces[lab][0]
                sched.pieces[lab][0] = type(p)(p.t0, p.t1, p.share + 17.0)
            elif edit == "precedence":  # a parent's first piece moved to t=0
                child = next(i for i in range(tree.n) if tree.parent[i] >= 0
                             and tree.lengths[tree.parent[i]] > 0 and sched.pieces.get(i))
                par = int(tree.parent[child])
                p = sched.pieces[par][0]
                sched.pieces[par][0] = type(p)(0.0, p.t1, p.share)
            try:
                sched.validate(tree, prof)
                verdicts.append("valid")
            except AssertionError as e:
                verdicts.append(str(e))
        assert verdicts[0] == "valid" and verdicts[1] != "valid" and verdicts[2] != "valid"
        return verdicts

    twin(run)


# ----------------------------------------------------------------------
# The pod scheduler (serve/pod_scheduler)
# ----------------------------------------------------------------------
def test_pod_serve_online():
    """Eight qwen3-4b prefill requests on one 256-device pod, SJF admission,
    through the package's ``serve_online`` (its deprecation shim): the same
    report as the reference's, every request served."""
    def run(P, rng):
        configs, serve = pod_modules(P)
        cfg = configs.ARCHS["qwen3-4b"]
        reqs = [serve.Request(i, 1024 * (1 + i % 4)) for i in range(8)]
        arrivals = P.online.poisson_arrivals(8, 0.2, seed=5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            serve_online = serve.serve_online
        report = serve_online(
            cfg, reqs, arrivals, pod_devices=256, alpha=ALPHA, admission="sjf"
        )
        report.validate()
        assert all(f.state == "done" for f in report.futures.values())
        assert {f.rid for f in report.futures.values()} == set(range(8))
        assert report.mean_latency() > 0
        assert 0 < report.utilization <= 1 + 1e-9
        return report_key(report), report.mean_latency()

    twin(run)


def test_two_pod_request_placement():
    """Six qwen3-4b requests on two equal pods (Algorithm 11) and on pods of
    256 and 128 devices (the Algorithm-12 FPTAS): the reference's makespans
    and placements exactly; the degraded pod takes the smaller share."""
    def run(P, rng):
        configs, serve = pod_modules(P)
        cfg = configs.ARCHS["qwen3-4b"]
        reqs = [serve.Request(i, 1024 * (i + 1)) for i in range(6)]
        mk, placement = serve.place_two_pods_equal(cfg, reqs, pod_devices=256, alpha=0.9)
        assert len(placement) == 6 and set(placement) <= {0, 1}
        assert mk > 0
        mk2, placement2 = serve.place_two_pods(cfg, reqs, 256, 128, alpha=0.9, lam=1.05)
        assert len(placement2) == 6
        w = np.array([r.prompt_tokens for r in reqs], float)
        assert w[np.array(placement2) == 1].sum() <= w.sum() * 0.6
        return mk, placement, mk2, placement2

    twin(run)
