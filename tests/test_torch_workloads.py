"""The port's workload front end against the JAX package's: twins of
``tests/test_workloads.py`` (the op-DAG IR, tree-ification, calibrated
costs, the model-zoo builders, ``Session.analyze_workload``, the mixed
two-node FPTAS, the laziness of the facade).

``repro_torch.workloads``, ``models.config``, ``configs`` and the
``launch.roofline`` counters are copies, so every twin builds the same
workload in both packages from the same inputs and holds the port to the
reference exactly: task lengths, footprints, ``op_map`` and the rest of
the meta, simulated makespans, and each PM schedule's JSON byte for byte
under the same platform (``SharedMemory``: calibration ``cpu``; CPU lanes
``DeviceMesh([cpu] * 4)`` against the reference's host ``DeviceMesh``:
``host-mesh``).  The reference runs on CPU JAX.

What does not carry over: the reference's ``tpu`` calibration (the port's
accelerator row is ``h100``, measured on the card; the roofline twin holds
the port to the reference's lengths under the reference's ``tpu`` rates
passed in as a ``Calibration``), and ``estimator="hlo"``, which compiles
the reduced model in JAX: the port has no model to count yet and raises
(ROADMAP queue 1 items 10 and 11).
"""
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.core.hetero as rhetero
import repro.workloads as rwl
import repro_torch.api as tapi
import repro_torch.workloads as twl
from repro.configs import ARCHS as RARCHS
from repro_torch.api import MixedCluster, Schedule, Session, SharedMemory
from repro_torch.configs import ARCHS, SOLVER
from repro_torch.core.hetero import (
    NodeSpec,
    hetero_fptas,
    mixed_hetero_fptas,
    mixed_lower_bound,
    mixed_partition_makespan,
)
from repro_torch.workloads import (
    CALIBRATIONS,
    Calibration,
    Op,
    OpGraph,
    Workload,
    analyze,
    calibration_for,
    default_workload,
    moe_dispatch,
    pipeline,
    serving_pod,
    task_lengths,
    treeify,
)

ALPHA = 0.9
CPU4 = [torch.device("cpu")] * 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = SimpleNamespace(api=rapi, workloads=rwl)
PORT = SimpleNamespace(api=tapi, workloads=twl)


def same_treeified(port, ref) -> None:
    """Two tree-ifications, field by field, exactly."""
    np.testing.assert_array_equal(port.tree.parent, ref.tree.parent)
    np.testing.assert_array_equal(port.tree.lengths, ref.tree.lengths)
    np.testing.assert_array_equal(port.tree.labels, ref.tree.labels)
    for f in ("flops", "bytes", "param_bytes", "out_bytes"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    assert port.op_map == ref.op_map
    assert port.relaxed_edges == ref.relaxed_edges
    assert port.meta() == ref.meta()


def same_problem(port, ref) -> None:
    """Two Problems: name, α, tree, lengths, footprints and meta, exactly."""
    assert (port.name, port.alpha, port.n) == (ref.name, ref.alpha, ref.n)
    np.testing.assert_array_equal(port.tree.parent, ref.tree.parent)
    np.testing.assert_array_equal(port.tree.lengths, ref.tree.lengths)
    np.testing.assert_array_equal(port.tree.labels, ref.tree.labels)
    pf, rf = port.memory_footprints(), ref.memory_footprints()
    assert (pf is None) == (rf is None)
    if pf is not None:
        for f in ("front_bytes", "factor_bytes", "cb_bytes"):
            np.testing.assert_array_equal(getattr(pf, f), getattr(rf, f))
    assert port.meta == ref.meta


def same_workload(port, ref) -> None:
    assert (port.name, port.kind, port.meta, port.prefixes) == (
        ref.name, ref.kind, ref.meta, ref.prefixes)
    assert [dataclasses.astuple(o) for o in port.graph.ops] == [
        dataclasses.astuple(o) for o in ref.graph.ops]
    same_treeified(port.treeified, ref.treeified)


def ref_graph(graph):
    """The reference's OpGraph of the same ops."""
    return rwl.OpGraph([rwl.Op(**dataclasses.asdict(op)) for op in graph.ops])


def both_treeified(ops):
    """``treeify`` of the same op list in both packages (held equal);
    returns the port's."""
    port = treeify(OpGraph(ops))
    same_treeified(port, rwl.treeify(ref_graph(OpGraph(ops))))
    return port


# ----------------------------------------------------------------------
# IR + tree-ification
# ----------------------------------------------------------------------
def test_opgraph_validates_deps_cycles_and_duplicates():
    cases = [
        ("unknown op", lambda m: m.OpGraph([m.Op("a", deps=("ghost",))])),
        ("duplicate", lambda m: m.OpGraph([m.Op("a"), m.Op("a")])),
        ("cycle", lambda m: m.OpGraph([m.Op("a", deps=("b",)), m.Op("b", deps=("a",))])),
        ("non-negative", lambda m: m.Op("a", flops=-1.0)),
    ]
    for match, build in cases:
        with pytest.raises(ValueError, match=match) as port:
            build(twl)
        with pytest.raises(ValueError) as ref:
            build(rwl)
        assert str(port.value) == str(ref.value)


def test_series_contraction_fuses_chains_and_conserves_work():
    tf = both_treeified([
        Op("a", flops=1.0, out_bytes=10.0),
        Op("b", flops=2.0, deps=("a",), out_bytes=20.0),
        Op("c", flops=4.0, deps=("b",), out_bytes=40.0),
    ])
    assert tf.n_tasks == 1
    assert tf.flops[0] == pytest.approx(7.0)
    assert sorted(tf.op_map[0]) == ["a", "b", "c"]
    assert tf.relaxed_edges == []
    assert tf.out_bytes[0] == pytest.approx(40.0)


def test_group_tags_block_cross_stage_fusion():
    tf = both_treeified([
        Op("a", flops=1.0, group="s0"),
        Op("b", flops=2.0, deps=("a",), group="s0"),
        Op("c", flops=4.0, deps=("b",), group="s1"),
    ])
    assert tf.n_tasks == 2
    assert sorted(map(sorted, tf.op_map)) == [["a", "b"], ["c"]]
    [s0] = [i for i, ops in enumerate(tf.op_map) if "a" in ops]
    [s1] = [i for i, ops in enumerate(tf.op_map) if "c" in ops]
    assert tf.tree.parent[s0] == s1


def test_fanout_relaxes_extra_edges_and_records_them():
    ops = [
        Op("src", flops=1.0),
        Op("l", flops=2.0, deps=("src",)),
        Op("r", flops=3.0, deps=("src",)),
        Op("join", flops=1.0, deps=("l", "r")),
    ]
    tf = both_treeified(ops)
    assert tf.n_tasks == 4
    assert len(tf.relaxed_edges) == 1
    assert tf.relaxed_edges[0][0] == "src"
    assert tf.flops.sum() == pytest.approx(OpGraph(ops).total_flops())


def test_multiple_sinks_join_under_zero_cost_virtual_root():
    tf = both_treeified([Op("a", flops=1.0), Op("b", flops=2.0)])
    assert tf.n_tasks == 3
    root = int(np.flatnonzero(tf.tree.parent == -1)[0])
    assert tf.op_map[root] == []
    assert tf.flops[root] == 0.0
    assert tf.flops.sum() == pytest.approx(3.0)


def test_meta_block_is_json_serializable_provenance():
    tf = both_treeified([Op("a", flops=1.0), Op("b", flops=2.0, deps=("a",))])
    meta = json.loads(json.dumps(tf.meta()))
    assert meta["n_ops"] == 2
    assert sorted(sum(meta["op_map"].values(), [])) == ["a", "b"]


# ----------------------------------------------------------------------
# Cost model
# ----------------------------------------------------------------------
def test_task_lengths_follow_the_roofline():
    """Each task's length is its binding resource's time under every
    calibration: the port's ``h100``, the rows both packages share, and
    the reference's ``tpu`` rates passed in (equal lengths, exactly)."""
    ops = [Op("compute", flops=1e12, bytes=1.0), Op("memory", flops=1.0, bytes=1e12)]
    tf = both_treeified(ops)
    rtf = rwl.treeify(ref_graph(OpGraph(ops)))
    tpu = rwl.CALIBRATIONS["tpu"]
    cals = [(CALIBRATIONS[k], rwl.CALIBRATIONS[k]) for k in ("cpu", "host-mesh")]
    cals.append((Calibration(tpu.name, tpu.alpha, tpu.flop_rate, tpu.mem_bw), tpu))
    for cal, rcal in cals:
        np.testing.assert_array_equal(task_lengths(tf, cal), rwl.task_lengths(rtf, rcal))
    assert sorted(CALIBRATIONS) == ["cpu", "h100", "host-mesh"]
    for cal in CALIBRATIONS.values():
        lengths = task_lengths(tf, cal)
        assert lengths.shape == (tf.n_tasks,)
        assert lengths[0] == pytest.approx(1e12 / cal.flop_rate)
        assert lengths[1] == pytest.approx(1e12 / cal.mem_bw)
        assert lengths[2] == 0.0


def test_calibration_for_duck_types_on_platform_name(monkeypatch):
    """SharedMemory → ``cpu``; a mixed cluster → its fastest node's row; a
    DeviceMesh → ``h100`` when its first device is a CUDA device (built
    here without touching one), ``host-mesh`` on CPU lanes or where
    ``DeviceMesh()`` finds no CUDA device (the reference's host mesh)."""
    assert calibration_for(SharedMemory(8)).name == "cpu"
    mixed = MixedCluster([SharedMemory(4), 2])
    assert calibration_for(mixed).name in CALIBRATIONS
    assert calibration_for(mixed).name == rwl.calibration_for(
        rapi.MixedCluster([rapi.SharedMemory(4), 2])).name
    assert calibration_for(tapi.DeviceMesh(CPU4)).name == "host-mesh"
    assert rwl.calibration_for(rapi.DeviceMesh()).name == "host-mesh"
    card = tapi.DeviceMesh([torch.device("cuda", 0)], plan_devices=256)
    assert calibration_for(card).name == "h100"
    with_card = MixedCluster([SharedMemory(40), card], node_memory=[1e9, 8e10])
    assert calibration_for(with_card).name == "h100"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert calibration_for(tapi.DeviceMesh(plan_devices=256)).name == "host-mesh"


# ----------------------------------------------------------------------
# Zoo builders: every config compiles to a §4-valid schedule
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_zoo_config_plans_valid_under_pm_and_online(name):
    wl = default_workload(ARCHS[name])
    assert isinstance(wl, Workload)
    same_workload(wl, rwl.default_workload(RARCHS[name]))
    prob = wl.problem(SharedMemory(16))
    ref_prob = rwl.default_workload(RARCHS[name]).problem(rapi.SharedMemory(16))
    same_problem(prob, ref_prob)
    assert prob.n >= 2
    assert np.all(np.asarray(prob.tree.lengths) >= 0)
    assert prob.meta and prob.meta["workload"]["kind"] == wl.kind

    sess = Session(SharedMemory(16)).load(prob)
    sched = sess.plan(policy="pm").schedule
    sched.validate(prob)
    assert sched.meta["workload"]["n_ops"] == wl.graph.n_ops
    ref_sess = rapi.Session(rapi.SharedMemory(16)).load(ref_prob)
    assert sched.to_json() == ref_sess.plan(policy="pm").schedule.to_json()

    rep = sess.simulate(policy="pm")
    assert rep.makespan == pytest.approx(sched.makespan, rel=1e-9)
    assert rep.makespan == ref_sess.simulate(policy="pm").makespan

    back = Schedule.from_json(sched.to_json())
    assert back.meta["workload"]["op_map"] == sched.meta["workload"]["op_map"]
    back.validate(prob)


def test_moe_dispatch_star_shape_and_skew():
    cfg = ARCHS["qwen2-moe-a2.7b"]
    wl = moe_dispatch(cfg, skew=1.0)
    same_workload(wl, rwl.moe_dispatch(RARCHS["qwen2-moe-a2.7b"], skew=1.0))
    assert wl.kind == "moe"
    tf = wl.treeified
    root = int(np.flatnonzero(tf.tree.parent == -1)[0])
    children = np.flatnonzero(tf.tree.parent == root)
    assert len(children) == cfg.moe.n_experts
    loads = tf.flops[children]
    assert loads.max() > loads.min()


def test_pipeline_contracts_to_stage_chain():
    wl = pipeline(ARCHS["qwen3-4b"], stages=4)
    same_workload(wl, rwl.pipeline(RARCHS["qwen3-4b"], stages=4))
    assert wl.kind == "pipeline"
    n = wl.treeified.n_tasks
    assert n <= 4 + 2
    parents = wl.treeified.tree.parent
    assert sum(1 for t in range(n) if t not in set(parents.tolist())) == 1


def test_serving_pod_namespaces_and_joins_models():
    pod = serving_pod(["qwen3-4b", "rwkv6-1.6b"])
    same_workload(pod, rwl.serving_pod(["qwen3-4b", "rwkv6-1.6b"]))
    assert pod.kind == "pod"
    names = [op.name for op in pod.graph.ops]
    assert all(n.startswith(("m0.", "m1.")) for n in names)
    prob = pod.problem(SharedMemory(16))
    same_problem(prob, rwl.serving_pod(["qwen3-4b", "rwkv6-1.6b"]).problem(
        rapi.SharedMemory(16)))
    root = int(np.flatnonzero(np.asarray(prob.tree.parent) == -1)[0])
    assert prob.tree.lengths[root] == 0.0


def test_analyze_dispatches_models_pods_and_sparse():
    p, rp = SharedMemory(16), rapi.SharedMemory(16)
    for spec in ("qwen3-4b", ["qwen3-4b", "rwkv6-1.6b"]):
        same_problem(analyze(spec, p), rwl.analyze(spec, rp))
    assert analyze("qwen3-4b", p).meta["workload"]["kind"] == "pipeline"
    assert analyze(["qwen3-4b", "rwkv6-1.6b"], p).meta["workload"]["kind"] == "pod"
    sp = analyze("sparse", p)
    assert sp.meta["workload"]["kind"] == "sparse"
    assert sp.n > 100
    same_problem(sp, rwl.analyze("sparse", rp))
    assert analyze(SOLVER.name, p).n == sp.n
    with pytest.raises((KeyError, ValueError)):
        analyze("no-such-model", p)


# ----------------------------------------------------------------------
# Facade: Session.analyze_workload end-to-end
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "name,shape",
    [
        ("qwen2-moe-a2.7b", "decode_32k"),
        ("granite-moe-3b-a800m", "decode_32k"),
        ("qwen3-4b", "prefill_32k"),
        ("qwen2.5-3b", "train_4k"),
        ("rwkv6-1.6b", "decode_32k"),
        ("starcoder2-7b", "prefill_32k"),
    ],
)
def test_analyze_workload_plans_and_simulates(name, shape):
    sess = Session(SharedMemory(32)).analyze_workload(name, shape=shape)
    ref = rapi.Session(rapi.SharedMemory(32)).analyze_workload(name, shape=shape)
    same_problem(sess.problem, ref.problem)
    sched = sess.plan(policy="pm").schedule
    sched.validate(sess.problem)
    assert sched.to_json() == ref.plan(policy="pm").schedule.to_json()
    rep = sess.simulate(policy="pm")
    assert rep.makespan > 0
    assert rep.makespan == ref.simulate(policy="pm").makespan
    assert sched.meta["workload"]["model"] == name


SPECS = sorted(ARCHS) + [["qwen3-4b", "rwkv6-1.6b"], "multifrontal"]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s if isinstance(s, str) else "pod")
def test_analyze_workload_on_cpu_lanes_equals_reference(spec):
    """``Session(DeviceMesh(...)).analyze_workload(spec)`` for every config,
    the pod and the paper's own solver config, on four CPU lanes planned
    for 256 devices: the reference's Problem (``host-mesh`` lengths) and
    the reference's PM schedule, JSON byte for byte."""
    sess = Session(tapi.DeviceMesh(CPU4, plan_devices=256)).analyze_workload(spec)
    ref = rapi.Session(rapi.DeviceMesh(plan_devices=256)).analyze_workload(spec)
    same_problem(sess.problem, ref.problem)
    if spec != "multifrontal":
        assert sess.problem.meta["workload"]["calibration"] == "host-mesh"
    assert sess.plan("pm").schedule.to_json() == ref.plan("pm").schedule.to_json()


def test_analyze_workload_multifrontal_executes_on_cpu_lanes():
    """The paper's workload (its grid cut to 11) through ``analyze_workload``
    executes in the solver's f32 on CPU lanes (the kernels' plain
    versions): the same panels, bit for bit, as the same grid through
    ``analyze``, and the reference's executed factor within f32's
    tolerance."""
    from repro.configs import SOLVER as RSOLVER
    from repro_torch.sparse import grid_laplacian_2d, nested_dissection_2d

    small = dataclasses.replace(SOLVER, grid=11)
    dtype = getattr(torch, SOLVER.dtype)
    sess = Session(tapi.DeviceMesh(CPU4, plan_devices=8)).analyze_workload(small)
    rep = sess.plan("greedy").execute(dtype=dtype, warmup=False)
    direct = Session(tapi.DeviceMesh(CPU4, plan_devices=8)).analyze(
        grid_laplacian_2d(11), SOLVER.alpha, ordering=nested_dissection_2d(11),
        relax=SOLVER.relax).plan("greedy").execute(dtype=dtype, warmup=False)
    for a, b in zip(rep.artifact.panels, direct.artifact.panels):
        np.testing.assert_array_equal(a, b)
    dense = sess.problem.matrix.toarray()
    l = rep.artifact.to_dense_l()
    assert np.abs(l @ l.T - dense).max() / np.abs(dense).max() < 1e-5
    assert sess.schedule.meta["workload"] == {
        "kind": "sparse", "model": SOLVER.name, "grid": 11, "relax": SOLVER.relax}
    ref = rapi.Session(rapi.DeviceMesh(plan_devices=8)).analyze_workload(
        dataclasses.replace(RSOLVER, grid=11)).plan("greedy").execute(warmup=False)
    assert len(ref.artifact.panels) == len(rep.artifact.panels)
    for a, b in zip(rep.artifact.panels, ref.artifact.panels):
        assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < 5e-5


def test_analyze_workload_memory_footprints_enforced():
    sess = Session(SharedMemory(32)).analyze_workload("qwen3-4b", shape="prefill_32k")
    ref = rapi.Session(rapi.SharedMemory(32)).analyze_workload("qwen3-4b", shape="prefill_32k")
    assert sess.problem.memory_footprints() is not None
    sched = sess.plan(policy="pm").schedule
    assert sched.peak_memory() > 0
    assert sched.peak_memory() == ref.plan(policy="pm").schedule.peak_memory()


def test_analyze_workload_serves_in_process():
    from test_torch_online import report_key

    reqs = [("qwen3-4b", 0), ("rwkv6-1.6b", 1), ("qwen3-4b", 0)]

    def serve(P):
        stream = [(P.workloads.analyze(n, P.api.SharedMemory(32)), 0.0, t) for n, t in reqs]
        return P.api.Session(P.api.SharedMemory(32)).serve(
            stream, admission="fair", max_concurrent=2, qos_weights={0: 4.0, 1: 1.0})

    port = serve(PORT)
    ref = serve(REF)
    online = port.detail
    assert len(online.futures) == 3
    assert all(f.state == "done" for f in online.futures.values())
    assert port.metrics["mean_latency"] > 0
    assert port.metrics == ref.metrics
    assert report_key(port.detail) == report_key(ref.detail)


def test_hlo_estimator_rescales_analytic_lengths():
    """The reference compiles the reduced qwen3-4b in JAX and rescales
    every length by one measured HLO/analytic flop ratio.  That does not
    carry over: the port has no model to compile and no flop counter over
    one yet, so ``estimator="hlo"`` raises, naming ROADMAP items 10 and 11;
    the analytic lengths stay the reference's, and an unknown estimator is
    refused as the reference refuses it."""
    wl = pipeline(ARCHS["qwen3-4b"])
    a = wl.problem(SharedMemory(8), estimator="analytic")
    same_problem(a, rwl.pipeline(RARCHS["qwen3-4b"]).problem(
        rapi.SharedMemory(8), estimator="analytic"))
    with pytest.raises(NotImplementedError, match="items 10 and 11"):
        wl.problem(SharedMemory(8), estimator="hlo")
    with pytest.raises(NotImplementedError, match="items 10 and 11"):
        Session(SharedMemory(8)).analyze_workload("qwen3-4b", estimator="hlo")
    with pytest.raises(ValueError, match="unknown estimator"):
        wl.problem(SharedMemory(8), estimator="xla")


# ----------------------------------------------------------------------
# Mixed-platform two-node FPTAS (§6.2 generalized)
# ----------------------------------------------------------------------
def test_mixed_fptas_matches_homogeneous_algorithm_12(rng):
    works = rng.uniform(0.5, 5.0, 24)
    node_p = NodeSpec(6.0, ALPHA)
    node_q = NodeSpec(3.0, ALPHA)
    res = mixed_hetero_fptas(works, node_p, node_q, lam=1.05)
    ref = rhetero.mixed_hetero_fptas(
        works, rhetero.NodeSpec(6.0, ALPHA), rhetero.NodeSpec(3.0, ALPHA), lam=1.05)
    assert repr(res) == repr(ref)
    legacy = hetero_fptas(works, 6.0, 3.0, ALPHA, lam=1.05)
    assert res.makespan <= legacy.makespan * 1.05 + 1e-12
    assert res.makespan >= res.lower_bound - 1e-9
    assert sorted(res.on_p + res.on_q) == list(range(24))
    assert res.makespan == pytest.approx(
        mixed_partition_makespan(works, res.on_p, node_p, node_q)
    )


def test_mixed_fptas_prefers_fast_node_for_everything_small(rng):
    works = rng.uniform(0.5, 1.0, 8)
    slow = NodeSpec(4.0, 0.85, speed=1.0)
    fast = NodeSpec(4.0, 0.95, speed=100.0)
    res = mixed_hetero_fptas(works, slow, fast, lam=1.05)
    ref = rhetero.mixed_hetero_fptas(
        works, rhetero.NodeSpec(4.0, 0.85, speed=1.0),
        rhetero.NodeSpec(4.0, 0.95, speed=100.0), lam=1.05)
    assert repr(res) == repr(ref)
    assert len(res.on_q) >= len(res.on_p)
    assert res.makespan >= mixed_lower_bound(works, slow, fast) - 1e-9


def test_mixed_cluster_policy_end_to_end(rng):
    works = rng.uniform(0.5, 3.0, 16)

    def plan(P):
        platform = P.MixedCluster(
            [P.SharedMemory(40), 8], alphas=(0.85, 0.95), speeds=(1.0, 4.0))
        prob = P.Problem.from_lengths(works, 0.9)
        return P.Session(platform).load(prob).plan(policy="hetero-mixed").schedule

    sched = plan(tapi)
    assert sched.to_json() == plan(rapi).to_json()
    assert sched.makespan >= sched.fluid_makespan - 1e-9
    placed = {lbl for lbl, _ in sched.meta["placement"]}
    assert len(placed) == 16
    assert set(n for _, n in sched.meta["placement"]) <= {0, 1}


def test_mixed_cluster_validates_construction():
    for P in (tapi, rapi):
        with pytest.raises(ValueError):
            P.MixedCluster([4, 4], alphas=(0.9, 1.5))
        with pytest.raises(ValueError):
            P.MixedCluster([4, 4], speeds=(1.0, -2.0))
        one = P.MixedCluster([P.SharedMemory(4)])
        with pytest.raises(ValueError):
            P.Session(one).load(P.Problem.from_lengths([1.0, 2.0], 0.9)).plan(
                policy="hetero-mixed"
            )


# ----------------------------------------------------------------------
# Laziness: the facade must not drag the zoo into light-weight sessions
# ----------------------------------------------------------------------
def test_plain_session_never_imports_the_model_zoo():
    """A plain sparse session (the top-level facade, a matrix Problem,
    plan, simulate, and an execute on CPU lanes) loads none of
    ``repro_torch.workloads`` / ``.models`` / ``.configs``; resolving a
    workload name on the facade is what loads them."""
    code = (
        "import sys, torch\n"
        "from repro_torch import DeviceMesh, Session, SharedMemory\n"
        "from repro_torch.sparse import grid_laplacian_2d, nested_dissection_2d\n"
        "from repro_torch.api import Problem\n"
        "a = grid_laplacian_2d(9)\n"
        "prob = Problem.from_matrix(a, 0.9, ordering=nested_dissection_2d(9))\n"
        "s = Session(SharedMemory(8)).load(prob).plan('pm')\n"
        "s.simulate()\n"
        "Session(DeviceMesh([torch.device('cpu')] * 2)).load(prob).plan('greedy')"
        ".execute(dtype=torch.float64, warmup=False)\n"
        "zoo = ('repro_torch.workloads', 'repro_torch.models', 'repro_torch.configs')\n"
        "heavy = [m for m in sys.modules if m.startswith(zoo)]\n"
        "assert not heavy, heavy\n"
        "import repro_torch\n"
        "repro_torch.analyze_workload\n"
        "assert all(m in sys.modules for m in zoo[:1]), sorted(sys.modules)\n"
        "repro_torch.analyze_workload('qwen3-4b')\n"
        "assert all(m in sys.modules for m in zoo)\n"
        "print('lazy-ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "lazy-ok" in out.stdout
