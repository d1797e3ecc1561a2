"""The port's PlanExecutor against the JAX package's, and its own contracts.

The port runs on ``devices=[torch.device("cpu")] * 4`` (the kernels' plain
versions); the reference on CPU JAX with interpret-mode Pallas kernels.
Both execute the same plan over the same symbolic analysis, in f64.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.sparse as rsparse
import repro_torch.kernels.frontal_cholesky as fc
import repro_torch.sparse as tsparse
from repro.runtime.executor import PlanExecutor as RefExecutor
from repro.sparse.plan import make_plan as rmake_plan
from repro_torch.kernels.ops import factor_fn
from repro_torch.obs import events as tobs_events
from repro_torch.obs import metrics as tobs_metrics
from repro_torch.runtime import PlanExecutor, execute_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(scope="module")
def grid23():
    a = rsparse.grid_laplacian_2d(23)
    ap = rsparse.permute_symmetric(a, rsparse.nested_dissection_2d(23))
    symb = tsparse.analyze(ap, relax=1)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    return ap, symb, plan


@pytest.fixture(scope="module")
def port_runs(grid23):
    ap, symb, plan = grid23
    return {
        mode: PlanExecutor(
            symb, plan, devices=CPU4, dtype=torch.float64, mode=mode
        ).run(ap, warmup=False)
        for mode in ("async", "waves")
    }


@pytest.fixture(scope="module")
def ref_waves(grid23):
    ap = grid23[0]
    jax.config.update("jax_enable_x64", True)
    try:
        symb = rsparse.analyze(ap, relax=1)
        plan = rmake_plan(symb.task_tree(), 8, alpha=0.9)
        return RefExecutor(symb, plan, mode="waves").run(ap, warmup=False)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_port_matches_reference_executor(grid23, port_runs, ref_waves):
    ap, symb, _ = grid23
    fref, rref = ref_waves
    for mode, (fact, report) in port_runs.items():
        assert len(fact.panels) == len(fref.panels) == symb.n_supernodes
        for a, b in zip(fact.panels, fref.panels):
            assert a.dtype == np.float64
            assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < 1e-10
        assert report.mode == mode and report.interpret
        assert sorted(e.front for e in report.trace) == list(range(symb.n_supernodes))
    _, rw = port_runs["waves"]
    assert rw.n_dispatches == rref.n_dispatches
    assert [(e.front, e.wave, e.batched) for e in rw.trace] == [
        (e.front, e.wave, e.batched) for e in rref.trace
    ]
    assert rw.projected_peak_bytes == rref.projected_peak_bytes
    dense = ap.toarray()
    l = port_runs["async"][0].to_dense_l()
    assert np.abs(l @ l.T - dense).max() / np.abs(dense).max() < 1e-14


def test_async_waves_sequential_bit_identical(grid23, port_runs):
    ap, symb, _ = grid23
    seq = tsparse.factorize(ap, symb, factor_fn=factor_fn(), dtype=torch.float64, device="cpu")
    fa, fw = port_runs["async"][0], port_runs["waves"][0]
    for s, (pa, pw, ps) in enumerate(zip(fa.panels, fw.panels, seq.panels)):
        np.testing.assert_array_equal(pa, pw, err_msg=f"panel {s}")
        np.testing.assert_array_equal(pa, ps, err_msg=f"panel {s}")


def test_async_report_observables(grid23, port_runs):
    _, symb, _ = grid23
    _, ra = port_runs["async"]
    ev = {e.front: e for e in ra.trace}
    for s, sn in enumerate(symb.supernodes):
        if sn.parent >= 0:
            assert ev[sn.parent].t_start >= ev[s].t_end - 1e-9
    assert ra.mean_ready_latency() is not None
    assert ra.n_dispatches < len(ra.trace)
    assert all(e["cat"] == "async" for e in ra.to_trace())
    text = ra.summary()
    assert "measured" in text and "interpret=True" in text


def test_large_fronts_and_batch_cap(monkeypatch):
    """Fronts over VMEM_FRONT_MAX take the panel + SYRK pipeline in every
    runner; max_batch=1 keeps one front per launch; bits still agree."""
    import repro_torch.runtime.executor as ex

    monkeypatch.setattr(ex, "VMEM_FRONT_MAX", 128)
    monkeypatch.setattr("repro_torch.kernels.ops.VMEM_FRONT_MAX", 128)
    a = rsparse.grid_laplacian_2d(12)
    ap = rsparse.permute_symmetric(a, rsparse.nested_dissection_2d(12))
    symb = tsparse.analyze(ap, relax=2)
    plan = tsparse.make_plan(symb.task_tree(), 4, alpha=0.9)
    fc.reset_counters()
    runs = [
        PlanExecutor(symb, plan, devices=CPU4[:2], dtype=torch.float64,
                     mode=m, max_batch=b).run(ap, warmup=w)
        for m, b, w in (("async", 32, True), ("waves", 1, False))
    ]
    assert fc.PLAIN_RUNS["panel_factor"] > 0 and fc.PLAIN_RUNS["syrk_downdate"] > 0
    assert fc.LAUNCHES == {k: 0 for k in fc.KERNELS}
    assert runs[1][1].n_dispatches == symb.n_supernodes
    for pa, pw in zip(runs[0][0].panels, runs[1][0].panels):
        np.testing.assert_array_equal(pa, pw)
    l = runs[0][0].to_dense_l()
    assert np.abs(l @ l.T - ap.toarray()).max() < 1e-12


def test_provenance_runners_bit_identical(grid23, port_runs):
    """An amalgamated plan (fused groups from the reference's optimizer)
    lands the same factor bits as the unoptimized async run."""
    from repro.api import DeviceMesh, Problem, Session

    ap, symb, _ = grid23
    rsymb = rsparse.analyze(ap, relax=1)
    sess = Session(DeviceMesh()).load(Problem.from_symbolic(rsymb, 0.9, matrix=ap))
    sess.optimize(max_front=64).plan("greedy")
    assert sess.problem.n < symb.n_supernodes
    plan = sess.schedule.to_execution_plan()
    prov = sess.problem.provenance
    fa = port_runs["async"][0]
    for mode in ("async", "waves"):
        fact, report = PlanExecutor(
            symb, plan, devices=CPU4, dtype=torch.float64, mode=mode,
            provenance=prov,
        ).run(ap, warmup=False)
        assert report.mode == mode
        for pa, pf in zip(fa.panels, fact.panels):
            np.testing.assert_array_equal(pa, pf)


def test_obs_metric_names_match_reference(grid23):
    """Both executors publish the same metric names for the same run."""
    from repro.obs import events as robs_events
    from repro.obs import metrics as robs_metrics

    ap, symb, plan = grid23
    names = {}
    for reg, bus, run in (
        (tobs_metrics.REGISTRY, tobs_events.BUS, lambda: execute_plan(
            ap, symb, plan, devices=CPU4, dtype=torch.float64, mode="async")),
        (robs_metrics.REGISTRY, robs_events.BUS, lambda: RefExecutor(
            symb, plan, mode="async").run(ap, warmup=False)),
    ):
        reg.reset()
        bus.clear()
        run()
        names[reg] = set(reg.names())
        assert len(bus.spans(name="run")) == symb.n_supernodes
    port, ref = names.values()
    # the port adds its host-stage, copy and GC counters
    assert port == ref | {"repro_executor_stage_seconds_total",
                          "repro_executor_copy_bytes_total", "repro_host_gc_seconds_total"}
    assert {"repro_dispatches_total", "repro_queue_depth",
            "repro_batch_width", "repro_peak_resident_bytes"} <= port


def test_executor_contracts(grid23):
    ap, symb, plan = grid23
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PlanExecutor(symb, plan)
    assert PlanExecutor(symb, plan, devices=CPU4, shard_dispatch=True).shard_dispatch
    with pytest.raises(ValueError):
        PlanExecutor(symb, plan, devices=CPU4, mode="eager")
    with pytest.raises(TypeError):
        PlanExecutor(symb, plan, devices=CPU4, dtype=torch.float16)
    ex = PlanExecutor(symb, plan, devices=CPU4)
    assert ex.dtype == np.float32 and ex.interpret


def test_dispatch_schedule_batches_same_shapes(grid23):
    """Twin of ``tests/test_executor.py::test_dispatch_schedule_batches_same_shapes``:
    every front dispatched once, fewer dispatches than fronts, no dispatch
    mixing shape classes; the schedule is the reference's, dispatch by
    dispatch."""
    from repro_torch.kernels.ops import padded_shape

    ap, symb, plan = grid23
    ds = PlanExecutor(symb, plan, devices=CPU4).dispatches()
    assert sorted(s for d in ds for s in d.supernodes) == list(range(symb.n_supernodes))
    assert len(ds) < symb.n_supernodes
    for d in ds:
        for s in d.supernodes:
            sn = symb.supernodes[s]
            assert padded_shape(sn.m, sn.nb) == d.key
    rsymb = rsparse.analyze(ap, relax=1)
    ref = RefExecutor(rsymb, rmake_plan(rsymb.task_tree(), 8, alpha=0.9)).dispatches()
    assert [(d.wave, d.key, d.supernodes) for d in ds] == [
        (d.wave, d.key, d.supernodes) for d in ref
    ]


def test_pow2_floor():
    """Twin of ``tests/test_executor.py::test_pow2_floor``."""
    from repro.distributed.device_groups import pow2_floor as rpow2_floor
    from repro_torch.distributed.device_groups import pow2_floor

    assert [pow2_floor(x) for x in (1, 2, 3, 7, 8, 9)] == [1, 2, 2, 4, 8, 8]
    assert [pow2_floor(x) for x in range(1, 600)] == [rpow2_floor(x) for x in range(1, 600)]


def test_assign_wave_groups_oversubscribed():
    """Twin of ``tests/test_executor.py::test_assign_wave_groups_oversubscribed``:
    more demand than devices degrades to time-sharing, never raises; the
    groups are the reference's."""
    from repro.distributed import device_groups as rdg
    from repro_torch.distributed import device_groups as tdg

    for req, n in (({i: 2 for i in range(5)}, 4), ({0: 4, 1: 4, 2: 2, 3: 1}, 4)):
        groups = tdg.assign_wave_groups(req, n)
        assert len(groups) == len(req)
        _, max_load = tdg.groups_footprint(groups)
        assert max_load >= 2
        ref = rdg.assign_wave_groups(req, n)
        assert {k: (g.offset, g.size) for k, g in groups.items()} == {
            k: (g.offset, g.size) for k, g in ref.items()
        }
        assert max_load == rdg.groups_footprint(ref)[1]


def test_import_isolation():
    """Every port module (the facade, the optimizer, the straggler module,
    the online scheduler and its replay bridge, the elastic module, the
    serving cluster, the efficiency metrics and the dashboard, the demo,
    the flash kernel's wrapper, the workload front end, the model configs
    and the pod scheduler, the model zoo, the sharding hooks and the serving
    launcher, the sharding rules, the meshes, the cost counter, the dry
    run and the example entry points among them), chip_smoke and the card
    tests import neither jax nor repro."""
    code = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
import test_torch_card
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
need = {"repro_torch.api.session", "repro_torch.api.platform", "repro_torch.demo",
        "repro_torch.kernels.flash_attention", "repro_torch.kernels._build",
        "repro_torch.sparse.optimize", "repro_torch.runtime.straggler",
        "repro_torch.online.events", "repro_torch.core.hetero",
        "repro_torch.online.state", "repro_torch.online.queue",
        "repro_torch.online.scheduler", "repro_torch.online.replay",
        "repro_torch.runtime.elastic", "repro_torch.obs.efficiency",
        "repro_torch.obs.dashboard", "repro_torch.cluster.comm",
        "repro_torch.cluster.scheduler", "repro_torch.cluster.worker",
        "repro_torch.cluster.engine", "repro_torch.cluster.service",
        "repro_torch.api._deprecate", "repro_torch.models.config",
        "repro_torch.configs", "repro_torch.launch.roofline",
        "repro_torch.workloads.graph", "repro_torch.workloads.costs",
        "repro_torch.workloads.zoo", "repro_torch.serve.pod_scheduler",
        "repro_torch.models.common", "repro_torch.models.attention",
        "repro_torch.models.gla", "repro_torch.models.rwkv6", "repro_torch.models.mamba2",
        "repro_torch.models.moe", "repro_torch.models.transformer",
        "repro_torch.models.decode", "repro_torch.models.model", "repro_torch.models.weights",
        "repro_torch.distributed.constraints", "repro_torch.launch.serve",
        "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
        "repro_torch.launch.hlocost", "repro_torch.launch.dryrun",
        "repro_torch.launch.train", "repro_torch.obs.scopes",
        "repro_torch.examples", "repro_torch.examples.quickstart",
        "repro_torch.examples.elastic_rescale", "repro_torch.examples.serve_lm",
        "repro_torch.examples.train_lm", "repro_torch.examples.workload_serving"}
assert need <= set(sys.modules), need - set(sys.modules)
print("ok", len([k for k in sys.modules if k.startswith("repro_torch")]))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), REPO, os.path.join(REPO, "tests")]))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
