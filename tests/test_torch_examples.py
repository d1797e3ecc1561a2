"""Twins of the reference's example entry points (``examples/*.py``):
``repro_torch.examples.<name>.main`` against the reference script's
``main`` on the same inputs.

The reference scripts print their numbers and return nothing, so each is
loaded by path and run with spies on the calls whose results it prints:
the spies keep those results at full precision.  The reference runs on CPU
JAX (its Pallas kernels in interpret mode, as its own tests run them), the
port on CPU lanes with the plain kernel versions.  Where the reference
draws random weights or batches (the LM scripts), the port's module is
handed the reference's draws (``params_from_numpy``), so the two compute
the same function.  Tolerances: virtual time and plan quantities 1e-9
relative; the f64 factor 1e-11 (``tests/test_kernels.py``), its residual
the reference's 1e-12; LM logits and losses 1e-5 relative to
max(1, max |reference|) (``tests/test_torch_models.py``), tokens exact.
The LM scripts run at a small size: ``cfg.reduced()`` for ``train_lm``'s
~100M config (``serve_lm`` is reduced already) and its own flags for the
steps, batch and length.
"""
import dataclasses
import functools
import importlib.util
import math
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.runtime as ref_runtime
from repro_torch import examples
from repro_torch.examples import (
    elastic_rescale,
    quickstart,
    serve_lm,
    train_lm,
    workload_serving,
)
from repro_torch.models.weights import params_from_numpy

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = [torch.device("cpu")]
VT = 1e-9  # virtual time and plan quantities, relative
LM_TOL = 1e-5
EXAMPLES = ("quickstart", "elastic_rescale", "serve_lm", "train_lm", "workload_serving")


@pytest.fixture
def reference(monkeypatch):
    """``load(name)``: the reference script ``examples/<name>.py`` as a
    module (JAX's x64 flag, which some scripts set on import, restored
    afterwards)."""
    x64 = bool(jax.config.jax_enable_x64)

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"reference_example_{name}", REPO / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    yield load
    jax.config.update("jax_enable_x64", x64)


def spy(monkeypatch, owner, name, keep=lambda args, kwargs, out: out) -> list:
    """Wrap ``owner.name``; each call appends ``keep(args, kwargs, out)``
    (taken at call time) to the returned list."""
    got = []
    orig = getattr(owner, name)

    @functools.wraps(orig)
    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        got.append(keep(args, kwargs, out))
        return out

    monkeypatch.setattr(owner, name, wrapper)
    return got


class _JitSpy:
    """Stands in for a script's ``jax`` module: ``jit`` records each
    output of the compiled function, everything else is JAX's."""

    def __init__(self, got: list):
        self._got = got

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        compiled = jax.jit(fn, **kw)

        def call(*args, **kwargs):
            out = compiled(*args, **kwargs)
            self._got.append(out)
            return out

        return call


def close(got, want, rel=VT) -> bool:
    return math.isclose(float(got), float(want), rel_tol=rel, abs_tol=0.0)


def _lm_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# ----------------------------------------------------------------------
def test_quickstart_matches_reference(reference, monkeypatch):
    plans = spy(monkeypatch, ref_api.Session, "plan",
                lambda a, k, out: (k.get("policy"), out.schedule.makespan))
    runs = spy(monkeypatch, ref_api.Session, "execute",
               lambda a, k, out: (out, a[0].problem.matrix.toarray()))
    sims = spy(monkeypatch, ref_api.Session, "simulate")
    fluids = spy(monkeypatch, ref_api.Problem, "fluid_makespan")
    reference("quickstart").main()
    got = quickstart.main([], devices=CPU)

    assert [p for p, _ in plans] == ["pm", "proportional", "divisible", "pm", "greedy", "pm"]
    for i, p in enumerate(("pm", "proportional", "divisible")):
        assert close(got["makespans"][p], plans[i][1]), p
    (run, dense), = runs
    assert got["n_fronts"] == len(run.planned.tasks())
    assert close(got["plan_efficiency"], run.planned.efficiency())
    assert got["n_dispatches"] == run.detail.n_dispatches
    l_ref = run.artifact.to_dense_l()
    l_got = got["factor"].to_dense_l()
    assert np.abs(l_got - l_ref).max() <= 1e-11 * np.abs(l_ref).max()
    assert got["residual"] <= quickstart.RESIDUAL_MAX
    err_ref = np.abs(l_ref @ l_ref.T - dense).max()
    assert got["residual_inf"] <= 1e-12 * np.abs(dense).max() and err_ref <= 1e-12 * 4
    assert close(got["no_failure_makespan"], plans[-1][1])
    rep, = sims
    assert close(got["failure_makespan"], rep.makespan)
    assert got["n_reshares"] == rep.detail.n_reshares
    assert close(got["fluid_bound"], fluids[-1])


def test_elastic_rescale_matches_reference(reference, monkeypatch):
    mod = reference("elastic_rescale")
    dead = spy(monkeypatch, ref_runtime.HeartbeatMonitor, "dead")
    eq = spy(monkeypatch, mod, "tree_equivalent_lengths",
             lambda a, k, out: out[a[0].root])
    pm = spy(monkeypatch, ref_runtime.ElasticController, "pm_makespan")
    runs = spy(monkeypatch, mod, "run_elastic_schedule")
    speeds = spy(monkeypatch, ref_runtime.StragglerDetector, "node_speeds")
    rebal = spy(monkeypatch, mod, "rebalance_two_pods",
                lambda a, k, out: (np.asarray(a[0]), out))
    mod.main()
    got = elastic_rescale.main([], devices=CPU)

    assert got["dead"] == list(dead[-1]) == [5]
    assert close(got["fluid_full"], eq[-1] / 256 ** mod.ALPHA)
    assert close(got["fluid_elastic"], pm[-1])
    (mk, plans), = runs
    assert close(got["elastic_makespan"], mk) and got["n_plans"] == len(plans)
    np.testing.assert_array_equal(got["speeds"], speeds[-1])
    (lengths, res), = rebal
    assert close(got["fast_pod_share"], sum(lengths[i] for i in res.on_p) / lengths.sum())
    assert close(got["rebalance_makespan"], res.makespan)
    assert close(got["rebalance_lower_bound"], res.lower_bound)


def test_workload_serving_matches_reference(reference, monkeypatch):
    plans = spy(monkeypatch, ref_api.Session, "plan",
                lambda a, k, out: (k.get("policy"), out.schedule, out.problem.n))
    sims = spy(monkeypatch, ref_api.Session, "simulate")
    served = spy(monkeypatch, ref_api.Session, "serve")
    reference("workload_serving").main()
    got = workload_serving.main([], devices=CPU)

    policies = [p for p, _, _ in plans]
    assert policies == ["pm", "proportional", "pm", "pm", "hetero-mixed"], policies
    assert close(got["moe_makespans"]["pm"], plans[0][1].makespan)
    assert close(got["moe_makespans"]["proportional"], plans[1][1].makespan)
    assert got["moe_experts"] == plans[0][1].meta["workload"]["n_experts"]
    assert got["moe_tasks"] == plans[0][2]
    sched = plans[3][1]
    assert got["pipeline_tasks"] == plans[3][2]
    assert close(got["pipeline_plan_makespan"], sched.makespan)
    assert close(got["pipeline_peak_bytes"], sched.peak_memory())
    rep, = sims
    assert close(got["pipeline_makespan"], rep.makespan)
    assert close(got["pipeline_efficiency"], rep.efficiency())
    srv, = served
    assert got["served"] == len(srv.detail.futures)
    assert close(got["mean_latency"], srv.metrics["mean_latency"])
    placed = plans[4][1]
    assert got["mixed_tasks"] == plans[4][2]
    assert got["mixed_on_fast"] == sum(1 for _, node in placed.meta["placement"] if node == 1)
    assert close(got["mixed_makespan"], placed.makespan)
    assert close(got["mixed_lower_bound"], placed.fluid_makespan)


def test_serve_lm_matches_reference(reference, monkeypatch):
    mod = reference("serve_lm")
    ref_params = spy(monkeypatch, mod, "init_params")
    ref_batch = spy(monkeypatch, mod, "random_batch")
    place_eq = spy(monkeypatch, mod, "place_two_pods_equal")
    place_het = spy(monkeypatch, mod, "place_two_pods")
    decodes = []
    monkeypatch.setattr(mod, "jax", _JitSpy(decodes))
    prefill_out = []
    orig_build = mod.build_prefill_fn

    def build_prefill(*a, **k):
        fn = orig_build(*a, **k)

        def run(params, batch):
            out = fn(params, batch)
            prefill_out.append(out[0])
            return out

        return run

    monkeypatch.setattr(mod, "build_prefill_fn", build_prefill)
    mod.main()

    cfg = mod.ARCHS["qwen2.5-3b"].reduced()
    tree = jax.tree.map(np.asarray, ref_params[0])
    monkeypatch.setattr(serve_lm, "init_params",
                        lambda cfg, seed, device=None: params_from_numpy(cfg, tree, device))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in ref_batch[0].items()}
    monkeypatch.setattr(serve_lm, "random_batch", lambda cfg, b, t, gen: batch)
    got = serve_lm.main([], devices=CPU)

    mk_eq, pl_eq = place_eq[0]
    mk_het, pl_het = place_het[0]
    assert got["placement_equal"] == pl_eq and got["placement_degraded"] == pl_het
    assert close(got["makespan_equal"], mk_eq) and close(got["makespan_degraded"], mk_het)
    logits0 = np.asarray(prefill_out[0])[:, -1]
    assert _lm_rel(got["prefill_logits"], logits0) < LM_TOL
    steps = [logits0] + [np.asarray(lg)[:, -1] for lg, _ in decodes]
    want = np.stack([s.argmax(-1) for s in steps], axis=1)
    assert got["tokens"].shape == want.shape == (4, 16)
    np.testing.assert_array_equal(got["tokens"], want)
    assert cfg.n_layers == 2  # the reference's reduced config, served as is


def test_train_lm_matches_reference(reference, monkeypatch, tmp_path):
    mod = reference("train_lm")
    small = lambda build: (lambda: build().reduced())  # noqa: E731
    monkeypatch.setattr(mod, "hundred_m_config", small(mod.hundred_m_config))
    monkeypatch.setattr(train_lm, "hundred_m_config", small(train_lm.hundred_m_config))
    ref_params = spy(monkeypatch, mod, "init_params")
    stats = []
    monkeypatch.setattr(mod, "jax", _JitSpy(stats))
    flags = ["--batch", "2", "--seq", "32"]

    def run_both(steps, resume, ref_stats_from):
        extra = ["--steps", str(steps)] + (["--resume"] if resume else [])
        monkeypatch.setattr(sys, "argv", ["train_lm.py", *flags, *extra,
                                          "--ckpt-dir", str(tmp_path / "ref")])
        mod.main()
        tree = jax.tree.map(np.asarray, ref_params[-1])
        monkeypatch.setattr(train_lm, "init_params",
                            lambda cfg, seed, device=None: params_from_numpy(cfg, tree, device))
        got = train_lm.main([*flags, *extra, "--ckpt-dir", str(tmp_path / "port")], devices=CPU)
        want = stats[ref_stats_from:]
        return got, [float(s["loss"]) for _, _, s in want], [float(s["lr"]) for _, _, s in want]

    got, losses, lrs = run_both(3, False, 0)
    assert got["start"] == 0 and len(got["losses"]) == len(losses) == 3
    assert got["n_params"] == sum(x.size for x in jax.tree.leaves(ref_params[0]))
    for g, w in zip(got["losses"], losses):
        assert abs(g - w) <= LM_TOL * max(1.0, abs(w)), (got["losses"], losses)
    np.testing.assert_allclose(got["lrs"], lrs, rtol=1e-6)
    assert sorted(os.listdir(tmp_path / "port")) == ["step_00000003"]

    # --resume: both restore their own step-3 checkpoint and run step 3
    got, losses, lrs = run_both(4, True, 3)
    assert got["start"] == 3 and len(got["losses"]) == len(losses) == 1
    assert abs(got["losses"][0] - losses[0]) <= LM_TOL * max(1.0, abs(losses[0]))
    np.testing.assert_allclose(got["lrs"], lrs, rtol=1e-6)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(name, monkeypatch):
    """No silent fallback: without CUDA and without CPU lanes every entry
    point raises before it does any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    module = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


@pytest.mark.parametrize("lanes", [1, 3])
def test_cpu_lanes_flag_names_the_devices(lanes):
    assert examples.resolve_devices(None, lanes) == CPU * lanes
    assert examples.resolve_devices(CPU * 2, lanes) == CPU * 2  # the caller's list wins


def test_example_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.elastic_rescale", "--cpu-lanes", "1"],
        capture_output=True, text=True, env=env, timeout=300, check=True).stdout
    assert "dead at t=5.5: [5] (expected [5])" in out
    assert "discretized elastic run" in out
