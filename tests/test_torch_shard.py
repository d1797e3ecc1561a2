"""Sharded dispatch (``PlanExecutor(shard_dispatch=True)``) on CPU lanes.

A batch of small fronts whose carved groups span several lanes is padded
with identity fronts to a multiple of the lane count and split, one run of
the kernel's plain version per lane.  The port runs on
``[torch.device("cpu")] * k``; its sharded runs must equal its unsharded
ones bit for bit (a front's bits depend on neither its batch nor its
lane) and the reference's within 1e-11 (f64).  The reference shards only
over real JAX devices, so its sharded run is made in a subprocess on a
forged 4-device host mesh (``XLA_FLAGS`` must be set before JAX starts),
as ``tests/test_executor.py::test_executor_multi_device_forged`` does; its
waves trace gives the per-front ``dispatch_devices`` the port must match.

    PYTHONPATH=src python -m pytest -q tests/test_torch_shard.py
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.kernels.frontal_cholesky as fc
import repro_torch.sparse as tsparse
from repro_torch.kernels.ops import padded_shape
from repro_torch.runtime import PlanExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CPU4 = [CPU] * 4


@pytest.fixture(scope="module")
def grid9():
    """Grid 9, nested dissection, relax 1, a plan for 4 devices: the
    reference's forged multi-device case."""
    a = tsparse.grid_laplacian_2d(9)
    ap = tsparse.permute_symmetric(a, tsparse.nested_dissection_2d(9))
    symb = tsparse.analyze(ap, relax=1)
    plan = tsparse.make_plan(symb.task_tree(), 4, alpha=0.9)
    return ap, symb, plan


def _spd_stack(b: int, mp: int, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).normal(size=(b, mp, mp))
    return x @ x.transpose(0, 2, 1) + mp * np.eye(mp)


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("b", [1, 3, 4, 5, 8])
def test_run_batch_splits_over_lanes(grid9, b, lanes):
    """The split output is the one-lane output bit for bit, with B fronts;
    each lane runs the plain version once (identity shards included)."""
    _, symb, plan = grid9
    ex = PlanExecutor(symb, plan, devices=[CPU] * lanes, dtype=torch.float64,
                      shard_dispatch=True)
    batch = _spd_stack(b, 256, seed=10 * b + lanes)
    one = ex._run_batch(batch, 128, [CPU])
    before = fc.PLAIN_RUNS["front_factor"]
    got = ex._run_batch(batch, 128, [CPU] * lanes)
    assert fc.PLAIN_RUNS["front_factor"] == before + lanes
    assert got.shape == (b, 256, 256)
    np.testing.assert_array_equal(got, one)


REF_SHARDED = """
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
from repro.runtime.executor import PlanExecutor
from repro.sparse import analyze, grid_laplacian_2d, make_plan, \\
    nested_dissection_2d, permute_symmetric

assert jax.device_count() == 4
a = grid_laplacian_2d(9)
ap = permute_symmetric(a, nested_dissection_2d(9))
symb = analyze(ap, relax=1)
plan = make_plan(symb.task_tree(), 4, alpha=0.9)
fact, rep = PlanExecutor(symb, plan, mode="waves", shard_dispatch=True).run(
    ap, warmup=False)
np.savez(sys.argv[1], *fact.panels)
print(json.dumps({"trace": [[e.front, e.dispatch_devices, e.devices_used]
                            for e in rep.trace]}))
"""


@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory):
    """The reference's sharded waves run on 4 forged host devices: its
    panels and its per-front (dispatch_devices, devices_used)."""
    path = tmp_path_factory.mktemp("ref_shard") / "panels.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", REF_SHARDED, str(path)],
                         capture_output=True, text=True, env=env, timeout=420)
    assert out.returncode == 0, out.stderr[-2000:]
    trace = json.loads(out.stdout.strip().splitlines()[-1])["trace"]
    with np.load(path) as z:
        panels = [z[f"arr_{i}"] for i in range(len(z.files))]
    return panels, {f: (dd, du) for f, dd, du in trace}


@pytest.fixture(scope="module")
def port_runs(grid9):
    """The port on 4 CPU lanes, both modes, sharded and not: (factor,
    report, plain front_factor runs)."""
    ap, symb, plan = grid9
    runs = {}
    for mode in ("waves", "async"):
        for shard in (False, True):
            fc.reset_counters()
            fact, rep = PlanExecutor(
                symb, plan, devices=CPU4, dtype=torch.float64, mode=mode,
                shard_dispatch=shard,
            ).run(ap, warmup=False)
            runs[mode, shard] = (fact, rep, fc.PLAIN_RUNS["front_factor"])
    return runs


def _lanes_per_small_dispatch(symb, rep) -> int:
    """Σ over the run's small-front dispatches of the lanes each engaged
    (fronts of one dispatch share its sequence number)."""
    lanes = {}
    for e in rep.trace:
        sn = symb.supernodes[e.front]
        if padded_shape(sn.m, sn.nb)[0] <= fc.VMEM_FRONT_MAX:
            lanes[e.wave, e.t_start] = e.dispatch_devices
    return sum(lanes.values())


def test_sharded_matches_unsharded_and_reference(grid9, port_runs, ref_sharded):
    """Twin of ``test_executor_multi_device_forged``: sharded panels are the
    unsharded ones bit for bit and the reference's within 1e-11; the
    waves trace engages the reference's lanes front by front; groups span
    lanes; the residual holds; each lane of a dispatch ran once."""
    ap, symb, _ = grid9
    ref_panels, ref_trace = ref_sharded
    base = port_runs["waves", False][0]
    for (mode, shard), (fact, rep, plain) in port_runs.items():
        assert rep.mode == mode and rep.interpret
        for s, (p, q, r) in enumerate(zip(fact.panels, base.panels, ref_panels)):
            np.testing.assert_array_equal(p, q, err_msg=f"{mode} {shard} panel {s}")
            assert np.abs(p - r).max() / max(1.0, np.abs(r).max()) < 1e-11
        assert plain == _lanes_per_small_dispatch(symb, rep)
        if not shard:
            assert {e.dispatch_devices for e in rep.trace} == {1}
    _, rw, _ = port_runs["waves", True]
    assert {e.front: (e.dispatch_devices, e.devices_used) for e in rw.trace} == ref_trace
    used = {e.devices_used for e in rw.trace}
    assert max(used) > 1, used
    assert max(e.dispatch_devices for e in port_runs["async", True][1].trace) > 1
    dense = ap.toarray()
    l = port_runs["async", True][0].to_dense_l()
    assert np.abs(l @ l.T - dense).max() / np.abs(dense).max() < 1e-12
    assert rw.fit_alpha() is not None  # dispatches engaged 1, 2 and 4 lanes


def test_shard_default_and_contracts(grid9, monkeypatch):
    """Off on CPU lanes, on for CUDA devices; building an executor touches
    no device; a list mixing CPU and CUDA devices raises."""
    _, symb, plan = grid9

    def touched(*args, **kwargs):
        raise AssertionError("the constructor touched the CUDA runtime")

    for name in ("_lazy_init", "is_available", "device_count", "current_device"):
        monkeypatch.setattr(torch.cuda, name, touched)
    assert PlanExecutor(symb, plan, devices=CPU4).shard_dispatch is False
    ex = PlanExecutor(symb, plan, devices=[torch.device("cuda", 0)])
    assert ex.shard_dispatch is True and not ex.interpret
    assert PlanExecutor(symb, plan, devices=[torch.device("cuda", 0)] * 4,
                        shard_dispatch=False).shard_dispatch is False
    assert PlanExecutor(symb, plan, devices=CPU4, shard_dispatch=True).shard_dispatch
    for mixed in ([CPU, torch.device("cuda", 0)], [torch.device("cuda", 0), CPU, CPU]):
        with pytest.raises(ValueError, match="all CPU lanes or all CUDA"):
            PlanExecutor(symb, plan, devices=mixed)
