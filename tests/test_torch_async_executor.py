"""The port's async futures runner against the wave barrier: twins of the
cases of ``tests/test_async_executor.py`` that other port tests do not
hold (the straggler cases are in ``test_torch_straggler.py``).

The port runs on CPU lanes (the kernels' plain versions), the reference
on CPU JAX; where the reference gives numbers (the buddy allocator's
groups, the wave path's measured peak, the trace's and the report's
keys), they are compared.  The forged-mesh A/B of the reference runs here
on ``[torch.device("cpu")] * 8``, once with sharding off (the CPU
default) and once with it on.
"""
import math

import jax
import numpy as np
import pytest
import torch

import repro.sparse as rsparse
import repro_torch.sparse as tsparse
from repro.distributed.device_groups import BuddyAllocator as RefBuddy
from repro.runtime.executor import PlanExecutor as RefExecutor
from repro.sparse.plan import make_plan as rmake_plan
from repro_torch.distributed.device_groups import BuddyAllocator
from repro_torch.runtime import FrontDelays, PlanExecutor

CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(scope="module")
def problem():
    a = tsparse.grid_laplacian_2d(9)
    ap = tsparse.permute_symmetric(a, tsparse.nested_dissection_2d(9))
    symb = tsparse.analyze(ap, relax=1)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    return ap, symb, plan


def _run(problem, mode, **kw):
    ap, symb, plan = problem
    return PlanExecutor(symb, plan, devices=CPU4, dtype=torch.float64, mode=mode,
                        **kw).run(ap, warmup=False)


@pytest.fixture(scope="module")
def ref_runs(problem):
    """The reference's waves and async runs of the same problem (f64)."""
    ap = problem[0]
    jax.config.update("jax_enable_x64", True)
    try:
        symb = rsparse.analyze(ap, relax=1)
        plan = rmake_plan(symb.task_tree(), 8, alpha=0.9)
        return {m: RefExecutor(symb, plan, mode=m).run(ap, warmup=False)[1]
                for m in ("waves", "async")}
    finally:
        jax.config.update("jax_enable_x64", False)


def test_buddy_exhaustion_and_free():
    """Twin of ``test_buddy_exhaustion_and_free``: the same groups as the
    reference's allocator, step by step."""
    out = []
    for cls in (BuddyAllocator, RefBuddy):
        alloc = cls(4)
        gs = [alloc.alloc(1) for _ in range(4)]
        assert all(g is not None for g in gs)
        assert alloc.n_free == 0
        assert alloc.alloc(1) is None  # full: the caller waits for a free
        alloc.free(gs[1])
        assert alloc.n_free == 1
        g = alloc.alloc(4)  # one device free: degrades, never None
        assert g is not None and g.size == 1 and g.offset == gs[1].offset
        out.append([(x.offset, x.size) for x in gs + [g]])
    assert out[0] == out[1]


def test_buddy_double_free_asserts():
    """Twin of ``test_buddy_double_free_asserts``."""
    for cls in (BuddyAllocator, RefBuddy):
        alloc = cls(2)
        g = alloc.alloc(2)
        alloc.free(g)
        with pytest.raises(AssertionError):
            alloc.free(g)


def test_async_tree_precedence(problem):
    """Twin of ``test_async_tree_precedence``: a parent starts after, and
    became ready at or after, each child's end."""
    _, symb, _ = problem
    _, ra = _run(problem, "async")
    ev = {e.front: e for e in ra.trace}
    assert sorted(ev) == list(range(symb.n_supernodes))
    for s, sn in enumerate(symb.supernodes):
        if sn.parent >= 0:
            assert ev[sn.parent].t_start >= ev[s].t_end - 1e-9
            assert ev[sn.parent].t_ready >= ev[s].t_end - 1e-9


def test_async_peak_capped_by_wave_peak(problem, ref_runs):
    """Twin of ``test_async_peak_capped_by_wave_peak``: capped at the wave
    path's measured peak (the reference's, byte for byte), async stays
    within it."""
    _, rw = _run(problem, "waves")
    assert rw.measured_peak_bytes == ref_runs["waves"].measured_peak_bytes
    _, ra = _run(problem, "async", memory_cap_bytes=rw.measured_peak_bytes)
    assert 0 < ra.measured_peak_bytes <= rw.measured_peak_bytes


def test_async_chrome_trace_export(problem, ref_runs):
    """Twin of ``test_async_chrome_trace_export``: the latency args are
    present under async and absent under waves, with the reference's keys."""
    _, ra = _run(problem, "async")
    _, rw = _run(problem, "waves")
    evs = ra.to_trace()
    assert evs and all(e["ph"] == "X" for e in evs)
    assert all(e["dur"] > 0 for e in evs)
    assert all("ready_latency_s" in e["args"] and "dispatch_latency_s" in e["args"]
               for e in evs)
    assert {e["cat"] for e in evs} == {"async"}
    wevs = rw.to_trace()
    assert all("ready_latency_s" not in e["args"] for e in wevs)
    for mine, ref in ((evs, ref_runs["async"]), (wevs, ref_runs["waves"])):
        assert {frozenset(e["args"]) for e in mine} == {
            frozenset(e["args"]) for e in ref.to_trace()
        }


def test_session_execute_mode():
    """Twin of ``test_session_execute_mode`` on CPU lanes: waves and async
    land the same factor, the metrics have the reference's keys (no ready
    latency under waves), the factor is the reference's within 1e-11."""
    from repro.api import DeviceMesh as RefMesh
    from repro.api import Problem as RefProblem
    from repro.api import Session as RefSession
    from repro_torch.api import DeviceMesh, Problem, Session

    g = 9
    a = tsparse.grid_laplacian_2d(g)
    prob = Problem.from_matrix(a, 0.9, ordering=tsparse.nested_dissection_2d(g), relax=1)
    sess = Session(DeviceMesh(CPU4, plan_devices=8)).load(prob).plan("greedy")
    rep_w = sess.execute(warmup=False, mode="waves", dtype=torch.float64)
    rep_a = sess.execute(warmup=False, dtype=torch.float64)  # async is the default
    assert rep_w.detail.mode == "waves" and rep_a.detail.mode == "async"
    l = rep_a.artifact.to_dense_l()
    np.testing.assert_array_equal(rep_w.artifact.to_dense_l(), l)
    assert "mean_ready_latency_s" not in rep_w.metrics
    assert rep_a.metrics["mean_ready_latency_s"] >= 0.0

    jax.config.update("jax_enable_x64", True)
    try:
        rprob = RefProblem.from_matrix(a, 0.9, ordering=rsparse.nested_dissection_2d(g),
                                       relax=1)
        rsess = RefSession(RefMesh(plan_devices=8)).load(rprob).plan("greedy")
        ref = {m: rsess.execute(warmup=False, mode=m) for m in ("waves", "async")}
    finally:
        jax.config.update("jax_enable_x64", False)
    assert set(rep_w.metrics) == set(ref["waves"].metrics)
    assert set(rep_a.metrics) == set(ref["async"].metrics)
    lref = ref["async"].artifact.to_dense_l()
    assert np.abs(l - lref).max() / max(1.0, np.abs(lref).max()) < 1e-11


@pytest.mark.parametrize("shard", [False, True])
def test_async_beats_waves_on_eight_lanes(shard):
    """Twin of ``test_async_beats_waves_forged_mesh`` on 8 CPU lanes, with
    sharding off (the CPU default) and on: with injected stragglers the
    futures runner beats the barrier, bit-identically, within the wave
    path's memory peak.

    On CPU lanes the plain versions' work (about 1 s here) is of the order
    of the stragglers' 0.8 s, and async wins by what it saves of them
    (two stragglers share one of its batches): a margin of 10-20% that a
    single pair of runs on a shared CPU can lose.  So the makespans are
    summed over two pairs run in turns (waves, async, async, waves)."""
    a = tsparse.grid_laplacian_2d(11)
    ap = tsparse.permute_symmetric(a, tsparse.nested_dissection_2d(11))
    symb = tsparse.analyze(ap, relax=1)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    delays = FrontDelays.random(range(symb.n_supernodes), 4, 0.2, seed=1)
    kw = dict(devices=[torch.device("cpu")] * 8, dtype=torch.float64, delay_fn=delays,
              shard_dispatch=shard)
    fw, rw = PlanExecutor(symb, plan, mode="waves", **kw).run(ap)
    cap = rw.measured_peak_bytes
    runs = [PlanExecutor(symb, plan, mode="async", memory_cap_bytes=cap, **kw).run(ap)
            for _ in range(2)]
    runs.append(PlanExecutor(symb, plan, mode="waves", **kw).run(ap))
    for fact, rep in runs:
        for pw, pa in zip(fw.panels, fact.panels):
            np.testing.assert_array_equal(pw, pa)
    ra, ra2, rw2 = (rep for _, rep in runs)
    for rep in (ra, ra2):
        assert rep.measured_peak_bytes <= rw.measured_peak_bytes
        assert all(not math.isnan(e.t_ready) for e in rep.trace)
        assert (max(e.dispatch_devices for e in rep.trace) > 1) == shard
    waves_s = rw.measured_makespan + rw2.measured_makespan
    async_s = ra.measured_makespan + ra2.measured_makespan
    assert waves_s / async_s > 1.0, (waves_s, async_s)
