"""The async runner's ready set (``repro_torch.runtime.executor``): one
min-heap of ready fronts per shape class, the classes fixed per executor.

Its decisions are held to the reference's async runner, which rebuilds the
shape classes from a list of ready fronts at every dispatch: the same
dispatches, the same fronts in each, the same ``queue_depth`` points.  Both
runners take the completion order from the worker pool, so both runs here
hand back the dispatches oldest first (real worker threads, a pinned
completion order); on one lane that is the only order there is.  A
``memory_cap_bytes`` below the uncapped peak on several lanes makes both
shed members from a batch and defer dispatches.  An amalgamated plan's
fused groups share one heap and are held to the reference's runner over
them the same way.  The port runs on CPU lanes (the kernels' plain
versions), the reference on CPU JAX, in f64.
"""
import itertools
from concurrent import futures

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.api as rapi
import repro.kernels.ops as rops
import repro.obs as robs
import repro.runtime.executor as rexecutor
import repro.sparse as rsparse
import repro.sparse.optimize as ropt
import repro_torch.api as tapi
import repro_torch.kernels.ops as tops
import repro_torch.obs as tobs
import repro_torch.runtime.executor as texecutor
import repro_torch.sparse as tsparse
from repro.sparse.plan import make_plan as rmake_plan
from repro_torch.kernels.ops import factor_fn
from repro_torch.sparse.optimize import optimize_problem

_ORDER = itertools.count()


class _OrderedPool(futures.ThreadPoolExecutor):
    """Real worker threads; each future keeps its place in submission order."""

    def submit(self, fn, *args, **kwargs):
        fut = super().submit(fn, *args, **kwargs)
        fut.order = next(_ORDER)
        return fut


def _pin_completions(monkeypatch, module, obs):
    """Make ``module``'s async runner complete its dispatches oldest first.
    Returns a list that counts deferrals: waits begun with a device free
    and fronts ready, which only the memory cap causes."""
    allocs, deferred = [], []

    class Alloc(module.BuddyAllocator):
        def __init__(self, *args):
            super().__init__(*args)
            allocs.append(self)

    def oldest_first(fs, return_when=None):
        fut = min(fs, key=lambda f: f.order)
        futures.wait([fut])
        depth = obs.BUS.events("queue_depth")
        if allocs[-1].n_free > 0 and depth and depth[-1].value > 0:
            deferred.append(fut.order)
        return {fut}, set(fs) - {fut}

    monkeypatch.setattr(module, "ThreadPoolExecutor", _OrderedPool)
    monkeypatch.setattr(module, "futures_wait", oldest_first)
    monkeypatch.setattr(module, "BuddyAllocator", Alloc)
    return deferred


def _blocks(sizes=(40, 150) * 6, sep=24):
    """Dense blocks joined through one dense separator: each block but the
    last is a leaf front, of class (256, 128) or (384, 256) by its size, so
    several shape classes are ready at once and their priorities interleave."""
    n = sum(sizes) + sep
    a = np.zeros((n, n))
    s = slice(n - sep, n)
    a[s, s] = -1.0
    off = 0
    for b in sizes:
        i = slice(off, off + b)
        a[i, i] = a[i, s] = a[s, i] = -1.0
        off += b
    np.fill_diagonal(a, 0.0)
    np.fill_diagonal(a, 1.0 - a.sum(axis=1))
    return sp.csr_matrix(a)


def _matrix(tree):
    if tree == "blocks":
        return _blocks()
    n = int(tree[len("grid"):])
    return rsparse.permute_symmetric(
        rsparse.grid_laplacian_2d(n), rsparse.nested_dissection_2d(n)
    )


def _queue_depth(obs):
    return [e.value for e in obs.BUS.events("queue_depth")]


# (tree, relax, VMEM_FRONT_MAX, max_batch, lanes, memory_cap_bytes)
CASES = {
    "grid23-b32": ("grid23", 1, None, 32, 1, None),
    "grid23-b4": ("grid23", 1, None, 4, 1, None),
    # every bordered front past VMEM_FRONT_MAX, the root below it
    "grid12-large-b32": ("grid12", 2, 128, 32, 1, None),
    "grid12-large-b4": ("grid12", 2, 128, 4, 1, None),
    "blocks-b32": ("blocks", 1, None, 32, 1, None),
    "blocks-b4": ("blocks", 1, None, 4, 1, None),
    # the (384, 256) leaves past VMEM_FRONT_MAX, the (256, 128) ones below
    "blocks-large-b4": ("blocks", 1, 256, 4, 1, None),
    # three quarters and a quarter of the uncapped peaks (2.17 and 16.8 MB)
    "grid23-cap-b4": ("grid23", 1, None, 4, 4, 1_630_000),
    "grid23-cap-b32": ("grid23", 1, None, 32, 8, 4_200_000),
}


@pytest.mark.parametrize("case", list(CASES))
def test_async_decisions_match_reference(case, monkeypatch):
    tree, relax, vmem, max_batch, lanes, cap = CASES[case]
    if vmem is not None:
        for module in (texecutor, tops, rexecutor, rops):
            monkeypatch.setattr(module, "VMEM_FRONT_MAX", vmem)
    ap = _matrix(tree)
    runs = {}
    for name, module, obs in (("port", texecutor, tobs), ("ref", rexecutor, robs)):
        deferred = _pin_completions(monkeypatch, module, obs)
        obs.enable()
        obs.reset()
        if name == "port":
            symb = tsparse.analyze(ap, relax=relax)
            plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
            ex = texecutor.PlanExecutor(
                symb, plan, devices=[torch.device("cpu")] * lanes,
                dtype=torch.float64, max_batch=max_batch, memory_cap_bytes=cap,
            )
            fact, report = ex.run(ap, warmup=False)
        else:
            jax.config.update("jax_enable_x64", True)
            try:
                rsymb = rsparse.analyze(ap, relax=relax)
                rplan = rmake_plan(rsymb.task_tree(), 8, alpha=0.9)
                fact, report = rexecutor.PlanExecutor(
                    rsymb, rplan, devices=jax.devices()[:1] * lanes,
                    mode="async", max_batch=max_batch, memory_cap_bytes=cap,
                ).run(ap, warmup=False)
            finally:
                jax.config.update("jax_enable_x64", False)
        runs[name] = (fact, report, _queue_depth(obs), len(deferred))
    (fp, rp, qp, dp), (fr, rr, qr, dr) = runs["port"], runs["ref"]

    assert rp.mode == "async"
    assert rp.n_dispatches == rr.n_dispatches
    assert [(e.wave, e.front) for e in rp.trace] == [
        (e.wave, e.front) for e in rr.trace
    ]
    assert qp == qr and len(qp) == 2 * rp.n_dispatches
    assert dp == dr
    if vmem is not None:
        assert any(tops.padded_shape(sn.m, sn.nb)[0] > vmem
                   for sn in symb.supernodes)
    if cap is not None:
        # a batch of small fronts is a power of two unless the cap shed it
        widths = {e.batched for e in rp.trace}
        assert any(w & (w - 1) for w in widths), widths
        assert dp > 0
    seq = tsparse.factorize(
        ap, symb, factor_fn=factor_fn(), dtype=torch.float64, device="cpu"
    )
    for s, (pp, ps, pr) in enumerate(zip(fp.panels, seq.panels, fr.panels)):
        np.testing.assert_array_equal(pp, ps, err_msg=f"panel {s}")
        assert np.abs(pp - pr).max() <= 1e-12 * max(1.0, np.abs(pr).max())


def test_fused_async_decisions_match_reference(monkeypatch):
    """An amalgamated plan (``provenance=``) on 4 lanes under a cap of
    about a fiftieth of its uncapped peak (1.08 MB): the port's ready heap
    of fused groups and the reference's ``_run_async_prov``, which scans a
    ready list, issue the same group dispatches in the same order, defer
    the same ones, and note the same peak."""
    g, cap = 15, 20_000
    a, order = rsparse.grid_laplacian_2d(g), rsparse.nested_dissection_2d(g)
    runs = {}
    for name, module, obs in (("port", texecutor, tobs), ("ref", rexecutor, robs)):
        deferred = _pin_completions(monkeypatch, module, obs)
        obs.enable()
        obs.reset()
        if name == "port":
            prob = tapi.Problem.from_matrix(a, 0.9, ordering=order, relax=1)
            opt = optimize_problem(prob, max_front=64)
            plan = tapi.Session(tapi.DeviceMesh([torch.device("cpu")] * 4, plan_devices=8)) \
                .load(opt).plan("greedy").schedule.to_execution_plan()
            fact, report = texecutor.PlanExecutor(
                prob.symb, plan, devices=[torch.device("cpu")] * 4, dtype=torch.float64,
                memory_cap_bytes=cap, provenance=opt.provenance,
            ).run(prob.matrix, warmup=False)
        else:
            jax.config.update("jax_enable_x64", True)
            try:
                rprob = rapi.Problem.from_matrix(a, 0.9, ordering=order, relax=1)
                ropt_prob = ropt.optimize_problem(rprob, max_front=64)
                rplan = rapi.Session(rapi.DeviceMesh(plan_devices=8)).load(ropt_prob) \
                    .plan("greedy").schedule.to_execution_plan()
                fact, report = rexecutor.PlanExecutor(
                    rprob.symb, rplan, devices=jax.devices()[:1] * 4, mode="async",
                    memory_cap_bytes=cap, provenance=ropt_prob.provenance,
                ).run(rprob.matrix, warmup=False)
            finally:
                jax.config.update("jax_enable_x64", False)
        runs[name] = (fact, report, _queue_depth(obs), len(deferred))
    (fp, rp, qp, dp), (fr, rr, qr, dr) = runs["port"], runs["ref"]
    assert rp.mode == "async" and opt.n < prob.symb.n_supernodes
    assert rp.n_dispatches == rr.n_dispatches == opt.n
    assert [(e.wave, e.front) for e in rp.trace] == [(e.wave, e.front) for e in rr.trace]
    assert qp == qr and len(qp) == 2 * rp.n_dispatches
    assert dp == dr and dp > 0
    assert rp.measured_peak_bytes == rr.measured_peak_bytes
    for pp, pr in zip(fp.panels, fr.panels):
        assert np.abs(pp - pr).max() <= 1e-12 * max(1.0, np.abs(pr).max())


def test_shape_classes_are_computed_once(monkeypatch):
    """Two runs of one executor ask ``padded_shape`` at most once a
    supernode in all, and not at all after the first run: a dispatch that
    rebuilt the shape classes of the ready fronts would ask thousands of
    times."""
    calls = []

    def counted(m, nb):
        calls.append((m, nb))
        return tops.padded_shape(m, nb)

    monkeypatch.setattr(texecutor, "padded_shape", counted)
    ap = _matrix("grid23")
    symb = tsparse.analyze(ap, relax=1)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    ex = texecutor.PlanExecutor(
        symb, plan, devices=[torch.device("cpu")] * 4, dtype=torch.float64
    )
    f1, r1 = ex.run(ap)
    after_first = len(calls)
    f2, r2 = ex.run(ap)
    assert r1.n_dispatches > 0 and r2.n_dispatches > 0
    assert len(calls) <= symb.n_supernodes
    assert len(calls) == after_first
    for p1, p2 in zip(f1.panels, f2.panels):
        np.testing.assert_array_equal(p1, p2)
