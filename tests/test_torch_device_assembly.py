"""The fronts' assembly on the lane (``repro_torch.runtime.executor``) and
its extend-add (``repro_torch.kernels.frontal_cholesky.extend_add``).

Every front, small (a batch of one shape class) or past
``VMEM_FRONT_MAX`` (alone), is built on its lane in float64 as the host
builds and pads it (``sparse.multifrontal.assemble_front_np``, then
``kernels.ops.pad_front_np``): its original entries, then each child's
Schur block added in tree order, one cast to the run's dtype.  Every
Schur block stays on the lane.  So the assembled stacks are held bit for
bit to the host's assembly and padding, the panels bit for bit to the
host-assembled ``factorize`` in all four runners, the extend-add bit for
bit to the reference's ``extend_add_np``, the panels within the
reference's front tolerance to the reference's ``factorize``, the kept
blocks' counters to sums over the supernodes, and the memory cap's
decisions to the reference's async runner (which assembles every front
on the host).  The port runs on CPU lanes (the kernels' plain versions).
"""
import itertools
from concurrent import futures

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.kernels.ops as rops
import repro.obs as robs
import repro.runtime.executor as rexecutor
import repro.sparse as rsparse
import repro_torch.api as tapi
import repro_torch.kernels.frontal_cholesky as fc
import repro_torch.kernels.ops as tops
import repro_torch.obs as obs
import repro_torch.runtime.executor as texecutor
import repro_torch.sparse as tsparse
import repro_torch.sparse.multifrontal as tmultifrontal
from repro.sparse.multifrontal import extend_add_np
from repro.sparse.plan import make_plan as rmake_plan
from repro.sparse.symbolic import Supernode
from repro_torch.sparse.multifrontal import factorize, gather_front_entries, lower_csc

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_obs():
    obs.enable()
    obs.reset()
    yield
    obs.enable()
    obs.reset()


def bits(x: np.ndarray) -> np.ndarray:
    """The array's bit patterns (so that -0.0 and +0.0 differ)."""
    return np.ascontiguousarray(x).view(np.int64 if x.dtype == np.float64 else np.int32)


def mirrored(low: np.ndarray) -> np.ndarray:
    """The host's Schur block from a factored block's lower triangle
    (``kernels.ops.extract_panel_schur``)."""
    t = np.tril(low)
    return t + t.T - np.diag(np.diag(t))


# -- the extend-add ----------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", range(4))
def test_plain_extend_add_is_the_hosts(dtype, seed):
    """A child's block, read from the lower triangle of a factored padded
    front (a strided view), added into a float64 parent at a random
    subset of its rows: ``extend_add_np`` of the mirrored block, bit for
    bit, signed zeros included."""
    g = np.random.default_rng(seed)
    m, n, off = int(g.integers(40, 90)), int(g.integers(1, 40)), int(g.integers(0, 9))
    rows = np.sort(g.choice(10 * m, size=m, replace=False))
    rows_c = np.sort(g.choice(rows, size=n, replace=False))
    parent = g.standard_normal((m, m))
    parent[g.random((m, m)) < 0.1] = -0.0
    padded = g.standard_normal((off + n + 3, off + n + 3)).astype(dtype)
    child = padded[off : off + n, off : off + n]
    child[g.random((n, n)) < 0.1] = -0.0
    want = parent.copy()
    extend_add_np(want, Supernode(cols=rows[:1], rows=rows), rows_c, mirrored(child))
    got = torch.from_numpy(parent.copy())
    src = torch.from_numpy(padded)[off : off + n, off : off + n]
    pos = torch.from_numpy(np.searchsorted(rows, rows_c).astype(np.int32))
    before = fc.PLAIN_RUNS["extend_add"]
    fc.extend_add(got, src, pos)
    assert fc.PLAIN_RUNS["extend_add"] == before + 1
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    # an uploaded host block (the mirrored one) gives the same bits
    again = torch.from_numpy(parent.copy())
    fc.extend_add(again, torch.from_numpy(mirrored(child)), pos)
    np.testing.assert_array_equal(bits(again.numpy()), bits(want))


def test_extend_add_rejects_what_it_does_not_take():
    dst = torch.zeros(8, 8, dtype=torch.float64)
    src = torch.ones(4, 4, dtype=torch.float64)
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        fc.extend_add(dst.float(), src, pos)  # the parent is float64
    with pytest.raises(ValueError):
        fc.extend_add(dst, src, pos.long())  # positions are int32
    with pytest.raises(ValueError):
        fc.extend_add(dst, src[:2], pos)  # fewer rows than positions
    with pytest.raises(ValueError):
        fc.extend_add(dst, torch.ones(8, 8, dtype=torch.float64)[::2, ::2], pos)  # rows not unit-stride
    fc.extend_add(dst, src[:0, :0], pos[:0])  # nothing to add
    assert not dst.any()


# -- panels against the host's assembly --------------------------------------
def grid15():
    a = tsparse.grid_laplacian_2d(15)
    return tsparse.permute_symmetric(a, tsparse.nested_dissection_2d(15))


def dense_chain():
    """One dense SPD block of order 1,100: a chain of fronts capped at 256
    pivots, the first padded past 1,024."""
    g = np.random.default_rng(2**33 + 1100)
    b = g.standard_normal((1100, 1100))
    return sp.csr_matrix(b @ b.T / 1100 + np.eye(1100))


# (matrix, relax, VMEM_FRONT_MAX): grid 15 with every bordered front large,
# and the dense chain at the module's threshold (a large leaf, small parents)
# and at 128 (every link large: each keeps its block for the next)
MATRICES = {
    "grid15-128": (grid15, 1, 128),
    "chain-1024": (dense_chain, 2, None),
    "chain-128": (dense_chain, 2, 128),
}


def _large(symb, s: int) -> bool:
    return s >= 0 and tops.padded_shape(symb.supernodes[s].m, symb.supernodes[s].nb)[0] \
        > texecutor.VMEM_FRONT_MAX


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(MATRICES))
def test_panels_are_the_host_assembled_factorization(case, dtype, monkeypatch):
    make, relax, vmem = MATRICES[case]
    if vmem is not None:
        monkeypatch.setattr(texecutor, "VMEM_FRONT_MAX", vmem)
    a = make()
    symb = tsparse.analyze(a, relax=relax)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    want = factorize(a, symb, factor_fn=tops.factor_fn(), dtype=dtype, device="cpu")
    large = [s for s in range(symb.n_supernodes) if _large(symb, s)]
    kept = [s for s in large if _large(symb, symb.supernodes[s].parent)]
    assert large and (bool(kept) == (vmem is not None))
    item = torch.finfo(dtype).bits // 8
    for mode, lanes in itertools.product(("async", "waves"), (2, 4)):
        obs.reset()
        ex = texecutor.PlanExecutor(symb, plan, devices=[CPU] * lanes, dtype=dtype, mode=mode)
        fact, _ = ex.run(a, warmup=False)
        for s, (p, q) in enumerate(zip(fact.panels, want.panels)):
            assert p.dtype == q.dtype
            np.testing.assert_array_equal(bits(p), bits(q), err_msg=f"{mode} {lanes} panel {s}")
        reg = obs.REGISTRY
        assert reg.get("repro_executor_large_fronts_total").value == len(large)
        assert reg.get("repro_executor_kept_blocks_total").value == len(kept)
        assert reg.get("repro_executor_kept_bytes_total").value == sum(
            (symb.supernodes[s].m - symb.supernodes[s].nb) ** 2 * item for s in kept)


LARGE_COUNTERS = (
    "repro_executor_large_fronts_total",
    "repro_executor_kept_blocks_total",
    "repro_executor_kept_bytes_total",
)


@pytest.mark.parametrize("case", ["chain-128", "grid15-128"])
def test_fused_plans_take_the_large_route(case, monkeypatch):
    """An amalgamated plan's group dispatches (``provenance=``) take the
    plain plan's per-front path: with every bordered front past
    ``VMEM_FRONT_MAX``, both fused runners give the host-assembled
    ``factorize``'s panels bit for bit, and assemble, factor and keep on
    the lane the fronts and blocks the plain run does, whether a kept
    block's parent is in its group or not."""
    make, relax, vmem = MATRICES[case]
    monkeypatch.setattr(texecutor, "VMEM_FRONT_MAX", vmem)
    a = make()
    symb = tsparse.analyze(a, relax=relax)
    want = factorize(a, symb, factor_fn=tops.factor_fn(), dtype=torch.float64, device="cpu")
    sess = tapi.Session(tapi.DeviceMesh([CPU] * 2, plan_devices=8)).load(
        tapi.Problem.from_symbolic(symb, 0.9, matrix=a))
    sess.optimize(max_front=64).plan("greedy")
    fused = (sess.schedule.to_execution_plan(), sess.problem.provenance)
    plain = (tsparse.make_plan(symb.task_tree(), 8, alpha=0.9), None)
    counts = {}
    for name, mode, (plan, prov) in (
        ("plain", "async", plain), ("async", "async", fused), ("waves", "waves", fused)
    ):
        obs.reset()
        fact, _ = texecutor.PlanExecutor(
            symb, plan, devices=[CPU] * 2, dtype=torch.float64, mode=mode, provenance=prov,
        ).run(a, warmup=False)
        for s, (p, q) in enumerate(zip(fact.panels, want.panels)):
            np.testing.assert_array_equal(bits(p), bits(q), err_msg=f"{name} panel {s}")
        counts[name] = [obs.REGISTRY.get(c).value for c in LARGE_COUNTERS]
    assert counts["plain"][0] > 0 and counts["plain"][1] > 0
    assert counts["async"] == counts["waves"] == counts["plain"]


# the reference's front tolerance (tests/test_kernels.py), relative to the
# largest entry: f32 5e-5; f64 1e-12 (tests/test_torch_sparse.py)
REF_TOL = {torch.float32: 5e-5, torch.float64: 1e-12}
NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(MATRICES))
def test_panels_match_the_reference(case, dtype, monkeypatch):
    """The port's panels, every large front assembled on a lane, against
    the reference's ``factorize`` (host assembly, its own partial
    Cholesky) on the same matrix and the same supernodes."""
    make, relax, vmem = MATRICES[case]
    if vmem is not None:
        monkeypatch.setattr(texecutor, "VMEM_FRONT_MAX", vmem)
    a = make()
    symb = tsparse.analyze(a, relax=relax)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    fact, _ = texecutor.PlanExecutor(symb, plan, devices=[CPU] * 2, dtype=dtype).run(
        a, warmup=False)
    assert obs.REGISTRY.get("repro_executor_large_fronts_total").value > 0
    x64 = dtype == torch.float64
    jax.config.update("jax_enable_x64", x64)
    try:
        rsymb = rsparse.analyze(a, relax=relax)
        ref = rsparse.factorize(a, rsymb)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert [(list(x.cols), list(x.rows)) for x in rsymb.supernodes] == [
        (list(x.cols), list(x.rows)) for x in symb.supernodes]
    for s, (p, r) in enumerate(zip(fact.panels, ref.panels)):
        assert p.dtype == r.dtype == NP_DTYPE[dtype]
        err = np.abs(p.astype(np.float64) - r).max() / max(1.0, np.abs(r).max())
        assert err <= REF_TOL[dtype], f"panel {s}: {err:.3e}"


def test_no_large_front_keeps_nothing():
    a = grid15()
    symb = tsparse.analyze(a, relax=1)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    ex = texecutor.PlanExecutor(symb, plan, devices=[CPU] * 2, dtype=torch.float64)
    ex.run(a, warmup=False)
    assert obs.REGISTRY.get("repro_executor_large_fronts_total").value == 0
    assert obs.REGISTRY.get("repro_executor_kept_blocks_total").value == 0
    assert obs.REGISTRY.get("repro_executor_kept_bytes_total").value == 0


def test_entry_maps_follow_the_pattern(monkeypatch):
    """A second matrix with another pattern on the same symbolic structure
    (one entry of the first dropped) rebuilds the maps: its panels are its
    own host-assembled factorization's."""
    monkeypatch.setattr(texecutor, "VMEM_FRONT_MAX", 128)
    a = grid15()
    symb = tsparse.analyze(a, relax=1)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    ex = texecutor.PlanExecutor(symb, plan, devices=[CPU] * 2, dtype=torch.float64)
    ex.run(a, warmup=False)
    b = a.tolil()
    i, j = sp.tril(a, -1).nonzero()
    b[i[7], j[7]] = b[j[7], i[7]] = 0.0
    b = b.tocsr()
    b.eliminate_zeros()
    b = b + sp.diags(np.full(a.shape[0], 0.5))
    assert b.nnz == a.nnz - 2
    fact, _ = ex.run(b, warmup=False)
    want = factorize(b, symb, factor_fn=tops.factor_fn(), dtype=torch.float64, device="cpu")
    for p, q in zip(fact.panels, want.panels):
        np.testing.assert_array_equal(bits(p), bits(q))


def random300():
    a = tsparse.random_spd(300, 6.0, np.random.default_rng(2**32 + 7))
    return tsparse.permute_symmetric(a, tsparse.min_degree(a))


@pytest.mark.parametrize("vmem", [128, None])
def test_entry_maps_are_the_hosts_gather(vmem, monkeypatch):
    """Every front's original entries placed through its maps, small or
    large, in its padded (mp, mp) block, are ``gather_front_entries``'
    block bit for bit at the front's rows and columns and zero on the
    padding, on a random SPD pattern (fronts of many sizes, rows that skip
    columns); the front table counts each front's entries."""
    if vmem is not None:
        monkeypatch.setattr(texecutor, "VMEM_FRONT_MAX", vmem)
    a = random300()
    symb = tsparse.analyze(a, relax=2)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    ex = texecutor.PlanExecutor(symb, plan, devices=[CPU], dtype=torch.float64)
    acsc = lower_csc(a)
    ex._entry_maps(acsc)
    assert any(_large(symb, s) for s in range(symb.n_supernodes)) == (vmem is not None)
    for s, sn in enumerate(symb.supernodes):
        m, nb, first, count = ex._desc[:, s]
        assert (m, nb) == (sn.m, sn.nb)
        idx, lower, mirror = (x[first : first + count] for x in ex._ent)
        mp, nbp = ex._shape[s]
        f = np.zeros(mp * mp)
        f[lower] = f[mirror] = acsc.data[idx]
        f = f.reshape(mp, mp)
        at = np.r_[0 : sn.nb, nbp : nbp + sn.m - sn.nb]  # the front's rows and columns
        assert not np.delete(np.delete(f, at, 0), at, 1).any()
        np.testing.assert_array_equal(bits(f[np.ix_(at, at)]),
                                      bits(gather_front_entries(acsc, sn)))


def arrow():
    """Four dense blocks of order 30, each coupled to the first three rows
    of a dense block of order 900: small leaves under the first link of a
    chain capped at 256 pivots (padded orders 1,024, 768, 512, 256).  At a
    ``VMEM_FRONT_MAX`` of 600 every pair of routes meets: small into large
    (the leaves), large into large, large into small, small into small."""
    g = np.random.default_rng(2**33 + 1020)
    k, w, nd = 4, 30, 900
    a = np.zeros((k * w + nd, k * w + nd))
    for i in range(k):
        x = g.standard_normal((w, w))
        a[i * w : (i + 1) * w, i * w : (i + 1) * w] = x @ x.T / w
        c = g.standard_normal((w, 3)) / w
        a[i * w : (i + 1) * w, k * w : k * w + 3] = c
        a[k * w : k * w + 3, i * w : (i + 1) * w] = c.T
    x = g.standard_normal((nd, nd))
    a[k * w :, k * w :] = x @ x.T / nd
    return sp.csr_matrix(a + 2 * np.eye(len(a)))


# MATRICES, and two with every pair of routes or many small children
ROUTES = {**MATRICES, "arrow-600": (arrow, 2, 600), "random300": (random300, 2, None)}


def _spy_lanes(monkeypatch):
    """Record every front a run assembles on a lane (float64, before the
    cast; by front) and every kept block's factored padded front (by
    child), as the executor's helpers produce them."""
    stacks, outs = {}, {}
    assemble, run_job = texecutor.PlanExecutor._assemble_stack, texecutor.PlanExecutor._run_job

    def assemble_spy(self, job, d, dev, clock):
        f = assemble(self, job, d, dev, clock)
        for j, s in enumerate(job.members):
            stacks[s] = f[j].clone()
        return f

    def run_job_spy(self, job, devs, clock=None):
        panels, kept = run_job(self, job, devs, clock)
        for s, blk in zip(job.members, kept):
            if blk is not None:
                outs[s] = blk.out.numpy().copy()
        return panels, kept

    monkeypatch.setattr(texecutor.PlanExecutor, "_assemble_stack", assemble_spy)
    monkeypatch.setattr(texecutor.PlanExecutor, "_run_job", run_job_spy)
    return stacks, outs


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(ROUTES))
def test_lane_assembly_is_the_hosts_assembly_and_padding(case, dtype, monkeypatch):
    """Every front assembled on a lane, cast to the run's dtype, is the
    host's assembly followed by its padding bit for bit: its original
    entries (``gather_front_entries``), each child's Schur block as the
    host cut it from the child's factored front (``extract_panel_schur``)
    added in tree order by ``sparse.multifrontal.extend_add_np``, the
    cast, ``kernels.ops.pad_front_np``."""
    make, relax, vmem = ROUTES[case]
    if vmem is not None:
        monkeypatch.setattr(texecutor, "VMEM_FRONT_MAX", vmem)
    a = make()
    symb = tsparse.analyze(a, relax=relax)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    stacks, outs = _spy_lanes(monkeypatch)
    texecutor.PlanExecutor(symb, plan, devices=[CPU] * 2, dtype=dtype).run(a, warmup=False)
    acsc, npdt, sns = lower_csc(a), NP_DTYPE[dtype], symb.supernodes
    assert sorted(stacks) == list(range(symb.n_supernodes))
    assert any(not _large(symb, s) for s in range(len(sns)))
    for s, sn in enumerate(sns):
        f = gather_front_entries(acsc, sn)
        for c in (c for c, k in enumerate(sns) if k.parent == s):
            k = sns[c]
            _, schur = tops.extract_panel_schur(outs[c], k.m, k.nb)
            tmultifrontal.extend_add_np(f, sn, k.rows[k.nb :], schur)
        want = tops.pad_front_np(f.astype(npdt), sn.nb, npdt)
        got = stacks[s].to(dtype).numpy()
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=f"{case} front {s}")


def _raise(*args, **kwargs):
    raise AssertionError("the host's assembly, padding or cut ran")


RUNNERS = ("async", "waves", "fused-async", "fused-waves")


@pytest.fixture(scope="module")
def arrow_factor():
    """The arrow, its analysis, and its host-assembled ``factorize`` by
    dtype (computed on first use)."""
    make, relax, _ = ROUTES["arrow-600"]
    a = make()
    symb = tsparse.analyze(a, relax=relax)
    want = {}

    def get(dtype):
        if dtype not in want:
            want[dtype] = factorize(a, symb, factor_fn=tops.factor_fn(), dtype=dtype,
                                    device="cpu")
        return a, symb, want[dtype]

    return get


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("runner", RUNNERS)
def test_every_runner_assembles_on_the_lane(runner, dtype, arrow_factor, monkeypatch):
    """The arrow at a ``VMEM_FRONT_MAX`` of 600 (every pair of routes) in
    each of the four runners: the panels are the host-assembled
    ``factorize``'s bit for bit, with the host's ``extend_add_np``,
    ``pad_front_np`` and ``extract_panel_schur`` made to raise; the small
    route's counters are sums over the small fronts."""
    monkeypatch.setattr(texecutor, "VMEM_FRONT_MAX", ROUTES["arrow-600"][2])
    a, symb, want = arrow_factor(dtype)
    mode = runner.split("-")[-1]
    if runner.startswith("fused"):
        sess = tapi.Session(tapi.DeviceMesh([CPU] * 2, plan_devices=8)).load(
            tapi.Problem.from_symbolic(symb, 0.9, matrix=a))
        sess.optimize(max_front=64).plan("greedy")
        assert sess.problem.n < symb.n_supernodes
        plan, prov = sess.schedule.to_execution_plan(), sess.problem.provenance
    else:
        plan, prov = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9), None
    for module, name in ((tmultifrontal, "extend_add_np"), (tops, "pad_front_np"),
                         (tops, "extract_panel_schur")):
        monkeypatch.setattr(module, name, _raise)
    fact, _ = texecutor.PlanExecutor(symb, plan, devices=[CPU] * 2, dtype=dtype, mode=mode,
                                     provenance=prov).run(a, warmup=True)
    for s, (p, q) in enumerate(zip(fact.panels, want.panels)):
        assert p.dtype == q.dtype and p.shape == q.shape
        np.testing.assert_array_equal(bits(p), bits(q), err_msg=f"{runner} panel {s}")
    sns = symb.supernodes
    small = [s for s in range(len(sns)) if not _large(symb, s)]
    assert obs.REGISTRY.get("repro_executor_small_fronts_total").value == len(small)
    item = torch.finfo(dtype).bits // 8
    assert obs.REGISTRY.get("repro_executor_small_kept_bytes_total").value == sum(
        (sns[s].m - sns[s].nb) ** 2 * item for s in small) > 0


# -- the memory cap's decisions ----------------------------------------------
_ORDER = itertools.count()


class _OrderedPool(futures.ThreadPoolExecutor):
    """Real worker threads; each future keeps its place in submission order."""

    def submit(self, fn, *args, **kwargs):
        fut = super().submit(fn, *args, **kwargs)
        fut.order = next(_ORDER)
        return fut


def _pin_completions(monkeypatch, module, bus_obs):
    """Make ``module``'s async runner complete its dispatches oldest first;
    returns a list that counts deferrals (waits begun with a device free
    and fronts ready, which only the memory cap causes)."""
    allocs, deferred = [], []

    class Alloc(module.BuddyAllocator):
        def __init__(self, *args):
            super().__init__(*args)
            allocs.append(self)

    def oldest_first(fs, return_when=None):
        fut = min(fs, key=lambda f: f.order)
        futures.wait([fut])
        depth = bus_obs.BUS.events("queue_depth")
        if allocs[-1].n_free > 0 and depth and depth[-1].value > 0:
            deferred.append(fut.order)
        return {fut}, set(fs) - {fut}

    monkeypatch.setattr(module, "ThreadPoolExecutor", _OrderedPool)
    monkeypatch.setattr(module, "futures_wait", oldest_first)
    monkeypatch.setattr(module, "BuddyAllocator", Alloc)
    return deferred


def test_memory_cap_defers_as_the_reference(monkeypatch):
    """Grid 15 with every bordered front large, on 4 lanes under a cap
    below its uncapped peak: the port, whose large fronts keep their
    blocks on the lane, defers and sheds exactly as the reference's async
    runner, which holds every block on the host."""
    for module in (texecutor, tops, rexecutor, rops):
        monkeypatch.setattr(module, "VMEM_FRONT_MAX", 128)
    a = grid15()
    cap = 20_000  # an eighth of the uncapped peak (153,464 B): 46 deferrals
    runs = {}
    for name, module, bus_obs in (("port", texecutor, obs), ("ref", rexecutor, robs)):
        deferred = _pin_completions(monkeypatch, module, bus_obs)
        bus_obs.enable()
        bus_obs.reset()
        if name == "port":
            symb = tsparse.analyze(a, relax=1)
            plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
            fact, report = texecutor.PlanExecutor(
                symb, plan, devices=[CPU] * 4, dtype=torch.float64, memory_cap_bytes=cap,
            ).run(a, warmup=False)
            kept = obs.REGISTRY.get("repro_executor_kept_blocks_total").value
        else:
            jax.config.update("jax_enable_x64", True)
            try:
                rsymb = rsparse.analyze(a, relax=1)
                rplan = rmake_plan(rsymb.task_tree(), 8, alpha=0.9)
                fact, report = rexecutor.PlanExecutor(
                    rsymb, rplan, devices=jax.devices()[:1] * 4, mode="async",
                    memory_cap_bytes=cap,
                ).run(a, warmup=False)
            finally:
                jax.config.update("jax_enable_x64", False)
        depth = [e.value for e in bus_obs.BUS.events("queue_depth")]
        runs[name] = (fact, report, depth, len(deferred))
    (fp, rp, qp, dp), (fr, rr, qr, dr) = runs["port"], runs["ref"]
    assert kept > 0
    assert dp == dr and dp > 0
    assert rp.n_dispatches == rr.n_dispatches
    assert [(e.wave, e.front) for e in rp.trace] == [(e.wave, e.front) for e in rr.trace]
    assert qp == qr
    assert rp.measured_peak_bytes == rr.measured_peak_bytes
    for p, r in zip(fp.panels, fr.panels):
        assert np.abs(p - r).max() <= 1e-12 * max(1.0, np.abs(r).max())


def test_lane_uploads_are_made_once_under_contention():
    """Sixteen threads ask at once for the pattern's maps and the run's
    values on one lane, with the interpreter switching threads every
    microsecond: one upload each, the values counted once, every caller
    handed the same tensors."""
    import sys
    import threading

    a = grid15()
    symb = tsparse.analyze(a, relax=1)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    ex = texecutor.PlanExecutor(symb, plan, devices=[CPU], dtype=torch.float64)
    acsc = lower_csc(a)
    ex._entry_maps(acsc)
    tally = texecutor._RunTally(8)
    clock = texecutor._StageClock(tally, "scan")
    st = texecutor._Run(ex, acsc, clock)
    got, start = [], threading.Barrier(16)

    def ask():
        start.wait(timeout=30)
        got.append((ex._lane(CPU), st.values_on(CPU, clock)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(got) == 16
    assert all(lane is got[0][0] and values is got[0][1] for lane, values in got)
    clock.close()
    assert tally.copied == tally.useful == acsc.data.nbytes
    np.testing.assert_array_equal(got[0][1].numpy(), acsc.data[ex._ent[0]])
