"""The port's CUDA kernels and executor on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The module imports neither JAX nor ``repro``, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_card.py

Each kernel is held against its plain PyTorch version on the same inputs:
5e-5 relative for f32 fronts, 1e-4 for the panel + SYRK route, 1e-11 for
f64 (the JAX package's tolerances); ``syrk_downdate`` is compared on both
triangles by default and, with uplo='L' (BLAS syrk), on its lower triangle
with its strictly-upper part equal to C; 2e-5 max-abs for f32 attention
(and f64, computed in f32 as the reference does) and, for bf16 and f16
attention, element by element |got - ref| <= eps * |ref| + 2e-5 (the same
f32 math within the f32 tolerance, then one rounding each: at most 2 ulps
of the element).  The frontal kernels are also held
to determinism and batch invariance bit for bit.  The serving cluster's
workers, sharing the card, give the executor's factors bit for bit, and so
does a batch split over several lanes (``shard_dispatch``: one launch a
lane, on one card or on each of several).  The
models' prefill on the card (flash attention) equals the CPU's (blocked
attention) within 1e-4 relative to max(1, max |CPU|).  A train step's loss
on the card equals the CPU's within 1e-5 relative and each gradient leaf
within 1e-4 of that leaf's max |g|; an async checkpoint taken before an
in-place step holds the state at the save bit for bit.  On the 1×1 mesh
(``make_smoke_mesh``) a train step and a prefill equal their runs without
a mesh bit for bit, the prefill launching the flash kernel once a layer.
"""
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro_torch.kernels.frontal_cholesky as fc
import repro_torch.kernels.ops as ops
import repro_torch.sparse as tsparse
from repro_torch.api import DeviceMesh, Problem, Session
from repro_torch.cluster import LocalCluster, leaked_threads
from repro_torch.configs import ARCHS
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import partial_cholesky_ref
from repro_torch.online import LognormalNoise, execute_online
from repro_torch.runtime import PlanExecutor

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spd(m, rng):
    b = rng.normal(size=(m, m))
    return b @ b.T + m * np.eye(m)


def _rel(got, want) -> float:
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def _spd_batch(b, m, rng, device, dtype):
    x = torch.from_numpy(rng.normal(size=(b, m, m))).to(device)
    return (x @ x.mT + m * torch.eye(m, device=device, dtype=x.dtype)).to(dtype)


FRONT_SHAPES = [(mp, nbp) for mp in (128, 256, 384, 1024) for nbp in sorted({128, mp})]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.float64, 1e-11)])
@pytest.mark.parametrize("mp,nbp", FRONT_SHAPES)
def test_front_factor_on_card(cuda, dtype, tol, mp, nbp, rng):
    x = _spd_batch(33, mp, rng, cuda, dtype)
    before = fc.LAUNCHES["front_factor"]
    got = fc.front_factor(x, nbp)
    assert fc.LAUNCHES["front_factor"] == before + 1
    pick = [0, 16, 32]
    want = fc.front_factor_plain(x[pick], nbp)
    assert _rel(torch.tril(got[pick]), torch.tril(want)) < tol
    # deterministic, and batch-invariant: a front's bits do not depend on
    # the batch it rides in (alone vs in a batch of 33)
    torch.testing.assert_close(fc.front_factor(x, nbp), got, rtol=0, atol=0)
    torch.testing.assert_close(fc.front_factor(x[16:17], nbp)[0], got[16], rtol=0, atol=0)


PANEL_SHAPES = [(mp, nb) for nb in (128, 256, 512) for mp in (nb, 640, 1152) if mp >= nb]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("mp,nb", PANEL_SHAPES)
def test_panel_factor_on_card(cuda, dtype, tol, mp, nb, rng):
    slab = _spd_batch(1, mp, rng, cuda, dtype)[0, :, :nb].contiguous()
    before = fc.LAUNCHES["panel_factor"]
    got = fc.panel_factor(slab)
    assert fc.LAUNCHES["panel_factor"] == before + 1
    assert _rel(torch.tril(got), torch.tril(fc.panel_factor_plain(slab))) < tol
    torch.testing.assert_close(fc.panel_factor(slab), got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.float64, 1e-11)])
@pytest.mark.parametrize("m,nb", [(200, 100), (300, 300), (1000, 150)])
def test_padding_inert_on_card(cuda, dtype, tol, m, nb, rng):
    """Unit-diagonal padding factors to no-ops on the card: padded pivots
    stay e_j columns, padded rows and columns stay zero, and the unpadded
    result is the oracle's."""
    front = _spd(m, rng)
    f = torch.from_numpy(ops.pad_front_np(front, nb)).to(cuda, dtype)
    mp, nbp = ops.padded_shape(m, nb)
    out = torch.tril(fc.front_factor(f[None], nbp)[0])
    real = torch.zeros(mp, dtype=torch.bool, device=cuda)
    real[:nb] = True
    real[nbp:nbp + m - nb] = True
    pad = ~real
    assert torch.equal(out[pad][:, pad], torch.eye(int(pad.sum()), device=cuda, dtype=dtype))
    assert not out[pad][:, real].any() and not out[real][:, pad].any()
    panel, schur = ops.extract_panel_schur(out.cpu().numpy(), m, nb)
    want_p, want_s = partial_cholesky_ref(torch.from_numpy(front), nb)
    assert _rel(torch.from_numpy(panel).double(), want_p) < tol
    if m > nb:
        assert _rel(torch.from_numpy(schur).double(), want_s) < tol


def _check_syrk_lower(c, a, tile, tol):
    """BLAS syrk, uplo='L': the lower triangle against the plain version's
    full product, the strictly-upper part exactly C, two calls bit for bit."""
    before = fc.LAUNCHES["syrk_downdate"]
    got = fc.syrk_downdate(c, a, tile=tile, uplo="L")
    assert fc.LAUNCHES["syrk_downdate"] == before + 1
    assert _rel(torch.tril(got), torch.tril(fc.syrk_downdate_plain(c, a))) < tol
    assert torch.equal(torch.triu(got, 1), torch.triu(c, 1))
    torch.testing.assert_close(fc.syrk_downdate(c, a, tile=tile, uplo="L"), got, rtol=0, atol=0)
    return got


def _check_syrk_full(c, a, tile, tol):
    """The default, the reference's full C − A·Aᵀ: both triangles against
    the plain version, two calls bit for bit."""
    before = fc.LAUNCHES["syrk_downdate"]
    got = fc.syrk_downdate(c, a, tile=tile)
    assert fc.LAUNCHES["syrk_downdate"] == before + 1
    want = fc.syrk_downdate_plain(c, a)
    assert _rel(torch.tril(got), torch.tril(want)) < tol
    assert _rel(torch.triu(got, 1), torch.triu(want, 1)) < tol
    torch.testing.assert_close(fc.syrk_downdate(c, a, tile=tile), got, rtol=0, atol=0)
    return got


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("m,k,tile", [(384, 128, 128), (1024, 128, 256), (896, 256, 128),
                                      (640, 512, 128), (256, 96, 128)])
def test_syrk_downdate_on_card(cuda, dtype, tol, m, k, tile, rng):
    """A small front's shape, chip_smoke's phase-2 shapes, the widest panel
    (K=512) and a K that leaves a partial 64-wide chunk: uplo='L' and the
    full result, whose lower triangles are the same bits."""
    c = torch.from_numpy(rng.normal(size=(m, m))).to(cuda, dtype)
    a = torch.from_numpy(rng.normal(size=(m, k))).to(cuda, dtype)
    lower = _check_syrk_lower(c, a, tile, tol)
    full = _check_syrk_full(c, a, tile, tol)
    assert torch.equal(torch.tril(full), torch.tril(lower))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-11)])
@pytest.mark.parametrize("m,k", [(128, 1), (256, 40), (384, 128), (128, 0)])
def test_syrk_downdate_full_any_k_on_card(cuda, dtype, tol, m, k, rng):
    """Any K (padded with zero columns to a multiple of 32 in the wrapper,
    K=0 included): the full result on both triangles, and uplo='L'."""
    c = torch.from_numpy(rng.normal(size=(m, m))).to(cuda, dtype)
    a = torch.from_numpy(rng.normal(size=(m, k))).to(cuda, dtype)
    full = _check_syrk_full(c, a, 128, tol)
    lower = _check_syrk_lower(c, a, 128, tol)
    assert torch.equal(torch.tril(full), torch.tril(lower))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_extend_add_on_card(cuda, dtype, rng):
    """A chain link's extend-add: a 3,794² Schur block, read from the lower
    triangle of the child's factored 4,096² front at offset 256, into a
    4,096² float64 parent at strictly increasing positions: the kernel's
    result is its plain version's bit for bit (signed zeros included), the
    same bits twice, and one launch each."""
    n, mp, off = 3794, 4096, 256
    child = torch.from_numpy(rng.standard_normal((mp, mp))).to(dtype)
    child[torch.from_numpy(rng.random((mp, mp)) < 0.01)] = -0.0
    parent = torch.from_numpy(rng.standard_normal((mp, mp)))
    parent[torch.from_numpy(rng.random((mp, mp)) < 0.01)] = -0.0
    pos = torch.from_numpy(np.sort(rng.choice(mp, size=n, replace=False)).astype(np.int32))
    want = parent.clone()
    fc.extend_add(want, child[off : off + n, off : off + n], pos)
    outs = []
    for _ in range(2):
        got = parent.to(cuda)
        before = fc.LAUNCHES["extend_add"]
        fc.extend_add(got, child.to(cuda)[off : off + n, off : off + n], pos.to(cuda))
        assert fc.LAUNCHES["extend_add"] == before + 1
        outs.append(got.cpu())
    for got in outs:
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    with pytest.raises(TypeError):
        fc.front_factor(torch.eye(128, device=cuda, dtype=torch.float16)[None], 128)
    with pytest.raises(ValueError):
        fc.panel_factor(torch.eye(256, device=cuda)[:, :128].T.contiguous().T)


def test_executor_on_card(cuda):
    a = tsparse.grid_laplacian_2d(23)
    ap = tsparse.permute_symmetric(a, tsparse.nested_dissection_2d(23))
    symb = tsparse.analyze(ap, relax=1)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    cpu, _ = PlanExecutor(
        symb, plan, devices=[torch.device("cpu")] * 2, dtype=torch.float64
    ).run(ap, warmup=False)
    fc.reset_counters()
    runs = [
        PlanExecutor(symb, plan, dtype=torch.float64, mode=m).run(ap)
        for m in ("async", "waves")
    ]
    assert not runs[0][1].interpret
    assert fc.LAUNCHES["front_factor"] > 0
    assert fc.PLAIN_RUNS == {k: 0 for k in fc.KERNELS}
    for pa, pw, pc in zip(runs[0][0].panels, runs[1][0].panels, cpu.panels):
        np.testing.assert_array_equal(pa, pw)
        assert np.abs(pa - pc).max() / max(1.0, np.abs(pc).max()) < 1e-11


def _grid_and_chain():
    """Grid 23 (nested dissection) beside a dense SPD block of order 1,100
    (a chain of fronts capped at 256 pivots, its leaf padded past 1,024):
    many small fronts, a large one under small parents."""
    g = tsparse.grid_laplacian_2d(23)
    g = tsparse.permute_symmetric(g, tsparse.nested_dissection_2d(23))
    x = np.random.default_rng(2**33 + 1100).standard_normal((1100, 1100))
    return sp.block_diag([g, x @ x.T / 1100 + np.eye(1100)], format="csr")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_executor_assembles_every_front_on_card(cuda, dtype):
    """Every front assembled on cuda:0: the panels are bit for bit those
    of the host-assembled ``factorize`` with the card's kernels (the
    parent's numerics: the card's kernels are not bit for bit their plain
    versions), and those of CPU lanes within the f64 / f32 front
    tolerances; one ``extend_add`` launch a child, no plain version; the
    run's values in and the panels out are all that crosses."""
    import repro_torch.obs as obs

    a = _grid_and_chain()
    symb = tsparse.analyze(a, relax=2)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    sns = symb.supernodes
    assert any(ops.padded_shape(sn.m, sn.nb)[0] > fc.VMEM_FRONT_MAX for sn in sns)
    want = tsparse.factorize(a, symb, factor_fn=ops.factor_fn(), dtype=dtype, device=cuda)
    cpu, _ = PlanExecutor(symb, plan, devices=[torch.device("cpu")] * 2, dtype=dtype).run(
        a, warmup=False)
    ex = PlanExecutor(symb, plan, devices=[cuda], dtype=dtype)
    ex.warmup()
    obs.enable()
    obs.reset()
    fc.reset_counters()
    fact, rep = ex.run(a, warmup=False)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["extend_add"] == sum(sn.parent >= 0 for sn in sns) > 0
    assert fc.PLAIN_RUNS == {k: 0 for k in fc.KERNELS}
    item = torch.finfo(dtype).bits // 8
    copied = sp.tril(a).nnz * 8 + sum(sn.m * sn.nb for sn in sns) * item
    assert rep.host.copied_bytes == rep.host.useful_bytes == copied
    tol = 1e-11 if dtype == torch.float64 else 5e-5
    for p, q, c in zip(fact.panels, want.panels, cpu.panels):
        assert p.dtype == q.dtype and p.shape == q.shape
        np.testing.assert_array_equal(p.view(np.uint8), q.view(np.uint8))
        assert np.abs(p - c).max() / max(1.0, np.abs(c).max()) < tol


def _lanes_launched(symb, report) -> int:
    """Σ over the run's small-front dispatches of the lanes each engaged."""
    lanes = {}
    for e in report.trace:
        sn = symb.supernodes[e.front]
        if ops.padded_shape(sn.m, sn.nb)[0] <= fc.VMEM_FRONT_MAX:
            lanes[e.wave, e.t_start] = e.dispatch_devices
    return sum(lanes.values())


@pytest.mark.parametrize("b", [1, 5, 8])
def test_sharded_run_batch_on_card(cuda, b, rng):
    """A batch split over [cuda:0] * 4 is the one-lane batch bit for bit:
    one launch a lane, identity shards included, no plain run."""
    a = tsparse.grid_laplacian_2d(9)
    symb = tsparse.analyze(a, relax=1)
    plan = tsparse.make_plan(symb.task_tree(), 4, alpha=0.9)
    lanes = [torch.device("cuda", 0)] * 4
    ex = PlanExecutor(symb, plan, devices=lanes, dtype=torch.float64)
    assert ex.shard_dispatch and not ex.interpret
    x = rng.normal(size=(b, 256, 256))
    batch = x @ x.transpose(0, 2, 1) + 256 * np.eye(256)
    one = ex._run_batch(batch, 128, lanes[:1])
    fc.reset_counters()
    got = ex._run_batch(batch, 128, lanes)
    assert fc.LAUNCHES["front_factor"] == 4
    assert fc.PLAIN_RUNS == {k: 0 for k in fc.KERNELS}
    assert got.shape == (b, 256, 256) and got.device == lanes[0]
    np.testing.assert_array_equal(got.cpu().numpy(), one.cpu().numpy())


def _sharded_grid23(devices):
    """Grid 23 (f64) planned for 4 devices, run async and waves on
    ``devices`` with sharding on, held bit for bit against one lane of the
    first card; each run's launches = Σ dispatch_devices, no plain run."""
    a = tsparse.grid_laplacian_2d(23)
    ap = tsparse.permute_symmetric(a, tsparse.nested_dissection_2d(23))
    symb = tsparse.analyze(ap, relax=1)
    plan = tsparse.make_plan(symb.task_tree(), 4, alpha=0.9)
    one, _ = PlanExecutor(symb, plan, devices=devices[:1], dtype=torch.float64).run(ap)
    by_card = {}
    for mode in ("async", "waves"):
        ex = PlanExecutor(symb, plan, devices=devices, dtype=torch.float64, mode=mode)
        ex.warmup()
        fc.reset_counters()
        fact, rep = ex.run(ap, warmup=False)
        assert fc.PLAIN_RUNS == {k: 0 for k in fc.KERNELS}
        assert fc.LAUNCHES["front_factor"] == _lanes_launched(symb, rep)
        assert max(e.dispatch_devices for e in rep.trace) > 1
        for p, q in zip(fact.panels, one.panels):
            np.testing.assert_array_equal(p, q)
        for (k, i), n in fc.DEVICE_LAUNCHES.items():
            by_card[i] = by_card.get(i, 0) + n * (k == "front_factor")
    return by_card


def test_sharded_executor_on_card(cuda):
    assert set(_sharded_grid23([torch.device("cuda", 0)] * 4)) == {0}


def test_sharded_executor_on_two_cards(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two CUDA devices to split a batch across cards; this machine has {n}")
    cards = [torch.device("cuda", i) for i in range(min(n, 4))]
    by_card = _sharded_grid23(cards)
    assert sorted(i for i, launches in by_card.items() if launches) == list(range(len(cards)))


FLASH_SHAPES = [
    (1, 64, 2, 16, 16, 16, True),
    (2, 128, 3, 32, 32, 64, True),
    (1, 64, 2, 16, 32, 16, False),
    (1, 96, 1, 8, 32, 32, True),  # 64 does not divide T: the ragged edge
    (1, 512, 32, 128, 256, 256, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,dh,bq,bkv,causal", FLASH_SHAPES)
def test_flash_attention_on_card(cuda, dtype, b, t, h, dh, bq, bkv, causal, rng):
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, dh)).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal, bq, bkv)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal, bq, bkv)
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        assert err < 2e-5
    else:
        # same f32 math on both sides (within the f32 tolerance), then one
        # rounding each: element by element, at most 2 bf16 ulps of the element
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=torch.finfo(torch.bfloat16).eps, atol=2e-5)


def _flash_check(got, want, dtype):
    """f32 math: 2e-5 max-abs (f32, and f64 computed in f32); bf16 and f16:
    element by element within eps·|ref| + 2e-5, one rounding each."""
    assert got.dtype == want.dtype == dtype
    if dtype in (torch.float32, torch.float64):
        assert float((got - want).abs().max()) < 2e-5
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=torch.finfo(dtype).eps, atol=2e-5)


TC_ROUTE = {torch.bfloat16: "wgmma_tma", torch.float32: "mma_3xtf32"}
FLASH_TC_SHAPES = [
    (1, 4096, 4, 64, True), (1, 4096, 4, 64, False),
    (1, 4096, 4, 128, True), (1, 4096, 4, 128, False),
    (1, 96, 2, 64, True), (1, 96, 2, 128, False),  # T below one 128-row tile
    (2, 200, 3, 128, True), (1, 200, 2, 64, False),  # a ragged last tile
    # head dims padded to the 64- or 128-column tile
    (1, 96, 2, 8, True), (1, 200, 2, 8, False),
    (1, 96, 2, 16, False), (2, 200, 3, 16, True),
    (1, 96, 2, 40, True), (1, 200, 2, 40, False),
    (1, 96, 2, 72, False), (2, 200, 3, 72, True),
    (1, 96, 2, 80, True), (1, 200, 2, 80, False), (1, 4096, 4, 80, True),
    (1, 96, 2, 96, False), (2, 200, 3, 96, True),
    (1, 96, 2, 120, True), (1, 200, 2, 120, False),
    # the wide tiles (fewer keys per K/V tile): Dh 136 padded to 192, 200
    # padded to 256, 192 and 256 as they are; T not a multiple of a tile
    (1, 200, 2, 136, True), (1, 96, 2, 136, False),
    (2, 200, 3, 200, True), (1, 96, 2, 200, False),
    (1, 200, 2, 192, True), (1, 96, 2, 192, False), (1, 4096, 4, 192, True),
    (1, 200, 2, 256, False), (2, 96, 2, 256, True), (1, 4096, 4, 256, True),
    (1, 1000, 2, 256, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,dh,causal", FLASH_TC_SHAPES)
def test_flash_tensor_core_routes_on_card(cuda, dtype, b, t, h, dh, causal, rng):
    """Every Dh up to 256 goes through the tensor-core kernel of its dtype
    (64, 128, 192 and 256 as they are, the others padded), meets the bar
    against the plain version and gives the same bits twice."""
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, dh)).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    blk = 128 if t % 128 == 0 else 8
    fa.reset_counters()
    got = fa.flash_attention(q, k, v, causal, blk, blk)
    torch.cuda.synchronize()
    assert fa.ROUTE_LAUNCHES == {r: int(r == TC_ROUTE[dtype]) for r in fa.ROUTES}
    assert fa.LAUNCHES["flash_attention"] == 1 and fa.PLAIN_RUNS["flash_attention"] == 0
    _flash_check(got, fa.flash_attention_plain(q, k, v, causal, blk, blk), dtype)
    torch.testing.assert_close(fa.flash_attention(q, k, v, causal, blk, blk), got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tensor_core_routes_take_strided_inputs(cuda, dtype, rng):
    """A (B, H, T, Dh) tensor seen as (B, T, H, Dh) is read in place; one
    whose rows are not 16-byte aligned is copied first: both give the bits
    of the contiguous inputs."""
    x = torch.from_numpy(rng.standard_normal((1, 3, 256, 128)).astype(np.float32)).to(cuda, dtype)
    view = x.transpose(1, 2)
    wide = torch.zeros(1, 256, 3, 130, device=cuda, dtype=dtype)
    wide[..., :128] = view
    odd = wide[..., :128]  # head rows 130 elements apart: not a multiple of 16 bytes
    assert fa.tma_ready(view) and not view.is_contiguous() and not fa.tma_ready(odd)
    want = fa.flash_attention(view.contiguous(), view.contiguous(), view.contiguous())
    for q in (view, odd):
        fa.reset_counters()
        got = fa.flash_attention(q, q, q)
        assert fa.ROUTE_LAUNCHES[TC_ROUTE[dtype]] == 1
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_reads_nothing_past_dh(cuda, dtype, rng):
    """q, k and v as the first 80 columns of (..., 128) tensors whose other
    columns hold NaN: read in place (no copy), they give the bits of
    contiguous inputs, so neither kernel reads past Dh."""
    views = []
    for _ in range(3):
        wide = torch.full((2, 200, 3, 128), float("nan"), device=cuda, dtype=dtype)
        wide[..., :80] = torch.from_numpy(
            rng.standard_normal((2, 200, 3, 80)).astype(np.float32)).to(cuda, dtype)
        views.append(wide[..., :80])
    assert all(fa.tma_ready(x) and not x.is_contiguous() for x in views)
    want = fa.flash_attention(*(x.contiguous() for x in views), True, 8, 8)
    fa.reset_counters()
    got = fa.flash_attention(*views, True, 8, 8)
    torch.cuda.synchronize()
    assert fa.ROUTE_LAUNCHES == {r: int(r == TC_ROUTE[dtype]) for r in fa.ROUTES}
    assert not got.isnan().any()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,dh,causal", [(200, 136, True), (96, 192, False)])
def test_flash_wide_head_dims_take_the_tensor_core_kernels(cuda, dtype, t, dh, causal, rng):
    """Dh 136 and 192 go through the tensor-core kernel of their dtype (the
    cluster route takes Dh past 256, the CUDA-core kernel only Dh past
    4096) and meet the bar."""
    q, k, v = (torch.from_numpy(rng.standard_normal((1, t, 2, dh)).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    fa.reset_counters()
    got = fa.flash_attention(q, k, v, causal, 8, 8)
    torch.cuda.synchronize()
    assert fa.ROUTE_LAUNCHES == {r: int(r == TC_ROUTE[dtype]) for r in fa.ROUTES}
    _flash_check(got, fa.flash_attention_plain(q, k, v, causal, 8, 8), dtype)


def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda):
    """Types no route computes, mixed types and mixed devices; every Dh, B·H
    and float type is taken (the tests below)."""
    q = torch.zeros(1, 64, 2, 16, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 64, 2, 16, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.half(), q)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q.cpu(), q)


FLASH_ANY_CASES = [  # (dtype, b, t, h, dh, causal)
    (torch.float16, 1, 200, 3, 128, True), (torch.float64, 1, 200, 3, 128, False),
    (torch.float16, 2, 96, 2, 64, False), (torch.float64, 1, 96, 2, 192, True),
    (torch.float32, 1, 200, 2, 20, True), (torch.bfloat16, 1, 200, 2, 20, False),
    (torch.float32, 1, 200, 2, 76, False), (torch.bfloat16, 2, 96, 2, 76, True),
    (torch.float16, 1, 96, 2, 76, True), (torch.float64, 1, 96, 2, 20, False),
    (torch.float32, 1, 200, 2, 264, True), (torch.bfloat16, 1, 96, 2, 264, False),
    (torch.float32, 1, 200, 2, 320, False), (torch.bfloat16, 1, 200, 2, 320, True),
    (torch.float16, 1, 96, 2, 330, True), (torch.float32, 1, 64, 1, 1000, True),
    # clusters of 3, 4, 5, 9 and 16 blocks (the reach), then past the reach
    (torch.bfloat16, 1, 200, 2, 600, True), (torch.float64, 1, 96, 2, 584, False),
    (torch.bfloat16, 1, 64, 1, 1000, False), (torch.float32, 1, 96, 1, 1032, False),
    (torch.bfloat16, 1, 96, 2, 2056, True), (torch.bfloat16, 1, 64, 1, 4096, True),
    (torch.float32, 1, 64, 1, 4096, False),
    (torch.float32, 1, 64, 1, 4104, True), (torch.bfloat16, 1, 64, 1, 4100, False),
]


def _route_of(dtype, dh):
    """The route rule, written out apart from :func:`route`."""
    p = -(-dh // 8) * 8
    if p <= 256:
        return "wgmma_tma" if dtype == torch.bfloat16 else "mma_3xtf32"
    return "tc_cluster" if p <= 4096 else "simt"


@pytest.mark.parametrize("dtype,b,t,h,dh,causal", FLASH_ANY_CASES)
def test_flash_takes_every_type_and_head_dim(cuda, dtype, b, t, h, dh, causal, rng):
    """f16 and f64 through the f32 route of their Dh, Dh not a multiple of
    8 padded, Dh 264 to 4096 on the cluster route, past it on the simt
    kernel's column chunks: against the plain version at the unchanged
    bars, the same bits twice, and through the route the rule names."""
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, dh)).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    fa.reset_counters()
    got = fa.flash_attention(q, k, v, causal, 8, 8)
    torch.cuda.synchronize()
    assert fa.route(dtype, dh) == _route_of(dtype, dh)
    assert fa.ROUTE_LAUNCHES == {r: int(r == _route_of(dtype, dh)) for r in fa.ROUTES}
    assert fa.PLAIN_RUNS["flash_attention"] == 0
    assert got.shape == q.shape and got.is_contiguous()
    _flash_check(got, fa.flash_attention_plain(q, k, v, causal, 8, 8), dtype)
    torch.testing.assert_close(fa.flash_attention(q, k, v, causal, 8, 8), got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 192), (torch.bfloat16, 136),
                                      (torch.float32, 64), (torch.bfloat16, 128),
                                      (torch.float32, 264), (torch.bfloat16, 256),
                                      (torch.float32, 320), (torch.bfloat16, 320)])
def test_flash_takes_more_than_65535_heads(cuda, dtype, dh, rng):
    """B·H = 65536 (more than a grid's y or z extent) on every route and
    tile width, the cluster route's grid of B·H·nc blocks included, at a
    short T."""
    b, t, h = 2, 16, 32768
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, dh)).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    fa.reset_counters()
    got = fa.flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    assert fa.ROUTE_LAUNCHES == {r: int(r == fa.route(dtype, dh)) for r in fa.ROUTES}
    _flash_check(got, fa.flash_attention_plain(q, k, v, True), dtype)


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 320), (torch.bfloat16, 320),
                                      (torch.float32, 512), (torch.bfloat16, 1000),
                                      (torch.bfloat16, 192), (torch.float32, 128)])
def test_flash_batch_invariance(cuda, dtype, dh, rng):
    """A head computed alone gives the bits it has inside a batch: no block
    of any route reads another head's rows (the cluster's blocks of one
    head sum their partials in the same order wherever the head lies)."""
    b, t, h = 2, 200, 3
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, dh)).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    whole = fa.flash_attention(q, k, v, True, 8, 8)
    for bi, hi in ((0, 0), (1, 2)):
        alone = fa.flash_attention(*(x[bi : bi + 1, :, hi : hi + 1].contiguous() for x in (q, k, v)),
                                   True, 8, 8)
        torch.testing.assert_close(alone, whole[bi : bi + 1, :, hi : hi + 1], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_cluster_room(cuda, dtype):
    """The cluster route's shape on the card: ceil(Dh / 256) blocks per
    cluster (16 at the reach, a non-portable size), each placeable (at
    least one such cluster resident at once); other Dh are refused."""
    for dh in (264, 320, 512, 600, 1000, 2056, 4096):
        ctas, room = fa.cluster_room(dtype, dh, cuda)
        assert ctas == fa.cluster_shape(dh)[0] and room >= 1
    for dh in (256, 4104):
        with pytest.raises(ValueError):
            fa.cluster_room(dtype, dh, cuda)


def test_execute_online_on_card(cuda):
    """The online path in f64: online run → projected plan → executor on
    the card; every front through the kernels (no plain run), the residual,
    and async equal to waves bit for bit."""
    g = 23
    a = tsparse.grid_laplacian_2d(g)
    ap = tsparse.permute_symmetric(a, tsparse.nested_dissection_2d(g))
    symb = tsparse.analyze(ap, relax=1)
    runs = {}
    for mode in ("async", "waves"):
        fc.reset_counters()
        fact, rep, online = execute_online(ap, symb, 8, 0.9, noise=LognormalNoise(0.3, seed=3),
                                           mode=mode, dtype=torch.float64)
        assert fc.LAUNCHES["front_factor"] > 0
        assert fc.PLAIN_RUNS == {k: 0 for k in fc.KERNELS}
        assert not rep.interpret and len(rep.trace) == symb.n_supernodes
        online.validate()
        runs[mode] = fact
    dense = ap.toarray()
    l = runs["async"].to_dense_l()
    assert np.abs(l @ l.T - dense).max() / np.abs(dense).max() < 1e-12
    for pa, pw in zip(runs["async"].panels, runs["waves"].panels):
        np.testing.assert_array_equal(pa, pw)


def test_session_execute_on_card(cuda):
    """The facade on every CUDA device, f64: the same factor bits as the
    executor driven directly, through the kernels."""
    g = 23
    a = tsparse.grid_laplacian_2d(g)
    sess = Session(DeviceMesh(plan_devices=8)).analyze(
        a, alpha=0.9, ordering=tsparse.nested_dissection_2d(g), relax=1).plan("greedy")
    assert sess.platform.devices()[0].type == "cuda"
    fc.reset_counters()
    rep = sess.execute(dtype=torch.float64)
    assert fc.LAUNCHES["front_factor"] > 0
    assert fc.PLAIN_RUNS == {k: 0 for k in fc.KERNELS}
    assert rep.detail.interpret is False and rep.metrics["n_devices"] >= 1
    direct, _ = PlanExecutor(sess.problem.symb, sess.schedule.to_execution_plan(),
                             dtype=torch.float64).run(sess.problem.matrix)
    for pa, pd in zip(rep.artifact.panels, direct.panels):
        np.testing.assert_array_equal(pa, pd)
    assert all(m > 0 for m in sess.platform.resources().memory)


# ----------------------------------------------------------------------
# The workload front end on the card (chip_smoke.py phase 10)
# ----------------------------------------------------------------------
def test_analyze_workload_multifrontal_on_card(cuda):
    """The paper's own workload (``configs/multifrontal.py``: the 63×63
    grid) through ``analyze_workload``, executed in the config's f32 on
    the card's frontal kernel."""
    from repro_torch.configs import SOLVER

    sess = Session(DeviceMesh(plan_devices=256)).analyze_workload("multifrontal")
    assert sess.problem.meta["workload"]["grid"] == SOLVER.grid == 63
    sess.plan("greedy")
    fc.reset_counters()
    rep = sess.execute(dtype=getattr(torch, SOLVER.dtype))
    assert fc.LAUNCHES["front_factor"] > 0
    assert fc.PLAIN_RUNS == {k: 0 for k in fc.KERNELS}
    assert rep.artifact.panels[0].dtype == np.float32
    dense = sess.problem.matrix.toarray()
    l = rep.artifact.to_dense_l().astype(np.float64)
    assert np.abs(l @ l.T - dense).max() / np.abs(dense).max() <= 1e-5


def test_calibration_for_card_mesh(cuda):
    from repro_torch.workloads import calibration_for

    assert calibration_for(DeviceMesh()).name == "h100"
    assert Session(DeviceMesh()).analyze_workload("qwen3-4b").problem.meta[
        "workload"]["calibration"] == "h100"


def test_calibration_for_cpu_lanes_beside_a_card(cuda):
    from repro_torch.workloads import calibration_for

    assert calibration_for(DeviceMesh([torch.device("cpu")] * 2)).name == "host-mesh"


# ----------------------------------------------------------------------
# The serving cluster on the card (chip_smoke.py phase 9, smaller)
# ----------------------------------------------------------------------
def _card_problems():
    """Poisson 20 (nested dissection: 156 fronts, padded order <= 256) and
    a random SPD of order 1200 in its natural order (195 fronts, 17 of
    padded order 1152: the large-front route)."""
    g = 20
    poisson = Problem.from_matrix(tsparse.grid_laplacian_2d(g), 0.9,
                                  ordering=tsparse.nested_dissection_2d(g))
    spd = Problem.from_matrix(tsparse.random_spd(1200, 16.0, np.random.default_rng(0)), 0.9)
    return poisson, spd


def _executed(prob):
    """The port's single-process executor on the card, f64."""
    return Session(DeviceMesh()).load(prob).plan("greedy").execute(
        dtype=torch.float64).artifact


def _no_cluster_threads(timeout=10.0):
    deadline = time.monotonic() + timeout
    while leaked_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    return leaked_threads()


def test_cluster_on_card_two_tenants(cuda):
    """Two tenants at once on two workers sharing the card, f64: every
    factor bit for bit the executor's, no front requeued, the three
    frontal kernels launched by the workers and no plain version run, and
    some dispatch carrying more than one front."""
    poisson, spd = _card_problems()
    want = [_executed(p) for p in (poisson, spd)]  # also builds the library
    assert any(ops.padded_shape(sn.m, sn.nb)[0] > ops.VMEM_FRONT_MAX
               for sn in spd.symb.supernodes)
    fc.reset_counters()
    with LocalCluster(n_workers=2, slots_per_worker=2, devices=[cuda], dtype=torch.float64,
                      heartbeat_timeout=10.0) as cl:
        client = cl.client()
        futs = [client.submit(p, tenant=t, rid=t) for t, p in enumerate((poisson, spd))]
        results = client.gather(futs, timeout=300.0)
        stats = cl.scheduler.stats()
        sizes = [b for w in cl.workers for b in w.batch_sizes]
    assert all(r.ok for r in results)
    assert stats["n_requeued"] == 0
    # the workers assemble on the host: the three factor kernels, no extend-add
    assert all(fc.LAUNCHES[k] > 0 for k in ("front_factor", "panel_factor", "syrk_downdate"))
    assert fc.LAUNCHES["extend_add"] == 0
    assert fc.PLAIN_RUNS == {k: 0 for k in fc.KERNELS}
    assert max(sizes) > 1
    for r, w, p in zip(results, want, (poisson, spd)):
        for pa, pw in zip(r.factor.panels, w.panels):
            np.testing.assert_array_equal(pa, pw)
        dense = p.matrix.toarray()
        l = r.factor.to_dense_l()
        assert np.abs(l @ l.T - dense).max() / np.abs(dense).max() < 1e-12
    assert _no_cluster_threads() == []


def test_cluster_on_card_worker_kill(cuda):
    """Kill one worker after the first dispatch (the reference test's
    timings): the requeued fronts re-run on the survivor and the factor is
    still the executor's, bit for bit."""
    poisson, _ = _card_problems()
    want = _executed(poisson)
    fc.reset_counters()
    with LocalCluster(n_workers=2, slots_per_worker=2, devices=[cuda], dtype=torch.float64,
                      tick=0.002, heartbeat_interval=0.03, heartbeat_timeout=0.2,
                      dispatch_overhead_s=0.05) as cl:
        client = cl.client()
        fut = client.submit(poisson, rid=0)
        deadline = time.monotonic() + 60.0
        while cl.scheduler.stats()["n_dispatches"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        cl.workers[1].kill()
        (res,) = client.gather([fut], timeout=300.0)
        losses = cl.scheduler.stats()["n_worker_losses"]
    assert res.ok and losses >= 1
    assert fc.LAUNCHES["front_factor"] > 0
    assert fc.PLAIN_RUNS == {k: 0 for k in fc.KERNELS}
    for pa, pw in zip(res.factor.panels, want.panels):
        np.testing.assert_array_equal(pa, pw)
    assert _no_cluster_threads() == []


# ----------------------------------------------------------------------
# The model zoo on the card (chip_smoke.py phase 11)
# ----------------------------------------------------------------------
def _flash_layers(cfg, t_dec, t_enc):
    """Flash launches of one prefill: each causal self-attention, the audio
    encoder's layers, a cross-attention over a memory of the decoder's
    length."""
    if cfg.family == "audio":
        return cfg.n_encoder_layers + cfg.n_layers * (2 if t_enc == t_dec else 1)
    return cfg.n_layers


@pytest.mark.parametrize("name", ["qwen3-4b", "seamless-m4t-large-v2"])
def test_model_prefill_on_card_matches_cpu(cuda, name):
    """Reduced qwen3-4b and seamless (a non-causal encoder, causal decoder,
    cross-attention): the prefill logits and caches on the card equal the
    same model's on the CPU within 1e-4 relative to max(1, max |CPU|); one
    flash launch per attention layer, no plain run."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params, random_batch
    from repro_torch.models import decode as dec
    from repro_torch.models.weights import params_from_numpy, params_to_numpy

    cfg = ARCHS[name].reduced()
    params = init_params(cfg, 0, device="cpu")
    batch = random_batch(cfg, 2, 40, torch.Generator().manual_seed(1))
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    want, want_cache = dec.prefill(cfg, params, batch["tokens"], extra=extra, remat=False,
                                   cache_dtype=torch.float32)
    card_params = params_from_numpy(cfg, params_to_numpy(params), cuda)
    fa.reset_counters()
    got, cache = dec.prefill(cfg, card_params, batch["tokens"].to(cuda),
                             extra={k: v.to(cuda) for k, v in extra.items()}, remat=False,
                             cache_dtype=torch.float32)
    torch.cuda.synchronize()
    t_enc = batch["frames"].shape[1] if "frames" in batch else 0
    assert fa.LAUNCHES["flash_attention"] == _flash_layers(cfg, 40, t_enc)
    assert fa.ROUTE_LAUNCHES["mma_3xtf32"] == fa.LAUNCHES["flash_attention"]
    assert fa.PLAIN_RUNS["flash_attention"] == 0
    assert _rel(got.cpu(), want) < 1e-4
    for kk, v in want_cache.items():
        assert _rel(cache[kk].cpu().double(), v.double()) < 1e-4, kk


def test_model_blocked_route_on_card(cuda, monkeypatch):
    """With ``takes_flash`` answering no, the card runs blocked attention
    (the test hook of chip_smoke phase 11): no launch, the same logits as
    the kernel's within 1e-4."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import attention, forward, init_params, random_batch

    cfg = ARCHS["qwen3-4b"].reduced()
    params = init_params(cfg, 0, device=cuda)
    tokens = random_batch(cfg, 2, 64, torch.Generator(cuda).manual_seed(1))["tokens"]
    fa.reset_counters()
    got, _ = forward(cfg, params, tokens, remat=False)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers
    monkeypatch.setattr(attention, "takes_flash", lambda *a, **k: False)
    fa.reset_counters()
    want, _ = forward(cfg, params, tokens, remat=False)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 0 and fa.PLAIN_RUNS["flash_attention"] == 0
    assert _rel(got, want) < 1e-4


def _eager_tokens(cfg, batch, prompt, gen, device, prompt_seed=1):
    """The serve launcher's tokens without a mesh, decoded eagerly: its
    parameters (seed 0) and prompts (seed 1, or ``prompt_seed``) on
    ``device``."""
    from repro_torch.models import build_decode_fn, build_prefill_fn, init_params, random_batch
    from repro_torch.models.decode import pad_caches

    params = init_params(cfg, 0, device=device)
    prompts = random_batch(cfg, batch, prompt, torch.Generator(device).manual_seed(prompt_seed))
    logits, cache = build_prefill_fn(cfg, remat=False, attn_block=32)(params, prompts)
    cache = pad_caches(cache, gen, multiple=1)
    decode = build_decode_fn(cfg)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    outs = [tok]
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, tok)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        outs.append(tok)
    return torch.cat(outs, dim=1).cpu().numpy()


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_serve_launcher_on_card(cuda, name):
    """``repro_torch.launch.serve`` on cuda:0 at each arch's reduced config:
    its decode, one CUDA graph replayed on the 1x1 mesh, gives the tokens
    of eager decode without a mesh; qwen3-4b's prefill launches flash once
    a layer."""
    from repro_torch.launch import serve

    fa.reset_counters()
    out = serve.main(["--arch", name, "--smoke", "--prompt", "48", "--gen", "6"])
    assert out["tokens"].shape == (4, 6)
    if name == "qwen3-4b":
        assert fa.LAUNCHES["flash_attention"] == 2 and fa.PLAIN_RUNS["flash_attention"] == 0
    want = _eager_tokens(ARCHS[name].reduced(), 4, 48, 6, torch.device("cuda", 0))
    np.testing.assert_array_equal(out["tokens"], want)


# ----------------------------------------------------------------------
# Training on the card (chip_smoke.py phase 12)
# ----------------------------------------------------------------------
def _train_batch(cfg, seed=1):
    from repro_torch.data import DataConfig, SyntheticTokens, with_extras

    return with_extras(SyntheticTokens(DataConfig(cfg.vocab_size, 16, 4, seed=seed)).batch_at(0),
                       cfg)


@pytest.mark.parametrize("name", ["qwen3-4b", "granite-moe-3b-a800m", "rwkv6-1.6b",
                                  "seamless-m4t-large-v2"])
def test_train_step_on_card_matches_cpu(cuda, name):
    """One step (microbatches 2, remat on) on the card and on the CPU from the
    same weights and tokens: the loss within 1e-5 relative, each gradient
    leaf within 1e-4 of that leaf's max |g| (chip_smoke phase 12 (b)'s
    tolerances); no flash launch under grad."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import place
    from repro_torch.models import init_params
    from repro_torch.models.common import tree_items
    from repro_torch.models.weights import params_from_numpy, params_to_numpy
    from repro_torch.train import build_value_and_grad

    cfg = ARCHS[name].reduced()
    host = params_to_numpy(init_params(cfg, 0, device="cpu"))
    batch = _train_batch(cfg)
    vg = build_value_and_grad(cfg, microbatches=2, attn_block=8)
    want_loss, want = vg(params_from_numpy(cfg, host, "cpu"), place(batch, "cpu"))
    fa.reset_counters()
    loss, got = vg(params_from_numpy(cfg, host, cuda), place(batch, cuda))
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 0 and fa.PLAIN_RUNS["flash_attention"] == 0
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for (pg, g), (pw, w) in zip(tree_items(got), tree_items(want)):
        assert pg == pw
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max()), pg


def test_flash_runs_again_after_a_train_step(cuda):
    """A train step turns ``requires_grad`` on for its length only: the
    step launches no flash kernel, the forward after it one per layer."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import place
    from repro_torch.models import forward
    from repro_torch.train import OptConfig, build_train_step, init_train_state

    cfg = ARCHS["qwen3-4b"].reduced()
    params, opt = init_train_state(cfg, 0)
    batch = place(_train_batch(cfg))
    fa.reset_counters()
    params, opt, stats = build_train_step(cfg, OptConfig(), attn_block=8)(params, opt, batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 0 and np.isfinite(float(stats["loss"]))
    assert not any(p.requires_grad for p in params.parameters())
    forward(cfg, params, batch["tokens"], remat=False)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers
    assert fa.PLAIN_RUNS["flash_attention"] == 0


def test_async_save_during_step_on_card(cuda, tmp_path):
    """``save(async_save=True)`` of CUDA tensors, then an in-place step at
    once: the checkpoint holds the state at the save bit for bit."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ARCHS
    from repro_torch.data import place
    from repro_torch.models.common import tree_items
    from repro_torch.models.model import param_specs
    from repro_torch.train import OptConfig, build_train_step, init_opt_state, init_train_state

    cfg = ARCHS["qwen3-4b"].reduced()
    params, opt = init_train_state(cfg, 0)
    step = build_train_step(cfg, OptConfig(lr=1e-2, warmup_steps=0), attn_block=8)
    batch = place(_train_batch(cfg))
    params, opt, _ = step(params, opt, batch)
    before = [(p, t.clone()) for p, t in tree_items({"params": params, "opt": opt})]
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": params, "opt": opt}, async_save=True)
    params, opt, _ = step(params, opt, batch)
    ck.wait()
    assert not torch.equal(params["embed"], dict(before)[("params", "embed")])
    _, got = ck.restore({"params": param_specs(cfg), "opt": init_opt_state(param_specs(cfg))})
    for (pa, a), (pb, b) in zip(before, tree_items(got)):
        assert pa == pb and b.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b), pa


# ----------------------------------------------------------------------
# the production meshes on the card: the 1x1 mesh
# ----------------------------------------------------------------------
@pytest.fixture
def mesh11(cuda):
    """``make_smoke_mesh(cuda:0)``; the one-rank group it makes is destroyed
    after the test."""
    from repro_torch.launch.mesh import smoke_mesh

    with smoke_mesh(torch.device("cuda", 0)) as mesh:
        yield mesh


def test_train_step_on_mesh_is_bit_for_bit(mesh11):
    """qwen3-4b at full width, 2 layers, 2 x 4096 tokens, f32: one step
    without a mesh and one from the same seed on the 1x1 mesh give the
    same loss and parameters bit for bit."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, SyntheticTokens, place
    from repro_torch.distributed.constraints import active_mesh
    from repro_torch.distributed.sharding import batch_pspecs, distribute, param_pspecs
    from repro_torch.models.common import ParamTree, tree_items
    from repro_torch.models.config import ShapeCell
    from repro_torch.train import OptConfig, build_train_step, init_opt_state, init_train_state

    cuda = torch.device("cuda", 0)
    cfg = dataclasses.replace(ARCHS["qwen3-4b"], n_layers=2)
    host = SyntheticTokens(DataConfig(cfg.vocab_size, 4096, 2)).batch_at(0)
    step = build_train_step(cfg, OptConfig(), microbatches=2, attn_block=512)
    params, opt = init_train_state(cfg, 0, device=cuda)
    params, _, stats = step(params, opt, place(host, cuda))
    want_loss, want = float(stats["loss"]), [p.clone() for _, p in tree_items(params)]
    del params, opt
    params, _ = init_train_state(cfg, 0, device=cuda)
    params = ParamTree(distribute(params.to_dict(), param_pspecs(cfg, params), mesh11))
    specs = batch_pspecs(cfg, ShapeCell("t", 4096, 2, "train"), mesh11)
    with active_mesh(mesh11):
        params, _, stats = step(params, init_opt_state(params), place(host, cuda, specs, mesh11))
        loss = stats["loss"]
        loss = float(loss.full_tensor() if isinstance(loss, DTensor) else loss)
    assert loss == want_loss
    for (path, p), w in zip(tree_items(params), want):
        assert torch.equal(p.to_local(), w), path


def test_prefill_on_mesh_launches_flash_per_layer(mesh11):
    """qwen3-4b f32, 2 layers, B=4 T=1024: the prefill on the 1x1 mesh
    (parameters made DTensors with ``from_local``, no copy) equals the
    prefill without a mesh bit for bit, and launches the flash kernel once
    a layer on the rank's heads, with no plain run."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ARCHS
    from repro_torch.distributed.constraints import active_mesh
    from repro_torch.distributed.sharding import distribute, param_pspecs, place_tensor
    from repro_torch.models import init_params, random_batch
    from repro_torch.models import decode as dec
    from repro_torch.models.common import ParamTree, tree_items

    cuda = torch.device("cuda", 0)
    cfg = dataclasses.replace(ARCHS["qwen3-4b"], n_layers=2)
    params = init_params(cfg, 0, dtype=torch.float32, device=cuda)
    tokens = random_batch(cfg, 4, 1024, torch.Generator(cuda).manual_seed(1))["tokens"]
    want, _ = dec.prefill(cfg, params, tokens, remat=False, cache_dtype=torch.float32)
    dparams = ParamTree(distribute(params.to_dict(), param_pspecs(cfg, params), mesh11))
    assert all(isinstance(d, DTensor) and d.to_local().data_ptr() == p.data_ptr()
               for (_, d), (_, p) in zip(tree_items(dparams), tree_items(params)))
    dtokens = place_tensor(tokens, (None, None), mesh11)
    fa.reset_counters()
    with active_mesh(mesh11):
        got, _ = dec.prefill(cfg, dparams, dtokens, remat=False, cache_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 2 and fa.PLAIN_RUNS["flash_attention"] == 0
    assert torch.equal(got.to_local(), want)


# ----------------------------------------------------------------------
# The example entry points on the card (chip_smoke.py phase 15)
# ----------------------------------------------------------------------
def test_serve_lm_example_on_card(cuda):
    """``repro_torch.examples.serve_lm`` takes cuda:0 by default: its
    prefill launches the flash kernel once a layer with no plain run, and
    its CUDA-graph decode gives the tokens of eager decode."""
    from repro_torch.examples import serve_lm

    fa.reset_counters()
    fc.reset_counters()
    out = serve_lm.main([])
    torch.cuda.synchronize()
    cfg = ARCHS["qwen2.5-3b"].reduced()
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers
    assert fa.PLAIN_RUNS["flash_attention"] == 0 and sum(fc.PLAIN_RUNS.values()) == 0
    assert sum(fc.LAUNCHES.values()) == 0
    assert out["device"] == "cuda:0" and out["tokens"].shape == (4, 16)
    want = _eager_tokens(cfg, 4, 32, 16, torch.device("cuda", 0), prompt_seed=0)
    np.testing.assert_array_equal(out["tokens"], want)


def test_workload_serving_example_on_card(cuda):
    """``repro_torch.examples.workload_serving`` only simulates (virtual
    time, on the host): on the card's default devices no kernel launches
    and no plain version runs, and the pipeline's simulation meets its
    fluid optimum."""
    from repro_torch.examples import workload_serving

    fa.reset_counters()
    fc.reset_counters()
    out = workload_serving.main([])
    torch.cuda.synchronize()
    assert out["devices"][0] == "cuda:0"
    assert sum(fc.LAUNCHES.values()) == 0 and sum(fc.PLAIN_RUNS.values()) == 0
    assert fa.LAUNCHES["flash_attention"] == 0 and fa.PLAIN_RUNS["flash_attention"] == 0
    assert abs(out["pipeline_efficiency"] - 1.0) <= 1e-9
    assert out["served"] == 4 and out["moe_experts"] == 60


# ----------------------------------------------------------------------
# 3-D linear elasticity on Q1 hexahedra (the benchmark's elasticity3d-30)
# ----------------------------------------------------------------------
def test_elasticity_factor_on_card(cuda):
    """18³ free nodes, 17,496 unknowns at 3 a node: the executor on cuda:0
    against the plain dense factor on the card within 1e-11 relative (f64),
    and the large route's counters count its 9 fronts, their bytes and the
    Schur blocks kept on the card."""
    import importlib.util
    from pathlib import Path

    import repro_torch.obs as obs
    from repro_torch.sparse import plain

    path = Path(__file__).resolve().parents[1] / "bench" / "families" / "q1_elasticity.py"
    spec = importlib.util.spec_from_file_location("family_q1_elasticity_for_card", path)
    q1 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(q1)
    op = q1.Operator({
        "grid": [19, 19, 19], "ordering": {"leaf": 4},
        "material": {"E0": 1.0, "Emin": 1e-9, "penal": 3, "nu": 0.3},
        "density": {"law": "uniform", "per": "element", "low": 0.3, "high": 1.0},
    })
    seed = 2**33 + 18
    assert op.n == 17496
    sess = Session(DeviceMesh([cuda], plan_devices=256)).analyze(
        op.matrix(seed, 0, original_order=True), 0.9, ordering=op.perm, relax=2).plan("pm")
    symb = sess.problem.symb
    large = [sn for sn in symb.supernodes if ops.padded_shape(sn.m, sn.nb)[0] > fc.VMEM_FRONT_MAX]
    assert len(large) == 9
    ex = PlanExecutor(symb, sess.schedule.to_execution_plan(), devices=[cuda],
                      dtype=torch.float64, mode="async")
    ex.warmup()
    obs.enable()
    obs.reset()
    fact, rep = ex.run(op.matrix(seed, 0), warmup=False)
    reg = obs.REGISTRY
    assert reg.get("repro_executor_large_fronts_total").value == 9
    # assembled on the card from the run's values there: only the panel
    # comes out, and the Schur block stays on the card
    sns = symb.supernodes

    def is_large(s):
        return s >= 0 and ops.padded_shape(sns[s].m, sns[s].nb)[0] > fc.VMEM_FRONT_MAX

    kept = [s for s in range(len(sns)) if is_large(s) and is_large(sns[s].parent)]
    assert 0 < len(kept) < 9
    assert reg.get("repro_executor_kept_blocks_total").value == len(kept)
    assert reg.get("repro_executor_kept_bytes_total").value == sum(
        (sns[s].m - sns[s].nb) ** 2 * 8 for s in kept)
    assert reg.get("repro_executor_large_bytes_total").value == sum(
        sn.m * sn.nb * 8 for s, sn in enumerate(sns) if is_large(s))
    assert 0 < reg.get("repro_executor_large_seconds_total").value
    k = plain.assemble_q1(op.dims, torch.from_numpy(op.moduli(seed, 0)), device=cuda)
    p = torch.from_numpy(op.perm).to(cuda)
    want = plain.dense_factor(k[p][:, p])
    got = torch.from_numpy(fact.to_dense_l()).to(cuda)
    assert _rel(got, want) < 1e-11
