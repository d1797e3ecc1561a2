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
workers, sharing the card, give the executor's factors bit for bit.
"""
import time

import numpy as np
import pytest
import torch

import repro_torch.kernels.frontal_cholesky as fc
import repro_torch.kernels.ops as ops
import repro_torch.sparse as tsparse
from repro_torch.api import DeviceMesh, Problem, Session
from repro_torch.cluster import LocalCluster, leaked_threads
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
def test_flash_other_head_dims_take_the_simt_kernel(cuda, dtype, t, dh, causal, rng):
    """Dh 136 and 192 go through the tensor-core kernel of their dtype (the
    CUDA-core kernel takes only Dh past 256) and meet the bar."""
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
]


@pytest.mark.parametrize("dtype,b,t,h,dh,causal", FLASH_ANY_CASES)
def test_flash_takes_every_type_and_head_dim(cuda, dtype, b, t, h, dh, causal, rng):
    """f16 and f64 through the f32 route of their Dh, Dh not a multiple of
    8 padded, Dh past 256 on the simt kernel's column chunks: against the
    plain version at the unchanged bars, the same bits twice, and through
    the route :func:`route` names."""
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, dh)).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    fa.reset_counters()
    got = fa.flash_attention(q, k, v, causal, 8, 8)
    torch.cuda.synchronize()
    assert fa.ROUTE_LAUNCHES == {r: int(r == fa.route(dtype, dh)) for r in fa.ROUTES}
    assert fa.PLAIN_RUNS["flash_attention"] == 0
    assert got.shape == q.shape and got.is_contiguous()
    _flash_check(got, fa.flash_attention_plain(q, k, v, causal, 8, 8), dtype)
    torch.testing.assert_close(fa.flash_attention(q, k, v, causal, 8, 8), got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 192), (torch.bfloat16, 136),
                                      (torch.float32, 64), (torch.bfloat16, 128),
                                      (torch.float32, 264), (torch.bfloat16, 256)])
def test_flash_takes_more_than_65535_heads(cuda, dtype, dh, rng):
    """B·H = 65536 (more than a grid's y or z extent) on every route and
    tile width, the simt kernel included, at a short T."""
    b, t, h = 2, 16, 32768
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, dh)).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    fa.reset_counters()
    got = fa.flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    assert fa.ROUTE_LAUNCHES == {r: int(r == fa.route(dtype, dh)) for r in fa.ROUTES}
    _flash_check(got, fa.flash_attention_plain(q, k, v, True), dtype)


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
    assert all(fc.LAUNCHES[k] > 0 for k in fc.KERNELS)
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
