"""The port's flash attention against the JAX package's Pallas kernel, and
the shared kernel build.

The same numpy inputs (seeded) go through
``repro.kernels.flash_attention.flash_attention(..., interpret=True)`` and
through the port's wrapper on CPU tensors, which takes the plain PyTorch
version; both are also held against a naive softmax.  Tolerance 2e-5
max-abs, the reference's own (``tests/test_kernels.py``).
"""
import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

CASES = [
    (1, 64, 2, 16, 16, 16, True),
    (2, 128, 3, 32, 32, 64, True),
    (1, 64, 2, 16, 32, 16, False),
    (1, 96, 1, 8, 32, 32, True),
    (1, 64, 2, 80, 32, 16, True),  # zamba2-2.7b's head dim (2560 / 32)
    (2, 96, 2, 96, 32, 32, False),
    # the wide tensor-core tiles: Dh padded to 192, 192 itself, 256
    (1, 64, 2, 136, 32, 16, True),
    (1, 96, 1, 192, 32, 32, False),
    (1, 64, 2, 256, 16, 32, True),
]


def _inputs(b, t, h, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(3)]


def _naive(q, k, v, causal):
    """softmax(q kᵀ · Dh^-0.5 [causal]) v in float64."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    t, dh = q.shape[1], q.shape[3]
    s = np.einsum("bqhd,bkhd->bhqk", q * dh**-0.5, k)
    if causal:
        s = np.where(np.tril(np.ones((t, t), bool))[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("b,t,h,dh,bq,bkv,causal", CASES)
def test_flash_matches_jax_and_naive(b, t, h, dh, bq, bkv, causal):
    q, k, v = _inputs(b, t, h, dh, seed=b * 7 + t)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, block_q=bq, block_kv=bkv, interpret=True))
    before = fa.PLAIN_RUNS["flash_attention"]
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal, bq, bkv)
    assert fa.PLAIN_RUNS["flash_attention"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, t, h, dh)
    got = got.numpy()
    naive = _naive(q, k, v, causal)
    assert np.abs(got - want).max() < 2e-5
    assert np.abs(got - naive).max() < 2e-5
    assert np.abs(want - naive).max() < 2e-5


@pytest.mark.parametrize("b,t,h,dh,bq,bkv,causal", CASES)
def test_flash_bf16_one_rounding(b, t, h, dh, bq, bkv, causal):
    """bf16 in, f32 math, one rounding out: element by element within 2
    bf16 ulps of the f32 result on the same (bf16) inputs."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(b, t, h, dh, seed=t))
    got = fa.flash_attention(q, k, v, causal, bq, bkv)
    assert got.dtype == torch.bfloat16
    ref = fa.flash_attention(q.float(), k.float(), v.float(), causal, bq, bkv)
    torch.testing.assert_close(got.float(), ref, rtol=torch.finfo(torch.bfloat16).eps, atol=0)
    # exactly the f32 result rounded once
    torch.testing.assert_close(got, ref.to(torch.bfloat16), rtol=0, atol=0)


def test_flash_strided_inputs_match_contiguous(rng):
    """Views in another layout (as produced by a (B, H, T, Dh) transpose)
    give the same result as their contiguous copies."""
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 16)).astype(np.float32))
    q = x.transpose(1, 2)  # (B, T, H, Dh), not contiguous
    assert not q.is_contiguous()
    torch.testing.assert_close(
        fa.flash_attention(q, q, q, True, 32, 32),
        fa.flash_attention(q.contiguous(), q.contiguous(), q.contiguous(), True, 32, 32),
        rtol=0, atol=0,
    )


def test_flash_contract():
    q = torch.zeros(1, 96, 2, 8)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, q, q, block_q=64)  # 96 % 64
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, q, q, block_q=32, block_kv=40)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(q, q[:, :64], q)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(q[0], q[0], q[0])
    # bq = min(block_q, T): blocks larger than T are fine, as in the reference
    assert fa.flash_attention(q, q, q, block_q=256, block_kv=256).shape == q.shape
    # a device with no kernel and no plain path is refused
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


def test_flash_counters_reset():
    q = torch.zeros(1, 32, 1, 8)
    fa.flash_attention(q, q, q)
    assert fa.PLAIN_RUNS["flash_attention"] > 0
    fa.reset_counters()
    assert fa.PLAIN_RUNS == {"flash_attention": 0} and fa.LAUNCHES == {"flash_attention": 0}


def test_library_hash_covers_every_source(tmp_path):
    """One library for all csrc sources: changing either file's bytes
    changes the build directory."""
    assert [p.name for p in _build.SOURCES] == ["frontal_cholesky.cu", "flash_attention.cu"]
    copies = [tmp_path / p.name for p in _build.SOURCES]
    for src, dst in zip(_build.SOURCES, copies):
        shutil.copyfile(src, dst)
    base = _build.library_path(copies)
    assert base == _build.library_path(_build.SOURCES)
    assert base.parent.parent == _build.BUILD_DIR
    seen = {base}
    for c in copies:
        original = c.read_bytes()
        c.write_bytes(original + b"\n")
        seen.add(_build.library_path(copies))
        c.write_bytes(original)
    assert len(seen) == 3
    assert _build.library_path(copies) == base
    # every C entry point the wrappers call is bound
    assert {"front_factor_f64", "flash_attention_f32", "flash_attention_bf16"} <= set(
        _build.SIGNATURES
    )
    entries = {name for by_dtype in fa._ENTRY.values() for name in by_dtype.values()}
    assert entries | set(fa._ROOM.values()) <= set(_build.SIGNATURES)


# ----------------------------------------------------------------------
# The card kernels' numeric design, emulated on the CPU
#
# The bf16 kernel keeps the reference's f32 P by splitting it into
# P_hi = bf16(P) and P_lo = bf16(P - P_hi) and running PV twice on bf16
# operands; the f32 kernel runs both products as three TF32 products
# (a_big b_big + a_big b_small + a_small b_big).  These emulations repeat
# that arithmetic tile by tile (the kernels' keys per K/V tile, _tiles; the
# exponent in base 2) with torch on the CPU, and are held to the card's bars
# against the JAX reference in interpret mode and against the plain version:
# element by element |err| <= eps_bf16 * |ref| + 2e-5 in bf16, 2e-5 max-abs
# in f32.  A Dh below the kernels' tile widths (64, 128, 192, 256) runs
# padded with zero columns to the next of them, with the scale of the true
# Dh; the emulations do the same and slice the output back to Dh.
# ----------------------------------------------------------------------
EPS_BF16 = torch.finfo(torch.bfloat16).eps
DESIGN_CASES = [(256, 64, True), (512, 128, True), (384, 128, False), (512, 64, False),
                (256, 80, True), (384, 96, False),
                (256, 136, True), (384, 192, False), (256, 256, True)]


def _tiles(dh: int):
    """(padded Dh, bf16 keys per K/V tile, f32 keys per K/V tile) as the
    kernels choose them: the narrowest of 64, 128, 192, 256 columns that
    holds Dh; past 128 columns fewer keys, so that the Q tile and two K/V
    stages fit a block's shared memory."""
    dhp = next(w for w in (64, 128, 192, 256) if dh <= w)
    return dhp, (128 if dhp <= 128 else 64), {64: 64, 128: 64, 192: 32, 256: 16}[dhp]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 fraction bits), to nearest, ties away from
    zero (``cvt.rna.tf32.f32``), by an add and a mask, as the kernel does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from the three TF32 products of the split, smallest first."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _emulate(q, k, v, causal, bkv, scores, pv, exp2_scale=None):
    """The kernels' blocked online softmax over (B, T, H, Dh) tensors with
    the products ``scores(q, k_tile)`` and ``pv(p, v_tile)``; f32 state, one
    rounding to q's dtype at the end.  With ``exp2_scale`` (the bf16
    kernel's form) the scores are unscaled and p = 2^(s * exp2_scale - m),
    m in the same base-2 units."""
    b, t, h, dh = q.shape
    qh, kh, vh = (x.transpose(1, 2).float() for x in (q, k, v))
    rows = torch.arange(t)
    m = torch.full((b, h, t), NEG_INF_F32)
    l = torch.zeros(b, h, t)
    acc = torch.zeros(b, h, t, dh)
    for k0 in range(0, t, bkv):
        s = scores(qh, kh[:, :, k0 : k0 + bkv])
        keys = k0 + torch.arange(s.shape[-1])
        if causal:
            s = torch.where(keys[None, :] <= rows[:, None], s, NEG_INF_F32)
        if exp2_scale is None:
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
        else:
            m_new = torch.maximum(m, s.amax(-1) * exp2_scale)
            p = torch.exp2(s * exp2_scale - m_new[..., None])
            corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + pv(p, vh[:, :, k0 : k0 + bkv])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


NEG_INF_F32 = -1e30


def _padded(q, k, v):
    """q, k, v with Dh padded by zero columns to the kernels' tile width
    (:func:`_tiles`), and the true Dh."""
    dh = q.shape[-1]
    dhp = _tiles(dh)[0]
    return [torch.nn.functional.pad(x, (0, dhp - dh)) for x in (q, k, v)], dh


def _bf16_design(q, k, v, causal, passes=2, keys=None):
    """The bf16 kernel's arithmetic over K/V tiles of ``keys`` keys (the
    kernel's own count for this Dh by default)."""
    keys = keys or _tiles(q.shape[-1])[1]
    (q, k, v), dh = _padded(q, k, v)
    scale = dh**-0.5

    def pv(p, vt):
        out, rest = 0, p
        for _ in range(passes):
            part = rest.to(torch.bfloat16).float()
            out = out + part @ vt
            rest = rest - part
        return out

    # (q . k) in f32 (exact products of bf16); the scale, with log2(e),
    # goes into the base-2 exponent
    return _emulate(q, k, v, causal, keys, lambda qh, kt: qh @ kt.mT, pv,
                    exp2_scale=scale * math.log2(math.e))[..., :dh]


def _tf32_design(q, k, v, causal):
    keys = _tiles(q.shape[-1])[2]
    (q, k, v), dh = _padded(q, k, v)
    scale = dh**-0.5
    # q scaled in f32 first, as the reference does; the exponent in base 2
    return _emulate(q, k, v, causal, keys, lambda qh, kt: _mm_3xtf32(qh * scale, kt.mT),
                    _mm_3xtf32, exp2_scale=math.log2(math.e))[..., :dh]


def _cluster_design(q, k, v, causal):
    """The cluster route's arithmetic (Dh past 256): Dh padded with zero
    columns to nc shares of 192 or 256 (:func:`fa.cluster_shape`), each
    block's partial S over its share by its kernel's product, the nc
    partials added in the fixed order 0..nc-1 (every block holds that sum),
    then the online softmax over the share's key tiles (bf16: 64 keys, f32:
    56 at share 192, 32 at 256) and PV with P split in two bf16 terms
    (bf16) or as three TF32 products (f32).  PV is column by column, so
    the blocks' output columns together are PV over the padded width."""
    dh = q.shape[-1]
    nc, share = fa.cluster_shape(dh)
    q, k, v = (torch.nn.functional.pad(x, (0, nc * share - dh)) for x in (q, k, v))
    scale = dh**-0.5
    cols = [slice(r * share, (r + 1) * share) for r in range(nc)]

    def summed(product):
        def scores(qh, kt):
            s = product(qh[..., cols[0]], kt[..., cols[0]])
            for c in cols[1:]:
                s = s + product(qh[..., c], kt[..., c])
            return s
        return scores

    if q.dtype == torch.bfloat16:
        def pv(p, vt):
            hi = p.to(torch.bfloat16).float()
            return hi @ vt + (p - hi).to(torch.bfloat16).float() @ vt

        out = _emulate(q, k, v, causal, 64, summed(lambda qc, kc: qc @ kc.mT), pv,
                       exp2_scale=scale * math.log2(math.e))
    else:
        keys = {192: 56, 256: 32}[share]
        out = _emulate(q, k, v, causal, keys,
                       summed(lambda qc, kc: _mm_3xtf32(qc * scale, kc.mT)), _mm_3xtf32,
                       exp2_scale=math.log2(math.e))
    return out[..., :dh]


def _jax_ref(q, k, v, causal, dtype):
    args = [jnp.asarray(x.float().numpy()).astype(dtype) for x in (q, k, v)]
    out = ref_flash(*args, causal=causal, block_q=128, block_kv=128, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _excess(got, ref, rtol):
    """max(|got - ref| - rtol |ref|): at most 2e-5 to meet the bar."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs() - rtol * ref.abs()).max())


def _design_inputs(t, dh, dtype, seed):
    return [torch.from_numpy(x).to(dtype) for x in _inputs(1, t, 2, dh, seed)]


@pytest.mark.parametrize("t,dh,causal", DESIGN_CASES)
def test_bf16_two_pass_p_meets_the_bar(t, dh, causal):
    """(a) P split into two bf16 terms for PV keeps every element within
    eps_bf16 |ref| + 2e-5 of the reference and of the plain version."""
    q, k, v = _design_inputs(t, dh, torch.bfloat16, seed=t + dh)
    got = _bf16_design(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _excess(got, _jax_ref(q, k, v, causal, jnp.bfloat16), EPS_BF16) <= 2e-5
    assert _excess(got, fa.flash_attention(q, k, v, causal, 128, 128), EPS_BF16) <= 2e-5


@pytest.mark.parametrize("t,dh,causal", DESIGN_CASES)
def test_3xtf32_products_meet_the_f32_bar(t, dh, causal):
    """(b) Both products as three TF32 products: within 2e-5 max-abs of the
    reference and of the plain version in f32."""
    q, k, v = _design_inputs(t, dh, torch.float32, seed=t + dh + 1)
    got = _tf32_design(q, k, v, causal)
    assert got.dtype == torch.float32
    assert _excess(got, _jax_ref(q, k, v, causal, jnp.float32), 0.0) <= 2e-5
    assert _excess(got, fa.flash_attention(q, k, v, causal, 128, 128), 0.0) <= 2e-5


CLUSTER_DESIGN_CASES = [(128, 264, True), (96, 264, False), (128, 320, True), (128, 320, False),
                        (96, 512, True), (64, 512, False), (64, 1000, True), (64, 1000, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,dh,causal", CLUSTER_DESIGN_CASES)
def test_cluster_design_meets_the_bars(dtype, t, dh, causal):
    """(c) Dh past 256 split over a cluster: per-block partial S over each
    column share, added in the fixed order, then the kernel's own P split
    (bf16) or 3xTF32 (f32).  Within eps_bf16 |ref| + 2e-5 (bf16) or 2e-5
    max-abs (f32) of the JAX reference in interpret mode and of the plain
    version, at the unchanged bars."""
    q, k, v = _design_inputs(t, dh, dtype, seed=t + dh + int(causal))
    got = _cluster_design(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    rtol = EPS_BF16 if dtype == torch.bfloat16 else 0.0
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    assert _excess(got, _jax_ref(q, k, v, causal, jdt), rtol) <= 2e-5
    assert _excess(got, fa.flash_attention(q, k, v, causal, 32, 32), rtol) <= 2e-5


def test_cluster_shares():
    """ceil(padded Dh / 256) blocks of an equal share rounded up to 64
    columns, always 192 or 256; the last block holds at least 8 columns of
    Dh; nothing at or below 256 or past the reach."""
    assert fa.CLUSTER_DH_MAX == 4096
    assert [fa.cluster_shape(d) for d in (257, 264, 320, 384, 392, 512, 520, 600, 776, 1000,
                                          1032, 4096)] == [
        (2, 192), (2, 192), (2, 192), (2, 192), (2, 256), (2, 256), (3, 192), (3, 256),
        (4, 256), (4, 256), (5, 256), (16, 256)]
    for dh in range(264, 4097, 8):
        nc, share = fa.cluster_shape(dh)
        assert share in (192, 256) and nc <= fa.CLUSTER_MAX
        assert (nc - 1) * share + 8 <= dh <= nc * share
    for dh in (256, 4097, 5000):
        with pytest.raises(ValueError):
            fa.cluster_shape(dh)
    with pytest.raises(ValueError):
        fa.cluster_room(torch.float32, 128, torch.device("cpu"))


def test_tf32_rounding_by_bit_masks():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-11, -(1 + 2**-11), 3.0e-5])
    got = _tf32(x)
    assert got.tolist()[:4] == [1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10)]  # ties away
    assert abs(float(got[4]) - 3.0e-5) <= 3.0e-5 * 2**-11
    # one TF32 product alone misses the f32 bar that the split meets
    q, k, v = _design_inputs(256, 64, torch.float32, seed=5)
    want = fa.flash_attention(q, k, v, True, 128, 128)
    one = _emulate(q, k, v, True, 64, lambda qh, kt: _tf32(qh * 0.125) @ _tf32(kt.mT),
                   lambda p, vt: _tf32(p) @ _tf32(vt))
    assert _excess(one, want, 0.0) > 2e-5


def test_one_pass_bf16_p_misses_the_bar_documenting_the_split():
    """Why the bf16 kernel runs PV twice: rounding P to bf16 once (as SDPA
    and FlashAttention do) errs by about 2^-9 |v| sqrt(sum p^2) / l, which
    does not shrink with |O|: outputs near zero miss the element-wise bar.
    This case documents the design; it is meant to pass."""
    q, k, v = _design_inputs(512, 128, torch.bfloat16, seed=7)
    want = fa.flash_attention(q, k, v, True, 128, 128)
    assert _excess(_bf16_design(q, k, v, True, passes=1), want, EPS_BF16) > 2e-5
    assert _excess(_bf16_design(q, k, v, True, passes=2), want, EPS_BF16) <= 2e-5


@pytest.mark.parametrize("dh", [192, 256])
def test_wide_bf16_tiles_of_64_keys_meet_the_bar_of_128(dh):
    """Past 128 columns the bf16 kernel takes 64-key K/V tiles (its shared
    memory holds no 128-key stages there).  The online softmax over 64-key
    tiles, P split in two terms, meets the same element-wise bar as over
    128-key tiles, against the plain version and the reference; one bf16
    term of P misses it at these widths too."""
    q, k, v = _design_inputs(512, dh, torch.bfloat16, seed=dh)
    assert _tiles(dh) == (dh, 64, 32 if dh == 192 else 16)
    want = fa.flash_attention(q, k, v, True, 128, 128)
    ref = _jax_ref(q, k, v, True, jnp.bfloat16)
    for keys in (64, 128):
        got = _bf16_design(q, k, v, True, keys=keys)
        assert _excess(got, want, EPS_BF16) <= 2e-5
        assert _excess(got, ref, EPS_BF16) <= 2e-5
    assert _excess(_bf16_design(q, k, v, True, passes=1), want, EPS_BF16) > 2e-5


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 128, "wgmma_tma"), (torch.bfloat16, 64, "wgmma_tma"),
    (torch.float32, 128, "mma_3xtf32"), (torch.float32, 64, "mma_3xtf32"),
    (torch.bfloat16, 32, "wgmma_tma"), (torch.float32, 256, "mma_3xtf32"),
    (torch.float32, 8, "mma_3xtf32"), (torch.bfloat16, 96, "wgmma_tma"),
    (torch.bfloat16, 136, "wgmma_tma"), (torch.float32, 80, "mma_3xtf32"),
    (torch.bfloat16, 256, "wgmma_tma"), (torch.float32, 192, "mma_3xtf32"),
    # f16 and f64 run in f32; Dh is padded to a multiple of 8 first
    (torch.float16, 128, "mma_3xtf32"), (torch.float64, 128, "mma_3xtf32"),
    (torch.float32, 76, "mma_3xtf32"), (torch.bfloat16, 125, "wgmma_tma"),
    (torch.float32, 121, "mma_3xtf32"), (torch.float32, 129, "mma_3xtf32"),
    (torch.float16, 320, "tc_cluster"), (torch.bfloat16, 264, "tc_cluster"),
    (torch.float64, 249, "mma_3xtf32"), (torch.float32, 257, "tc_cluster"),
    # the edges: 256 against 264, the cluster's reach (4096) against the next
    (torch.bfloat16, 256, "wgmma_tma"), (torch.float32, 264, "tc_cluster"),
    (torch.bfloat16, 1000, "tc_cluster"), (torch.float64, 4090, "tc_cluster"),
    (torch.bfloat16, 4096, "tc_cluster"), (torch.float32, 4096, "tc_cluster"),
    (torch.bfloat16, 4097, "simt"), (torch.float32, 4104, "simt"),
])
def test_route_rule(dtype, dh, want):
    """The card's kernel is a pure function of (dtype, Dh): the tensor-core
    kernel of the type it runs in up to a padded Dh of 256 (padded to 64,
    128, 192 or 256), the cluster route from 264 to its reach of 4096, simt
    past it."""
    assert fa.route(dtype, dh) == want
    assert want in fa.ROUTES and fa.KERNEL_DTYPE[dtype] in fa._ENTRY[want]


def test_route_rule_rejects_other_dtypes():
    for dtype in (torch.int32, torch.complex64, torch.float8_e4m3fn):
        with pytest.raises(TypeError):
            fa.route(dtype, 128)


def test_tensor_core_routes_copy_what_tma_cannot_read():
    """The tensor-core routes read strided tensors in place when TMA can
    (innermost stride 1, other strides positive multiples of 16 bytes, 16-byte
    aligned data) and get a contiguous copy otherwise; the simt kernel takes
    any strides."""
    x = torch.zeros(2, 4, 64, 128)
    q = x.transpose(1, 2)  # (B, T, H, Dh) view of a (B, H, T, Dh) tensor
    ready = [x.permute(0, 2, 1, 3).contiguous(), q, q[..., :64], q.to(torch.bfloat16)]
    flat = torch.zeros(2 * 64 * 4 * 128 + 8)
    unready = [
        flat[1 : 1 + x.numel()].view(2, 64, 4, 128),  # 4 bytes off alignment
        torch.zeros(2, 64, 4, 256)[..., ::2],  # innermost stride 2, not 1
        torch.zeros(2, 64, 1, 128).expand(2, 64, 4, 128),  # a zero stride
        torch.zeros(2, 64, 4, 130, dtype=torch.bfloat16)[..., :128],  # 260-byte rows
    ]
    for t in ready:
        assert fa.tma_ready(t)
        for rt in fa.ROUTES:
            assert all(y is t for y in fa.kernel_inputs(t, t, t, rt))
    for t in unready:
        assert not fa.tma_ready(t)
        for rt in ("wgmma_tma", "mma_3xtf32", "tc_cluster"):
            got = fa.kernel_inputs(t, t, t, rt)
            assert all(y.is_contiguous() and fa.tma_ready(y) and torch.equal(y, t) for y in got)
        assert all(y is t for y in fa.kernel_inputs(t, t, t, "simt"))


def test_build_compiles_each_source_apart_then_links(tmp_path, monkeypatch):
    """One ``nvcc -c`` per source, all started before any is waited on,
    then one link; the objects are removed and the library lands at
    ``library_path()``.  A stand-in ``nvcc`` records its calls: each compile
    leaves a mark and waits (10 s at most) until every compile has left
    one, so each logs how many it saw: all of them only if they overlapped."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    log, marks = tmp_path / "calls.log", tmp_path / "marks"
    marks.mkdir()
    n = len(_build.SOURCES)
    fake = bin_dir / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "for last; do :; done\n"
        "seen=0\n"
        'case " $* " in *" -c "*)\n'
        f'  touch "{marks}/$(basename "$last")"; i=0\n'
        f'  while [ "$(ls {marks} | wc -l)" -lt {n} ] && [ $i -lt 200 ]; do\n'
        "    sleep 0.05; i=$((i + 1)); done\n"
        f'  seen=$(ls {marks} | wc -l);;\n'
        "esac\n"
        f'echo "$seen $@" >> {log}\n'
        'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then shift; touch "$1"; fi; shift; done\n'
    )
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    out = _build.build_library()
    assert out == _build.library_path() and out.exists()
    calls = [line.split(" ", 1) for line in log.read_text().splitlines()]
    assert len(calls) == n + 1
    compiles, (link_seen, link) = calls[:-1], calls[-1]
    assert sorted(call.split()[-1] for _, call in compiles) == sorted(map(str, _build.SOURCES))
    for seen, call in compiles:
        assert int(seen) == n  # every compile was running while this one waited
        assert " -c " in f" {call} " and "-shared" not in call
        assert "arch=compute_90a,code=sm_90a" in call
    assert link_seen == "0" and link.startswith("-shared -o ") and link.count(".o") == n
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]
    assert _build.build_library() == out  # built once
    assert len(log.read_text().splitlines()) == len(calls)


# ----------------------------------------------------------------------
# What the wrapper hands a kernel on the card: types and padded Dh
# ----------------------------------------------------------------------
PAD_CASES = [  # (dtype, Dh, causal)
    (torch.float16, 20, True), (torch.float32, 76, False), (torch.float64, 128, True),
    (torch.float32, 264, True), (torch.bfloat16, 125, False), (torch.float16, 131, False),
]


def _plain_at_scale(q, k, v, scale, causal, bq):
    """The plain version on padded operands with the kernels' ``scale``:
    it scales q by Dh**-0.5 of the Dh it is given, so q comes in f32 with
    that factor taken back out."""
    q = q.float() * (scale * q.shape[-1] ** 0.5)
    return fa.flash_attention_plain(q, k.float(), v.float(), causal, bq, bq)


@pytest.mark.parametrize("dtype,dh,causal", PAD_CASES)
def test_kernel_operands_keep_the_reference_semantics(dtype, dh, causal):
    """The card's recipe, run here through the plain version: inputs in the
    type they run in (f16 and f64 in f32), Dh padded with zero columns to
    a multiple of 8 with the scale of the true Dh, the padding sliced off
    and one rounding to the input type.  It must give the JAX kernel's
    result (interpret mode) on the same inputs: 2e-5 max-abs for f32 math
    (f32, and f64, which the reference also computes in f32), element by
    element within eps·|ref| + 2e-5 for f16 and bf16 (one rounding)."""
    t, h, bq = 64, 2, 32
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _inputs(1, t, h, dh, seed=dh))
    qp, kp, vp, scale = fa.kernel_operands(q, k, v)
    assert qp.dtype == fa.KERNEL_DTYPE[dtype] and qp.shape[-1] == fa.padded_dh(dh)
    assert qp.shape[-1] % 8 == 0 and scale == dh**-0.5
    assert not qp[..., dh:].any() and not kp[..., dh:].any() and not vp[..., dh:].any()
    got = _plain_at_scale(qp, kp, vp, scale, causal, bq)[..., :dh].to(dtype)
    assert got.dtype == dtype and got.shape == q.shape
    # the reference in the input type (f64 as f32: its f64 run needs x64
    # and casts to f32 all the same)
    jdt = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16}.get(dtype, jnp.float32)
    want = torch.from_numpy(np.asarray(ref_flash(
        *(jnp.asarray(x.float().numpy(), dtype=jdt) for x in (q, k, v)),
        causal=causal, block_q=bq, block_kv=bq, interpret=True)).astype(np.float32))
    eps = torch.finfo(dtype).eps if dtype in (torch.float16, torch.bfloat16) else 0.0
    assert float(((got.float() - want).abs() - eps * want.abs()).max()) <= 2e-5
    # and the port's unpadded plain version: the same function
    plain = fa.flash_attention_plain(q, k, v, causal, bq, bq).float()
    assert float(((got.float() - plain).abs() - eps * plain.abs()).max()) <= 2e-5


def test_padding_with_the_padded_scale_would_show():
    """The scale must be the true Dh's: the padded Dh's moves the result
    far past the bar, so the test above tells the two apart."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 64, 2, 76, seed=3))
    qp, kp, vp, scale = fa.kernel_operands(q, k, v)
    right = _plain_at_scale(qp, kp, vp, scale, True, 32)[..., :76]
    wrong = fa.flash_attention_plain(qp, kp, vp, True, 32, 32)[..., :76]  # Dh 80's scale
    assert float((right - fa.flash_attention_plain(q, k, v, True, 32, 32)).abs().max()) < 2e-5
    assert float((wrong - right).abs().max()) > 1e-3


def test_flash_tiles_edits_match_the_source():
    """The tile A/B script's text edits each find their one line in the
    source (a variant that silently kept the source's tiles would time the
    same kernel twice), and the edited tiles still fit a block's shared
    memory: Q and two K/V stages, rows padded by 4 floats."""
    from repro_torch.kernels import flash_tiles

    src = (flash_tiles.CSRC / "flash_attention.cu").read_text()
    assert flash_tiles.VARIANTS["rows 128"] == {}
    for old, new in flash_tiles.VARIANTS["rows 64"].items():
        assert src.count(old) == 1 and old != new
    for dh in flash_tiles.DHS:
        for rows, keys in ((128, _tiles(dh)[2]), (64, 32)):
            assert (rows + 4 * keys) * (dh + 4) * 4 <= 232_448
