"""The port's flash attention against the JAX package's Pallas kernel, and
the shared kernel build.

The same numpy inputs (seeded) go through
``repro.kernels.flash_attention.flash_attention(..., interpret=True)`` and
through the port's wrapper on CPU tensors, which takes the plain PyTorch
version; both are also held against a naive softmax.  Tolerance 2e-5
max-abs, the reference's own (``tests/test_kernels.py``).
"""
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
