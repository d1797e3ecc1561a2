"""The port's frontal-factorization kernels against the JAX package's.

Twins of tests/test_kernels.py (flash attention aside): the same inputs,
made with numpy from a seed, go through the JAX Pallas kernels in interpret
mode and through ``repro_torch``'s wrappers, which take their plain PyTorch
versions for CPU tensors.  Tolerances are the reference's own: 5e-5
relative for f32 fronts, 1e-4 for the panel + SYRK composition, 1e-11 for
f64.  The CUDA kernels themselves are tested on the card by
tests/test_torch_card.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
import repro_torch.kernels.frontal_cholesky as fc
import repro_torch.kernels.ops as tops
from repro.kernels.frontal_cholesky import panel_factor as jpanel_factor
from repro.kernels.frontal_cholesky import syrk_downdate as jsyrk_downdate
from repro.kernels.ref import partial_cholesky_ref as jpartial_cholesky_ref
from repro_torch.kernels.ref import (
    panel_factor_ref,
    partial_cholesky_ref,
    syrk_update_ref,
)


def _spd(m, rng, dtype=np.float32):
    b = rng.normal(size=(m, m)).astype(np.float64)
    a = b @ b.T + m * np.eye(m)
    return a.astype(dtype)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _both(m, nb, a, tol):
    """Port vs JAX interpret-mode kernel, and port vs its own oracle."""
    pan, sch = tops.partial_cholesky(torch.from_numpy(a), nb)
    jpan, jsch = jops.partial_cholesky(jnp.asarray(a), nb, interpret=True)
    pr, sr = partial_cholesky_ref(torch.from_numpy(a), nb)
    assert pan.shape == (m, nb) and sch.shape == (m - nb, m - nb)
    assert pan.dtype == sch.dtype == torch.from_numpy(a).dtype
    assert _rel(pan, jpan) < tol and _rel(pan, pr) < tol
    if sch.numel():
        assert _rel(sch, jsch) < tol and _rel(sch, sr) < tol


@pytest.mark.parametrize(
    "m,nb",
    [(16, 8), (32, 32), (100, 60), (128, 128), (192, 64), (256, 128),
     (300, 140), (384, 256)],
)
def test_partial_cholesky_matches_jax_f32(m, nb, rng):
    _both(m, nb, _spd(m, rng), 5e-5)


def test_partial_cholesky_f64(rng):
    jax.config.update("jax_enable_x64", True)
    try:
        a = _spd(96, rng, np.float64)
        pan, sch = tops.partial_cholesky(torch.from_numpy(a), 48)
        jpan, jsch = jops.partial_cholesky(jnp.asarray(a), 48, interpret=True)
        jpr, jsr = jpartial_cholesky_ref(jnp.asarray(a), 48)
        assert np.abs(pan.numpy() - np.asarray(jpan)).max() < 1e-11
        assert np.abs(sch.numpy() - np.asarray(jsch)).max() < 1e-11
        assert np.abs(pan.numpy() - np.asarray(jpr)).max() < 1e-11
        assert np.abs(sch.numpy() - np.asarray(jsr)).max() < 1e-11
    finally:
        jax.config.update("jax_enable_x64", False)


def test_large_front_panel_path(rng, monkeypatch):
    for mod in (jops, tops):
        monkeypatch.setattr(mod, "VMEM_FRONT_MAX", 256)
        monkeypatch.setattr(mod, "OUTER_PANEL", 256)
    fc.reset_counters()
    _both(520, 384, _spd(520, rng), 1e-4)
    # mp = 640 > 256: two 256-wide panels, each followed by a SYRK
    assert fc.PLAIN_RUNS["panel_factor"] == 2
    assert fc.PLAIN_RUNS["syrk_downdate"] == 2
    assert fc.PLAIN_RUNS["front_factor"] == 0


def test_panel_factor_kernel(rng):
    mp, nb = 256, fc.TILE
    slab = np.ascontiguousarray(_spd(mp, rng)[:, :nb])
    got = fc.panel_factor(torch.from_numpy(slab)).numpy()
    want = np.asarray(jpanel_factor(jnp.asarray(slab), interpret=True))
    ref = panel_factor_ref(torch.from_numpy(slab)).numpy()
    tri = np.tril(np.ones((nb, nb), bool))
    scale = max(1.0, np.abs(want).max())
    for other in (want, ref):
        top = np.where(tri, got[:nb], 0) - np.where(tri, other[:nb], 0)
        assert np.abs(top).max() / scale < 5e-5
        assert np.abs(got[nb:] - other[nb:]).max() / scale < 5e-5


@pytest.mark.parametrize("m,k,tile", [(256, 128, 128), (512, 256, 256)])
def test_syrk_downdate_kernel(m, k, tile, rng):
    c = rng.normal(size=(m, m)).astype(np.float32)
    a = rng.normal(size=(m, k)).astype(np.float32)
    got = fc.syrk_downdate(torch.from_numpy(c), torch.from_numpy(a), tile=tile)
    want = jsyrk_downdate(jnp.asarray(c), jnp.asarray(a), tile=tile, interpret=True)
    ref = syrk_update_ref(torch.from_numpy(c), torch.from_numpy(a))
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-2  # |C|~k
    assert np.abs(got.numpy() - ref.numpy()).max() < 1e-2


@pytest.mark.parametrize("k", [1, 40, 128])
def test_syrk_downdate_uplo_rule(k, rng):
    """``uplo=None`` is the reference's full C − A·Aᵀ (any K); ``uplo='L'``
    keeps the lower triangle of it and C above the diagonal; the K padding
    the card applies (``syrk_operand``) changes neither."""
    m = 256
    c = rng.normal(size=(m, m))
    a = rng.normal(size=(m, k))
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(jsyrk_downdate(jnp.asarray(c), jnp.asarray(a), tile=128,
                                         interpret=True))
    finally:
        jax.config.update("jax_enable_x64", False)
    tc, ta = torch.from_numpy(c), torch.from_numpy(a)
    full = fc.syrk_downdate(tc, ta, tile=128)
    assert np.abs(full.numpy() - want).max() / max(1.0, np.abs(want).max()) < 1e-11
    lower = fc.syrk_downdate(tc, ta, tile=128, uplo="L")
    torch.testing.assert_close(torch.tril(lower), torch.tril(full), rtol=0, atol=0)
    torch.testing.assert_close(torch.triu(lower, 1), torch.triu(tc, 1), rtol=0, atol=0)
    padded = fc.syrk_operand(ta)
    assert padded.shape == (m, max(32, -(-k // 32) * 32)) and not padded[:, k:].any()
    torch.testing.assert_close(fc.syrk_downdate_plain(tc, padded), full, rtol=1e-14, atol=1e-12)
    with pytest.raises(ValueError, match="uplo"):
        fc.syrk_downdate(tc, ta, tile=128, uplo="U")


def test_large_front_route_reads_the_lower_triangle(rng, monkeypatch):
    """``partial_cholesky``'s large-front loop asks for ``uplo='L'``, so the
    card does the lower triangle's work only."""
    seen = []
    real = tops.syrk_downdate
    monkeypatch.setattr(tops, "syrk_downdate",
                        lambda *a, **kw: seen.append(kw.get("uplo")) or real(*a, **kw))
    monkeypatch.setattr(tops, "VMEM_FRONT_MAX", 256)
    monkeypatch.setattr(tops, "OUTER_PANEL", 256)
    tops.partial_cholesky(torch.from_numpy(_spd(520, rng, np.float64)), 384)
    assert seen == ["L", "L"]


def test_padding_pivots_are_inert(rng):
    """nb not a multiple of 128: padded pivots must not change results."""
    _both(160, 37, _spd(160, rng), 5e-5)


def test_batched_front_factor_matches_jax(rng):
    """A (3, 256, 256) stack through one call: each lane equals the JAX
    vmapped kernel's and the port's own single-front call bit for bit."""
    fronts = np.stack(
        [jops.pad_front_np(_spd(200, rng), 90 + 10 * i) for i in range(3)]
    )
    assert fronts.shape == (3, 256, 256)
    got = tops.batched_front_factor(torch.from_numpy(fronts), 128).numpy()
    want = np.asarray(
        jops.batched_front_factor(jnp.asarray(fronts), 128, interpret=True)
    )
    low = np.tril(np.ones((256, 256), bool))
    for g, w in zip(got, want):
        assert _rel(np.where(low, g, 0), np.where(low, w, 0)) < 5e-5
    for i in range(3):
        one = tops.batched_front_factor(torch.from_numpy(fronts[i : i + 1]), 128)
        np.testing.assert_array_equal(one.numpy()[0], got[i])


@pytest.mark.parametrize("m,nb", [(16, 8), (100, 60), (300, 140)])
def test_oracles_match_jax_f64(m, nb, rng):
    jax.config.update("jax_enable_x64", True)
    try:
        a = _spd(m, rng, np.float64)
        pan, sch = partial_cholesky_ref(torch.from_numpy(a), nb)
        jpan, jsch = jpartial_cholesky_ref(jnp.asarray(a), nb)
        assert np.abs(pan.numpy() - np.asarray(jpan)).max() < 1e-11
        assert np.abs(sch.numpy() - np.asarray(jsch)).max() < 1e-11
    finally:
        jax.config.update("jax_enable_x64", False)


def test_padding_helpers_match_jax(rng):
    for m, nb in [(16, 8), (300, 140), (1060, 256)]:
        assert tops.padded_shape(m, nb) == jops.padded_shape(m, nb)
        f = _spd(m, rng, np.float64)
        p = tops.pad_front_np(f, nb)
        np.testing.assert_array_equal(p, jops.pad_front_np(f, nb))
        a, b = tops.extract_panel_schur(p, m, nb)
        ja, jb = jops.extract_panel_schur(p, m, nb)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
    assert (tops.OUTER_PANEL, fc.TILE, fc.VMEM_FRONT_MAX) == (
        jops.OUTER_PANEL, jops.TILE, jops.VMEM_FRONT_MAX,
    )


def test_wrappers_count_plain_runs_and_reject_bad_shapes():
    fc.reset_counters()
    eye = torch.eye(128, dtype=torch.float64)[None]
    out = fc.front_factor(eye, 128)
    torch.testing.assert_close(out, eye, rtol=0, atol=0)  # identity is inert
    assert fc.PLAIN_RUNS["front_factor"] == 1
    assert fc.LAUNCHES == {k: 0 for k in fc.KERNELS}
    with pytest.raises(ValueError):
        fc.front_factor(torch.eye(100)[None], 128)
    with pytest.raises(ValueError):
        fc.panel_factor(torch.zeros(128, 256))
    with pytest.raises(ValueError):
        fc.syrk_downdate(torch.zeros(256, 256), torch.zeros(256, 64), tile=512)
    with pytest.raises(ValueError):
        tops.batched_front_factor(torch.zeros(1, 1152, 1152), 128)


def test_frontal_split_switches_match_the_source():
    """The phase-split tool edits the kernel source by text: each edit must
    find its line exactly once, and every variant skips a distinct set of
    phases."""
    from repro_torch.kernels import frontal_split

    src = (frontal_split.CSRC / "frontal_cholesky.cu").read_text()
    for old in frontal_split._SWITCHES:
        assert src.count(old) == 1, old
    assert len(set(frontal_split.VARIANTS.values())) == len(frontal_split.VARIANTS)
    assert frontal_split.VARIANTS["full"] == 0
