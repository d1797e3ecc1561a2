"""The port's model zoo (``repro_torch.models``) against the JAX package's
(``repro.models``) on the CPU: the twin of ``tests/test_models.py``, and
of ``tests/test_system.py::test_serve_batched_requests``.

The reference draws its parameters with its own ``init_params`` (JAX
PRNG); they are carried over through numpy by ``params_from_numpy``, and
both packages get the same batch.  On the CPU the port's attention is
``blocked_attention`` (the flash kernel is the card's: see
``tests/test_torch_card.py``).  Tolerances, all f32: logits, aux, loss
and every cache tensor within 1e-5 relative to max(1, max |reference|)
(``TOL``); decode continuation within the reference's 2e-4 of the port's
own teacher-forced forward.  The reference's loss is its ``loss_fn``'s
body (``cross_entropy`` of its forward logits + aux), computed from the
forward it already ran.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")  # property tests need it; skip if absent
from hypothesis import given, strategies as st

import repro.models as rm
from repro.configs import ARCHS
from repro.models import decode as rdec
from repro.models.attention import blocked_attention as r_blocked
from repro.models.common import cross_entropy as r_cross_entropy
from repro.models.gla import gla_chunked as r_gla
from repro.models.moe import _dispatch_row as r_dispatch_row
from repro.models.moe import moe_apply as r_moe_apply
from repro.models.moe import moe_params as r_moe_params
from repro.serve import Request as RRequest
from repro.serve import place_two_pods_equal as r_place
from repro_torch import configs as tconfigs
from repro_torch import models as tm
from repro_torch.distributed import active_mesh, constrain, get_active_mesh, shard_over_dp
from repro_torch.launch import serve as tserve
from repro_torch.models import decode as tdec
from repro_torch.models.attention import attend, blocked_attention
from repro_torch.models.common import ParamTree
from repro_torch.models.gla import gla_chunked, gla_decode_step
from repro_torch.models.moe import _dispatch_row, _top_k, moe_apply
from repro_torch.models.weights import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.serve import Request, place_two_pods_equal

KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
REDUCED = {name: cfg.reduced() for name, cfg in ARCHS.items()}
T0, STEPS, BLOCK = 12, 3, 8  # prompt, decode steps, attention block (T0 + STEPS ragged)
TOL = 1e-5
CACHE_SEQ = ("k", "v", "ak", "av", "xk", "xv")


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _decode_cfg(name):
    """The reference test's decode config: MoE capacity 8 (no token dropped
    at any length, so prefill + decode equals the forward)."""
    cfg = REDUCED[name]
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


@functools.lru_cache(maxsize=None)
def _pair(cfg):
    """(reference params, port params, reference batch, port batch)."""
    jp = rm.init_params(cfg, KEY)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), CPU)
    jb = rm.random_batch(cfg, 2, T0 + STEPS, KEY)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    return jp, tp, jb, tb


def _prompt_extra(batch):
    """The non-token inputs of a T0-token prompt (audio frames cut to T0)."""
    return {k: (v[:, :T0] if k == "frames" else v) for k, v in batch.items() if k != "tokens"}


@functools.lru_cache(maxsize=None)
def _ref_forward(cfg):
    jp, _, jb, _ = _pair(cfg)
    logits, aux = rm.forward(cfg, jp, jb["tokens"], extra=jb, remat=False, attn_block=BLOCK)
    t = jb["tokens"].shape[1]
    loss = r_cross_entropy(logits[:, -t:][:, :-1], jb["tokens"][:, 1:]) + aux
    return np.asarray(logits), float(aux), float(loss)


@functools.lru_cache(maxsize=None)
def _ref_serve(cfg):
    """The reference's prefill of T0 tokens (f32 cache) and the logits of
    its STEPS teacher-forced decode steps."""
    jp, _, jb, _ = _pair(cfg)
    toks = jb["tokens"]
    logits, cache = rdec.prefill(cfg, jp, toks[:, :T0], extra=_prompt_extra(jb), remat=False,
                                 attn_block=BLOCK, cache_dtype=jnp.float32)
    cache0 = jax.tree.map(np.asarray, cache)
    for kk in CACHE_SEQ:
        if kk in cache:
            padw = [(0, 0)] * cache[kk].ndim
            padw[2] = (0, STEPS)
            cache[kk] = jnp.pad(cache[kk], padw)
    decf = rm.build_decode_fn(cfg)
    steps = []
    for i in range(STEPS):
        out, cache = decf(jp, cache, toks[:, T0 + i : T0 + i + 1])
        steps.append(np.asarray(out))
    return np.asarray(logits), cache0, steps


# ----------------------------------------------------------------------
# every arch: forward, aux, loss; prefill and caches; decode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_and_loss_match_reference(name):
    cfg = REDUCED[name]
    _, tp, _, tb = _pair(cfg)
    ref_logits, ref_aux, ref_loss = _ref_forward(cfg)
    logits, aux = tm.forward(cfg, tp, tb["tokens"], extra=tb, remat=False, attn_block=BLOCK)
    assert logits.shape == ref_logits.shape
    assert logits.shape[-1] == cfg.padded_vocab() and logits.shape[1] >= T0 + STEPS
    assert torch.isfinite(logits).all()
    assert _rel(logits, ref_logits) < TOL
    assert abs(float(aux) - ref_aux) <= TOL * max(1.0, abs(ref_aux))
    loss = tm.build_loss_fn(cfg, remat=False, attn_block=BLOCK)(tp, tb)
    assert abs(float(loss) - ref_loss) <= TOL * max(1.0, abs(ref_loss)), (float(loss), ref_loss)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_and_caches_match_reference(name):
    cfg = _decode_cfg(name)
    _, tp, _, tb = _pair(cfg)
    ref_logits, ref_cache, _ = _ref_serve(cfg)
    logits, cache = tdec.prefill(cfg, tp, tb["tokens"][:, :T0], extra=_prompt_extra(tb),
                                 remat=False, attn_block=BLOCK, cache_dtype=torch.float32)
    assert _rel(logits, ref_logits) < TOL
    got = cache_to_numpy(cache)
    assert set(got) == set(ref_cache)
    for kk, want in ref_cache.items():
        assert got[kk].shape == want.shape and got[kk].dtype == want.dtype, kk
        assert _rel(got[kk], want) < TOL, kk
    # the reference's cache carried over is the port's, bit for bit
    back = cache_from_numpy(ref_cache, CPU)
    assert all(np.array_equal(cache_to_numpy(back)[k], v) for k, v in ref_cache.items())


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_decode_continuation(name):
    """prefill(T0) then decode equals the teacher-forced forward (2e-4, the
    reference's rule) and the reference's decode_step logits (TOL)."""
    cfg = _decode_cfg(name)
    _, tp, _, tb = _pair(cfg)
    _, _, ref_steps = _ref_serve(cfg)
    toks = tb["tokens"]
    _, cache = tdec.prefill(cfg, tp, toks[:, :T0], extra=_prompt_extra(tb), remat=False,
                            attn_block=BLOCK, cache_dtype=torch.float32)
    for kk in CACHE_SEQ:
        if kk in cache:
            cache[kk] = torch.nn.functional.pad(cache[kk], (0, 0, 0, 0, 0, STEPS))
    decf = tm.build_decode_fn(cfg)
    for i in range(STEPS):
        logits_dec, cache = decf(tp, cache, toks[:, T0 + i : T0 + i + 1])
        prefix = cfg.frontend_len if cfg.family == "vlm" else 0  # patch positions
        assert int(cache["pos"]) == prefix + T0 + i + 1
        ref = dict(tb, tokens=toks[:, : T0 + i + 1])
        if "frames" in ref:
            ref["frames"] = tb["frames"][:, :T0]
        full, _ = tm.forward(cfg, tp, ref["tokens"], extra=ref, remat=False, attn_block=BLOCK)
        err = float((full[:, -1, :] - logits_dec[:, 0, :]).abs().max())
        assert err < 2e-4, (name, i, err)
        assert _rel(logits_dec, ref_steps[i]) < TOL, (name, i)


@pytest.mark.parametrize("name", ["qwen3-4b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_remat_does_not_change_loss(name):
    """With gradients on, remat runs each layer under checkpointing: the
    loss and its gradients stay the same."""
    cfg = REDUCED[name]
    _, tp, _, tb = _pair(cfg)
    params = ParamTree(tp.to_dict())  # new leaves: the shared tree keeps requires_grad off
    for p in params.parameters():
        p.requires_grad_(True)
    leaves = list(params.parameters())
    losses, grads = [], []
    for remat in (False, True):
        loss = tm.build_loss_fn(cfg, remat=remat, attn_block=BLOCK)(params, tb)
        losses.append(float(loss.detach()))
        grads.append(torch.autograd.grad(loss, leaves))
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    assert all(torch.allclose(a, b, rtol=1e-5, atol=1e-7) for a, b in zip(*grads))


# ----------------------------------------------------------------------
# blocked attention == naive softmax attention
# ----------------------------------------------------------------------
def _naive_attention(q, k, v, causal, window=None):
    t, dh = q.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q * dh**-0.5, k)
    qi, ki = torch.arange(t)[:, None], torch.arange(t)[None, :]
    mask = (ki <= qi) if causal else torch.ones(t, t, dtype=torch.bool)
    if window is not None:
        mask = mask & (ki > qi - window)
    logits = torch.where(mask, logits, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)


@given(
    st.integers(1, 3),
    st.integers(2, 5),  # T multiplier of block
    st.integers(1, 4),
    st.sampled_from([4, 8]),
    st.booleans(),
)
def test_blocked_attention_matches_naive(b, tm_, h, dh, causal):
    block = 8
    t = tm_ * block - 3  # exercise padding
    gen = torch.Generator().manual_seed(b * 100 + tm_ * 10 + h)
    q, k, v = (torch.randn(b, t, h, dh, generator=gen) for _ in range(3))
    out = blocked_attention(q, k, v, causal=causal, block=block)
    assert float((out - _naive_attention(q, k, v, causal)).abs().max()) < 1e-4
    assert torch.equal(attend(q, k, v, causal=causal, block=block), out)  # the CPU's route


def test_blocked_attention_sliding_window():
    b, t, h, dh, w = 1, 32, 2, 8, 4
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(b, t, h, dh, generator=gen) for _ in range(3))
    out = blocked_attention(q, k, v, causal=True, window=w, block=8)
    assert float((out - _naive_attention(q, k, v, True, w)).abs().max()) < 1e-4


@pytest.mark.parametrize("causal,window,q_offset,kv_len,tq", [
    (True, None, 0, None, 21), (True, 5, 0, None, 21), (True, None, 4, None, 9),
    (False, None, 0, 13, 21), (False, None, 0, None, 7),
])
def test_blocked_attention_matches_reference(causal, window, q_offset, kv_len, tq, rng):
    """The same function as the reference's: window, q_offset, kv_len,
    ragged Tk, Tq apart from Tk."""
    tk = 21
    q = rng.normal(size=(2, tq, 3, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, tk, 3, 8)).astype(np.float32) for _ in range(2))
    want = r_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     window=window, block=8, q_offset=q_offset,
                     kv_len=None if kv_len is None else jnp.asarray(kv_len))
    got = blocked_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                            window=window, block=8, q_offset=q_offset,
                            kv_len=None if kv_len is None else torch.tensor(kv_len))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < TOL


# ----------------------------------------------------------------------
# GLA: chunked == sequential recurrence; decode step == one more token
# ----------------------------------------------------------------------
def _gla_naive(q, k, v, g, u=None, mode="post"):
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    s = np.zeros((b, h, dk, dv))
    outs = []
    qf, kf, vf, gf = (np.asarray(x, np.float64) for x in (q, k, v, g))
    for i in range(t):
        s_new = s * np.exp(gf[:, i])[..., None] + np.einsum("bhk,bhv->bhkv", kf[:, i], vf[:, i])
        if mode == "post":
            o = np.einsum("bhk,bhkv->bhv", qf[:, i], s_new)
        else:
            o = np.einsum("bhk,bhkv->bhv", qf[:, i], s)
            uu = np.asarray(u, np.float64) if u is not None else 1.0
            o = o + np.einsum("bhk,bhk,bhv->bhv", qf[:, i] * uu, kf[:, i], vf[:, i])
        outs.append(o)
        s = s_new
    return np.stack(outs, axis=1), s


def _gla_inputs(seed, b, t, h, dk, scalar_decay):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, t, h, dk, generator=gen) for _ in range(3))
    g = -torch.exp(torch.randn(b, t, h, 1 if scalar_decay else dk, generator=gen) * 0.5)
    return q, k, v, g.expand(b, t, h, dk).contiguous()


@given(
    st.integers(1, 2),
    st.sampled_from([7, 8, 16, 19]),
    st.integers(1, 3),
    st.sampled_from([4, 8]),
    st.sampled_from(["post", "pre"]),
    st.sampled_from([4, 8]),
    st.sampled_from(["scan", "matmul"]),
)
def test_gla_chunked_matches_recurrence(b, t, h, dk, mode, chunk, intra):
    """Both intra-chunk paths (the matmul one takes a decay scalar per head)."""
    q, k, v, g = _gla_inputs(b * 1000 + t * 10 + h, b, t, h, dk, intra == "matmul")
    u = torch.randn(h, dk, generator=torch.Generator().manual_seed(t)) if mode == "pre" else None
    out, s = gla_chunked(q, k, v, g, u=u, mode=mode, chunk=chunk, intra=intra)
    ref, s_ref = _gla_naive(q, k, v, g, u=u, mode=mode)
    assert np.abs(out.numpy() - ref).max() < 1e-4
    assert np.abs(s.numpy() - s_ref).max() < 1e-4


@pytest.mark.parametrize("mode,intra", [("post", "scan"), ("pre", "scan"), ("post", "matmul"),
                                        ("pre", "matmul")])
def test_gla_chunked_matches_reference(mode, intra):
    q, k, v, g = _gla_inputs(11, 2, 19, 2, 8, intra == "matmul")
    u = torch.randn(2, 8, generator=torch.Generator().manual_seed(3)) if mode == "pre" else None
    out, s = gla_chunked(q, k, v, g, u=u, mode=mode, chunk=8, intra=intra)
    j = [jnp.asarray(x.numpy()) for x in (q, k, v, g)]
    want, s_want = r_gla(*j, u=None if u is None else jnp.asarray(u.numpy()), mode=mode,
                         chunk=8, intra=intra)
    assert _rel(out, want) < TOL and _rel(s, s_want) < TOL


def test_gla_decode_step_continues_state():
    b, t, h, dk = 1, 9, 2, 4
    q, k, v, g = _gla_inputs(3, b, t + 1, h, dk, False)
    _, s = gla_chunked(q[:, :t], k[:, :t], v[:, :t], g[:, :t], chunk=4)
    o_step, s2 = gla_decode_step(q[:, t], k[:, t], v[:, t], g[:, t], s)
    full, s_full = gla_chunked(q, k, v, g, chunk=4)
    assert float((o_step - full[:, t]).abs().max()) < 1e-4
    assert float((s2 - s_full).abs().max()) < 1e-4


# ----------------------------------------------------------------------
# MoE specifics
# ----------------------------------------------------------------------
def test_moe_aux_loss_and_capacity():
    cfg = REDUCED["qwen2-moe-a2.7b"]
    p = tm.init_params(cfg, 0, device="cpu")["layers"]
    lp = {k: v[0] for k, v in p["moe"].items()}
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(0))
    out, aux = moe_apply(x, lp, cfg)
    assert out.shape == x.shape
    assert float(aux) > 0.0
    assert torch.isfinite(out).all()


def test_moe_apply_matches_reference_with_overflow():
    """Default capacity (tokens dropped) on both packages' same inputs."""
    cfg = REDUCED["granite-moe-3b-a800m"]
    jp = r_moe_params(KEY, cfg)
    x = jax.random.normal(KEY, (2, 32, cfg.d_model))
    want, want_aux = r_moe_apply(x, jp, cfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    got, aux = moe_apply(torch.from_numpy(np.array(x)), tp, cfg)
    assert _rel(got, want) < TOL
    assert abs(float(aux) - float(want_aux)) < TOL


def test_dispatch_row_matches_reference_on_overflow():
    """An expert past its capacity c ends with slot c−1 empty (the
    reference's last write); the rest of the table and gates equal."""
    t, k, e, c = 16, 2, 8, 4
    rng = np.random.default_rng(5)
    idx = np.where(rng.random((t, k)) < 0.6, 0, rng.integers(1, e, (t, k))).astype(np.int32)
    idx[:, 1] = np.where(idx[:, 1] == idx[:, 0], (idx[:, 0] + 1) % e, idx[:, 1])
    gate = rng.random((t, k)).astype(np.float32)
    assert np.bincount(idx.ravel(), minlength=e).max() > c  # overflow
    want_t, want_g = r_dispatch_row(jnp.asarray(idx), jnp.asarray(gate), e, c)
    got_t, got_g = _dispatch_row(torch.from_numpy(idx).long(), torch.from_numpy(gate), e, c)
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    assert np.array_equal(got_g.numpy(), np.asarray(want_g))
    assert (got_t[0, c - 1] == -1).item() and got_g[0, c - 1].item() == 0.0


def test_top_k_takes_the_lower_index_on_ties():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.25, 0.25, 0.25, 0.25, 0.0]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = _top_k(torch.from_numpy(probs), 3)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


def test_head_padding_is_inert():
    """padded_n_heads > n_heads: the padded heads' output rows of wo are
    zero, so their query weights do not change the loss."""
    base = REDUCED["starcoder2-7b"]
    cfg_pad = dataclasses.replace(base, n_heads=6, n_kv_heads=2, tp_degree=4)
    assert cfg_pad.padded_n_heads == 8
    params = tm.init_params(cfg_pad, 0, device="cpu")
    batch = tm.random_batch(cfg_pad, 2, 12, torch.Generator().manual_seed(0))
    loss_fn = tm.build_loss_fn(cfg_pad, remat=False, attn_block=8)
    l1 = float(loss_fn(params, batch))
    assert np.isfinite(l1)
    dh = cfg_pad.resolved_head_dim
    wo, wq = params["layers"]["attn"]["wo"], params["layers"]["attn"]["wq"]
    assert float(wo[:, cfg_pad.n_heads * dh :, :].abs().max()) == 0.0
    wq[:, :, cfg_pad.n_heads * dh :] += 3.0  # the padded heads' queries
    assert float(loss_fn(params, batch)) == l1


# ----------------------------------------------------------------------
# specs, device rule, sharding hooks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_match_reference_at_full_width(name):
    """``param_specs`` at the published widths: meta tensors (nothing
    allocated) with the reference's keys, shapes and dtype."""
    cfg = tconfigs.get(name)
    got = tm.param_specs(cfg)
    want = rm.param_specs(ARCHS[name])
    flat = {k: v for k, v in got.state_dict().items()}
    ref = {".".join(str(p.key) for p in path): leaf
           for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    assert set(flat) == set(ref)
    for key, t in flat.items():
        assert t.device.type == "meta" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == tuple(ref[key].shape), key


def test_input_specs_match_reference():
    from repro.models.config import shape_by_name

    from repro_torch.models.config import shape_by_name as t_shape_by_name

    for name in ("qwen3-4b", "pixtral-12b", "seamless-m4t-large-v2", "zamba2-2.7b", "rwkv6-1.6b"):
        cfg, shape = tconfigs.get(name), t_shape_by_name("decode_32k")
        ref_cfg, ref_shape = ARCHS[name], shape_by_name("decode_32k")
        got, want = tm.batch_specs(cfg, shape), rm.batch_specs(ref_cfg, ref_shape)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
        got, want = tm.decode_input_specs(cfg, shape), rm.decode_input_specs(ref_cfg, ref_shape)
        assert all(v.device.type == "meta" for v in got["cache"].values())
        assert {k: tuple(v.shape) for k, v in got["cache"].items()} == {
            k: tuple(v.shape) for k, v in want["cache"].items()}
        assert tuple(got["token"].shape) == tuple(want["token"].shape)


def test_models_raise_without_cuda(monkeypatch):
    """The models run on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = REDUCED["qwen3-4b"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdec.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen3-4b", "--smoke"])
    assert tm.init_params(cfg, 0, device="cpu")["embed"].device.type == "cpu"


def test_constraints_are_identity_without_a_mesh_and_raise_under_one():
    x = torch.ones(4, 3)
    assert get_active_mesh() is None
    assert constrain(x, ("pod", "data"), None) is x and shard_over_dp(x) is x
    with active_mesh("a mesh"):
        with pytest.raises(NotImplementedError, match="10c"):
            shard_over_dp(x)
    assert get_active_mesh() is None


# ----------------------------------------------------------------------
# the serving launcher (test_system's serve case)
# ----------------------------------------------------------------------
def test_serve_launcher_smoke_on_cpu(capsys):
    out = tserve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu"])
    assert out["tokens"].shape == (4, 16)
    assert ((0 <= out["tokens"]) & (out["tokens"] < ARCHS["qwen2.5-3b"].padded_vocab())).all()
    assert "§6 placement across pods" in capsys.readouterr().out
    want_mk, want_place = r_place(ARCHS["qwen2.5-3b"], [RRequest(i, 32) for i in range(4)],
                                  256, alpha=0.9)
    assert out["placement"] == want_place and out["projected_makespan"] == pytest.approx(want_mk)


def test_serve_batched_requests():
    cfg = tconfigs.get("qwen2.5-3b").reduced()
    params = tm.init_params(cfg, 0, device="cpu")
    reqs = [Request(i, prompt_tokens=8 + 4 * i) for i in range(4)]
    mk, placement = place_two_pods_equal(tconfigs.get("qwen2.5-3b"), reqs, 256, 0.9)
    assert len(placement) == 4 and mk > 0

    batch = tm.random_batch(cfg, 2, 12, torch.Generator().manual_seed(0))
    logits, cache = tm.build_prefill_fn(cfg, remat=False, attn_block=8)(params, batch)
    for kk in ("k", "v"):
        cache[kk] = torch.nn.functional.pad(cache[kk], (0, 0, 0, 0, 0, 4))
    decode = tm.build_decode_fn(cfg)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    for _ in range(3):
        logits_d, cache = decode(params, cache, tok)
        tok = logits_d[:, -1:].argmax(-1).to(torch.int32)
        assert torch.isfinite(logits_d).all()
    assert int(cache["pos"]) == 12 + 3
