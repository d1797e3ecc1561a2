"""The port's training substrate (``repro_torch.{train,data,checkpoint}``,
``launch/train.py``) against the JAX package's on the CPU: the twin of
``tests/test_train.py`` and of ``tests/test_system.py::
test_train_checkpoint_restart``.

Reference parameters come from its own ``init_params`` (JAX PRNG), carried
over by ``params_from_numpy``; token batches are built once in numpy and
fed to both packages.  On the CPU every attention under grad is
``blocked_attention`` (as on the card: the flash kernel is forward only).

Tolerances, chosen before the first run, all f32:

* gradients: each leaf within ``GRAD_TOL`` = 1e-4 of that leaf's max |g|
  (reference); loss within ``LOSS_TOL`` = 1e-5 relative;
* loss trajectories over train steps: ``TRAJ_TOL`` = 1e-4 relative.  Adam
  turns a 1e-7 difference in a near-zero gradient into a sign, so
  parameters after a step are never compared tighter than 2·lr;
* ``lr_at``: 1e-7 absolute; one ``adamw_update`` on a seeded tree (not near
  zero): 1e-6 relative to max(1, |reference|), ``grad_norm`` included;
* data: bit for bit; checkpoints: bit for bit (f32, and bf16 within the
  port).
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rm
from repro.checkpoint import Checkpointer as RCheckpointer
from repro.configs import ARCHS
from repro.data import DataConfig as RDataConfig
from repro.data import SyntheticTokens as RSyntheticTokens
from repro.data import with_extras as r_with_extras
from repro.models.moe import _dispatch_row as r_dispatch_row
from repro.train import OptConfig as ROptConfig
from repro.train import adamw_update as r_adamw_update
from repro.train import build_train_step as r_build_train_step
from repro.train import init_opt_state as r_init_opt_state
from repro.train import lr_at as r_lr_at
import repro_torch.models.moe as tmoe
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig, SyntheticTokens, place, with_extras
from repro_torch.launch import train as ttrain
from repro_torch.models import build_loss_fn, init_params
from repro_torch.models.common import tree_from_items, tree_items
from repro_torch.models.model import param_specs
from repro_torch.models.weights import (
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
)
from repro_torch.train import (
    OptConfig,
    adamw_update,
    build_train_step,
    build_value_and_grad,
    init_opt_state,
    init_train_state,
    lr_at,
)

KEY = jax.random.PRNGKey(0)
R_ADAMW_JIT = jax.jit(r_adamw_update, static_argnums=3)  # one compile per tree, not per op
CPU = torch.device("cpu")
GRAD_TOL, LOSS_TOL, TRAJ_TOL = 1e-4, 1e-5, 1e-4
B, T, BLOCK = 4, 16, 8


def _cfg(name):
    """The reduced arch; MoE at capacity factor 0.5 (c = 4 slots for 16
    tokens x top-2 over 8 experts: experts overflow)."""
    cfg = ARCHS[name].reduced()
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    return cfg


CFGS = {name: _cfg(name) for name in sorted(ARCHS)}


@functools.lru_cache(maxsize=None)
def _ref_params(cfg):
    return rm.init_params(cfg, KEY)


def _port_params(cfg):
    """A fresh copy of the reference's parameters in the port (CPU)."""
    return params_from_numpy(cfg, jax.tree.map(np.asarray, _ref_params(cfg)), CPU)


@functools.lru_cache(maxsize=None)
def _batch(cfg):
    """One numpy batch (B x T, the pipeline's tokens + stub modality inputs)."""
    return with_extras(SyntheticTokens(DataConfig(cfg.vocab_size, T, B, seed=1)).batch_at(0), cfg)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(cfg):
    return jax.jit(jax.value_and_grad(rm.build_loss_fn(cfg, remat=False, attn_block=BLOCK)))


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _ref_flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree):
    return {"/".join(path): v.detach().float().numpy() for path, v in tree_items(tree)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _assert_grads_close(got_tree, want_tree):
    got, want = _port_flat(got_tree), _ref_flat(want_tree)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err, scale = np.abs(got[k] - w).max(), np.abs(w).max()
        assert err <= GRAD_TOL * scale, (k, err, scale)


@pytest.fixture
def overflow_spy(monkeypatch):
    """Records, for each MoE dispatch of the port, whether an expert got
    more assignments than its capacity in some row."""
    seen = []
    dispatch = tmoe._dispatch

    def spy(idx, gate, e, c):
        rows = idx.reshape(idx.shape[0], -1)
        seen.append(any(bool((torch.bincount(r, minlength=e) > c).any()) for r in rows))
        return dispatch(idx, gate, e, c)

    monkeypatch.setattr(tmoe, "_dispatch", spy)
    return seen


# ----------------------------------------------------------------------
# Twins of tests/test_train.py
# ----------------------------------------------------------------------
def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    cfg = OptConfig(lr=0.3, weight_decay=0.0, warmup_steps=0, total_steps=200)

    def loss(p):
        return torch.sum(torch.square(p["w"]))

    for _ in range(150):
        w = params["w"].detach().requires_grad_(True)
        g = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        params, state, _ = adamw_update(params, g, state, cfg)
    assert float(loss(params)) < 1e-2
    assert int(state["step"]) == 150 and state["step"].dtype == torch.int32


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(3)}
    state = init_opt_state(params)
    cfg = OptConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0, warmup_steps=0)
    g = {"w": torch.tensor([1e6, 0.0, 0.0])}
    _, _, stats = adamw_update(params, g, state, cfg)
    assert float(stats["grad_norm"]) == pytest.approx(1e6)
    # the reference's update of the same inputs
    rcfg = ROptConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0, warmup_steps=0)
    want, _, _ = r_adamw_update({"w": jnp.zeros(3)}, {"w": jnp.array([1e6, 0.0, 0.0])},
                                r_init_opt_state({"w": jnp.zeros(3)}), rcfg)
    assert _rel(params["w"].numpy(), want["w"]) <= 1e-6


def test_lr_schedule_shape():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(lr_at(torch.tensor(0), cfg)) < 0.2
    assert float(lr_at(torch.tensor(9), cfg)) == pytest.approx(1.0, abs=0.01)
    assert float(lr_at(torch.tensor(99), cfg)) == pytest.approx(0.1, abs=0.02)


def test_train_step_reduces_loss():
    """Both packages overfit one batch for 8 steps from the same weights:
    the port's loss falls and follows the reference's within TRAJ_TOL."""
    cfg = CFGS["qwen2.5-3b"]
    batch = jax.tree.map(np.asarray, rm.random_batch(cfg, B, T, KEY))
    ref_step = jax.jit(r_build_train_step(cfg, ROptConfig(lr=5e-3, warmup_steps=0), remat=True,
                                          attn_block=BLOCK))
    rp, ropt, want = _ref_params(cfg), r_init_opt_state(_ref_params(cfg)), []
    params = _port_params(cfg)
    opt = init_opt_state(params)
    step = build_train_step(cfg, OptConfig(lr=5e-3, warmup_steps=0), remat=True,
                            attn_block=BLOCK)
    losses = []
    for _ in range(8):
        rp, ropt, rstats = ref_step(rp, ropt, _jnp(batch))
        want.append(float(rstats["loss"]))
        params, opt, stats = step(params, opt, _torch(batch))
        losses.append(float(stats["loss"]))
    assert losses[-1] < losses[0]
    assert max(abs(a - b) / abs(b) for a, b in zip(losses, want)) <= TRAJ_TOL


def test_microbatching_matches_full_batch_grads():
    cfg = CFGS["qwen3-4b"]
    params = _port_params(cfg)
    batch = _torch(jax.tree.map(np.asarray, rm.random_batch(cfg, B, T, KEY)))
    loss_fn = build_loss_fn(cfg, remat=False, attn_block=BLOCK)
    leaves = [p for _, p in tree_items(params)]
    for p in leaves:
        p.requires_grad_(True)
    g_full = torch.autograd.grad(loss_fn(params, batch), leaves)
    # mean of per-microbatch grads (equal sizes) == full-batch grad since the
    # loss is a token mean over equal-token microbatches
    g_acc = [torch.zeros_like(g) for g in g_full]
    for i in range(2):
        mb = {k: v.reshape((2, 2) + v.shape[1:])[i] for k, v in batch.items()}
        g = torch.autograd.grad(loss_fn(params, mb), leaves)
        g_acc = [a + b / 2 for a, b in zip(g_acc, g)]
    for p in leaves:
        p.requires_grad_(False)
    flat1 = torch.cat([x.ravel() for x in g_full])
    flat2 = torch.cat([x.ravel() for x in g_acc])
    assert float((flat1 - flat2).abs().max()) < 2e-5
    # build_value_and_grad's f32 accumulation is that sum; the full-batch
    # gradient is the reference's
    _, g_mb = build_value_and_grad(cfg, microbatches=2, remat=False, attn_block=BLOCK)(
        params, batch)
    got = torch.cat([g.ravel() for _, g in tree_items(g_mb)])
    assert float((got - flat2).abs().max()) <= 1e-7
    assert not any(p.requires_grad for p in leaves)  # the step leaves them as it found them
    _, want = _ref_value_and_grad(cfg)(_ref_params(cfg), _jnp(jax.tree.map(np.asarray, batch)))
    _assert_grads_close(tree_from_items(zip([path for path, _ in tree_items(params)], g_full)),
                        want)


def test_data_pipeline_determinism_and_packing():
    dc = DataConfig(vocab_size=1000, seq_len=64, global_batch=4, seed=7)
    ds = SyntheticTokens(dc)
    b1 = ds.batch_at(3)
    b2 = ds.batch_at(3)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 64)
    assert b1["tokens"].max() < 1000
    # different steps differ
    assert not np.array_equal(ds.batch_at(4)["tokens"], b1["tokens"])
    # extras for modality archs
    b3 = with_extras(b1, ARCHS["pixtral-12b"].reduced())
    assert "patches" in b3


def test_checkpoint_roundtrip(tmp_path):
    cfg = CFGS["rwkv6-1.6b"]
    params = init_params(cfg, 0, device=CPU)
    opt = init_opt_state(params)
    ck = Checkpointer(str(tmp_path), keep=2)
    state = {"params": params, "opt": opt}
    ck.save(10, state)
    ck.save(20, state, async_save=True)
    ck.wait()
    assert ck.all_steps() == [10, 20]
    example = {"params": param_specs(cfg), "opt": init_opt_state(param_specs(cfg))}
    step, restored = ck.restore(example, device=CPU)
    assert step == 20
    for (pa, a), (pb, b) in zip(tree_items(state), tree_items(restored)):
        assert pa == pb and a.dtype == b.dtype and b.device == CPU
        assert torch.equal(a, b)
    # GC keeps only `keep`
    ck.save(30, state)
    assert ck.all_steps() == [20, 30]


def test_checkpoint_atomicity(tmp_path):
    """A stray .tmp dir (simulated crash) must not be visible as a step."""
    ck = Checkpointer(str(tmp_path))
    os.makedirs(tmp_path / "step_00000099.tmp")
    assert ck.all_steps() == []
    ck.save(5, {"x": torch.ones(3)})
    assert ck.latest_step() == 5


# ----------------------------------------------------------------------
# Twin of tests/test_system.py::test_train_checkpoint_restart
# ----------------------------------------------------------------------
def test_train_checkpoint_restart(tmp_path):
    """Four steps, a checkpoint, a restore into fresh tensors, three more
    steps at the same stream position: the loss keeps dropping, the
    restored state is the saved one bit for bit, and the seven losses
    follow the reference's same program within TRAJ_TOL."""
    cfg = CFGS["qwen3-4b"]
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=3)
    ds = SyntheticTokens(dcfg)
    params = _port_params(cfg)
    opt = init_opt_state(params)
    step_fn = build_train_step(cfg, OptConfig(lr=3e-3, warmup_steps=0),
                               microbatches=2, attn_block=BLOCK)
    ck = Checkpointer(str(tmp_path))

    losses = []
    for step in range(4):
        batch = place(with_extras(ds.batch_at(step), cfg), CPU)
        params, opt, stats = step_fn(params, opt, batch)
        losses.append(float(stats["loss"]))
    ck.save(4, {"params": params, "opt": opt})

    # simulate restart: restore and continue at the same stream position
    example = {"params": param_specs(cfg), "opt": init_opt_state(param_specs(cfg))}
    _, restored = ck.restore(example, device=CPU)
    for (_, a), (_, b) in zip(tree_items({"params": params, "opt": opt}), tree_items(restored)):
        assert torch.equal(a, b)
    params2, opt2 = restored["params"], restored["opt"]
    for step in range(4, 7):
        batch = place(with_extras(ds.batch_at(step), cfg), CPU)
        params2, opt2, stats = step_fn(params2, opt2, batch)
        losses.append(float(stats["loss"]))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))

    rds = RSyntheticTokens(RDataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                                       seed=3))
    ref_step = jax.jit(r_build_train_step(cfg, ROptConfig(lr=3e-3, warmup_steps=0),
                                          microbatches=2, attn_block=BLOCK))
    rp, ropt, want = _ref_params(cfg), r_init_opt_state(_ref_params(cfg)), []
    for step in range(7):
        rp, ropt, rstats = ref_step(rp, ropt, _jnp(r_with_extras(rds.batch_at(step), cfg)))
        want.append(float(rstats["loss"]))
    assert max(abs(a - b) / abs(b) for a, b in zip(losses, want)) <= TRAJ_TOL


# ----------------------------------------------------------------------
# The port against the reference: schedule, update, gradients, data
# ----------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 9, 50, 99])
def test_lr_at_matches_reference(step):
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    rcfg = ROptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = lr_at(torch.tensor(step, dtype=torch.int32), cfg)
    want = r_lr_at(jnp.asarray(step, jnp.int32), rcfg)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-7


def test_adamw_update_matches_reference():
    """One update of a seeded tree at step 3, clipping active (|g| ~ 5):
    parameters, mu, nu, step, lr and grad_norm within 1e-6."""
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}

    def draw(scale=1.0, positive=False):
        def one(shape):
            x = rng.normal(size=shape).astype(np.float32) * scale
            return np.abs(x) if positive else x
        return jax.tree.map(one, shapes, is_leaf=lambda s: isinstance(s, tuple))

    p, g, mu, nu = draw(), draw(), draw(0.1), draw(0.01, positive=True)
    rstate = {"mu": jax.tree.map(jnp.asarray, mu), "nu": jax.tree.map(jnp.asarray, nu),
              "step": jnp.asarray(3, jnp.int32)}
    rcfg, cfg = ROptConfig(lr=1e-2, warmup_steps=2), OptConfig(lr=1e-2, warmup_steps=2)
    want_p, want_s, want_stats = r_adamw_update(jax.tree.map(jnp.asarray, p),
                                                jax.tree.map(jnp.asarray, g), rstate, rcfg)
    tt = functools.partial(jax.tree.map, torch.from_numpy)
    state = {"mu": tt(mu), "nu": tt(nu), "step": torch.tensor(3, dtype=torch.int32)}
    got_p, got_s, stats = adamw_update(tt(p), tt(g), state, cfg)
    assert float(want_stats["grad_norm"]) > cfg.clip_norm  # the clip is active
    for got, want in ((got_p, want_p), (got_s["mu"], want_s["mu"]), (got_s["nu"], want_s["nu"])):
        got, want = _port_flat(got), _ref_flat(want)
        for k in want:
            assert _rel(got[k], want[k]) <= 1e-6, k
    assert int(got_s["step"]) == int(want_s["step"]) == 4
    assert got_s["step"].dtype == torch.int32
    for k in ("lr", "grad_norm"):
        assert isinstance(stats[k], torch.Tensor)
        assert abs(float(stats[k]) - float(want_stats[k])) <= 1e-6 * max(1.0, float(want_stats[k]))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_grads_match_reference(name, overflow_spy):
    """The loss and every gradient leaf of the port's ``build_value_and_grad``
    (remat on: ``torch.utils.checkpoint`` per layer) against
    ``jax.grad(build_loss_fn(cfg, remat=False, attn_block=8))``; MoE at a
    capacity its experts overflow."""
    cfg = CFGS[name]
    batch = _batch(cfg)
    want_loss, want = _ref_value_and_grad(cfg)(_ref_params(cfg), _jnp(batch))
    loss, grads = build_value_and_grad(cfg, remat=True, attn_block=BLOCK)(
        _port_params(cfg), _torch(batch))
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * abs(float(want_loss))
    _assert_grads_close(grads, want)
    assert any(overflow_spy) == (cfg.moe is not None)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_loss_trajectory_matches_reference(name):
    """Three train steps of one batch (lr 5e-3, no warmup) in both packages:
    the losses within TRAJ_TOL relative."""
    cfg = CFGS[name]
    batch = _batch(cfg)
    rcfg, ocfg = ROptConfig(lr=5e-3, warmup_steps=0), OptConfig(lr=5e-3, warmup_steps=0)
    vg = _ref_value_and_grad(cfg)
    rp, ropt, want = _ref_params(cfg), r_init_opt_state(_ref_params(cfg)), []
    params = _port_params(cfg)
    opt = init_opt_state(params)
    step = build_train_step(cfg, ocfg, remat=True, attn_block=BLOCK)
    got = []
    for _ in range(3):
        loss, g = vg(rp, _jnp(batch))
        rp, ropt, _ = R_ADAMW_JIT(rp, g, ropt, rcfg)
        want.append(float(loss))
        params, opt, stats = step(params, opt, _torch(batch))
        got.append(float(stats["loss"]))
    assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) <= TRAJ_TOL
    assert got[-1] < got[0]


def test_moe_dispatch_gradient_on_overflow():
    """The overflow case of ``test_dispatch_row_matches_reference_on_overflow``
    under grad: the gates' gradient equals ``jax.grad``'s, where the
    overwritten assignment at slot c−1 gets none (JAX's scatter gives an
    overwritten update a zero cotangent)."""
    t, k, e, c = 16, 2, 8, 4
    rng = np.random.default_rng(5)
    idx = np.where(rng.random((t, k)) < 0.6, 0, rng.integers(1, e, (t, k))).astype(np.int32)
    idx[:, 1] = np.where(idx[:, 1] == idx[:, 0], (idx[:, 0] + 1) % e, idx[:, 1])
    gate = rng.random((t, k)).astype(np.float32)
    w = rng.normal(size=(e, c)).astype(np.float32)
    assert np.bincount(idx.ravel(), minlength=e).max() > c  # overflow
    want = jax.grad(lambda g: jnp.sum(r_dispatch_row(jnp.asarray(idx), g, e, c)[1] * w))(
        jnp.asarray(gate))
    g = torch.from_numpy(gate).requires_grad_(True)
    _, gates = tmoe._dispatch_row(torch.from_numpy(idx).long(), g, e, c)
    (got,) = torch.autograd.grad((gates * torch.from_numpy(w)).sum(), g)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,step,b,s", [(0, 0, 4, 64), (3, 5, 2, 16), (7, 123, 3, 4096)])
def test_synthetic_tokens_bit_for_bit(seed, step, b, s):
    got = SyntheticTokens(DataConfig(151_936, s, b, seed=seed)).batch_at(step)
    want = RSyntheticTokens(RDataConfig(151_936, s, b, seed=seed)).batch_at(step)
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for name in ("pixtral-12b", "seamless-m4t-large-v2", "qwen3-4b"):
        cfg = ARCHS[name].reduced()
        ge, we = with_extras(got, cfg, rng_seed=seed), r_with_extras(want, cfg, rng_seed=seed)
        assert sorted(ge) == sorted(we)
        for key in we:
            assert ge[key].dtype == we[key].dtype
            np.testing.assert_array_equal(ge[key], we[key])
    it = iter(SyntheticTokens(DataConfig(1000, 8, 2, seed=seed)))
    np.testing.assert_array_equal(next(it)["tokens"],
                                  RSyntheticTokens(RDataConfig(1000, 8, 2, seed=seed))
                                  .batch_at(0)["tokens"])


def test_place_keeps_dtypes():
    cfg = ARCHS["pixtral-12b"].reduced()
    batch = with_extras(SyntheticTokens(DataConfig(cfg.vocab_size, 8, 2)).batch_at(0), cfg)
    got = place(batch, "cpu")
    assert got["tokens"].dtype == torch.int32 and got["patches"].dtype == torch.float32
    assert np.array_equal(got["tokens"].numpy(), batch["tokens"])
    got["tokens"][0, 0] += 1  # a copy: the host batch is not touched
    assert got["tokens"][0, 0] != batch["tokens"][0, 0]


# ----------------------------------------------------------------------
# Checkpoints across the two packages, bf16, async
# ----------------------------------------------------------------------
def _ref_state(cfg):
    """The reference's {"params", "opt"} after one update (step 1, nonzero
    mu / nu)."""
    p = _ref_params(cfg)
    _, g = _ref_value_and_grad(cfg)(p, _jnp(_batch(cfg)))
    p, opt, _ = r_adamw_update(p, g, r_init_opt_state(p), ROptConfig(lr=1e-3, warmup_steps=0))
    return {"params": p, "opt": opt}


def test_checkpoint_reference_writes_port_restores(tmp_path):
    cfg = CFGS["qwen3-4b"]
    state = _ref_state(cfg)
    RCheckpointer(str(tmp_path)).save(7, state)
    example = {"params": param_specs(cfg), "opt": init_opt_state(param_specs(cfg))}
    step, got = Checkpointer(str(tmp_path)).restore(example, device=CPU)
    assert step == 7
    want = _ref_flat(state)
    flat = dict(tree_items(got))
    assert sorted("/".join(k) for k in flat) == sorted(want)
    for path, t in flat.items():
        w = want["/".join(path)]
        assert t.dtype == {np.dtype(np.float32): torch.float32,
                           np.dtype(np.int32): torch.int32}[w.dtype]
        np.testing.assert_array_equal(t.numpy(), w)
    # the restored tree is the port's: a train step takes it
    step_fn = build_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=0), attn_block=BLOCK)
    _, opt, stats = step_fn(got["params"], got["opt"], _torch(_batch(cfg)))
    assert np.isfinite(float(stats["loss"])) and int(opt["step"]) == 2


def test_checkpoint_port_writes_reference_restores(tmp_path):
    cfg = CFGS["granite-moe-3b-a800m"]
    rstate = _ref_state(cfg)
    nstate = jax.tree.map(np.asarray, rstate)
    state = {"params": params_from_numpy(cfg, nstate["params"], CPU),
             "opt": opt_state_from_numpy(cfg, nstate["opt"], CPU)}
    Checkpointer(str(tmp_path)).save(3, state)
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert manifest["step"] == 3 and manifest["complete"] and manifest["dtypes"] == {}
    step, got = RCheckpointer(str(tmp_path)).restore(jax.eval_shape(lambda: rstate))
    assert step == 3
    want, got = _ref_flat(rstate), _ref_flat(got)
    assert sorted(got) == sorted(want) == sorted(manifest["keys"])
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_checkpoint_bf16_roundtrip(tmp_path):
    """bf16 leaves are stored as f32 (exact; numpy has no bf16) and come
    back in bf16 bit for bit; the f32 optimizer state stays f32."""
    cfg = CFGS["zamba2-2.7b"]
    params, opt = init_train_state(cfg, 3, dtype=torch.bfloat16, device=CPU)
    for _, t in tree_items(opt["mu"]):
        t.normal_()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": params, "opt": opt})
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert set(manifest["dtypes"]) == {"params/" + "/".join(p) for p, _ in tree_items(params)}
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        assert z["params/embed"].dtype == np.float32
    _, got = ck.restore({"params": param_specs(cfg), "opt": init_opt_state(param_specs(cfg))},
                        device=CPU)
    for (_, a), (_, b) in zip(tree_items({"params": params, "opt": opt}), tree_items(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["opt"]["mu"]["embed"].dtype == torch.float32


def test_async_save_holds_values_before_inplace_step(tmp_path):
    """``save(async_save=True)`` then an in-place train step at once: the
    checkpoint holds the state at the save, not the step's update."""
    cfg = CFGS["qwen3-4b"]
    params = _port_params(cfg)
    opt = init_opt_state(params)
    step_fn = build_train_step(cfg, OptConfig(lr=1e-2, warmup_steps=0), attn_block=BLOCK)
    batch = _torch(_batch(cfg))
    params, opt, _ = step_fn(params, opt, batch)
    before = {k: v.clone() for k, v in tree_items({"params": params, "opt": opt})}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": params, "opt": opt}, async_save=True)
    params, opt, _ = step_fn(params, opt, batch)  # updates the saved tensors in place
    ck.wait()
    assert not torch.equal(params["embed"], before[("params", "embed")])
    _, got = ck.restore({"params": param_specs(cfg), "opt": init_opt_state(param_specs(cfg))},
                        device=CPU)
    for path, t in tree_items(got):
        assert torch.equal(t, before[path]), path
    assert int(got["opt"]["step"]) == 1


def test_opt_state_numpy_roundtrip():
    cfg = CFGS["seamless-m4t-large-v2"]
    ropt = jax.tree.map(np.asarray, _ref_state(cfg)["opt"])
    opt = opt_state_from_numpy(cfg, ropt, CPU)
    assert opt["step"].dtype == torch.int32 and opt["step"].shape == ()
    assert all(t.dtype == torch.float32 for _, t in tree_items({"mu": opt["mu"], "nu": opt["nu"]}))
    back, want = _ref_flat(opt_state_to_numpy(opt)), _ref_flat(ropt)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    bad = dict(ropt, mu={**ropt["mu"], "extra": np.zeros(3)})
    with pytest.raises(ValueError, match="mu"):
        opt_state_from_numpy(cfg, bad, CPU)


def test_microbatch_grads_accumulate_in_f32_for_bf16_params():
    cfg = CFGS["qwen3-4b"]
    params, _ = init_train_state(cfg, 0, dtype=torch.bfloat16, device=CPU)
    batch = _torch(_batch(cfg))
    _, g1 = build_value_and_grad(cfg, microbatches=1, attn_block=BLOCK)(params, batch)
    loss, g2 = build_value_and_grad(cfg, microbatches=2, attn_block=BLOCK)(params, batch)
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.bfloat16 for _, g in tree_items(g1))
    assert all(g.dtype == torch.float32 for _, g in tree_items(g2))


# ----------------------------------------------------------------------
# The launcher
# ----------------------------------------------------------------------
def test_train_launcher_smoke_on_cpu(capsys, tmp_path):
    out = ttrain.main(["--smoke", "--device", "cpu", "--steps", "3"])
    assert len(out["losses"]) == len(out["step_s"]) == 3
    assert all(np.isfinite(out["losses"]))
    assert out["peak_bytes"] is None and out["tokens_per_step"] == 4 * 64
    assert out["cuts"] == {}
    assert "step    2 loss" in capsys.readouterr().out


def test_train_launcher_checkpoint_on_the_mesh_restores_bit_for_bit(tmp_path):
    """The launcher's parameters and moments are DTensors (the 1x1 mesh):
    its checkpoint holds them whole, and a restore into DTensors placed on
    a new mesh gives them back bit for bit, placed as the example."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import distribute, param_pspecs
    from repro_torch.launch.mesh import smoke_mesh
    from repro_torch.models.common import ParamTree
    from repro_torch.train.optimizer import init_opt_state

    out = ttrain.main(["--smoke", "--device", "cpu", "--steps", "3", "--layers", "1",
                       "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    ck = Checkpointer(str(tmp_path))
    assert ck.all_steps() == [2]  # after the last step: the run's final state
    cfg = out["cfg"]
    with smoke_mesh("cpu") as mesh:
        params = init_params(cfg, 0, device="cpu")
        params = ParamTree(distribute(params.to_dict(), param_pspecs(cfg, params), mesh))
        step, got = ck.restore({"params": params, "opt": init_opt_state(params)})
    assert step == 2
    want = tree_items(out["state"])
    assert [p for p, _ in tree_items(got)] == [p for p, _ in want]
    n_dtensors = 0
    for (path, g), (_, w) in zip(tree_items(got), want):
        assert isinstance(g, DTensor) == isinstance(w, DTensor), path
        if isinstance(w, DTensor):  # all but the optimizer's step count
            assert g.placements == w.placements, path
            g, w = g.to_local(), w.to_local()
            n_dtensors += 1
        assert g.dtype == w.dtype and torch.equal(g, w), path
    assert n_dtensors == len(want) - 1


def test_train_launcher_cuts_are_printed(capsys):
    out = ttrain.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--steps", "1",
                       "--layers", "1", "--seq", "32", "--global-batch", "2",
                       "--microbatches", "1"])
    assert out["cuts"] == {"global_batch": (4, 2), "seq": (64, 32), "layers": (2, 1)}
    assert out["cfg"].n_layers == 1 and out["tokens_per_step"] == 64
    text = capsys.readouterr().out
    assert "cut: layers 2 -> 1" in text and "cut: seq 64 -> 32" in text


def test_train_launcher_multi_pod_raises():
    """--multi-pod needs a 512-rank world (2x16x16); one process raises and
    says so, before any group is made."""
    with pytest.raises(RuntimeError, match="512 ranks"):
        ttrain.main(["--smoke", "--device", "cpu", "--multi-pod"])


def test_train_launcher_under_torchrun_on_four_cpu_ranks():
    """The production path's set-up: ``torchrun``'s environment makes the
    default group (gloo, 4 CPU ranks; ``--mesh 2x2`` cuts the 16x16 mesh
    to the world), and every rank prints the one-process run's loss."""
    import re
    import subprocess
    import sys

    args = ["--smoke", "--device", "cpu", "--steps", "1", "--layers", "1", "--seq", "16",
            "--mesh", "2x2"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *args],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    losses = re.findall(r"step +0 loss +([0-9.]+)", out.stdout)
    want = ttrain.main(args[:-2])["losses"][0]
    assert losses == [f"{want:.4f}"] * 4, (losses, want)


@pytest.mark.parametrize("mesh", ["2x2", "1x1x1", "4"])
def test_train_launcher_mesh_must_fit_the_world(mesh):
    """--mesh cuts the 16x16 mesh to a world of its size: in one process
    a 2x2 mesh, or one of another rank, raises before any group is made."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="--mesh"):
        ttrain.main(["--smoke", "--device", "cpu", "--mesh", mesh])
    assert not dist.is_initialized()


def test_training_raises_without_cuda(monkeypatch, tmp_path):
    """No fallback hides the device: without CUDA the launcher, the state,
    the placement and a restore of a meta example raise unless asked for
    the CPU."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CFGS["qwen3-4b"]
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        place({"tokens": np.zeros((1, 2), np.int32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        ck.restore({"x": torch.empty(2, device="meta")})
    assert torch.equal(ck.restore({"x": torch.empty(2, device="meta")}, device="cpu")[1]["x"],
                       torch.ones(2))
