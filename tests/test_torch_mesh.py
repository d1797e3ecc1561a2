"""Multi-rank numerics of the port's production-mesh layer on CPU ranks.

One ``torch.multiprocessing`` spawn of 4 gloo ranks (a ``FileStore`` under
``tmp_path``: no port) runs three meshes in turn, (data 2, model 2),
(pod 2, data 1, model 2) (run on its (dp, model) view, ``model_mesh``) and
(data 1, model 4), the last with the reduced configs' 2 KV heads under 4-way
TP (the sequence-sharded decode cache).  On
each, every reduced arch, its parameters the reference's (``init_params``,
carried by ``params_from_numpy``) placed by ``param_pspecs``, its batch by
``batch_pspecs``:

* one train step: ``build_value_and_grad`` (2 microbatches of a 4 × 16
  batch) then ``adamw_update``;
* a prefill of 12 tokens (caches placed by ``cache_pspecs``) and 3 greedy
  decode steps.

After the meshes the same ranks run the launchers' ``main`` on cuts of the
production mesh of the world's size: ``launch.train`` on ``--mesh 2x2``
(with a checkpoint every step) and ``--multi-pod --mesh 2x1x2``,
``launch.serve`` on ``--mesh 2x2``.  The parent holds them to the same
launchers in one process (the 1×1 mesh): losses within 1e-5 relative,
parameters within 2·lr, tokens equal; the 2x2 run's checkpoint equals that
run's final state bit for bit.

Meanwhile the parent computes the reference on CPU JAX (``jax.value_and_grad``
over the same microbatches, ``adamw_update``, prefill and decode) and holds
the port to it, with the tolerances of ``tests/test_torch_train.py`` and
``tests/test_torch_models.py``, chosen before the first run (f32):
loss within 1e-5 relative; each gradient leaf (``full_tensor()``) within
1e-4 of that leaf's max; parameters after the step within 2·lr (Adam turns
a 1e-7 difference in a near-zero gradient into a sign); logits within 1e-5
of max(1, max |logit|); decoded tokens equal.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro.models as rm
from repro.configs import ARCHS
from repro.models import decode as rdec
from repro.train import OptConfig as ROptConfig
from repro.train import adamw_update as r_adamw_update
from repro.train import init_opt_state as r_init_opt_state
from repro.train import lr_at as r_lr_at

MESHES = (((2, 2), ("data", "model")), ((2, 1, 2), ("pod", "data", "model")),
          ((1, 4), ("data", "model")))
WORLD = 4
B, T, M, BLOCK = 4, 16, 2, 8
T0, STEPS = 12, 3
LOSS_TOL, GRAD_TOL, LOGIT_TOL = 1e-5, 1e-4, 1e-5
NAMES = sorted(ARCHS)
CACHE_SEQ = ("k", "v", "ak", "av", "xk", "xv")
# the launchers at a small cut: 1 layer, 2 steps of 4 x 16 tokens
TRAIN_ARGS = ["--smoke", "--device", "cpu", "--steps", "2", "--layers", "1", "--seq", "16"]
SERVE_ARGS = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--prompt", "8", "--gen", "3"]
LAUNCHER_MESHES = {"2x2": ["--mesh", "2x2"], "2x1x2": ["--multi-pod", "--mesh", "2x1x2"]}


def _cfgs(name):
    """(train config, serve config): the reduced arch; serving MoE at
    capacity 8 (no token dropped, as tests/test_torch_models.py)."""
    cfg = ARCHS[name].reduced()
    serve = cfg
    if cfg.moe:
        serve = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg, serve


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (B, T), dtype=np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(B, T, cfg.frontend_dim)).astype(np.float32)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _prompt(batch):
    return {k: (v[:, :T0] if k in ("tokens", "frames") else v) for k, v in batch.items()}


# ----------------------------------------------------------------------
# the reference (parent process, CPU JAX)
# ----------------------------------------------------------------------
def _reference(name, params_np):
    cfg, serve = _cfgs(name)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    params = jax.tree.map(jnp.asarray, params_np)
    vg = jax.jit(jax.value_and_grad(rm.build_loss_fn(cfg, remat=False, attn_block=BLOCK)))
    loss, grads = 0.0, None
    for i in range(M):
        mb = {k: v[i * B // M : (i + 1) * B // M] for k, v in batch.items()}
        l, g = vg(params, mb)
        loss = loss + l / M
        grads = jax.tree.map(lambda a: a / M, g) if grads is None else jax.tree.map(
            lambda a, b: a + b / M, grads, g)
    grads = jax.tree.map(lambda g: g.astype(jnp.float32), grads)
    new_p, _, _ = r_adamw_update(params, grads, r_init_opt_state(params), ROptConfig())
    out = {"loss": float(loss), **{f"grad/{k}": v for k, v in _flat(grads).items()},
           **{f"param/{k}": v for k, v in _flat(new_p).items()}}
    logits, cache = rdec.prefill(serve, params, batch["tokens"][:, :T0], extra=_prompt(batch),
                                 remat=False, attn_block=BLOCK, cache_dtype=jnp.float32)
    for kk in CACHE_SEQ:
        if kk in cache:
            padw = [(0, 0)] * cache[kk].ndim
            padw[2] = (0, STEPS)
            cache[kk] = jnp.pad(cache[kk], padw)
    out["logits/0"] = np.asarray(logits)
    decode = rm.build_decode_fn(serve)
    toks = []
    for i in range(STEPS):
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok)
        out[f"logits/{i + 1}"] = np.asarray(logits)
    out["tokens"] = np.concatenate(toks, axis=1)
    return out


# ----------------------------------------------------------------------
# the port (spawned ranks)
# ----------------------------------------------------------------------
def _rank(rank, store_path, work):
    import repro_torch.models.decode as tdec
    from repro_torch import configs
    from repro_torch.distributed.constraints import active_mesh, mesh_axis_size
    from repro_torch.models.decode import pad_caches
    from repro_torch.distributed.sharding import (
        batch_pspecs, cache_pspecs, distribute, param_pspecs, to_spec)
    from repro_torch.launch.mesh import model_mesh
    from repro_torch.models import build_decode_fn
    from repro_torch.models.common import ParamTree, tree_items
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.train import OptConfig, adamw_update, build_value_and_grad
    from repro_torch.train.optimizer import init_opt_state
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD)
    cpu = torch.device("cpu")

    def full(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach().float().numpy()

    def place(tree, specs, mesh):
        return {k: to_spec(v, specs[k], mesh) for k, v in tree.items()}

    for mi, (shape, names) in enumerate(MESHES):
        mesh = model_mesh(init_device_mesh("cpu", shape, mesh_dim_names=names))
        for name in NAMES:
            cfg = configs.get(name).reduced()
            serve = cfg
            if cfg.moe:
                serve = dataclasses.replace(
                    cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
            params_np = dict(np.load(os.path.join(work, f"params_{name}.npz")))
            tree = {}
            for k, v in params_np.items():
                node = tree
                *head, last = k.split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[last] = v
            host = params_from_numpy(cfg, tree, cpu)
            params = ParamTree(distribute(host.to_dict(), param_pspecs(cfg, host), mesh))
            batch_np = _batch(cfg)
            cell = ShapeCell("mesh_test", T, B, "train")
            batch = place({k: torch.from_numpy(v) for k, v in batch_np.items()},
                          batch_pspecs(cfg, cell, mesh), mesh)
            out = {}
            with active_mesh(mesh):
                # serving first: the train step below updates the parameters in place
                logits, cache = tdec.prefill(serve, params, batch["tokens"][:, :T0],
                                             extra=_prompt(batch), remat=False,
                                             attn_block=BLOCK, cache_dtype=torch.float32)
                cache = pad_caches(cache, STEPS, multiple=mesh_axis_size("model"))
                cache = place(cache, cache_pspecs(serve, cell, mesh, cache), mesh)
                out["logits/0"] = full(logits)
                decode = build_decode_fn(serve)
                toks = []
                for i in range(STEPS):
                    tok = logits[:, -1:].argmax(-1).to(torch.int32)
                    toks.append(full(tok).astype(np.int32))
                    logits, cache = decode(params, cache, tok)
                    out[f"logits/{i + 1}"] = full(logits)
                out["tokens"] = np.concatenate(toks, axis=1)
                loss, grads = build_value_and_grad(cfg, M, remat=True, attn_block=BLOCK)(
                    params, batch)
                out["loss"] = full(loss)
                for path, g in tree_items(grads):
                    out["grad/" + "/".join(path)] = full(g)
                new_p, _, _ = adamw_update(params, grads, init_opt_state(params), OptConfig())
                for path, p in tree_items(new_p):
                    out["param/" + "/".join(path)] = full(p)
            if rank == 0:
                np.savez(os.path.join(work, f"port_{mi}_{name}.npz"), **out)

    # the launchers on cuts of the production mesh of this world's size
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    for tag, extra in LAUNCHER_MESHES.items():
        ck = ["--ckpt-dir", os.path.join(work, "ckpt"), "--ckpt-every", "1"] if tag == "2x2" else []
        res = ttrain.main(TRAIN_ARGS + extra + ck)
        out = {"losses": np.asarray(res["losses"])}
        for path, p in tree_items(res["state"]["params"]):
            out["param/" + "/".join(path)] = full(p)
        if rank == 0:
            np.savez(os.path.join(work, f"train_{tag}.npz"), **out)
    res = tserve.main(SERVE_ARGS + ["--mesh", "2x2"])
    if rank == 0:
        np.save(os.path.join(work, "serve_2x2.npy"), res["tokens"])
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn of the 4 ranks (every case below), the reference on CPU
    JAX meanwhile: (work dir, {arch: reference results})."""
    work = str(tmp_path_factory.mktemp("mesh"))
    key = jax.random.PRNGKey(0)
    ref_params = {}
    for name in NAMES:
        cfg, _ = _cfgs(name)
        ref_params[name] = jax.tree.map(np.asarray, rm.init_params(cfg, key))
        np.savez(os.path.join(work, f"params_{name}.npz"), **_flat(ref_params[name]))
    ctx = mp.start_processes(_rank, args=(os.path.join(work, "store"), work), nprocs=WORLD,
                             join=False, start_method="spawn")
    want = {name: _reference(name, ref_params[name]) for name in NAMES}
    while not ctx.join(timeout=600):
        pass
    return work, want


def test_meshes_match_reference_on_four_cpu_ranks(spawned):
    work, want = spawned
    lr = float(r_lr_at(0, ROptConfig()))
    for mi in range(len(MESHES)):
        for name in NAMES:
            got = dict(np.load(os.path.join(work, f"port_{mi}_{name}.npz")))
            w = want[name]
            where = (MESHES[mi][0], name)
            assert sorted(got) == sorted(w), where
            assert abs(float(got["loss"]) - w["loss"]) <= LOSS_TOL * abs(w["loss"]), where
            for k, wv in w.items():
                if k.startswith("grad/"):
                    err, scale = np.abs(got[k] - wv).max(), np.abs(wv).max()
                    assert err <= GRAD_TOL * scale, (where, k, err, scale)
                elif k.startswith("param/"):
                    assert np.abs(got[k] - wv).max() <= 2 * lr, (where, k)
                elif k.startswith("logits/"):
                    err = np.abs(got[k] - wv).max() / max(1.0, np.abs(wv).max())
                    assert err <= LOGIT_TOL, (where, k, err)
            np.testing.assert_array_equal(got["tokens"], w["tokens"], err_msg=str(where))


def test_launchers_on_cuts_of_the_production_mesh_on_four_cpu_ranks(spawned):
    """``launch.train`` and ``launch.serve``'s ``main`` on 4 ranks (2x2 and
    2x1x2) against the same launchers in one process (1x1), and the 2x2
    run's checkpoint, written by rank 0, against that run's state."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.models.common import tree_items

    work, _ = spawned
    one = ttrain.main(TRAIN_ARGS)
    sched = ROptConfig(warmup_steps=5, total_steps=10)  # the launcher's, at 2 steps
    lr = float(r_lr_at(0, sched)) + float(r_lr_at(1, sched))
    for tag in LAUNCHER_MESHES:
        got = dict(np.load(os.path.join(work, f"train_{tag}.npz")))
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_TOL, err_msg=tag)
        for path, p in tree_items(one["state"]["params"]):
            k = "param/" + "/".join(path)
            assert np.abs(got[k] - p.to_local().numpy()).max() <= 2 * lr, (tag, k)
    ck = Checkpointer(os.path.join(work, "ckpt"))
    assert ck.all_steps() == [1]
    with np.load(os.path.join(work, "ckpt", "step_00000001", "arrays.npz")) as z:
        stored = {k: z[k] for k in z.files}
    got = dict(np.load(os.path.join(work, "train_2x2.npz")))
    for k, v in got.items():
        if k.startswith("param/"):
            np.testing.assert_array_equal(stored["params/" + k[len("param/"):]], v, err_msg=k)
    tokens = np.load(os.path.join(work, "serve_2x2.npy"))
    np.testing.assert_array_equal(tokens, tserve.main(SERVE_ARGS)["tokens"])
