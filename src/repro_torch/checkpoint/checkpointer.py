"""Checkpoint/restart: atomic, versioned, optionally async (port of
``repro.checkpoint.checkpointer``).

Layout, the reference's: ``<dir>/step_<n>/arrays.npz`` + ``manifest.json``
(step, keys, complete).  Writes go to a tmp dir then ``os.replace`` (atomic
on POSIX), so a crash mid-save never corrupts the latest checkpoint, and
the restore path always loads the newest *complete* step.  ``keep`` bounds
retained checkpoints.

The npz keys are the reference's: tree paths joined by ``/``
(``params/layers/attn/wq``, ``opt/mu/embed``, ``opt/step``), so a
checkpoint written by either package restores in the other.  numpy has no
bfloat16: a bf16 leaf is stored as f32 (exact) and the manifest's
``dtypes`` records it, so restore gives it back in bf16.

``async_save`` copies every tensor to the host **before** it returns (the
train step updates parameters and optimizer state in place, so a copy
taken later would record a later step) and runs the serialization on a
worker thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import ParamTree, tree_items
from repro_torch.models.transformer import resolve_device

def _host_copy(t) -> np.ndarray:
    """A host copy that no later in-place update of ``t`` can reach."""
    if not isinstance(t, torch.Tensor):
        return np.array(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()  # a new tensor: exact in f32
    return t.to("cpu", copy=True).numpy()


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """The reference's flat keys → host arrays, and the keys stored in
    another dtype than the tensor's (bf16 → f32) with that dtype."""
    flat, dtypes = {}, {}
    for path, leaf in tree_items(tree):
        key = "/".join(path)
        flat[key] = _host_copy(leaf)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            dtypes[key] = "bfloat16"
    return flat, dtypes


def _unflatten(example, flat: Dict[str, np.ndarray], dtypes: Dict[str, str], device,
               prefix: Tuple[str, ...] = ()):
    """``example``'s structure (a :class:`ParamTree` node stays one) with
    the stored arrays as tensors, each in its stored dtype, on ``device``
    or else on the example leaf's (a ``meta`` leaf: the first CUDA
    device)."""
    out = {}
    for k in example.keys():
        leaf, path = example[k], prefix + (k,)
        if isinstance(leaf, Mapping):
            out[k] = _unflatten(leaf, flat, dtypes, device, path)
            continue
        key = "/".join(path)
        arr = flat[key]
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(arr.shape) != want:
            raise ValueError(f"checkpoint {key}: shape {arr.shape}, expected {want}")
        dev = device
        if dev is None:
            dev = getattr(leaf, "device", None)
            dev = resolve_device(None if dev is None or dev.type == "meta" else dev)
        t = torch.from_numpy(arr)  # the stored dtype; bf16 was stored as f32
        out[k] = t.to(device=dev, dtype=torch.bfloat16 if dtypes.get(key) == "bfloat16" else None)
    return ParamTree(out) if isinstance(example, ParamTree) else out


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state, async_save: bool = False) -> None:
        # host copies first, synchronously: the next step updates in place
        flat, dtypes = _flatten(state)
        if async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, dtypes), daemon=True,
                name="checkpoint-writer")
            self._thread.start()
        else:
            self._write(step, flat, dtypes)

    def _write(self, step: int, flat: Dict[str, np.ndarray], dtypes: Dict[str, str]) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "complete": True,
            "dtypes": dtypes,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                man = os.path.join(self.dir, name, "manifest.json")
                if os.path.exists(man):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, example, step: Optional[int] = None, device=None) -> Tuple[int, Any]:
        """``(step, tree)``: the checkpoint at ``step`` (the latest by
        default) in ``example``'s structure and shapes (its leaves may be
        ``meta`` tensors, the analogue of ``jax.eval_shape``), in new
        tensors of the stored dtypes."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        folder = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(folder, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(folder, "manifest.json")) as f:
            dtypes = json.load(f).get("dtypes", {})  # the reference writes none
        return step, _unflatten(example, flat, dtypes,
                                None if device is None else torch.device(device))
