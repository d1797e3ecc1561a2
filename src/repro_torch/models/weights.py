"""Weights, optimizer state and decode state across the package boundary:
the reference's parameter pytree, optimizer state and decode caches as
nested dicts of numpy arrays, in and out of the port.

A PyTorch generator cannot draw JAX's numbers, so the parity tests draw
the reference's parameters with its own ``init_params``, convert them with
``jax.tree.map(np.asarray, ...)`` and carry them over here.  bfloat16
arrays (numpy's ``ml_dtypes`` type) go through float32, which holds them
exactly.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .common import ParamTree
from .config import ModelConfig
from .model import param_specs


def _to_tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(a, dtype=np.float32 if bf16 else a.dtype))  # a writable copy
    return t.to(device=device, dtype=dtype or (torch.bfloat16 if bf16 else t.dtype))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tree_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any], device,
                     dtype: Optional[torch.dtype], what: str) -> Dict[str, Any]:
    """Nested dicts of tensors from a tree under ``cfg``'s parameter keys;
    raises ``ValueError`` unless it has exactly those keys and shapes."""
    specs = param_specs(cfg).to_dict()

    def convert(node, spec, path):
        if isinstance(spec, Mapping):
            if not isinstance(node, Mapping) or set(node) != set(spec):
                have = sorted(node) if isinstance(node, Mapping) else type(node).__name__
                raise ValueError(f"{what} {cfg.name}: {path or 'root'} has "
                                 f"{have}, expected {sorted(spec)}")
            return {k: convert(node[k], spec[k], f"{path}.{k}".lstrip(".")) for k in spec}
        if tuple(np.shape(node)) != tuple(spec.shape):
            raise ValueError(f"{what} {cfg.name}: {path} has shape "
                             f"{np.shape(node)}, expected {tuple(spec.shape)}")
        return _to_tensor(node, device, dtype)

    return convert(tree, specs, "")


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any], device,
                      dtype: Optional[torch.dtype] = None) -> ParamTree:
    """The reference's parameter pytree (nested dicts of arrays) as the
    port's :class:`ParamTree` on ``device`` (in ``dtype``, or the arrays'
    own).  Raises ``ValueError`` unless the tree has exactly the keys and
    shapes of ``cfg``'s parameters."""
    return ParamTree(_tree_from_numpy(cfg, tree, device, dtype, "params_from_numpy"))


def opt_state_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any], device) -> Dict[str, Any]:
    """The reference's optimizer state (``{"mu", "nu", "step"}``, mu and nu
    under the parameters' keys) as the port's: mu and nu f32 nested dicts,
    ``step`` a 0-d int32 tensor, on ``device``.  Raises ``ValueError`` on
    other keys or shapes."""
    return {
        "mu": _tree_from_numpy(cfg, tree["mu"], device, torch.float32, "opt_state_from_numpy mu"),
        "nu": _tree_from_numpy(cfg, tree["nu"], device, torch.float32, "opt_state_from_numpy nu"),
        "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32, device=device),
    }


def opt_state_to_numpy(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's optimizer state as nested dicts of numpy arrays, ``step``
    a 0-d int32 array."""
    return {"mu": params_to_numpy(state["mu"]), "nu": params_to_numpy(state["nu"]),
            "step": np.asarray(int(state["step"]), dtype=np.int32)}


def params_to_numpy(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's parameters (or any tree of tensors under their keys) as
    nested dicts of numpy arrays."""
    return {k: params_to_numpy(v) if isinstance(v, Mapping) else _to_numpy(v)
            for k, v in params.items()}


def cache_from_numpy(cache: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """A decode cache of the reference's layout (``k``/``v``, ``tm_last``,
    ``conv``/``s``/``ak``/``av``, ``xk``/``xv``/``src_len``, ``pos``) on
    ``device``, each array in its own dtype."""
    return {k: _to_tensor(v, device, None) for k, v in cache.items()}


def cache_to_numpy(cache: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A decode cache as numpy arrays (bfloat16 as float32)."""
    return {k: _to_numpy(v) for k, v in cache.items()}
