"""Weights and decode state across the package boundary: the reference's
parameter pytree and decode caches as nested dicts of numpy arrays, in and
out of the port.

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


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any], device,
                      dtype: Optional[torch.dtype] = None) -> ParamTree:
    """The reference's parameter pytree (nested dicts of arrays) as the
    port's :class:`ParamTree` on ``device`` (in ``dtype``, or the arrays'
    own).  Raises ``ValueError`` unless the tree has exactly the keys and
    shapes of ``cfg``'s parameters."""
    specs = param_specs(cfg).to_dict()

    def convert(node, spec, path):
        if isinstance(spec, Mapping):
            if not isinstance(node, Mapping) or set(node) != set(spec):
                have = sorted(node) if isinstance(node, Mapping) else type(node).__name__
                raise ValueError(f"params_from_numpy {cfg.name}: {path or 'root'} has "
                                 f"{have}, expected {sorted(spec)}")
            return {k: convert(node[k], spec[k], f"{path}.{k}".lstrip(".")) for k in spec}
        if tuple(np.shape(node)) != tuple(spec.shape):
            raise ValueError(f"params_from_numpy {cfg.name}: {path} has shape "
                             f"{np.shape(node)}, expected {tuple(spec.shape)}")
        return _to_tensor(node, device, dtype)

    return ParamTree(convert(tree, specs, ""))


def params_to_numpy(params: ParamTree) -> Dict[str, Any]:
    """The port's parameters as nested dicts of numpy arrays."""
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
