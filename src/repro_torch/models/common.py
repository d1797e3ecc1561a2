"""Shared neural building blocks (port of ``repro.models.common``).

Norms, RoPE, the MLPs, the loss, the parameter draws and the parameter
tree.  Two of JAX's defaults are kept on purpose: ``jax.nn.gelu`` is the
tanh approximation, and ``jnp.var`` the population variance.

Parameters are drawn through a :class:`Draw` (generator, dtype, device and
a leading stack shape: the reference's ``vmap`` over layer keys leaves
every per-layer tensor stacked on a leading L axis, and a draw with
``stack=(L,)`` draws it so).  A PyTorch generator cannot draw JAX's
numbers: parity with the reference goes through
:func:`repro_torch.models.weights.params_from_numpy`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Params = Mapping[str, Any]  # a dict of tensors / subtrees, or a ParamTree node


# ----------------------------------------------------------------------
# Parameter tree and draws
# ----------------------------------------------------------------------
class ParamTree(nn.Module):
    """A node of the parameter tree: tensors as parameters, subtrees as
    child modules, under the reference's pytree keys (``embed``,
    ``layers.attn.wq``, ``encoder.layers``, ...), so ``state_dict()`` names
    are the reference's paths joined by dots.  Indexed like the
    reference's dicts (``p["wq"]``, ``"bq" in p``, ``p.get("lm_head")``).

    Parameters are made with ``requires_grad=False``: serving needs no
    graph (and the flash kernel has no backward pass); training turns it
    on where it wants gradients."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, v if isinstance(v, ParamTree) else ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: object) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._parameters) + len(self._modules)

    def keys(self):
        return [*self._parameters, *self._modules]

    def values(self):
        return [self[k] for k in self.keys()]

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def to_dict(self) -> Dict[str, Any]:
        """Nested dicts of the tensors (the reference's pytree layout)."""
        return {k: v.to_dict() if isinstance(v, ParamTree) else v.data
                for k, v in self.items()}


Mapping.register(ParamTree)  # indexed, iterated and tested like the reference's dicts


def tree_index(tree: Params, i) -> Dict[str, Any]:
    """Layer ``i`` of a stacked tree: every tensor indexed on its leading
    axis (views; what the reference's ``lax.scan`` hands each step)."""
    return {k: tree_index(v, i) if isinstance(v, Mapping) else v[i]
            for k, v in tree.items()}


def tree_items(tree: Params, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf of a nested mapping, keys sorted at each
    level: the order in which ``jax.tree_util`` flattens the reference's
    dicts."""
    out = []
    for k in sorted(tree.keys()):
        v = tree[k]
        if isinstance(v, Mapping):
            out += tree_items(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def tree_from_items(items) -> Dict[str, Any]:
    """Nested dicts from (path, leaf) pairs (the inverse of :func:`tree_items`)."""
    out: Dict[str, Any] = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


@dataclass(frozen=True)
class Draw:
    """How parameters are drawn: the generator (on ``device``'s type), the
    tensors' dtype and device, and a leading ``stack`` shape.  On the
    ``meta`` device nothing is drawn or allocated (``gen`` may be None)."""

    gen: Optional[torch.Generator]
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")
    stack: Tuple[int, ...] = ()

    def stacked(self, n: int) -> "Draw":
        return replace(self, stack=(n,) + self.stack)

    def normal(self, shape: Tuple[int, ...], scale: float) -> torch.Tensor:
        shape = self.stack + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        return torch.randn(shape, generator=self.gen, dtype=self.dtype,
                           device=self.device) * scale

    def full(self, shape: Tuple[int, ...], value: float) -> torch.Tensor:
        return torch.full(self.stack + tuple(shape), value, dtype=self.dtype,
                          device=self.device)


def dense_init(draw: Draw, shape: Tuple[int, ...], scale: Optional[float] = None):
    fan_in = shape[0]
    return draw.normal(shape, scale if scale is not None else fan_in**-0.5)


def embed_init(draw: Draw, vocab: int, d: int):
    return draw.normal((vocab, d), 0.02)


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)  # jnp.var: the population variance
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, p: Params, kind: str, eps: float) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"], eps)
    return rmsnorm(x, p["scale"], eps)


def norm_params(draw: Draw, d: int, kind: str) -> Dict[str, torch.Tensor]:
    p = {"scale": draw.full((d,), 1.0)}
    if kind == "layernorm":
        p["bias"] = draw.full((d,), 0.0)
    return p


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, Dh); positions: broadcastable to (..., T)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # (Dh/2,)
    ang = positions[..., None].float() * freqs  # (..., T, Dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2 :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------
def mlp_params(draw: Draw, d: int, f: int, kind: str) -> Dict[str, torch.Tensor]:
    if kind == "swiglu":
        return {
            "w_gate": draw.normal((d, f), d**-0.5),
            "w_up": draw.normal((d, f), d**-0.5),
            "w_down": draw.normal((f, d), f**-0.5),
        }
    return {
        "w_up": draw.normal((d, f), d**-0.5),
        "b_up": draw.full((f,), 0.0),
        "w_down": draw.normal((f, d), f**-0.5),
        "b_down": draw.full((d,), 0.0),
    }


def mlp_apply(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        g = F.silu(x @ p["w_gate"])
        return (g * (x @ p["w_up"])) @ p["w_down"]
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")  # jax.nn.gelu's default
    return h @ p["w_down"] + p["b_down"]


# ----------------------------------------------------------------------
# Losses
# ----------------------------------------------------------------------
def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean token cross-entropy in fp32; labels < 0 are ignored."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - ll
    valid = (labels >= 0).float()
    if mask is not None:
        valid = valid * mask.float()
    return (nll * valid).sum() / valid.sum().clamp(min=1.0)
