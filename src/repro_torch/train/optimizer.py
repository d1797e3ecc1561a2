"""AdamW with warmup + cosine schedule and global-norm clipping (port of
``repro.train.optimizer``).

The reference's math, not ``torch.optim.AdamW``'s: the gradients are
clipped by their global norm (``scale = min(1, clip / max(gnorm, 1e-9))``),
the bias corrections ``1 − b^(step+1)`` are taken in f32, and
``delta = mhat / (sqrt(nhat) + eps) + wd · p`` with weight decay on every
leaf (norms, biases and the embedding included, as the reference does).
mu and nu are f32 whatever the parameters' dtype; ``step`` is an int32
tensor on the parameters' device.  ``lr``, the clip scale and the norm stay
tensors, so an update makes no host sync.

Trees are nested mappings of tensors (a :class:`ParamTree` or dicts) under
the reference's keys.  :func:`adamw_update` updates parameters, mu, nu and
step **in place** (under ``torch.no_grad``; the port's analogue of the
reference's ``donate_argnums``) and returns them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.constraints import zeros_like
from repro_torch.models.common import Params, tree_from_items, tree_items


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    min_lr_ratio: float = 0.1


def init_opt_state(params: Params) -> Dict[str, Any]:
    """mu and nu (f32 zeros under the parameters' keys, as nested dicts,
    placed as the parameters are) and ``step`` (a 0-d int32 zero) on the
    parameters' device."""
    items = tree_items(params)
    # zeros_like: a DTensor parameter's moments take its placements
    zeros = [(path, zeros_like(p, torch.float32)) for path, p in items]
    return {
        "mu": tree_from_items(zeros),
        "nu": tree_from_items((path, z.clone()) for path, z in zeros),
        "step": torch.zeros((), dtype=torch.int32, device=items[0][1].device),
    }


def lr_at(step, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor, or an int): linear
    warmup, then a cosine down to ``min_lr_ratio`` of ``lr``."""
    step = torch.as_tensor(step)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.linalg.vector_norm(g, dtype=torch.float32).square()
                          for _, g in tree_items(tree)))


@torch.no_grad()
def adamw_update(
    params: Params, grads: Params, state: Dict[str, Any], cfg: OptConfig
) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``(params, state, {"lr", "grad_norm"})``, the
    parameters, mu, nu and step updated in place (``grads`` is read only)."""
    p_items = tree_items(params)
    paths = [path for path, _ in p_items]
    flat = {}
    for name in ("grads", "mu", "nu"):
        items = tree_items(grads if name == "grads" else state[name])
        if [path for path, _ in items] != paths:
            raise ValueError(f"adamw_update: the {name} tree's keys differ from the params'")
        flat[name] = [leaf for _, leaf in items]

    step = state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(step, cfg)
    b1c = 1 - cfg.b1 ** (step.float() + 1)
    b2c = 1 - cfg.b2 ** (step.float() + 1)
    for (_, p), g, mu, nu in zip(p_items, flat["grads"], flat["mu"], flat["nu"]):
        g = g.float() * scale
        mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu.mul_(cfg.b2).add_(g.square_(), alpha=1 - cfg.b2)
        delta = (mu / b1c).div_((nu / b2c).sqrt_().add_(cfg.eps))
        pf = p.float()
        delta.add_(pf, alpha=cfg.weight_decay)
        p.copy_(pf - delta.mul_(lr))
    step.add_(1)
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, {
        "lr": lr, "grad_norm": gnorm}
