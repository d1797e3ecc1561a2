"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``).

Real corpora are unavailable offline; the pipeline is nevertheless a real
pipeline: documents of power-law length are generated from a seeded
generator, packed into fixed-length sequences with EOS boundaries, batched,
and placed on a device (host → device transfer is the same code path a
file-backed loader would use).  Steps are reproducible from (seed, step)
alone, which is what checkpoint-restart resumption keys off.

``DataConfig``, ``SyntheticTokens`` and ``with_extras`` are the reference's
numpy code unchanged, so every ``(seed, step)`` gives the reference's
tokens bit for bit.  ``place(batch, device, shardings, mesh)`` is the
reference's ``place(batch, shardings)``: DTensors on the mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.transformer import resolve_device


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: float = 512.0


class SyntheticTokens:
    """Packed-document token stream; ``batch_at(step)`` is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _docs(self, rng: np.random.Generator, n_tokens: int) -> np.ndarray:
        out = np.empty(n_tokens, dtype=np.int32)
        i = 0
        while i < n_tokens:
            ln = int(min(max(8, rng.pareto(1.5) * self.cfg.mean_doc_len), 8192))
            ln = min(ln, n_tokens - i)
            out[i : i + ln] = rng.integers(
                1, self.cfg.vocab_size, size=ln, dtype=np.int32
            )
            if i + ln < n_tokens:
                out[i + ln - 1] = self.cfg.eos_id
            i += ln
        return out

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.cfg.seed, step))
        n = self.cfg.global_batch * self.cfg.seq_len
        toks = self._docs(rng, n).reshape(self.cfg.global_batch, self.cfg.seq_len)
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def with_extras(batch: Dict[str, np.ndarray], cfg_model, rng_seed: int = 0):
    """Add stub modality inputs (patches/frames) for vlm/audio families."""
    rng = np.random.default_rng(rng_seed)
    b, s = batch["tokens"].shape
    out = dict(batch)
    if cfg_model.family == "vlm":
        out["patches"] = rng.normal(
            size=(b, cfg_model.frontend_len, cfg_model.frontend_dim)
        ).astype(np.float32)
    if cfg_model.family == "audio":
        out["frames"] = rng.normal(size=(b, s, cfg_model.frontend_dim)).astype(
            np.float32
        )
    return out


def place(batch: Dict[str, np.ndarray], device=None, shardings=None, mesh=None
          ) -> Dict[str, torch.Tensor]:
    """Host batch → tensors on ``device`` (the first CUDA device by default;
    raises without one), each in its array's dtype: int32 tokens, f32
    patches / frames.  With ``shardings`` ({key: spec}, e.g.
    ``sharding.batch_pspecs``) and ``mesh``, each becomes a DTensor placed
    by its spec (the reference's ``place(batch, shardings)``)."""
    device = resolve_device(device)
    out = {k: torch.tensor(v, device=device) for k, v in batch.items()}
    if shardings is None:
        return out
    from repro_torch.distributed.sharding import to_spec

    return {k: to_spec(v, shardings[k], mesh) for k, v in out.items()}
