"""Roofline accounting (port of ``repro.launch.roofline``): analytic
MODEL_FLOPS per cell and the dry run's three roofline terms.

MODEL_FLOPS (useful flops, paper-standard formulas):
  train    6 · N_active · tokens            (fwd 2× + bwd 4×)
  prefill  2 · N_active · tokens  (+ attention O(T²) term)
  decode   2 · N_active · batch   (+ attention O(S) KV term per step)

:func:`terms` turns a rank's counted flops, bytes and collective bytes
(:mod:`repro_torch.launch.hlocost`) into seconds at the card's rates: the
compute and memory rates are the measured ``h100`` row of
:data:`repro_torch.workloads.costs.CALIBRATIONS` (dense bf16 matmul and a
device copy, ``chip_smoke.py`` phase 10); the collective rate is a data-sheet
figure, since one card measures no link: NVLink 4 of the H100 SXM, 450 GB/s
in each direction.  The reference's TPU rates do not carry over.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.workloads.costs import CALIBRATIONS

PEAK_FLOPS = CALIBRATIONS["h100"].flop_rate  # measured bf16 matmul rate, flop/s
HBM_BW = CALIBRATIONS["h100"].mem_bw  # measured device-copy bandwidth, B/s
NVLINK_BW = 450e9  # H100 SXM data sheet: NVLink 4, 450 GB/s per direction


def _attn_flops_train(cfg: ModelConfig, tokens_per_seq: int, n_seqs: int) -> float:
    """Exact causal attention flops (qkᵀ + pv), true head count, fwd only."""
    if cfg.family == "ssm":
        # linear attention state ops: T · H · dk · dv · ~3 mults
        d = cfg.d_model
        h = d // cfg.ssm.head_dim
        per_tok = 3 * h * cfg.ssm.head_dim**2 * 2
        return cfg.n_layers * n_seqs * tokens_per_seq * per_tok
    dh = cfg.resolved_head_dim
    t = tokens_per_seq
    causal_pairs = t * (t + 1) / 2
    layers = cfg.n_layers if cfg.family != "hybrid" else (
        cfg.n_layers // (cfg.hybrid_attn_every or cfg.n_layers)
    )
    per_layer = 2 * 2 * causal_pairs * cfg.n_heads * dh  # qk + pv
    total = layers * n_seqs * per_layer
    if cfg.encdec:
        # encoder full attention + decoder cross attention
        total += cfg.n_encoder_layers * n_seqs * 2 * 2 * t * t * cfg.n_heads * dh
        total += cfg.n_layers * n_seqs * 2 * 2 * t * t * cfg.n_heads * dh
    if cfg.family == "hybrid":
        d = cfg.d_model
        h = (cfg.ssm.expand * d) // cfg.ssm.head_dim
        total += cfg.n_layers * n_seqs * tokens_per_seq * 3 * h * (
            cfg.ssm.d_state * cfg.ssm.head_dim
        ) * 2
    return total


def model_flops(cfg: ModelConfig, shape: ShapeCell) -> float:
    """Global useful flops for one step of the cell."""
    n = cfg.n_active_params
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * b * t + 3.0 * _attn_flops_train(cfg, t, b)
    if shape.kind == "prefill":
        return 2.0 * n * b * t + _attn_flops_train(cfg, t, b)
    # decode: one token per sequence; attention reads the full cache
    base = 2.0 * n * b
    if cfg.family == "ssm":
        d = cfg.d_model
        h = d // cfg.ssm.head_dim
        attn = cfg.n_layers * b * 3 * h * cfg.ssm.head_dim**2 * 2
    elif cfg.family == "hybrid":
        groups = cfg.n_layers // (cfg.hybrid_attn_every or cfg.n_layers)
        window = min(cfg.sliding_window or t, t)
        dh = cfg.resolved_head_dim
        attn = groups * b * 2 * 2 * window * cfg.n_heads * dh
        h = (cfg.ssm.expand * d_model(cfg)) // cfg.ssm.head_dim
        attn += cfg.n_layers * b * 3 * h * cfg.ssm.d_state * cfg.ssm.head_dim * 2
    else:
        dh = cfg.resolved_head_dim
        layers = cfg.n_layers
        attn = layers * b * 2 * 2 * t * cfg.n_heads * dh
        if cfg.encdec:
            attn += cfg.n_layers * b * 2 * 2 * t * cfg.n_heads * dh  # cross
    return base + attn


def d_model(cfg: ModelConfig) -> int:
    return cfg.d_model


def terms(hlo_flops: float, hlo_bytes: float, coll_bytes: float) -> Dict[str, float]:
    """Per-rank seconds of the three roofline terms."""
    return {
        "t_compute": hlo_flops / PEAK_FLOPS,
        "t_memory": hlo_bytes / HBM_BW,
        "t_collective": coll_bytes / NVLINK_BW,
    }
