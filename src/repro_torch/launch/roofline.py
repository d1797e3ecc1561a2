"""Analytic MODEL_FLOPS per cell (a part of ``repro.launch.roofline``).

MODEL_FLOPS (useful flops, paper-standard formulas):
  train    6 · N_active · tokens            (fwd 2× + bwd 4×)
  prefill  2 · N_active · tokens  (+ attention O(T²) term)
  decode   2 · N_active · batch   (+ attention O(S) KV term per step)

Only the counters :func:`repro_torch.workloads.zoo.pipeline` reads are
copied: ``_attn_flops_train``, ``model_flops`` and ``d_model``.  The
reference's peak rates and its ``terms`` (the dry run's three roofline
terms) are the reference's accelerator's figures and serve the dry run,
ROADMAP item 11; the port's rates are the measured ``h100`` row of
:data:`repro_torch.workloads.costs.CALIBRATIONS`.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig, ShapeCell
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
