"""Model configuration for the assigned architectures.

One frozen dataclass describes every family (dense / moe / ssm / vlm /
audio / hybrid); ``src/repro_torch/configs/<id>.py`` instantiate the exact
public-literature dims.  A copy of ``repro.models.config``: the workload
zoo (:mod:`repro_torch.workloads`) builds task trees from these fields,
the models (:mod:`repro_torch.models`) their parameters; reduced variants
(``cfg.reduced()``) are what the CPU tests run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0  # per-expert FFN hidden size
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    kind: str  # "rwkv6" | "mamba2"
    d_state: int = 64
    head_dim: int = 64  # per-head key/value dim of the linear-attention view
    expand: int = 2  # mamba2 inner expansion
    conv_width: int = 4
    chunk: int = 128  # chunked-scan block length
    # intra-chunk algorithm: "scan" (exact short scan, any decay) or
    # "matmul" (masked matmul grams — scalar-per-head decay only, §Perf lever)
    intra: str = "scan"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # None → d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one weight-shared attention block applied every
    # ``hybrid_attn_every`` ssm layers
    hybrid_attn_every: int = 0
    sliding_window: Optional[int] = None  # used by the shared attn at 500k
    # encoder-decoder (seamless): n_layers is the decoder depth
    encdec: bool = False
    n_encoder_layers: int = 0
    # modality frontend stub: inputs are precomputed embeddings
    frontend: Optional[str] = None  # "patch" (vlm) | "frames" (audio)
    frontend_dim: int = 0
    frontend_len: int = 256  # patches / frames per example in train shapes
    subquadratic: bool = False  # may run long_500k
    source: str = ""  # provenance note
    # MoE expert-weight sharding: "tp" = TP on the expert hidden dim
    # (replicated experts, all-reduce of the (B,E,C,D) dispatch tensor);
    # "ep" = expert parallelism (experts sharded over "model", dispatch
    # stays local, combine all-reduces only (B,T,D)) — §Perf lever.
    moe_sharding: str = "tp"

    # tensor-parallel head padding: head counts that do not divide the TP
    # degree are padded with inert heads (their wo rows are zero-initialised,
    # so the function computed is identical to the true-head model); the
    # flop overhead is visible in the roofline's MODEL_FLOPS/HLO ratio.
    tp_degree: int = 16

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_n_experts(self) -> int:
        """Experts padded to the TP degree for "ep" sharding (dummies are
        never routed to: router logits keep the true count)."""
        if self.moe is None:
            return 0
        e = self.moe.n_experts
        if self.moe_sharding != "ep" or e % self.tp_degree == 0:
            return e
        return (e + self.tp_degree - 1) // self.tp_degree * self.tp_degree

    @property
    def padded_n_heads(self) -> int:
        t = self.tp_degree
        if self.n_heads % t == 0:
            return self.n_heads
        padded = (self.n_heads + t - 1) // t * t
        # GQA grouping must stay even
        while padded % self.n_kv_heads != 0:
            padded += t
        return padded

    @property
    def n_params(self) -> int:
        """Total parameter count (approximate analytic formula)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        if self.moe:
            e = self.moe
            ffn = (e.n_experts + e.n_shared) * (3 * d * e.d_expert) + d * e.n_experts
        elif self.mlp == "swiglu":
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        if self.ssm is not None and self.family in ("ssm", "hybrid"):
            inner = self.ssm.expand * d
            mix = d * inner * 3 + inner * d  # rough: in/gate/out + extras
            per_layer = mix + ffn if self.family == "ssm" else mix
        else:
            per_layer = attn + ffn
        layers = self.n_layers * per_layer
        if self.family == "hybrid":
            layers += (attn + 3 * d * f)  # one shared attention block
        if self.encdec:
            layers += self.n_encoder_layers * (attn + ffn) + self.n_layers * attn
        emb = v * d * (1 if self.tie_embeddings else 2)
        return int(layers + emb)

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed top-k + shared)."""
        if not self.moe:
            return self.n_params
        e = self.moe
        d = self.d_model
        full = self.n_params
        all_experts = (e.n_experts + e.n_shared) * 3 * d * e.d_expert
        active = (e.top_k + e.n_shared) * 3 * d * e.d_expert
        return int(full - self.n_layers * (all_experts - active) // 1)

    def padded_vocab(self, multiple: int = 16) -> int:
        return (self.vocab_size + multiple - 1) // multiple * multiple

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            tp_degree=1,
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab_size=512,
            head_dim=16 if self.head_dim else None,
            frontend_len=8 if self.frontend else self.frontend_len,
            frontend_dim=32 if self.frontend else 0,
            n_encoder_layers=2 if self.encdec else 0,
            sliding_window=16 if self.sliding_window else None,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
        )
        if self.moe:
            kw["moe"] = MoEConfig(
                n_experts=8,
                top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1),
                d_expert=32,
                capacity_factor=self.moe.capacity_factor,
            )
        if self.ssm:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=8
            )
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    """One (shape-id) column of the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_is_runnable(cfg: ModelConfig, shape: ShapeCell) -> bool:
    """long_500k only for sub-quadratic architectures (see DESIGN.md)."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True
