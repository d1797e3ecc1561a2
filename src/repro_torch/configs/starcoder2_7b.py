"""starcoder2-7b [dense] — GQA, RoPE, LayerNorm + GELU MLP.
[arXiv:2402.19173; hf].  36 heads do not divide the TP degree 16; padded to
48 inert heads (zeroed wo rows — function identical, flop pad visible in
roofline MODEL/HLO ratio)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18_432,
    vocab_size=49_152,
    head_dim=128,
    mlp="gelu",
    norm="layernorm",
    qkv_bias=True,
    rope_theta=100_000.0,
    source="arXiv:2402.19173",
)
