"""zamba2-2.7b [hybrid] — Mamba-2 backbone with a weight-shared attention
block every 6 layers (simplification of zamba2's two alternating shared
blocks; noted in DESIGN.md).  Sliding-window (4096) ring cache keeps the
long_500k decode cell sub-quadratic.  [arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10_240,            # shared-block MLP
    vocab_size=32_000,
    ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, expand=2, chunk=128,
                  intra="ssd"),  # §Perf: head-shared SSD chunked scan
    hybrid_attn_every=6,
    sliding_window=4096,
    subquadratic=True,
    source="arXiv:2411.15242",
)
