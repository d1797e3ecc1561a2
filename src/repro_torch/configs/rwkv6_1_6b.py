"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,             # = d_model / ssm.head_dim (linear-attn view)
    n_kv_heads=32,
    d_ff=7168,              # channel-mix hidden
    vocab_size=65_536,
    ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk=128),
    subquadratic=True,
    source="arXiv:2404.05892",
)
