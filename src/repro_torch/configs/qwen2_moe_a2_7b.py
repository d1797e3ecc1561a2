"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,              # per-expert hidden size (assignment)
    vocab_size=151_936,
    qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_expert=1408),
    moe_sharding="ep",  # §Perf: expert parallelism (padded to TP degree)
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
