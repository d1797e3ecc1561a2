"""granite-moe-3b-a800m [moe] — 40 routed experts top-8 (assignment primary
spec; the HF card of the 1b-a400m sibling lists 32 — we follow the
assignment line).  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,               # per-expert hidden size
    vocab_size=49_155,      # padded to 49168 for TP=16
    moe=MoEConfig(n_experts=40, top_k=8, n_shared=0, d_expert=512),
    moe_sharding="ep",  # §Perf: expert parallelism (padded to TP degree)
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (assignment dims)",
)
