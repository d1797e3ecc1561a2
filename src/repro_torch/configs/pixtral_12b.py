"""pixtral-12b [vlm] — pixtral-ViT frontend (STUB: precomputed patch
embeddings per the assignment) + mistral-nemo-style decoder backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=131_072,
    head_dim=128,
    rope_theta=1_000_000.0,
    frontend="patch",
    frontend_dim=1024,      # pixtral vision encoder width
    frontend_len=256,       # patches per image (stub)
    source="hf:mistralai/Pixtral-12B-2409",
)
