"""seamless-m4t-large-v2 [audio] — encoder-decoder backbone; the speech
frontend is a STUB (precomputed frame embeddings per the assignment).
Assignment lists 24L: we build 24 encoder + 24 decoder layers.
[arXiv:2308.11596; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,            # decoder
    n_encoder_layers=24,
    encdec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,     # padded to 256208 for TP=16
    frontend="frames",
    frontend_dim=160,       # fbank-stack stub width
    source="arXiv:2308.11596",
)
