"""seamless-m4t-large-v2 — encoder-decoder speech/text model; the audio
frontend is a STUB (precomputed frame embeddings) [arXiv:2308.11596; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    use_bias=True,
    use_layernorm=True,
    mlp_act="gelu",
    tie_embeddings=True,
    source="arXiv:2308.11596",
)

REDUCED = CONFIG.replace(n_layers=2, n_encoder_layers=2, d_model=64,
                         n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256)
