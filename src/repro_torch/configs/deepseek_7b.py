"""deepseek-7b — dense llama-arch decoder [arXiv:2401.02954; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10000.0,
    tie_embeddings=False,
    source="arXiv:2401.02954",
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab_size=256)
