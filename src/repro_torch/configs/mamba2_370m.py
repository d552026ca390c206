"""mamba2-370m — pure SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                  chunk_size=256),
    source="arXiv:2405.21060",
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, vocab_size=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, n_groups=1,
                  chunk_size=16))
