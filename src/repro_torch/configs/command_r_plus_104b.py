"""command-r-plus-104b — parallel attn||ffn blocks, LayerNorm, no bias
[hf:CohereForAI/c4ai-command-r-plus; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    parallel_block=True,
    use_layernorm=True,
    use_bias=False,
    tie_embeddings=True,
    rope_theta=75000000.0,
    source="hf:CohereForAI/c4ai-command-r-plus",
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=256, rope_theta=10000.0)
