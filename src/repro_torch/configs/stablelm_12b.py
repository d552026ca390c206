"""stablelm-12b — GQA kv=8, partial rotary, per-head qk-norm
[hf:stabilityai/stablelm-2-12b; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    rope_pct=0.25,
    qk_norm=True,
    tie_embeddings=False,
    source="hf:stabilityai/stablelm-2-12b",
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=256)
