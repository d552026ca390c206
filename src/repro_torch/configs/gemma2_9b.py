"""gemma2-9b — local/global alternating attention, logit softcaps
[arXiv:2408.00118; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    sliding_window=4096,
    alt_local_global=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    attn_scale=(3584 / 16) ** -0.5,  # query_pre_attn_scalar = d_model/n_heads
    post_block_norm=True,
    embed_scale=True,
    mlp_act="gelu",
    tie_embeddings=True,
    source="arXiv:2408.00118",
)

REDUCED = CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=256, head_dim=16,
                         sliding_window=16, attn_scale=(64 / 4) ** -0.5)
