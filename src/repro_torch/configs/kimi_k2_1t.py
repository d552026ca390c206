"""kimi-k2-1t-a32b — trillion-param MoE, 384 routed top-8 + 1 shared expert,
first layer dense [arXiv:2501.kimi2 (paper-table); unverified].

Assignment specifies GQA kv=8 (the released model uses MLA; we follow the
assignment's table)."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=0,
    vocab_size=163840,
    head_dim=112,  # d_model / n_heads
    tie_embeddings=False,
    moe=MoEConfig(num_experts=384, top_k=8, num_shared=1, d_ff_expert=2048,
                  first_k_dense=1, d_ff_dense=18432),
    source="arXiv:2501.kimi2",
)

# drop-free capacity in the reduced config (see deepseek_moe_16b.py note)
REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=256,
    head_dim=16,
    moe=MoEConfig(num_experts=16, top_k=4, num_shared=1, d_ff_expert=32,
                  first_k_dense=1, d_ff_dense=128, capacity_factor=64.0))
