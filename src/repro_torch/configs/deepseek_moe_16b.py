"""deepseek-moe-16b — 2 shared + 64 routed top-6 fine-grained experts,
first layer dense [arXiv:2401.06066; hf]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab_size=102400,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_ff_expert=1408,
                  first_k_dense=1, d_ff_dense=10944),
    source="arXiv:2401.06066",
)

# capacity_factor is large in the reduced config so smoke tests are drop-free
# (capacity-based MoE drops depend on batch composition, which would make
# prefill-vs-decode equivalence tests flaky at tiny token counts).
REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, num_shared=1, d_ff_expert=32,
                  first_k_dense=1, d_ff_dense=128, capacity_factor=64.0))
