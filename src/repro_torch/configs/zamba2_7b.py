"""zamba2-7b — Mamba2 backbone + shared (parameter-tied) attention block
applied every 6th layer [arXiv:2411.15242; unverified].

Simplification kept from the reference (recorded in DESIGN.md): the shared
block consumes the current hidden state (the released model concatenates the
original embeddings and applies per-invocation LoRA deltas)."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    shared_attn_every=6,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=2,
                  chunk_size=256),
    source="arXiv:2411.15242",
)

REDUCED = CONFIG.replace(
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
    shared_attn_every=3,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, n_groups=2,
                  chunk_size=16))
