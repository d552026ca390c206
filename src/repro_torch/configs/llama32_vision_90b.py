"""llama-3.2-vision-90b — text backbone with cross-attn image layers every
5th layer; vision frontend is a STUB (precomputed patch embeddings)
[hf:meta-llama/Llama-3.2-90B-Vision; unverified]."""
from .base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=False,
    vision=VisionConfig(cross_every=5, num_patches=4096, d_vision=1280),
    source="hf:meta-llama/Llama-3.2-90B-Vision",
)

REDUCED = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    vision=VisionConfig(cross_every=5, num_patches=16, d_vision=32))
