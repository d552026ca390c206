"""Base configuration dataclasses for the model zoo and shape cells.

A copy of ``repro.configs.base``: the port keeps its own so that it imports
nothing of the JAX package. Every architecture instantiates
:class:`ModelConfig`; ``REDUCED`` in each per-arch file is the CPU test
variant, and the full ``CONFIG`` runs on the card.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class MoEConfig:
    """Fine-grained mixture-of-experts settings (DeepSeekMoE-style)."""

    num_experts: int = 0            # routed experts
    top_k: int = 0
    num_shared: int = 0             # always-on shared experts
    d_ff_expert: int = 0            # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01   # load-balance auxiliary loss
    first_k_dense: int = 0          # leading dense layers (DeepSeek/Kimi style)
    d_ff_dense: int = 0             # hidden dim of those dense layers


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD settings."""

    d_state: int = 0
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class VisionConfig:
    """Cross-attention VLM settings (modality frontend is a stub)."""

    cross_every: int = 0        # a cross-attn layer every N layers (0 = none)
    num_patches: int = 4096     # precomputed patch-embedding tokens
    d_vision: int = 1280        # frontend embedding width (projected to d_model)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # --- attention flavor ---
    rope_theta: float = 10000.0
    rope_pct: float = 1.0       # fraction of head_dim rotated (stablelm: 0.25)
    qk_norm: bool = False
    sliding_window: int = 0     # 0 = full attention
    alt_local_global: bool = False  # gemma2: even layers local, odd global
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    attn_scale: float = 0.0     # 0 -> 1/sqrt(head_dim)
    use_bias: bool = False
    use_layernorm: bool = False  # False -> RMSNorm
    post_block_norm: bool = False  # gemma2 sandwich norms
    parallel_block: bool = False   # command-r style attn || mlp
    embed_scale: bool = False      # gemma: scale embeddings by sqrt(d_model)
    tie_embeddings: bool = True
    mlp_act: str = "silu"       # silu | gelu  (gated)
    # --- sub-family configs ---
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)
    # hybrid (zamba2): a shared attention block applied every N ssm blocks
    shared_attn_every: int = 0
    # encoder-decoder (seamless)
    n_encoder_layers: int = 0
    # --- numerics ---
    param_dtype: str = "bfloat16"
    activ_dtype: str = "bfloat16"
    # --- citations / provenance ---
    source: str = ""

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if decode at 500k context is sub-quadratic / constant-state."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_CELLS: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> bool:
    """Whether a shape cell applies to an architecture (DESIGN.md §4)."""
    if cell.name == "long_500k":
        return cfg.supports_long_context
    return True
