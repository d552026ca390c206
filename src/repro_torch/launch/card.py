"""The launchers' reduced configs on the card.

Every reduced config of the registry is 64 wide with 4 attention heads, so
its head dim is 16 (gemma2-9b and kimi-k2 say so outright), and the flash
kernels take none below 64 (``kernels/flash_attention.py::HEAD_DIMS``):
there is no fallback to a plain version on the card. ``card_config`` gives
such a config as many heads of the smallest head dim both kernels take as
its width allows (one head of 64, with one KV head, at a width of 64) and
keeps every other field. Every attention of an arch reads its heads from
these fields: self, cross, the encoder's, the VLM's and the hybrid's shared
block. An attention-free config, and one whose head dim the kernels take
already, is returned as it is. ``get_config`` stays the reference's: the
CPU runs and the parity tests use its configs unchanged.
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..kernels.flash_attention import BWD_HEAD_DIMS, HEAD_DIMS

CARD_HEAD_DIMS = tuple(sorted(set(HEAD_DIMS) & set(BWD_HEAD_DIMS)))


def card_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with attention heads that the forward and backward flash
    kernels take: ``d_model // 64`` heads of 64 (at least one), the KV heads
    in the same groups where they divide, else one."""
    if cfg.is_attention_free or cfg.head_dim_ in CARD_HEAD_DIMS:
        return cfg
    hd = CARD_HEAD_DIMS[0]
    heads = max(cfg.d_model // hd, 1)
    group = cfg.n_heads // cfg.n_kv_heads
    kv = heads // group if heads % group == 0 else 1
    explicit = cfg.head_dim or heads * hd != cfg.d_model
    return cfg.replace(n_heads=heads, n_kv_heads=kv,
                       head_dim=hd if explicit else 0)


def launch_config(cfg: ModelConfig, *, reduced: bool, device, tag: str,
                  say=print) -> ModelConfig:
    """The config a launcher runs on ``device``: ``cfg`` (the registry's,
    reduced or not as ``reduced`` says), through ``card_config`` where it
    is reduced and the device a card. A change is said through ``say`` as
    ``[tag] ...``, on the launcher's first line."""
    if not reduced or getattr(device, "type", str(device)) != "cuda":
        return cfg
    card = card_config(cfg)
    if card != cfg:
        say(f"[{tag}] {cfg.name} reduced on the card: {cfg.n_heads} heads of "
            f"{cfg.head_dim_} (kv {cfg.n_kv_heads}) -> {card.n_heads} of "
            f"{card.head_dim_} (kv {card.n_kv_heads}); the flash kernels "
            f"take head dims {CARD_HEAD_DIMS}")
    return card
