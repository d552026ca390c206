"""Model facade: build a (specs, init, apply, cache) bundle from a config."""
from __future__ import annotations

import torch

from .._bridge import resolve_device
from ..configs.base import ModelConfig
from . import transformer
from .common import dtype_of, init_params, param_count


class Model:
    """Thin, stateless facade over the functional model defined by ``cfg``."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.specs = transformer.lm_specs(cfg)

    # -- parameters ---------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on ``generator.device`` (seed it to reproduce)."""
        return init_params(self.specs, generator, dtype_of(self.cfg.param_dtype))

    def param_count(self) -> int:
        return param_count(self.specs)

    # -- inputs -------------------------------------------------------------
    def extra_inputs(self, batch: int, seq_len: int, *, device=None) -> dict:
        """Modality-stub inputs, zero bf16 as the reference's: ``frames``
        (batch, seq_len, d_model) for the encoder-decoder, ``patches``
        (batch, num_patches, d_vision) for the VLM; nothing for the
        decoder-only families. ``device`` defaults to ``cuda``."""
        cfg = self.cfg
        if cfg.family == "encdec":
            name, shape = "frames", (batch, seq_len, cfg.d_model)
        elif cfg.family == "vlm":
            name = "patches"
            shape = (batch, cfg.vision.num_patches, cfg.vision.d_vision)
        else:
            return {}
        return {name: torch.zeros(shape, dtype=torch.bfloat16,
                                  device=resolve_device(device))}

    def enc_len_for(self, seq_len: int) -> int:
        """Cross-attention KV length the reference sizes a cache with: the
        encoder's states (encdec), the image patches (vlm), none otherwise."""
        if self.cfg.family == "encdec":
            return seq_len
        if self.cfg.family == "vlm":
            return self.cfg.vision.num_patches
        return 0

    # -- execution ----------------------------------------------------------
    def apply(self, params, inputs, *, mode="train", cache=None,
              cache_index=None, remat_policy=None, scan_unroll: int = 1):
        return transformer.forward(params, inputs, cfg=self.cfg, mode=mode,
                                   cache=cache, cache_index=cache_index,
                                   remat_policy=remat_policy,
                                   scan_unroll=scan_unroll)

    def init_cache(self, batch: int, max_len: int, *, enc_len: int = 0,
                   device=None, kv_dtype=torch.bfloat16):
        """Zeroed decode cache on ``device`` (default ``cuda``); ``enc_len``
        sizes the cross-attention K/V, which a prefill fills from the frames
        or patches of that length."""
        return transformer.init_cache(self.cfg, batch, max_len,
                                      enc_len=enc_len, kv_dtype=kv_dtype,
                                      device=resolve_device(device))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
