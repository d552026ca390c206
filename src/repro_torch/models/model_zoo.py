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

    # -- execution ----------------------------------------------------------
    def apply(self, params, inputs, *, mode="train", cache=None,
              cache_index=None):
        return transformer.forward(params, inputs, cfg=self.cfg, mode=mode,
                                   cache=cache, cache_index=cache_index)

    def init_cache(self, batch: int, max_len: int, *, device=None,
                   kv_dtype=torch.bfloat16):
        """Zeroed decode cache on ``device`` (default ``cuda``)."""
        return transformer.init_cache(self.cfg, batch, max_len,
                                      kv_dtype=kv_dtype,
                                      device=resolve_device(device))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
