"""Architecture registry: ``--arch <id>`` resolution for the port's launchers.

Lists only the architectures whose families the port runs so far; the
others join as their slices land (ROADMAP.md, queue A).
"""
from __future__ import annotations

from . import (deepseek_7b, deepseek_moe_16b, kimi_k2_1t, mamba2_370m,
               seamless_m4t_large_v2, zamba2_7b)
from .base import ModelConfig

_MODULES = {
    "deepseek-7b": deepseek_7b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "kimi-k2-1t-a32b": kimi_k2_1t,
    "mamba2-370m": mamba2_370m,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "zamba2-7b": zamba2_7b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs: {ARCH_IDS}")
    mod = _MODULES[arch]
    return mod.REDUCED if reduced else mod.CONFIG
