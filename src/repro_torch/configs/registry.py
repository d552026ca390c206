"""Architecture registry: ``--arch <id>`` resolution for the port's launchers.

Lists every architecture of the reference's registry, in its order.
"""
from __future__ import annotations

from . import (command_r_plus_104b, deepseek_7b, deepseek_moe_16b, gemma2_9b,
               kimi_k2_1t, llama32_vision_90b, mamba2_370m,
               seamless_m4t_large_v2, stablelm_12b, zamba2_7b)
from .base import ModelConfig

_MODULES = {
    "deepseek-7b": deepseek_7b,
    "gemma2-9b": gemma2_9b,
    "stablelm-12b": stablelm_12b,
    "command-r-plus-104b": command_r_plus_104b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "kimi-k2-1t-a32b": kimi_k2_1t,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "llama-3.2-vision-90b": llama32_vision_90b,
    "zamba2-7b": zamba2_7b,
    "mamba2-370m": mamba2_370m,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs: {ARCH_IDS}")
    mod = _MODULES[arch]
    return mod.REDUCED if reduced else mod.CONFIG
