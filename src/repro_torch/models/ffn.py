"""Gated feed-forward (SwiGLU / GeGLU)."""
from __future__ import annotations

import functools

import torch.nn.functional as F

from .common import ParamSpec
from .tp import TP


def ffn_specs(cfg, d_ff: int | None = None, d_model: int | None = None) -> dict:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    spec = {
        "w_gate": ParamSpec((d, f), ("embed", "mlp")),
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }
    if cfg.use_bias:
        spec["b_gate"] = ParamSpec((f,), ("mlp",), init="zeros")
        spec["b_up"] = ParamSpec((f,), ("mlp",), init="zeros")
        spec["b_down"] = ParamSpec((d,), ("embed",), init="zeros")
    return spec


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    return {"silu": F.silu,
            "gelu": functools.partial(F.gelu, approximate="tanh")}[name]


def apply_ffn(p, x, *, cfg, tp: TP = TP()):
    """Gated MLP. Tensor parallel (``tp``): the rank's gate/up columns and
    down rows, the partial sums reduced over model before ``b_down``."""
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    if cfg.use_bias:
        g = g + p["b_gate"]
        u = u + p["b_up"]
    h = _act(cfg.mlp_act)(g) * u
    out = h @ p["w_down"]
    if tp.split("w_down", 0):
        out = tp.psum(out)
    if cfg.use_bias:
        out = out + p["b_down"]
    return out
