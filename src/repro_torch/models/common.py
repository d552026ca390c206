"""Parameter specs, norms, RoPE and init helpers.

Counterpart of ``repro.models.common``. Models are (spec, apply) pairs over
plain nested dicts of tensors. A ``ParamSpec`` tree is the single source of
truth for the parameter layout; ``init_params`` draws it from an explicit
``torch.Generator`` on that generator's device (``jax.random`` bits are not
reproduced: parity runs on weights carried across by ``repro_torch._bridge``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..tree import leaves_with_path


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]   # logical axis name per dim
    init: str = "normal"           # normal | zeros | ones | embed
    scale: float = 0.0             # stddev override; 0 -> fan-in scaled
    dtype: Any = None              # None -> model param dtype


def tree_map_specs(fn, spec_tree):
    if isinstance(spec_tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in spec_tree.items()}
    return fn(spec_tree)


def stack_specs(spec_tree, n: int, axis_name: str = "layers"):
    """Prepend a stacking dim (stacked per-layer parameters)."""

    def _stack(s: ParamSpec) -> ParamSpec:
        return s._replace(shape=(n, *s.shape), axes=(axis_name, *s.axes))

    return tree_map_specs(_stack, spec_tree)


def _fan_in(shape: tuple[int, ...], axes: tuple[str | None, ...]) -> int:
    # Fan-in = product of all dims except the last "output-ish" dim; for
    # stacked layer params, skip the leading 'layers'/stack dims.
    dims = [d for d, a in zip(shape, axes) if a not in ("layers", "group")]
    if len(dims) <= 1:
        return max(dims[0] if dims else 1, 1)
    return max(math.prod(dims[:-1]), 1)


def init_params(spec_tree, generator: torch.Generator,
                default_dtype=torch.bfloat16):
    """Concrete tensors for a spec tree, on ``generator.device``.

    Normal draws are made in fp32 and cast, as the reference does.
    """
    dev = generator.device
    out: dict = {}
    for path, s in leaves_with_path(spec_tree):
        dt = s.dtype or default_dtype
        if s.init == "zeros":
            t = torch.zeros(s.shape, dtype=dt, device=dev)
        elif s.init == "ones":
            t = torch.ones(s.shape, dtype=dt, device=dev)
        else:
            std = (s.scale or 1.0) if s.init == "embed" else \
                (s.scale or 1.0 / math.sqrt(_fan_in(s.shape, s.axes)))
            t = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                            device=dev)
            t = t.mul_(std).to(dt)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape) for _, s in leaves_with_path(spec_tree))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6, zero_centered: bool = False):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    s = scale.float()
    if zero_centered:  # gemma-style (1 + scale)
        s = 1.0 + s
    return (y * s).to(dt)


def layer_norm(x, scale, bias=None, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def norm_spec(cfg, d: int | None = None) -> dict:
    d = d or cfg.d_model
    spec = {"scale": ParamSpec((d,), ("embed_norm",),
                               init="zeros" if _zero_centered(cfg) else "ones")}
    if cfg.use_layernorm and cfg.use_bias:
        spec["bias"] = ParamSpec((d,), ("embed_norm",), init="zeros")
    return spec


def _zero_centered(cfg) -> bool:
    return cfg.name.startswith("gemma")


def apply_norm(p: dict, x, cfg):
    if cfg.use_layernorm:
        return layer_norm(x, p["scale"], p.get("bias"))
    return rms_norm(x, p["scale"], zero_centered=_zero_centered(cfg))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, rope_pct: float, theta: float, device=None):
    rot_dim = int(head_dim * rope_pct)
    rot_dim -= rot_dim % 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    inv = 1.0 / (theta ** exps)
    return inv, rot_dim


def apply_rope(x, positions, *, rope_pct: float = 1.0, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int.

    Rotates interleaved pairs (0::2, 1::2), as the reference does; the
    rotation runs in fp32 and is cast back to x's dtype.
    """
    head_dim = x.shape[-1]
    inv, rot_dim = rope_freqs(head_dim, rope_pct, theta, device=x.device)
    if rot_dim == 0:
        return x
    ang = positions[..., :, None].float() * inv          # (..., seq, rot/2)
    cos = torch.cos(ang)[..., :, None, :]                # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
