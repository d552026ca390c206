"""Mamba2 block (SSD): projections, causal depthwise conv, gated norm.

Counterpart of ``repro.models.ssm``. Train and prefill run the chunked SSD
scan (``ops.ssd_scan``: the CUDA kernel on the card); decode is the
O(1)-per-token recurrent update carried in (conv buffer, ssm state).

The reference returns a new state; here, when a state is given, the new conv
buffer and ssm state are also copied into it in place. The state holds views
of one layer of the model's stacked cache, so that copy is what carries the
prefill into decode (the caller discards the returned state, as it does for
the KV cache).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import ParamSpec, rms_norm


def ssm_dims(cfg, d_model: int | None = None):
    s = cfg.ssm
    d = d_model or cfg.d_model
    d_inner = s.expand * d
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d, d_inner, n_heads, conv_dim


def ssm_specs(cfg, d_model: int | None = None) -> dict:
    s = cfg.ssm
    d, d_inner, nh, conv_dim = ssm_dims(cfg, d_model)
    proj_out = 2 * d_inner + 2 * s.n_groups * s.d_state + nh
    return {
        "in_proj": ParamSpec((d, proj_out), ("embed", "ssm_in")),
        "conv_w": ParamSpec((s.conv_width, conv_dim), ("conv", "ssm_conv"),
                            scale=0.5),
        "conv_b": ParamSpec((conv_dim,), ("ssm_conv",), init="zeros"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "a_log": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "d_skip": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "norm": ParamSpec((d_inner,), ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec((d_inner, d), ("ssm_inner", "embed")),
    }


def init_ssm_state(cfg, batch: int, n_layers: int, d_model: int | None = None,
                   lead: tuple[int, ...] = (), *, device):
    s = cfg.ssm
    _, d_inner, nh, conv_dim = ssm_dims(cfg, d_model)
    return {
        "conv": torch.zeros((n_layers, *lead, batch, s.conv_width - 1,
                             conv_dim), dtype=torch.float32, device=device),
        "ssm": torch.zeros((n_layers, *lead, batch, nh, s.head_dim,
                            s.d_state), dtype=torch.float32, device=device),
    }


def _split_proj(proj, cfg, d_model=None):
    s = cfg.ssm
    _, d_inner, nh, _ = ssm_dims(cfg, d_model)
    gn = s.n_groups * s.d_state
    return torch.split(proj, [d_inner, d_inner, gn, gn, nh], dim=-1)


def _causal_conv(x, w, b):
    """x: (B, L, C); w: (W, C) depthwise causal conv via shifted adds, in x's
    dtype as the reference does (``F.conv1d`` would round differently, and
    in fp32 on the card it runs through cuDNN in TF32 unless that is off)."""
    W, L = w.shape[0], x.shape[1]
    out = x * w[W - 1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :L]
        out = out + shifted * w[W - 1 - i]
    return out + b


def _gated_out(p, y, z):
    """Gated RMS norm and the output projection."""
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"])
    return y @ p["out_proj"]


def apply_ssm(p, x, *, cfg, d_model=None, state=None):
    """x: (B, L, d). Returns (out, new_state|None).

    state (decode handoff): dict(conv=(B, W-1, conv_dim), ssm=(B,H,P,N));
    when given for prefill, the new state reflects the sequence end and is
    also written into ``state`` in place.
    """
    s = cfg.ssm
    B, L, _ = x.shape
    _, d_inner, nh, _ = ssm_dims(cfg, d_model)
    gn = s.n_groups * s.d_state
    z, xs, bm, cm, dt = _split_proj(x @ p["in_proj"], cfg, d_model)
    conv_in = torch.cat([xs, bm, cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs, bm, cm = torch.split(conv_out, [d_inner, gn, gn], dim=-1)
    # softplus before the padding below: padded steps must have dt = 0
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    xh = xs.reshape(B, L, nh, s.head_dim)
    bh = bm.reshape(B, L, s.n_groups, s.d_state)
    ch = cm.reshape(B, L, s.n_groups, s.d_state)
    # pad L to a chunk multiple; dt = 0 at pad positions makes the recurrence
    # an exact identity there (decay exp(0) = 1, input u = 0), so y and the
    # final state are unaffected
    chunk = min(s.chunk_size, L)
    pad = (-L) % chunk
    xh, bh, ch = (F.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t.contiguous()
                  for t in (xh, bh, ch))
    if pad:
        dt = F.pad(dt, (0, 0, 0, pad))
    y, ssm_state = ops.ssd_scan(xh, dt, p["a_log"], bh, ch, p["d_skip"],
                                chunk=chunk)
    out = _gated_out(p, y[:, :L].reshape(B, L, d_inner), z)
    new_state = None
    if state is not None:
        # the last W-1 conv inputs (before the conv, the SiLU and the
        # padding), stored in fp32
        state["conv"].copy_(conv_in[:, -(s.conv_width - 1):])
        state["ssm"].copy_(ssm_state)
        new_state = state
    return out, new_state


def apply_ssm_decode(p, x_t, state, *, cfg, d_model=None):
    """Single-token step. x_t: (B, 1, d); state from init or prefill, updated
    in place and returned."""
    s = cfg.ssm
    B = x_t.shape[0]
    _, d_inner, nh, _ = ssm_dims(cfg, d_model)
    gn = s.n_groups * s.d_state
    z, xs, bm, cm, dt = _split_proj((x_t @ p["in_proj"])[:, 0], cfg, d_model)
    conv_in = torch.cat([xs, bm, cm], dim=-1)                     # (B, conv_dim)
    # the conv in fp32 over the fp32 window, then cast to the activation dtype
    window = torch.cat([state["conv"], conv_in[:, None].float()], dim=1)
    conv_out = (window * p["conv_w"].float()).sum(dim=1) + p["conv_b"].float()
    conv_out = F.silu(conv_out).to(x_t.dtype)
    xs, bm, cm = torch.split(conv_out, [d_inner, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    y, ssm_state = ops.ssd_decode_step(
        state["ssm"], xs.reshape(B, nh, s.head_dim), dt, p["a_log"],
        bm.reshape(B, s.n_groups, s.d_state),
        cm.reshape(B, s.n_groups, s.d_state), p["d_skip"])
    out = _gated_out(p, y.reshape(B, d_inner), z)[:, None]       # (B, 1, d)
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(ssm_state)
    return out, state
