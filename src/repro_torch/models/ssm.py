"""Mamba2 block (SSD): projections, causal depthwise conv, gated norm.

Counterpart of ``repro.models.ssm``. Train and prefill run the chunked SSD
scan (``ops.ssd_scan``: the CUDA kernel on the card); decode is the
O(1)-per-token recurrent update carried in (conv buffer, ssm state).

The reference returns a new state; here, when a state is given, the new conv
buffer and ssm state are also copied into it in place. The state holds views
of one layer of the model's stacked cache, so that copy is what carries the
prefill into decode (the caller discards the returned state, as it does for
the KV cache).

Tensor parallel over the model axis (``tp``, ``models/tp.py``), as GSPMD
computes the reference's block from its rule table (``ssm_in``,
``ssm_inner``, ``ssm_conv`` and ``ssm_heads`` over model): where the
block's heads split (``split_heads``), a rank computes its heads ``Part``.
``in_proj`` arrives whole (one layer's, gathered on use) and the rank takes
its columns: z, x and dt of its heads, B and C of the groups its heads read
(``in_proj_columns``), and the matching conv channels (``conv_channels``):
the stored split of those leaves is contiguous across the z/x/B/C/dt
segments, so it does not line up with the heads. ``norm``, ``out_proj``,
``dt_bias``, ``a_log`` and ``d_skip`` arrive as stored: the rank's heads.
The conv and the SSD scan run on the rank's channels and heads, the gated
RMS norm over the whole ``d_inner`` (the sum of squares psummed over
model), and ``out_proj`` gives partial sums, psummed before the residual.
The cache holds the rank's share: the ``ssm`` leaf its heads, the ``conv``
leaf its channels (x of its heads, B and C of its groups).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import ParamSpec, rms_norm
from .tp import TP


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


class Part(NamedTuple):
    """The share of a Mamba2 block one rank computes: heads [h0, h0 + nh)
    and the groups [g0, g0 + ng) they read."""

    h0: int
    nh: int
    g0: int
    ng: int


def split_heads(cfg, size: int, d_model: int | None = None) -> bool:
    """Whether a Mamba2 block's heads split over ``size`` ranks: the model
    has such blocks, its heads divide, and a rank's heads read whole groups
    or part of one group."""
    _, _, nh, _ = ssm_dims(cfg, d_model)
    if not cfg.ssm.d_state or size <= 1 or nh % size:
        return False
    hq, hg = nh // size, nh // cfg.ssm.n_groups
    return hq % hg == 0 or hg % hq == 0


def rank_part(cfg, size: int, rank: int, d_model: int | None = None) -> Part:
    """The heads and groups of rank ``rank`` of ``size`` (``split_heads``)."""
    _, _, nh, _ = ssm_dims(cfg, d_model)
    hq, hg = nh // size, nh // cfg.ssm.n_groups
    return Part(rank * hq, hq, rank * hq // hg, max(hq // hg, 1))


def in_proj_columns(cfg, part: Part, d_model: int | None = None) -> list:
    """``in_proj``'s column ranges [lo, hi) of ``part``, in the order of
    its segments: z and x of its heads, B and C of its groups, dt of its
    heads."""
    s = cfg.ssm
    _, di, _, _ = ssm_dims(cfg, d_model)
    gn, P, N = s.n_groups * s.d_state, s.head_dim, s.d_state
    heads = (part.h0 * P, (part.h0 + part.nh) * P)
    groups = (part.g0 * N, (part.g0 + part.ng) * N)
    return [heads, _shift(heads, di), _shift(groups, 2 * di),
            _shift(groups, 2 * di + gn),
            _shift((part.h0, part.h0 + part.nh), 2 * di + 2 * gn)]


def conv_channels(cfg, part: Part, d_model: int | None = None) -> list:
    """The conv's channel ranges [lo, hi) of ``part`` (x of its heads, B
    and C of its groups): of ``conv_w``, ``conv_b`` and the conv cache
    leaf, whose channel c is ``in_proj``'s column d_inner + c."""
    _, di, _, _ = ssm_dims(cfg, d_model)
    return [_shift(r, -di) for r in in_proj_columns(cfg, part, d_model)[1:4]]


def _shift(r, by: int):
    return (r[0] + by, r[1] + by)


def take(t, ranges, dim: int = -1):
    """The ranges [lo, hi) of ``t``'s dim ``dim``, concatenated."""
    return torch.cat([t.narrow(dim, lo, hi - lo) for lo, hi in ranges], dim)


class _Widths(NamedTuple):
    d_inner: int
    nh: int
    gn: int


def _share(p, cfg, tp: TP, d_model):
    """The block's weights and widths as this rank computes with them, and
    the view its norm and output reduce over (None: the block is whole)."""
    s = cfg.ssm
    _, di, nh, _ = ssm_dims(cfg, d_model)
    if not tp.split("dt_bias", 0):
        return p, _Widths(di, nh, s.n_groups * s.d_state), None
    part = rank_part(cfg, tp.size, tp.rank, d_model)
    chans = conv_channels(cfg, part, d_model)
    p = dict(p, in_proj=take(p["in_proj"], in_proj_columns(cfg, part, d_model)),
             conv_w=take(p["conv_w"], chans), conv_b=take(p["conv_b"], chans))
    return p, _Widths(part.nh * s.head_dim, part.nh, part.ng * s.d_state), tp


def _split_proj(proj, w: _Widths):
    return torch.split(proj, [w.d_inner, w.d_inner, w.gn, w.gn, w.nh], dim=-1)


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


def _gated_out(p, y, z, tp: TP | None, d_inner: int):
    """Gated RMS norm over the whole ``d_inner`` and the output projection;
    on a rank's heads (``tp``) the sum of squares and the projection's
    partial sums are psummed over model."""
    g = y * F.silu(z.float()).to(y.dtype)
    if tp is None:
        return rms_norm(g, p["norm"]) @ p["out_proj"]
    with tp.at("norm"):
        g = rms_norm(g, p["norm"], psum=tp.psum, width=d_inner)
    with tp.at("out_proj"):
        return tp.psum(g @ p["out_proj"])


def apply_ssm(p, x, *, cfg, d_model=None, state=None, tp: TP = TP()):
    """x: (B, L, d). Returns (out, new_state|None).

    state (decode handoff): dict(conv=(B, W-1, conv_dim), ssm=(B,H,P,N)), of
    the rank's channels and heads where ``tp`` splits the block; when given
    for prefill, the new state reflects the sequence end and is also
    written into ``state`` in place.
    """
    s = cfg.ssm
    B, L, _ = x.shape
    d_inner = ssm_dims(cfg, d_model)[1]
    p, w, tp = _share(p, cfg, tp, d_model)
    z, xs, bm, cm, dt = _split_proj(x @ p["in_proj"], w)
    conv_in = torch.cat([xs, bm, cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs, bm, cm = torch.split(conv_out, [w.d_inner, w.gn, w.gn], dim=-1)
    # softplus before the padding below: padded steps must have dt = 0
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    xh = xs.reshape(B, L, w.nh, s.head_dim)
    bh = bm.reshape(B, L, -1, s.d_state)
    ch = cm.reshape(B, L, -1, s.d_state)
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
    out = _gated_out(p, y[:, :L].reshape(B, L, w.d_inner), z, tp, d_inner)
    new_state = None
    if state is not None:
        # the last W-1 conv inputs (before the conv, the SiLU and the
        # padding), stored in fp32
        state["conv"].copy_(conv_in[:, -(s.conv_width - 1):])
        state["ssm"].copy_(ssm_state)
        new_state = state
    return out, new_state


def apply_ssm_decode(p, x_t, state, *, cfg, d_model=None, tp: TP = TP()):
    """Single-token step. x_t: (B, 1, d); state from init or prefill (the
    rank's channels and heads where ``tp`` splits the block), updated in
    place and returned."""
    s = cfg.ssm
    B = x_t.shape[0]
    d_inner = ssm_dims(cfg, d_model)[1]
    p, w, tp = _share(p, cfg, tp, d_model)
    z, xs, bm, cm, dt = _split_proj((x_t @ p["in_proj"])[:, 0], w)
    conv_in = torch.cat([xs, bm, cm], dim=-1)                     # (B, conv_dim)
    # the conv in fp32 over the fp32 window, then cast to the activation dtype
    window = torch.cat([state["conv"], conv_in[:, None].float()], dim=1)
    conv_out = (window * p["conv_w"].float()).sum(dim=1) + p["conv_b"].float()
    conv_out = F.silu(conv_out).to(x_t.dtype)
    xs, bm, cm = torch.split(conv_out, [w.d_inner, w.gn, w.gn], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    y, ssm_state = ops.ssd_decode_step(
        state["ssm"], xs.reshape(B, w.nh, s.head_dim), dt, p["a_log"],
        bm.reshape(B, -1, s.d_state), cm.reshape(B, -1, s.d_state),
        p["d_skip"])
    out = _gated_out(p, y.reshape(B, w.d_inner), z, tp, d_inner)[:, None]
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(ssm_state)
    return out, state
