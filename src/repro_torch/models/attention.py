"""GQA attention block (full / sliding-window / softcap) with KV cache."""
from __future__ import annotations

import torch

from ..kernels import ops
from .common import ParamSpec, apply_rope, rms_norm


def attention_specs(cfg, d_model: int | None = None) -> dict:
    d = d_model or cfg.d_model
    hd = cfg.head_dim_
    spec = {
        "wq": ParamSpec((d, cfg.n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((cfg.n_heads, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.use_bias:
        spec["bq"] = ParamSpec((cfg.n_heads, hd), ("heads", "head_dim"), init="zeros")
        spec["bk"] = ParamSpec((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = ParamSpec((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros")
        spec["bo"] = ParamSpec((d,), ("embed",), init="zeros")
    if cfg.qk_norm:
        spec["q_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
        spec["k_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
    return spec


def _heads(x, w):
    """(B, S, d) @ (d, H, hd) -> (B, S, H, hd)."""
    B, S, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])


def _project_qkv(p, x, cfg):
    q = _heads(x, p["wq"])
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    if cfg.use_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def apply_attention(p, x, *, cfg, window: int = 0, positions=None,
                    cache: dict | None = None, cache_index=None,
                    cross_kv: tuple | None = None, causal: bool = True,
                    mode: str = "train"):
    """x: (B, S, d). Returns (out, new_cache_slice).

    - train: no cache IO, flash attention over x.
    - prefill: flash attention over x; k/v written into ``cache`` at 0.
    - decode: k/v written at ``cache_index``; attention over the cache.
    - cross-attention: ``cross_kv`` = (k, v) precomputed from the encoder's
      states; no RoPE, ``causal`` is ignored (every key is visible).

    The cache is written in place (the reference returns an updated copy):
    ``cache`` holds views of one layer of the stacked cache, so the returned
    slice is ``cache`` itself.
    """
    B, S, _ = x.shape
    scale = cfg.attn_scale or cfg.head_dim_ ** -0.5

    if cross_kv is not None:
        q = _heads(x, p["wq"])
        if cfg.use_bias:
            q = q + p["bq"]
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"])
        k, v = cross_kv
        o = ops.flash_attention(q, k, v, causal=False, scale=scale,
                                logit_softcap=cfg.attn_logit_softcap)
        return _out(p, o, cfg), None

    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, rope_pct=cfg.rope_pct, theta=cfg.rope_theta)
    k = apply_rope(k, positions, rope_pct=cfg.rope_pct, theta=cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        idx = int(cache_index)
        cache["k"][:, idx:idx + S] = k.to(cache["k"].dtype)
        cache["v"][:, idx:idx + S] = v.to(cache["v"].dtype)
        o = ops.decode_attention(q, cache["k"], cache["v"], window=window,
                                 logit_softcap=cfg.attn_logit_softcap,
                                 scale=scale, q_offset=idx, kv_len=idx + S)
        new_cache = cache
    else:
        o = ops.flash_attention(q, k, v, causal=causal, window=window,
                                logit_softcap=cfg.attn_logit_softcap,
                                scale=scale)
        if mode == "prefill" and cache is not None:
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
            new_cache = cache

    return _out(p, o, cfg), new_cache


def _out(p, o, cfg):
    """(B, S, H, hd) @ (H, hd, d) -> (B, S, d), plus ``bo``."""
    B, S = o.shape[:2]
    out = o.reshape(B, S, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1])
    if cfg.use_bias:
        out = out + p["bo"]
    return out


def cross_kv_specs(cfg, d_src: int) -> dict:
    """K/V projections from a source modality (the encoder's states)."""
    hd = cfg.head_dim_
    return {
        "wk": ParamSpec((d_src, cfg.n_kv_heads, hd),
                        ("src_embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d_src, cfg.n_kv_heads, hd),
                        ("src_embed", "kv_heads", "head_dim")),
    }


def compute_cross_kv(p, src):
    """src (B, S_enc, d_src) -> k, v (B, S_enc, KVH, hd)."""
    return _heads(src, p["wk"]), _heads(src, p["wv"])
