"""GQA attention block (full / sliding-window / softcap) with KV cache."""
from __future__ import annotations

import torch

from ..kernels import ops
from .common import ParamSpec, apply_rope, rms_norm
from .tp import TP


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


def _kv_heads_of(k, tp: TP, cfg):
    """The K/V heads the rank's q heads read: all of ``k`` where it holds
    the rank's kv heads (or nothing is split); where the q heads are split
    and the kv heads are not, the slice of those the rank's q heads map
    onto (GQA: q head h reads kv head h // (H / KVH))."""
    if not tp.split("wq", 1) or tp.split("wk", 1):
        return k
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    hq, g = H // tp.size, H // KVH
    if hq % g and g % hq:
        raise NotImplementedError(
            f"{hq} q heads a rank do not map onto whole groups of {g}")
    lo, n = tp.rank * hq // g, max(hq // g, 1)
    return k[:, :, lo:lo + n].contiguous()


def apply_attention(p, x, *, cfg, window: int = 0, positions=None,
                    cache: dict | None = None, cache_index=None,
                    cross_kv: tuple | None = None, causal: bool = True,
                    mode: str = "train", tp: TP = TP()):
    """x: (B, S, d). Returns (out, new_cache_slice).

    - train: no cache IO, flash attention over x.
    - prefill: flash attention over x; k/v written into ``cache`` at 0.
    - decode: k/v written at ``cache_index``; attention over the cache.
    - cross-attention: ``cross_kv`` = (k, v) precomputed from the encoder's
      states; no RoPE, ``causal`` is ignored (every key is visible).

    The cache is written in place (the reference returns an updated copy):
    ``cache`` holds views of one layer of the stacked cache, so the returned
    slice is ``cache`` itself.

    Tensor parallel (``tp``, ``models/tp.py``): q/k/v are the rank's heads,
    ``wo`` its rows, summed over model. The cache is the rank's block under
    its placement: its kv heads (head-parallel), its positions
    (sequence-parallel: prefill writes the rank's share of the prompt,
    decode writes on the rank holding ``cache_index`` and attends by
    ``ops.decode_attention_split`` with every rank's q heads), or whole.
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
        if mode == "decode" and tp.cache_split("ck", 1):
            o = _seq_split_decode(q, k, v, tp, cfg, scale=scale, window=0,
                                  q_offset=0, kv_len=tp.size * k.shape[1],
                                  causal=False)
        else:
            o = ops.flash_attention(q, _kv_heads_of(k, tp, cfg),
                                    _kv_heads_of(v, tp, cfg), causal=False,
                                    scale=scale,
                                    logit_softcap=cfg.attn_logit_softcap)
        return _out(p, o, cfg, tp), None

    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, rope_pct=cfg.rope_pct, theta=cfg.rope_theta)
    k = apply_rope(k, positions, rope_pct=cfg.rope_pct, theta=cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        idx = int(cache_index)
        if tp.cache_split("k", 1):
            write_cache(cache, ("k", "v"), (k, v), idx, tp)
            o = _seq_split_decode(q, cache["k"], cache["v"], tp, cfg,
                                  scale=scale, window=window, q_offset=idx,
                                  kv_len=idx + S)
        else:
            cache["k"][:, idx:idx + S] = k.to(cache["k"].dtype)
            cache["v"][:, idx:idx + S] = v.to(cache["v"].dtype)
            o = ops.decode_attention(q, _kv_heads_of(cache["k"], tp, cfg),
                                     _kv_heads_of(cache["v"], tp, cfg),
                                     window=window,
                                     logit_softcap=cfg.attn_logit_softcap,
                                     scale=scale, q_offset=idx, kv_len=idx + S)
        new_cache = cache
    else:
        o = ops.flash_attention(q, _kv_heads_of(k, tp, cfg),
                                _kv_heads_of(v, tp, cfg), causal=causal,
                                window=window,
                                logit_softcap=cfg.attn_logit_softcap,
                                scale=scale)
        if mode == "prefill" and cache is not None:
            write_cache(cache, ("k", "v"), (k, v), 0, tp)
            new_cache = cache

    return _out(p, o, cfg, tp), new_cache


def write_cache(cache, names, kvs, at: int, tp: TP = TP()) -> None:
    """Write (B, S, KVH, D) K/V at positions ``at`` onwards into the cache
    leaves ``names``. On a cache split by position (dim 1 over model) a
    rank writes the positions it holds, if any."""
    for name, t in zip(names, kvs):
        leaf = cache[name]
        lo = 0
        if tp.cache_split(name, 1):
            lo = tp.rank * leaf.shape[1]
        start, stop = max(at, lo), min(at + t.shape[1], lo + leaf.shape[1])
        if start < stop:
            leaf[:, start - lo:stop - lo] = t[:, start - at:stop - at].to(leaf.dtype)


def _seq_split_decode(q, k, v, tp: TP, cfg, *, scale, window, q_offset,
                      kv_len, causal=True):
    """Decode attention of the rank's q heads over a position-split cache:
    every rank's heads are gathered, attend to the whole cache through the
    ranks' slices, and the rank keeps its own heads' outputs."""
    heads_split = tp.split("wq", 1)
    with tp.at():
        q_all = tp.gather(q, 2) if heads_split else q
        o = ops.decode_attention_split(
            q_all, k, v, k_start=tp.rank * k.shape[1], pmax=tp.pmax,
            psum=tp.psum, window=window, logit_softcap=cfg.attn_logit_softcap,
            scale=scale, q_offset=q_offset, kv_len=kv_len, causal=causal)
    if not heads_split:
        return o
    hq = q.shape[2]
    return o[:, :, tp.rank * hq:(tp.rank + 1) * hq]


def _out(p, o, cfg, tp: TP = TP()):
    """(B, S, H, hd) @ (H, hd, d) -> (B, S, d), plus ``bo``; with the
    rank's heads, the partial sums reduced over model before ``bo``."""
    B, S = o.shape[:2]
    out = o.reshape(B, S, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1])
    if tp.split("wo", 0):
        with tp.at("wo"):
            out = tp.psum(out)
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
    """src (B, S_enc, d_src) -> k, v (B, S_enc, KVH, hd): the rank's kv
    heads where ``wk`` / ``wv`` are its block of them."""
    return _heads(src, p["wk"]), _heads(src, p["wv"])
