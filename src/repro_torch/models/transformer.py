"""Decoder stack: layer plans, a loop over stacked layers, caches.

Counterpart of ``repro.models.transformer`` for every family: dense, MoE,
SSM, hybrid, encoder-decoder and VLM. Every architecture is a *layer plan*,
a tuple of ``GroupDesc`` entries; each group's parameters are stacked per
layer (leading ``layers`` axis, the reference's layout), and the group runs
as a Python loop that indexes layer ``i`` of the stacked tensors in place of
``jax.lax.scan``.

Modes: ``train`` (no cache), ``prefill`` (flash attention or the SSD scan +
cache write at 0), ``decode`` (single-token step over the KV cache and SSM
state). MoE blocks (the local path of ``models/moe.py``) return the router's
load-balance loss, which ``forward`` sums over the blocks as the reference
does. The encoder-decoder family runs its encoder (``encoder_plan``) on
``inputs["frames"]`` outside decode; its ``cross_attn`` blocks attend to the
encoder's final states, through a ``ck``/``cv`` cache in decode. The VLM's
``cross_attn`` blocks (every ``vision.cross_every``-th layer) attend the same
way to ``inputs["patches"]`` projected by ``vision_proj``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .attention import (apply_attention, attention_specs, compute_cross_kv,
                        cross_kv_specs)
from .common import (ParamSpec, apply_norm, dtype_of, norm_spec, softcap,
                     stack_specs)
from .ffn import apply_ffn, ffn_specs
from .moe import apply_moe, moe_specs
from .ssm import apply_ssm, apply_ssm_decode, init_ssm_state, ssm_specs

@dataclass(frozen=True)
class BlockDesc:
    kind: str            # attn | ffn | moe | ssm | cross_attn | parallel | shared_attn
    window: int = 0
    d_ff: int = 0        # ffn width override (0 -> cfg.d_ff)
    causal: bool = True


@dataclass(frozen=True)
class GroupDesc:
    repeat: int
    blocks: tuple[BlockDesc, ...]


A, F, S = BlockDesc("attn"), BlockDesc("ffn"), BlockDesc("ssm")


def layer_plan(cfg) -> tuple[GroupDesc, ...]:
    if cfg.family == "ssm":
        return (GroupDesc(cfg.n_layers, (S,)),)
    if cfg.family == "hybrid":
        per, n = cfg.shared_attn_every, cfg.n_layers
        full, rest = divmod(n, per)
        groups = [GroupDesc(full, tuple([S] * per) + (BlockDesc("shared_attn"),))]
        if rest:
            groups.append(GroupDesc(rest, (S,)))
        return tuple(groups)
    if cfg.family == "vlm":
        ce = cfg.vision.cross_every
        assert cfg.n_layers % ce == 0
        blocks = tuple([A, F] * (ce - 1)) + (BlockDesc("cross_attn"), F)
        return (GroupDesc(cfg.n_layers // ce, blocks),)
    if cfg.family == "encdec":
        return (GroupDesc(cfg.n_layers, (A, BlockDesc("cross_attn"), F)),)
    if cfg.parallel_block:
        return (GroupDesc(cfg.n_layers, (BlockDesc("parallel"),)),)
    if cfg.alt_local_global:
        assert cfg.n_layers % 2 == 0
        return (GroupDesc(cfg.n_layers // 2,
                          (BlockDesc("attn", window=cfg.sliding_window), F,
                           A, F)),)
    if cfg.family == "moe":
        m = cfg.moe
        groups = []
        if m.first_k_dense:
            groups.append(GroupDesc(
                m.first_k_dense, (A, BlockDesc("ffn", d_ff=m.d_ff_dense))))
        groups.append(GroupDesc(cfg.n_layers - m.first_k_dense,
                                (A, BlockDesc("moe"))))
        return tuple(groups)
    # plain dense decoder
    w = cfg.sliding_window
    attn = BlockDesc("attn", window=w) if w else A
    return (GroupDesc(cfg.n_layers, (attn, F)),)


def encoder_plan(cfg) -> tuple[GroupDesc, ...]:
    return (GroupDesc(cfg.n_encoder_layers,
                      (BlockDesc("attn", causal=False), F)),)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _block_specs(cfg, b: BlockDesc) -> dict:
    if b.kind == "shared_attn":
        return {}  # parameters live at the top level (tied across repeats)
    spec: dict = {"norm": norm_spec(cfg)}
    if cfg.post_block_norm:
        spec["post_norm"] = norm_spec(cfg)
    if b.kind == "attn":
        spec["attn"] = attention_specs(cfg)
    elif b.kind == "ffn":
        spec["ffn"] = ffn_specs(cfg, d_ff=b.d_ff or cfg.d_ff)
    elif b.kind == "moe":
        spec["moe"] = moe_specs(cfg)
    elif b.kind == "ssm":
        spec["ssm"] = ssm_specs(cfg)
    elif b.kind == "cross_attn":
        spec["attn"] = attention_specs(cfg)
        spec["cross_kv"] = cross_kv_specs(cfg, cfg.d_model)
    elif b.kind == "parallel":
        spec["attn"] = attention_specs(cfg)
        spec["ffn"] = ffn_specs(cfg)
    else:
        raise ValueError(b.kind)
    return spec


def _group_specs(cfg, gd: GroupDesc) -> dict:
    blocks = {f"b{i}": _block_specs(cfg, b) for i, b in enumerate(gd.blocks)}
    return stack_specs(blocks, gd.repeat)


def lm_specs(cfg) -> dict:
    spec: dict = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           init="embed", scale=0.02),
        "final_norm": norm_spec(cfg),
        "groups": {f"g{i}": _group_specs(cfg, gd)
                   for i, gd in enumerate(layer_plan(cfg))},
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                    ("embed", "vocab"))
    if cfg.family == "vlm":
        spec["vision_proj"] = ParamSpec((cfg.vision.d_vision, cfg.d_model),
                                        ("vision_embed", "embed"))
    if cfg.family == "hybrid":
        spec["shared"] = {
            "norm": norm_spec(cfg),
            "attn": attention_specs(cfg),
            "ffn": ffn_specs(cfg),
            "ffn_norm": norm_spec(cfg),
        }
    if cfg.family == "encdec":
        spec["encoder"] = {
            "in_proj": ParamSpec((cfg.d_model, cfg.d_model),
                                 ("src_embed", "embed")),
            "final_norm": norm_spec(cfg),
            "groups": {f"g{i}": _group_specs(cfg, gd)
                       for i, gd in enumerate(encoder_plan(cfg))},
        }
    return spec


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _kv_pair(names, repeat, batch, length, cfg, *, device, kv_dtype) -> dict:
    shape = (repeat, batch, length, cfg.n_kv_heads, cfg.head_dim_)
    return {n: torch.zeros(shape, dtype=kv_dtype, device=device) for n in names}


def init_cache(cfg, batch: int, max_len: int, *, device, enc_len: int = 0,
               kv_dtype=torch.bfloat16) -> dict:
    """Decode cache mirroring the layer plan: per attention block (a shared
    one too: each repeat has its own), k/v of (repeat, batch, max_len,
    kv_heads, head_dim); per cross-attention block, ck/cv of (repeat, batch,
    enc_len, kv_heads, head_dim); per SSM block, the fp32 conv buffer and
    state of ``init_ssm_state``."""
    kw = dict(device=device, kv_dtype=kv_dtype)
    groups = {}
    for i, gd in enumerate(layer_plan(cfg)):
        blocks = {}
        for j, b in enumerate(gd.blocks):
            if b.kind in ("attn", "parallel", "shared_attn"):
                blocks[f"b{j}"] = _kv_pair(("k", "v"), gd.repeat, batch,
                                           max_len, cfg, **kw)
            elif b.kind == "cross_attn":
                blocks[f"b{j}"] = _kv_pair(("ck", "cv"), gd.repeat, batch,
                                           enc_len, cfg, **kw)
            elif b.kind == "ssm":
                blocks[f"b{j}"] = init_ssm_state(cfg, batch, gd.repeat,
                                                 device=device)
        groups[f"g{i}"] = blocks
    return {"groups": groups}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked tensors (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_block(bp, x, b: BlockDesc, *, cfg, mode, cache, cache_index,
                 cross_states, shared_params, positions):
    """One residual block. Returns (x, new_cache|None, aux).

    Caches are written in place (attention and SSM alike). ``aux`` is the
    MoE router's load-balance loss; other blocks return None where the
    reference adds 0.0 (exact, and one launch fewer per block)."""
    new_cache, aux = None, None

    def maybe_post(out, p):
        return apply_norm(p["post_norm"], out, cfg) if cfg.post_block_norm else out

    if b.kind in ("attn", "shared_attn"):
        p = shared_params if b.kind == "shared_attn" else bp
        h = apply_norm(p["norm"], x, cfg)
        out, new_cache = apply_attention(
            p["attn"], h, cfg=cfg, window=b.window, positions=positions,
            cache=cache, cache_index=cache_index, causal=b.causal, mode=mode)
        x = x + maybe_post(out, p)
        if b.kind == "shared_attn":  # zamba2 shared block = attn + mlp
            h = apply_norm(p["ffn_norm"], x, cfg)
            x = x + apply_ffn(p["ffn"], h, cfg=cfg)
    elif b.kind == "parallel":  # command-r: one norm, attn || ffn
        h = apply_norm(bp["norm"], x, cfg)
        out_a, new_cache = apply_attention(
            bp["attn"], h, cfg=cfg, window=b.window, positions=positions,
            cache=cache, cache_index=cache_index, mode=mode)
        out_f = apply_ffn(bp["ffn"], h, cfg=cfg)
        x = x + out_a + out_f
    elif b.kind == "ffn":
        h = apply_norm(bp["norm"], x, cfg)
        x = x + maybe_post(apply_ffn(bp["ffn"], h, cfg=cfg), bp)
    elif b.kind == "moe":
        h = apply_norm(bp["norm"], x, cfg)
        out, aux = apply_moe(bp["moe"], h, cfg=cfg)
        x = x + maybe_post(out, bp)
    elif b.kind == "ssm":
        h = apply_norm(bp["norm"], x, cfg)
        if mode == "decode":
            out, new_cache = apply_ssm_decode(bp["ssm"], h, cache, cfg=cfg)
        else:
            out, new_cache = apply_ssm(bp["ssm"], h, cfg=cfg, state=cache)
        x = x + maybe_post(out, bp)
    elif b.kind == "cross_attn":
        h = apply_norm(bp["norm"], x, cfg)
        if mode == "decode":      # the encoder's K/V, cached by the prefill
            kv = (cache["ck"], cache["cv"])
            new_cache = cache
        else:
            kv = compute_cross_kv(bp["cross_kv"], cross_states)
            if cache is not None:
                if cache["ck"].shape[1] != kv[0].shape[1]:
                    raise ValueError(
                        f"cross cache made for {cache['ck'].shape[1]} "
                        f"positions, the frames or patches have "
                        f"{kv[0].shape[1]}")
                cache["ck"].copy_(kv[0])
                cache["cv"].copy_(kv[1])
                new_cache = cache
        out, _ = apply_attention(bp["attn"], h, cfg=cfg, cross_kv=kv,
                                 positions=positions, mode=mode)
        x = x + maybe_post(out, bp)
    else:
        raise ValueError(b.kind)
    return x, new_cache, aux


def _apply_group(gp, x, gd: GroupDesc, *, cfg, mode, cache, cache_index,
                 cross_states, shared_params, positions):
    """Run the group's ``repeat`` stacked layers in order. Returns (x, aux,
    cache): aux is the blocks' auxiliary losses summed in layer order from an
    fp32 zero, as the reference's scan carries it.

    Every block writes its slice of the cache in place (the KV cache and the
    SSM conv buffer and state alike), so the blocks' returned caches are
    discarded and the group's new cache is ``cache``.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(gd.repeat):
        bp_all = _layer(gp, i)
        bc_all = None if cache is None else _layer(cache, i)
        for j, b in enumerate(gd.blocks):
            key = f"b{j}"
            bc = None if bc_all is None else bc_all.get(key)
            x, _, aux_j = _apply_block(
                bp_all.get(key), x, b, cfg=cfg, mode=mode, cache=bc,
                cache_index=cache_index, cross_states=cross_states,
                shared_params=shared_params, positions=positions)
            if aux_j is not None:
                aux = aux + aux_j
    return x, aux, cache


def forward(params, inputs, *, cfg, mode="train", cache=None,
            cache_index=None):
    """Run the model.

    inputs: {'tokens': (B, S) int; outside decode, for the encoder-decoder
    'frames': (B, S_enc, d_model), the stub frontend's frame embeddings, and
    for the VLM 'patches': (B, P, d_vision), the stub vision frontend's patch
    embeddings}. Returns (logits fp32, new_cache|None, aux_loss fp32: the MoE
    blocks' load-balance losses, zero without them).

    A prefill writes the cross-attention K/V (of the encoder's states or the
    projected patches) into the cache's ck/cv leaves, which must have been
    made for that length (``enc_len``).
    """
    tokens = inputs["tokens"]
    B, Sq = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens].to(dtype_of(cfg.activ_dtype))
    if cfg.embed_scale:   # the scale rounded to x's dtype, as the reference does
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))

    if cache_index is None:
        positions = torch.arange(Sq, device=dev)[None, :]
        cache_index = 0 if cache is not None else None
    else:
        positions = int(cache_index) + torch.arange(Sq, device=dev)[None, :]

    cross_states = None
    if cfg.family == "vlm" and mode != "decode":
        cross_states = inputs["patches"].to(x.dtype) @ \
            params["vision_proj"].to(x.dtype)
    if cfg.family == "encdec" and mode != "decode":
        cross_states = encode(params, inputs["frames"], cfg=cfg)

    shared_params = params.get("shared")
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    new_groups = {}
    for i, gd in enumerate(layer_plan(cfg)):
        gcache = None if cache is None else cache["groups"].get(f"g{i}")
        x, aux_g, ncache = _apply_group(
            params["groups"][f"g{i}"], x, gd, cfg=cfg, mode=mode,
            cache=gcache, cache_index=cache_index, cross_states=cross_states,
            shared_params=shared_params, positions=positions)
        aux = aux + aux_g
        if ncache is not None:
            new_groups[f"g{i}"] = ncache

    x = apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    logits = softcap(logits.float(), cfg.final_logit_softcap)
    new_cache = {"groups": new_groups} if cache is not None else None
    return logits, new_cache, aux


def encode(params, frames, *, cfg):
    """The encoder over the frame embeddings (B, S_enc, d_model):
    ``in_proj``, the non-causal stack of ``encoder_plan``, ``final_norm``.
    Returns the states that the decoder's cross-attention blocks attend to,
    in the activation dtype."""
    enc = params["encoder"]
    dt = dtype_of(cfg.activ_dtype)
    h = frames.to(dt) @ enc["in_proj"].to(dt)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for i, gd in enumerate(encoder_plan(cfg)):
        h, _, _ = _apply_group(enc["groups"][f"g{i}"], h, gd, cfg=cfg,
                               mode="train", cache=None, cache_index=None,
                               cross_states=None, shared_params=None,
                               positions=positions)
    return apply_norm(enc["final_norm"], h, cfg)

