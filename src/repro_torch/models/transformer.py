"""Decoder stack: layer plans, a loop over stacked layers, caches.

Counterpart of ``repro.models.transformer`` for every family: dense, MoE,
SSM, hybrid, encoder-decoder and VLM. Every architecture is a *layer plan*,
a tuple of ``GroupDesc`` entries; each group's parameters are stacked per
layer (leading ``layers`` axis, the reference's layout), and the group runs
as a Python loop that indexes layer ``i`` of the stacked tensors in place of
``jax.lax.scan``.

In ``train`` mode each layer of a group can be one checkpointed unit
(``remat_policy``, as the reference checkpoints one scan step).

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
from torch.utils import checkpoint as torch_checkpoint

from .attention import (apply_attention, attention_specs, compute_cross_kv,
                        cross_kv_specs, write_cache)
from .common import (ParamSpec, apply_norm, dtype_of, norm_spec, softcap,
                     stack_specs)
from .ffn import apply_ffn, ffn_specs
from .moe import LOCAL, DistContext, apply_moe, moe_specs
from .ssm import apply_ssm, apply_ssm_decode, init_ssm_state, ssm_specs
from .tp import TP, embed_lookup, of as tp_of

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


def _layers(tree, n: int) -> list:
    """The ``n`` layers of a tree of stacked tensors (views, no copies), by
    one ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where indexing each layer would make a zero-filled full-size gradient
    per layer. A mesh step's group (``runtime/sharding.py::GroupOnUse``)
    gives one function per layer, which moves the layer's weights to their
    use blocks when called."""
    if tree is None:
        return [None] * n
    if hasattr(tree, "layers"):
        return tree.layers(n)
    if isinstance(tree, dict):
        per_key = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: layers[i] for k, layers in per_key.items()}
                for i in range(n)]
    return list(torch.unbind(tree, 0))


# remat "dots": matmul outputs without batch dims are saved, everything else
# recomputed (jax.checkpoint_policies.dots_with_no_batch_dims_saveable); a
# (B, S, d) @ (d, f) product runs as one aten.mm
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    policy = torch_checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def _maybe_remat(body, remat_policy: str | None, mode: str):
    """remat_policy: None (no remat) | 'full' | 'dots' | 'minimal', in
    ``train`` mode only; ``torch.utils.checkpoint`` without reentrance.
    'minimal' saves everything (the reference's everything_saveable), which
    is what autograd does without a checkpoint."""
    if remat_policy not in (None, "full", "dots", "minimal"):
        raise ValueError(remat_policy)
    if remat_policy in (None, "minimal") or mode != "train":
        return body
    if remat_policy == "full":
        context_fn = torch_checkpoint.noop_context_fn
    else:
        def context_fn():
            return torch_checkpoint.create_selective_checkpoint_contexts(
                _dots_policy)

    def remat_body(*args):
        return torch_checkpoint.checkpoint(body, *args, use_reentrant=False,
                                           context_fn=context_fn)
    return remat_body


def _apply_block(bp, x, b: BlockDesc, *, cfg, dist, mode, cache, cache_index,
                 cross_states, shared_params, positions, tp: TP = TP(),
                 shared_tp: TP = TP()):
    """One residual block. Returns (x, new_cache|None, aux).

    Caches are written in place (attention and SSM alike). ``aux`` is the
    MoE router's load-balance loss; other blocks return None where the
    reference adds 0.0 (exact, and one launch fewer per block). ``tp`` is
    the block's tensor-parallel view (``shared_tp`` the shared block's
    weights'): attention, MLP, shared experts and Mamba2 blocks compute the
    rank's block."""
    new_cache, aux = None, None

    def maybe_post(out, p):
        return apply_norm(p["post_norm"], out, cfg) if cfg.post_block_norm else out

    if b.kind in ("attn", "shared_attn"):
        p = shared_params if b.kind == "shared_attn" else bp
        ptp = shared_tp.with_cache(tp.cache) if b.kind == "shared_attn" else tp
        h = apply_norm(p["norm"], x, cfg)
        out, new_cache = apply_attention(
            p["attn"], h, cfg=cfg, window=b.window, positions=positions,
            cache=cache, cache_index=cache_index, causal=b.causal, mode=mode,
            tp=ptp.sub("attn"))
        x = x + maybe_post(out, p)
        if b.kind == "shared_attn":  # zamba2 shared block = attn + mlp
            h = apply_norm(p["ffn_norm"], x, cfg)
            x = x + apply_ffn(p["ffn"], h, cfg=cfg, tp=ptp.sub("ffn"))
    elif b.kind == "parallel":  # command-r: one norm, attn || ffn
        h = apply_norm(bp["norm"], x, cfg)
        out_a, new_cache = apply_attention(
            bp["attn"], h, cfg=cfg, window=b.window, positions=positions,
            cache=cache, cache_index=cache_index, mode=mode,
            tp=tp.sub("attn"))
        out_f = apply_ffn(bp["ffn"], h, cfg=cfg, tp=tp.sub("ffn"))
        x = x + out_a + out_f
    elif b.kind == "ffn":
        h = apply_norm(bp["norm"], x, cfg)
        x = x + maybe_post(apply_ffn(bp["ffn"], h, cfg=cfg,
                                     tp=tp.sub("ffn")), bp)
    elif b.kind == "moe":
        h = apply_norm(bp["norm"], x, cfg)
        out, aux = apply_moe(bp["moe"], h, cfg=cfg, dist=dist,
                             tp=tp.sub("moe"))
        x = x + maybe_post(out, bp)
    elif b.kind == "ssm":
        h = apply_norm(bp["norm"], x, cfg)
        if mode == "decode":
            out, new_cache = apply_ssm_decode(bp["ssm"], h, cache, cfg=cfg,
                                              tp=tp.sub("ssm"))
        else:
            out, new_cache = apply_ssm(bp["ssm"], h, cfg=cfg, state=cache,
                                       tp=tp.sub("ssm"))
        x = x + maybe_post(out, bp)
    elif b.kind == "cross_attn":
        h = apply_norm(bp["norm"], x, cfg)
        if mode == "decode":      # the encoder's K/V, cached by the prefill
            kv = (cache["ck"], cache["cv"])
            new_cache = cache
        else:
            kv = compute_cross_kv(bp["cross_kv"], cross_states)
            if cache is not None:
                made = cache["ck"].shape[1] * \
                    (tp.size if tp.cache_split("ck", 1) else 1)
                if made != kv[0].shape[1]:
                    raise ValueError(
                        f"cross cache made for {made} positions, the frames "
                        f"or patches have {kv[0].shape[1]}")
                write_cache(cache, ("ck", "cv"), kv, 0, tp)
                new_cache = cache
        out, _ = apply_attention(bp["attn"], h, cfg=cfg, cross_kv=kv,
                                 positions=positions, mode=mode,
                                 tp=tp.sub("attn"))
        x = x + maybe_post(out, bp)
    else:
        raise ValueError(b.kind)
    return x, new_cache, aux


def _apply_group(gp, x, gd: GroupDesc, *, cfg, dist, mode, cache, cache_index,
                 cross_states, shared_params, positions, remat_policy=None,
                 tp: TP = TP(), shared_tp: TP = TP()):
    """Run the group's ``repeat`` stacked layers in order. Returns (x, aux,
    cache): aux is the blocks' auxiliary losses summed in layer order from an
    fp32 zero, as the reference's scan carries it. With ``remat_policy`` in
    ``train`` mode, each layer (all of its blocks) is one checkpointed unit.

    Every block writes its slice of the cache in place (the KV cache and the
    SSM conv buffer and state alike), so the blocks' returned caches are
    discarded and the group's new cache is ``cache``. ``tp`` is the group's
    per-layer tensor-parallel view. On a mesh each layer's weights move to
    their use blocks when the layer runs, within its checkpointed unit:
    under remat one layer's gathered weights are live at a time, and none
    is kept for the backward.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp_all, bc_all in zip(_layers(gp, gd.repeat),
                              _layers(cache, gd.repeat)):
        def body(x, aux, bp_all=bp_all, bc_all=bc_all):
            if callable(bp_all):      # moved here: inside the remat unit
                bp_all = bp_all()
            for j, b in enumerate(gd.blocks):
                key = f"b{j}"
                bc = None if bc_all is None else bc_all.get(key)
                btp = tp.block(key)
                with btp.at():
                    x, _, aux_j = _apply_block(
                        bp_all.get(key), x, b, cfg=cfg, dist=dist, mode=mode,
                        cache=bc, cache_index=cache_index,
                        cross_states=cross_states, shared_params=shared_params,
                        positions=positions, tp=btp, shared_tp=shared_tp)
                if aux_j is not None:
                    aux = aux + aux_j
            return x, aux

        x, aux = _maybe_remat(body, remat_policy, mode)(x, aux)
    return x, aux, cache


def forward(params, inputs, *, cfg, dist: DistContext = LOCAL, mode="train",
            cache=None, cache_index=None, remat_policy=None,
            scan_unroll: int = 1):
    """Run the model.

    remat_policy: None | 'full' | 'dots' | 'minimal', applied per layer in
    ``train`` mode (the encoder's layers too). scan_unroll is accepted for
    parity with the reference, where it unrolls ``jax.lax.scan``; the layers
    here are a Python loop, so it has no effect.

    inputs: {'tokens': (B, S) int; outside decode, for the encoder-decoder
    'frames': (B, S_enc, d_model), the stub frontend's frame embeddings, and
    for the VLM 'patches': (B, P, d_vision), the stub vision frontend's patch
    embeddings}. Returns (logits fp32, new_cache|None, aux_loss fp32: the MoE
    blocks' load-balance losses, zero without them).

    A prefill writes the cross-attention K/V (of the encoder's states or the
    projected patches) into the cache's ck/cv leaves, which must have been
    made for that length (``enc_len``).

    ``dist`` says how the layers distribute themselves: the MoE layers by
    the expert-parallel path of ``models/moe.py`` when it has a mesh, the
    attention, MLP and vocabulary tensor parallel over the model axis by
    ``dist.use`` (``models/tp.py``), on the rank's own rows. With a
    vocab-split output embedding the logits are the rank's vocabulary
    block (``tp.vocab_split``).
    """
    tokens = inputs["tokens"]
    B, Sq = tokens.shape
    dev = tokens.device
    root = tp_of(dist)
    x = embed_lookup(params["embed"], tokens, root).to(dtype_of(cfg.activ_dtype))
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
        cross_states = encode(params, inputs["frames"], cfg=cfg, dist=dist,
                              remat_policy=remat_policy, tp=root.block("encoder"))

    shared_params = params.get("shared")
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    new_groups = {}
    for i, gd in enumerate(layer_plan(cfg)):
        gcache = None if cache is None else cache["groups"].get(f"g{i}")
        x, aux_g, ncache = _apply_group(
            params["groups"][f"g{i}"], x, gd, cfg=cfg, dist=dist, mode=mode,
            cache=gcache, cache_index=cache_index, cross_states=cross_states,
            shared_params=shared_params, positions=positions,
            remat_policy=remat_policy, tp=root.group("groups", f"g{i}"),
            shared_tp=root.sub("shared"))
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


def encode(params, frames, *, cfg, dist: DistContext = LOCAL,
           remat_policy=None, tp: TP = TP()):
    """The encoder over the frame embeddings (B, S_enc, d_model):
    ``in_proj``, the non-causal stack of ``encoder_plan``, ``final_norm``.
    Returns the states that the decoder's cross-attention blocks attend to,
    in the activation dtype. Its layers run in ``train`` mode, so
    ``remat_policy`` applies to them, as in the reference."""
    enc = params["encoder"]
    dt = dtype_of(cfg.activ_dtype)
    h = frames.to(dt) @ enc["in_proj"].to(dt)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for i, gd in enumerate(encoder_plan(cfg)):
        h, _, _ = _apply_group(enc["groups"][f"g{i}"], h, gd, cfg=cfg,
                               dist=dist, mode="train", cache=None,
                               cache_index=None, cross_states=None,
                               shared_params=None, positions=positions,
                               remat_policy=remat_policy,
                               tp=tp.group("groups", f"g{i}"))
    return apply_norm(enc["final_norm"], h, cfg)

