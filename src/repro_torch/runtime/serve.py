"""Serving steps: prefill, decode (KV cache / SSM state), sampling, batching.

Counterpart of ``repro.runtime.serve``. PyTorch runs eagerly, so the steps
are plain functions; ``ServeSession`` is the real-execution path (batched
prefill, then a decode loop).

The mesh path (``jit_prefill_step`` / ``jit_decode_step``), one process per
device: the weights are DTensors placed by ``SERVING_RULES`` (dense weights
split on the model axis only; experts EP over model, with ``expert_tp`` f
over data too), moved on use one layer group at a time to the blocks a rank
computes with (``train.use_specs``: heads, MLP columns and vocabulary
tensor parallel over model, ``models/tp.py``; experts their
expert-parallel blocks; SSM weights whole). Each rank computes on its
batch shard with its own cache (``mesh_cache``): the attention leaves
placed by ``cache_shardings`` (head-parallel over model where model
divides ``kv_heads``, else sequence-parallel over the positions where it
divides them), the SSM leaves split over the batch only. The step gathers
the last position's logits over model where the vocabulary is split, and
returns the whole batch's tokens and logits on every rank.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .. import collectives
from .._bridge import resolve_device
from ..models import tp as tp_mod
from ..models.common import dtype_of
from ..models.model_zoo import Model
from ..models.moe import LOCAL, DistContext
from ..tree import leaves_with_path
from . import sharding as shd
from .train import tp_dist


@dataclass(frozen=True)
class ServeOptions:
    kv_dtype: str = "bfloat16"
    temperature: float = 0.0      # 0 = greedy
    fsdp_experts: bool = False    # serving default: keep experts TP-only
    expert_tp: bool = False       # 2D expert sharding (SERVING_RULES)
    moe_capacity_cap: int = 0     # decode capacity cap (0 = the default rule)
    scan_unroll: int = 1          # no effect: the layers are a loop


def make_dist(mesh, opts: ServeOptions) -> DistContext:
    if mesh is None:
        return LOCAL
    return DistContext(mesh=mesh, data_axes=shd.batch_axes(mesh),
                       model_axis="model", fsdp_experts=opts.fsdp_experts,
                       ep=True, expert_tp=opts.expert_tp,
                       capacity_cap=opts.moe_capacity_cap)


def cache_shardings(model: Model, cache_abstract, mesh, rules=None):
    axes = shd.cache_logical_axes(cache_abstract)
    return shd.tree_shardings(axes, cache_abstract, mesh, rules)


def abstract_cache(model: Model, batch: int, max_len: int, enc_len: int = 0,
                   kv_dtype=torch.bfloat16):
    """The decode cache as meta-device tensors (shapes and dtypes only)."""
    return model.init_cache(batch, max_len, enc_len=enc_len, device="meta",
                            kv_dtype=kv_dtype)


def shard_params(params, model: Model, mesh, rules=shd.SERVING_RULES):
    """Full params (the same on every rank) as DTensors placed by ``rules``."""
    specs = shd.tree_shardings(model.axes(), model.abstract(), mesh, rules)
    return shd.distribute(params, specs, mesh)


ATTENTION_CACHE = ("k", "v", "ck", "cv")


def mesh_cache_specs(model: Model, cache_abstract, mesh, rules=None):
    """The mesh steps' cache placements: the attention leaves'
    ``cache_shardings``; the SSM leaves' batch dim (dim 1) split over the
    data axes, nothing else (their model-axis split is ROADMAP.md A14)."""
    want = cache_shardings(model, cache_abstract, mesh, rules)

    def walk(meta, spec, name=""):
        if isinstance(meta, dict):
            return {k: walk(v, spec[k], k) for k, v in meta.items()}
        if name in ATTENTION_CACHE:
            return spec
        return shd.spec_for_axes((None, "batch"), meta.shape, mesh)

    return walk(cache_abstract, want)


def mesh_cache(model: Model, opts: ServeOptions, mesh, batch: int,
               max_len: int, enc_len: int = 0, device=None):
    """The mesh steps' cache: DTensors placed by ``mesh_cache_specs``, each
    rank's shard zeroed on ``device`` (default ``cuda``)."""
    from torch.distributed.tensor import DTensor
    device = resolve_device(device)
    meta = abstract_cache(model, batch, max_len, enc_len,
                          dtype_of(opts.kv_dtype))

    def make(meta, spec):
        if isinstance(meta, dict):
            return {k: make(v, spec[k]) for k, v in meta.items()}
        t = torch.zeros(shd.local_part(meta, spec, mesh).shape,
                        dtype=meta.dtype, device=device)
        return DTensor.from_local(t, mesh, shd.placements(spec, mesh),
                                  run_check=False)

    return make(meta, mesh_cache_specs(model, meta, mesh))


def _meta(tree):
    """A tree of DTensors as meta tensors of their global shapes."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _check_placements(tree, want, what: str):
    got = shd.spec_tree_of(tree)
    if got != want:
        wrong = [path for path, spec in leaves_with_path(
            got, is_leaf=lambda t: isinstance(t, tuple))
            if spec != shd.tree_at(want, path)]
        raise ValueError(f"{what} are not placed as the rule table says: "
                         f"{['/'.join(p) for p in wrong]}")


def _gathered_params(params, use, mesh):
    """DTensor params as the forward reads them (``gather_on_use``)."""
    return shd.gather_on_use(shd.local_tree(params), shd.spec_tree_of(params),
                             use, mesh)


def _whole_batch(last, rows: int, dist: DistContext, cfg):
    """A step's per-rank last logits (B_rank, V_rank) gathered into the
    batch of ``rows`` rows and the whole vocabulary."""
    if tp_mod.vocab_split(dist, cfg):
        last = tp_mod.of(dist).gather(last, -1)
    spec = shd.data_spec((rows,), dist.mesh)
    if not spec:
        return last
    return collectives.all_gather(last, dist.mesh, shd.spec_axes(spec[0]),
                                  dim=0)


def _on_cache(dist: DistContext, cache) -> DistContext:
    """``dist`` with the placements of the mesh cache it computes on."""
    return dataclasses.replace(dist, cache_specs=shd.spec_tree_of(cache))


def _next_token(last, opts: ServeOptions, generator=None):
    """(B, V) fp32 logits -> (B, 1) tokens: argmax (first maximum, as
    ``jnp.argmax``), or a draw from ``generator`` when temperature > 0."""
    if opts.temperature > 0 and generator is not None:
        probs = torch.softmax(last / opts.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(last, dim=-1)[:, None]


def build_prefill_step(model: Model, opts: ServeOptions, mesh=None,
                       rules=shd.SERVING_RULES):
    """(params, inputs, cache) -> (last position's logits, cache). With a
    mesh: DTensor params placed by ``rules``, the whole batch's inputs and
    a ``mesh_cache``; the logits of the whole batch on every rank."""
    dist = tp_dist(model, make_dist(mesh, opts), rules)

    def prefill(params, inputs, cache):
        if mesh is None:
            logits, cache, _ = model.apply(params, inputs, mode="prefill",
                                           cache=cache, cache_index=0)
            return logits[:, -1], cache
        d = _on_cache(dist, cache)
        logits, _, _ = model.apply(
            _gathered_params(params, d.use, mesh),
            shd.local_batch(inputs, mesh), mode="prefill", dist=d,
            cache=shd.local_tree(cache), cache_index=0)
        rows = inputs["tokens"].shape[0]
        return _whole_batch(logits[:, -1], rows, d, model.cfg), cache

    return prefill


def build_decode_step(model: Model, opts: ServeOptions, mesh=None,
                      rules=shd.SERVING_RULES):
    dist = tp_dist(model, make_dist(mesh, opts), rules)

    def decode(params, cache, tokens, index, generator=None):
        """tokens: (B, 1); index: int position. -> (next, last, cache).

        Samples from ``generator`` when temperature > 0 and one is given (the
        reference samples when given a key); otherwise greedy. With a mesh,
        as the prefill: the whole batch's tokens in and out on every rank."""
        if mesh is None:
            logits, cache, _ = model.apply(params, {"tokens": tokens},
                                           mode="decode", cache=cache,
                                           cache_index=index)
            last = logits[:, -1]
        else:
            d = _on_cache(dist, cache)
            logits, _, _ = model.apply(
                _gathered_params(params, d.use, mesh),
                shd.local_batch({"tokens": tokens}, mesh), mode="decode",
                dist=d, cache=shd.local_tree(cache), cache_index=index)
            last = _whole_batch(logits[:, -1], tokens.shape[0], d, model.cfg)
        return _next_token(last, opts, generator), last, cache

    return decode


def jit_decode_step(model: Model, opts: ServeOptions, mesh, batch: int,
                    max_len: int, enc_len: int = 0, rules=shd.SERVING_RULES):
    """The mesh decode step and (params, cache) as meta tensors. The step
    takes params placed by ``rules`` (``shard_params``), a ``mesh_cache``,
    the whole batch's (B, 1) tokens and the position; it checks the
    params' and the cache's placements."""
    decode = build_decode_step(model, opts, mesh, rules)
    p_abs = model.abstract()
    p_sh = shd.tree_shardings(model.axes(), p_abs, mesh, rules)
    cache_abs = abstract_cache(model, batch, max_len, enc_len,
                               dtype_of(opts.kv_dtype))
    c_sh = mesh_cache_specs(model, cache_abs, mesh)

    def fn(params, cache, tokens, index):
        _check_placements(params, p_sh, "params")
        _check_placements(cache, c_sh, "cache leaves")
        return decode(params, cache, tokens, index)

    return fn, (p_abs, cache_abs)


def jit_prefill_step(model: Model, opts: ServeOptions, mesh, batch: int,
                     seq_len: int, rules=shd.SERVING_RULES):
    """The mesh prefill step and (params, inputs, cache) as meta tensors;
    the step takes what ``jit_decode_step``'s does, with the whole batch's
    inputs."""
    prefill = build_prefill_step(model, opts, mesh, rules)
    enc_len = model.enc_len_for(seq_len)
    p_abs = model.abstract()
    p_sh = shd.tree_shardings(model.axes(), p_abs, mesh, rules)
    cache_abs = abstract_cache(model, batch, seq_len, enc_len,
                               dtype_of(opts.kv_dtype))
    in_abs = {"tokens": torch.empty((batch, seq_len), dtype=torch.int64,
                                    device="meta"),
              **model.extra_inputs(batch, seq_len, device="meta")}

    def fn(params, inputs, cache):
        _check_placements(params, p_sh, "params")
        # the cache is the decode's, of its own length
        _check_placements(cache, mesh_cache_specs(model, _meta(cache), mesh),
                          "cache leaves")
        return prefill(params, inputs, cache)

    return fn, (p_abs, in_abs, cache_abs)


def cross_len(extras: dict) -> int:
    """The cross-attention source length of a prefill's modality inputs:
    the encoder-decoder's frames or the VLM's patches (0 without either)."""
    for name in ("frames", "patches"):
        if name in extras:
            return extras[name].shape[1]
    return 0


class ServeSession:
    """Batched request serving against a locally-materialized model.

    ``device`` defaults to ``cuda`` and raises when no card is present;
    ``params`` must already live there. ``generate`` decodes greedily at any
    temperature, token for token as the reference's session does (it passes
    its decode step no key); sampling is the decode step's, given a
    generator.
    """

    def __init__(self, model: Model, params, opts: ServeOptions = ServeOptions(),
                 *, device=None):
        self.device = resolve_device(device)
        where = params["embed"].device
        if where.type != self.device.type:
            raise ValueError(f"params are on {where}, the session on "
                             f"{self.device}")
        self.model, self.params, self.opts = model, params, opts
        self._prefill = build_prefill_step(model, opts)
        self._decode = build_decode_step(model, opts)

    @torch.inference_mode()
    def generate(self, prompts, max_new_tokens: int = 32, extras=None):
        """prompts: (B, S) int tensor -> (B, max_new_tokens) int64.

        ``extras``: modality inputs for the prefill, ``{"frames": (B, S_enc,
        d_model)}`` for the encoder-decoder or ``{"patches": (B, P,
        d_vision)}`` for the VLM; the cross-attention cache is sized by their
        length (the reference sizes it by ``enc_len_for(S)``, the prompt's
        length for the encoder-decoder, and its prefill replaces the
        leaves)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        B, S = prompts.shape
        extras = extras or {}
        enc_len = cross_len(extras)
        cache = self.model.init_cache(B, S + max_new_tokens, enc_len=enc_len,
                                      device=self.device,
                                      kv_dtype=dtype_of(self.opts.kv_dtype))
        inputs = {"tokens": prompts, **extras}
        last_logits, cache = self._prefill(self.params, inputs, cache)
        tok = torch.argmax(last_logits, dim=-1)[:, None]
        out = [tok]
        for idx in range(S, S + max_new_tokens - 1):
            tok, _, cache = self._decode(self.params, cache, tok, idx)
            out.append(tok)
        return torch.cat(out, dim=1)
