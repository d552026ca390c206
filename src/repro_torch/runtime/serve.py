"""Serving steps: prefill, decode (KV cache / SSM state), sampling, batching.

Counterpart of ``repro.runtime.serve``. PyTorch runs eagerly, so the steps
are plain functions; ``ServeSession`` is the real-execution path (batched
prefill, then a decode loop).

The mesh path (``jit_prefill_step`` / ``jit_decode_step``), one process per
device: the weights are DTensors placed by ``SERVING_RULES`` (dense weights
split on the model axis only; experts EP over model, with ``expert_tp`` f
over data too), gathered to full on use one layer group at a time (experts
to their expert-parallel blocks); each rank computes on its batch shard
with its own cache (``mesh_cache``: the batch split over the data axes),
and the step returns the whole batch's tokens and logits on every rank.
``cache_shardings`` gives the rule table's assignment of the cache
(sequence- or head-parallel over model), which the tensor-parallel compute
of a later slice will hold.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import collectives
from .._bridge import resolve_device
from ..models.common import dtype_of
from ..models.model_zoo import Model
from ..models.moe import LOCAL, DistContext
from . import sharding as shd
from .train import use_specs


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


def mesh_cache(model: Model, opts: ServeOptions, mesh, batch: int,
               max_len: int, enc_len: int = 0, device=None):
    """The mesh steps' cache: DTensors whose batch dim (dim 1) is split over
    the data axes, each rank's shard zeroed on ``device`` (default
    ``cuda``)."""
    from torch.distributed.tensor import DTensor
    device = resolve_device(device)

    def make(meta):
        if isinstance(meta, dict):
            return {k: make(v) for k, v in meta.items()}
        spec = shd.spec_for_axes((None, "batch"), meta.shape, mesh)
        t = torch.zeros(shd.local_part(meta, spec, mesh).shape,
                        dtype=meta.dtype, device=device)
        return DTensor.from_local(t, mesh, shd.placements(spec, mesh),
                                  run_check=False)

    return make(abstract_cache(model, batch, max_len, enc_len,
                               dtype_of(opts.kv_dtype)))


def _check_placements(tree, want, what: str):
    got = shd.spec_tree_of(tree)
    if got != want:
        raise ValueError(f"{what} are not placed as the rule table says")


def _gathered_params(params, use, mesh):
    """DTensor params as the forward reads them (``gather_on_use``)."""
    return shd.gather_on_use(shd.local_tree(params), shd.spec_tree_of(params),
                             use, mesh)


def _whole_batch(t, rows: int, mesh):
    """A step's per-rank rows gathered into the batch of ``rows`` rows."""
    spec = shd.data_spec((rows,), mesh)
    if not spec:
        return t
    return collectives.all_gather(t, mesh, shd.spec_axes(spec[0]), dim=0)


def _next_token(last, opts: ServeOptions, generator=None):
    """(B, V) fp32 logits -> (B, 1) tokens: argmax (first maximum, as
    ``jnp.argmax``), or a draw from ``generator`` when temperature > 0."""
    if opts.temperature > 0 and generator is not None:
        probs = torch.softmax(last / opts.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(last, dim=-1)[:, None]


def build_prefill_step(model: Model, opts: ServeOptions, mesh=None):
    """(params, inputs, cache) -> (last position's logits, cache). With a
    mesh: DTensor params, the whole batch's inputs and a ``mesh_cache``;
    the logits of the whole batch on every rank."""
    dist = make_dist(mesh, opts)
    use = None if mesh is None else use_specs(model, dist)

    def prefill(params, inputs, cache):
        if mesh is None:
            logits, cache, _ = model.apply(params, inputs, mode="prefill",
                                           cache=cache, cache_index=0)
            return logits[:, -1], cache
        logits, _, _ = model.apply(
            _gathered_params(params, use, mesh), shd.local_batch(inputs, mesh),
            mode="prefill", dist=dist, cache=shd.local_tree(cache),
            cache_index=0)
        rows = inputs["tokens"].shape[0]
        return _whole_batch(logits[:, -1], rows, mesh), cache

    return prefill


def build_decode_step(model: Model, opts: ServeOptions, mesh=None):
    dist = make_dist(mesh, opts)
    use = None if mesh is None else use_specs(model, dist)

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
            logits, _, _ = model.apply(
                _gathered_params(params, use, mesh),
                shd.local_batch({"tokens": tokens}, mesh), mode="decode",
                dist=dist, cache=shd.local_tree(cache), cache_index=index)
            last = _whole_batch(logits[:, -1], tokens.shape[0], mesh)
        return _next_token(last, opts, generator), last, cache

    return decode


def jit_decode_step(model: Model, opts: ServeOptions, mesh, batch: int,
                    max_len: int, enc_len: int = 0, rules=shd.SERVING_RULES):
    """The mesh decode step and (params, cache) as meta tensors. The step
    takes params placed by ``rules`` (``shard_params``), a ``mesh_cache``,
    the whole batch's (B, 1) tokens and the position; it checks the
    params' placements."""
    decode = build_decode_step(model, opts, mesh)
    p_abs = model.abstract()
    p_sh = shd.tree_shardings(model.axes(), p_abs, mesh, rules)
    cache_abs = abstract_cache(model, batch, max_len, enc_len,
                               dtype_of(opts.kv_dtype))

    def fn(params, cache, tokens, index):
        _check_placements(params, p_sh, "params")
        return decode(params, cache, tokens, index)

    return fn, (p_abs, cache_abs)


def jit_prefill_step(model: Model, opts: ServeOptions, mesh, batch: int,
                     seq_len: int, rules=shd.SERVING_RULES):
    """The mesh prefill step and (params, inputs, cache) as meta tensors;
    the step takes what ``jit_decode_step``'s does, with the whole batch's
    inputs."""
    prefill = build_prefill_step(model, opts, mesh)
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
