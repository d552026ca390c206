"""Serving steps: prefill, decode (KV cache / SSM state), sampling, batching.

Counterpart of the local (``mesh=None``) path of ``repro.runtime.serve``.
PyTorch runs eagerly, so the steps are plain functions; ``ServeSession`` is
the real-execution path (batched prefill, then a decode loop).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .._bridge import resolve_device
from ..models.common import dtype_of
from ..models.model_zoo import Model


@dataclass(frozen=True)
class ServeOptions:
    kv_dtype: str = "bfloat16"
    temperature: float = 0.0      # 0 = greedy


def _next_token(last, opts: ServeOptions, generator=None):
    """(B, V) fp32 logits -> (B, 1) tokens: argmax (first maximum, as
    ``jnp.argmax``), or a draw from ``generator`` when temperature > 0."""
    if opts.temperature > 0 and generator is not None:
        probs = torch.softmax(last / opts.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(last, dim=-1)[:, None]


def build_prefill_step(model: Model, opts: ServeOptions):
    del opts  # no prefill option yet; kept for the reference's signature

    def prefill(params, inputs, cache):
        logits, cache, _ = model.apply(params, inputs, mode="prefill",
                                       cache=cache, cache_index=0)
        return logits[:, -1], cache

    return prefill


def build_decode_step(model: Model, opts: ServeOptions):

    def decode(params, cache, tokens, index, generator=None):
        """tokens: (B, 1); index: int position. -> (next, last, cache).

        Samples from ``generator`` when temperature > 0 and one is given (the
        reference samples when given a key); otherwise greedy."""
        logits, cache, _ = model.apply(params, {"tokens": tokens},
                                       mode="decode", cache=cache,
                                       cache_index=index)
        last = logits[:, -1]
        return _next_token(last, opts, generator), last, cache

    return decode


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
