"""Kernel entry points with device dispatch.

Counterpart of ``repro.kernels.ops``. ``flash_attention``, ``decode_attention``,
``ssd_scan`` and ``gmm`` go to the hand-written kernels' wrappers, which run
the CUDA kernel on a CUDA tensor and its plain version on a CPU tensor; a
census counts each call as one kernel call. ``decode_attention`` has no
Pallas counterpart (a GEMV in the reference): its kernel reads the bf16
cache once, over the visible prefix. ``decode_attention_split`` (a cache
split by position across ranks) and ``ssd_decode_step`` (a recurrent
update) are plain torch on every device.
"""
from __future__ import annotations

import torch

from .. import census
from . import ref
from .decode_attention import decode_attention_cost  # noqa: F401  (re-exported)
from .decode_attention import decode_attention_cuda, decode_pv, decode_scores
from .flash_attention import flash_attention_cuda
from .moe_gmm import gmm_cuda
from .ssd_scan import ssd_scan_cuda


def flash_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                    scale=None, q_offset=0, kv_len=None):
    """Multi-head GQA attention; see ``ref.mha_naive`` for semantics.

    kv_len: None or a python int, the number of valid cache entries.
    """
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=logit_softcap, scale=scale,
                                q_offset=q_offset, kv_valid=kv_len)


def decode_attention(q, k, v, *, window=0, logit_softcap=0.0, scale=None,
                     q_offset, kv_len, bf16_kv: bool = True):
    """One query row a head against a cache: the hand-written kernel on a
    CUDA tensor, its plain version on a CPU one (which also takes several
    rows, tensor positions and ``bf16_kv=False``); see
    ``decode_attention.decode_attention_plain`` for the arithmetic."""
    with census.span("decode_attention", B=q.shape[0], Sk=k.shape[1]):
        return decode_attention_cuda(q, k, v, window=window,
                                     logit_softcap=logit_softcap, scale=scale,
                                     q_offset=q_offset, kv_len=kv_len,
                                     bf16_kv=bf16_kv)


def decode_attention_split(q, k, v, *, k_start: int, pmax, psum, window=0,
                           logit_softcap=0.0, scale=None, q_offset, kv_len,
                           causal: bool = True, bf16_kv: bool = True):
    """``decode_attention`` over a cache split by position across ranks
    (flash-decoding's layout), in plain torch on every device: k, v are this
    rank's positions ``k_start`` onwards; q is every rank's same query.
    ``pmax`` and ``psum`` reduce a tensor over the ranks (pmax need not be
    differentiable: decode is not).

    The masks (causal, window, ``kv_len``) are on global positions; then
    the global row max, the global sum of exp, P normalised and rounded to
    V's dtype as the local path rounds it, and the ranks' PV products
    summed. Each rank's partial softmax is not rescaled on its own: P is
    rounded once, from the global max and sum. ``causal=False`` drops the
    causal mask (cross-attention's cache)."""
    with census.span("decode_attention", B=q.shape[0], Sk=k.shape[1]):
        s = decode_scores(q, k, window=window, logit_softcap=logit_softcap,
                          scale=scale, q_offset=q_offset, kv_len=kv_len,
                          bf16_kv=bf16_kv, k_start=k_start, causal=causal)
        m = pmax(s.amax(dim=-1, keepdim=True))
        e = torch.exp(s - m)
        p = e / psum(e.sum(dim=-1, keepdim=True))
        return psum(decode_pv(p, v, q, bf16_kv,
                              out_dtype=torch.float32)).to(q.dtype)


def ssd_scan(x, dt, a_log, b, c, d_skip, *, chunk=128):
    """Chunked Mamba2 SSD; see ``ref.ssd_naive`` for semantics."""
    return ssd_scan_cuda(x, dt, a_log, b, c, d_skip, chunk=chunk)


def ssd_decode_step(state, x_t, dt_t, a_log, b_t, c_t, d_skip):
    return ref.ssd_decode_step(state, x_t, dt_t, a_log, b_t, c_t, d_skip)


def gmm(x, w):
    """Grouped per-expert matmul: (E, C, d) @ (E, d, f) -> (E, C, f)."""
    return gmm_cuda(x, w)
