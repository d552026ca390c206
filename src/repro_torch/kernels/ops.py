"""Kernel entry points with device dispatch.

Counterpart of ``repro.kernels.ops``. ``flash_attention``, ``ssd_scan`` and
``gmm`` go to the hand-written kernels' wrappers, which run the CUDA kernel
on a CUDA tensor and its plain version on a CPU tensor. ``decode_attention``
and ``ssd_decode_step`` are plain torch on every device: they are a GEMV and
a recurrent update in the reference too, not Pallas kernels (a split-KV
decode kernel is queued in ROADMAP.md).
"""
from __future__ import annotations

import torch

from . import ref
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
    """Single-token (Sq small) attention over a cache; plain torch GEMV path.

    q_offset/kv_len may be ints or tensors (dynamic decode position).

    bf16_kv mirrors the reference's mixed precision: scores of the stored K
    in fp32 (the reference's ``preferred_element_type``), softmax in fp32,
    and P rounded to V's dtype before the PV product, accumulated in fp32.
    A product of two bf16 values is exact in fp32, so contracting fp32
    copies gives those fp32 sums; an einsum on the bf16 tensors themselves
    would round the scores to bf16.
    """
    s = _decode_scores(q, k, window=window, logit_softcap=logit_softcap,
                       scale=scale, q_offset=q_offset, kv_len=kv_len,
                       bf16_kv=bf16_kv)
    p = torch.softmax(s, dim=-1)
    return _decode_pv(p, v, q, bf16_kv)


def decode_attention_split(q, k, v, *, k_start: int, pmax, psum, window=0,
                           logit_softcap=0.0, scale=None, q_offset, kv_len,
                           causal: bool = True, bf16_kv: bool = True):
    """``decode_attention`` over a cache split by position across ranks
    (flash-decoding's layout): k, v are this rank's positions ``k_start``
    onwards; q is every rank's same query. ``pmax`` and ``psum`` reduce a
    tensor over the ranks (pmax need not be differentiable: decode is not).

    The masks (causal, window, ``kv_len``) are on global positions; then
    the global row max, the global sum of exp, P normalised and rounded to
    V's dtype as the local path rounds it, and the ranks' PV products
    summed. Each rank's partial softmax is not rescaled on its own: P is
    rounded once, from the global max and sum. ``causal=False`` drops the
    causal mask (cross-attention's cache)."""
    s = _decode_scores(q, k, window=window, logit_softcap=logit_softcap,
                       scale=scale, q_offset=q_offset, kv_len=kv_len,
                       bf16_kv=bf16_kv, k_start=k_start, causal=causal)
    m = pmax(s.amax(dim=-1, keepdim=True))
    e = torch.exp(s - m)
    p = e / psum(e.sum(dim=-1, keepdim=True))
    return psum(_decode_pv(p, v, q, bf16_kv, out_dtype=torch.float32)).to(q.dtype)


def decode_attention_cost(B, Sq, Sk, H, KVH, D) -> tuple[int, int]:
    """(FLOPs, HBM bytes) of one ``decode_attention`` over a cache of Sk
    positions: the score and PV products, 4 B H D Sq Sk; the bf16 cache's K
    and V read and q and the output read or written once. Its ops are plain
    torch, which a census (``launch/op_cost.py``) counts one by one; this is
    the kernel-sized count the reference's dry-run models decode with."""
    return 4 * B * H * D * Sq * Sk, 2 * (2 * B * Sk * KVH * D + 2 * B * Sq * H * D)


def _decode_scores(q, k, *, window, logit_softcap, scale, q_offset, kv_len,
                   bf16_kv, k_start=0, causal=True):
    """Masked fp32 scores (B, KVH, g, Sq, Sk) of q against keys at global
    positions ``k_start`` onwards."""
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    g = H // KVH
    dev = q.device
    scale = scale if scale is not None else D ** -0.5
    if bf16_kv:
        qf = q.float().reshape(B, Sq, KVH, g, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    else:
        qf = (q.float() * scale).reshape(B, Sq, KVH, g, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    # python ints stay kernel arguments: a host-to-card copy of a scalar
    # would wait for the stream on every layer of every decode step
    if isinstance(q_offset, torch.Tensor):
        q_offset = q_offset.to(dev)[..., None]
    if isinstance(kv_len, torch.Tensor):
        kv_len = torch.broadcast_to(kv_len.to(dev), (B,))[:, None, None]
    q_pos = torch.broadcast_to(q_offset + torch.arange(Sq, device=dev), (B, Sq))
    k_pos = torch.arange(k_start, k_start + Sk, device=dev)[None, None, :]
    m = k_pos < kv_len
    if causal:
        m = m & (k_pos <= q_pos[..., None])
    if window:
        m = m & (q_pos[..., None] - k_pos < window)
    return torch.where(m[:, None, None], s, ref.NEG_INF)


def _decode_pv(p, v, q, bf16_kv, out_dtype=None):
    """(B, KVH, g, Sq, Sk) probabilities times V -> (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    if bf16_kv:
        p = p.to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.float(), v.float())
    return o.reshape(B, Sq, H, D).to(out_dtype or q.dtype)


def ssd_scan(x, dt, a_log, b, c, d_skip, *, chunk=128):
    """Chunked Mamba2 SSD; see ``ref.ssd_naive`` for semantics."""
    return ssd_scan_cuda(x, dt, a_log, b, c, d_skip, chunk=chunk)


def ssd_decode_step(state, x_t, dt_t, a_log, b_t, c_t, d_skip):
    return ref.ssd_decode_step(state, x_t, dt_t, a_log, b_t, c_t, d_skip)


def gmm(x, w):
    """Grouped per-expert matmul: (E, C, d) @ (E, d, f) -> (E, C, f)."""
    return gmm_cuda(x, w)
