"""Plain-torch reference oracles for the attention kernels.

The torch twin of the attention half of ``repro.kernels.ref``:

- ``mha_naive``   : materializes the full scores. The ground-truth oracle.
- ``mha_chunked`` : online softmax over kv blocks (a Python loop in place of
                    ``jax.lax.scan``). Numerically equal to the naive tier
                    with O(block) intermediates; the plain version of the
                    flash-attention kernel and the CPU execution path.

Both compute in fp32 whatever the input dtype and return q's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def _mask(q_pos, k_pos, *, causal: bool, window: int, kv_len=None):
    """Boolean mask (..., q, k): True = attend."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window:
        m &= qp - kp < window
    if kv_len is not None:
        m = m & (kp < kv_len[..., None, None])
    return m


def _as_kv_len(kv_len, batch: int, device):
    if kv_len is None or isinstance(kv_len, torch.Tensor):
        return kv_len
    return torch.full((batch,), int(kv_len), dtype=torch.int64, device=device)


def mha_naive(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
              scale=None, q_offset=0, kv_len=None):
    """Full-scores attention.

    q: (B, Sq, H, D); k, v: (B, Sk, KVH, D). GQA via head grouping.
    q_offset: absolute position of q[0] (for decode).
    kv_len: optional (B,) valid kv lengths (for cache decode).
    Returns (B, Sq, H, D).
    """
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    g = H // KVH
    dev = q.device
    scale = scale if scale is not None else D ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, KVH, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    s = _softcap(s, logit_softcap)
    q_pos = torch.arange(Sq, device=dev) + q_offset
    k_pos = torch.arange(Sk, device=dev)
    m = _mask(q_pos[None], k_pos[None], causal=causal, window=window,
              kv_len=_as_kv_len(kv_len, B, dev))          # (B or 1, q, k)
    s = torch.where(m[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def mha_chunked(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                scale=None, q_offset=0, kv_len=None, block_k=1024):
    """Flash-style online-softmax attention, looping over kv blocks.

    Same signature/semantics as :func:`mha_naive`; intermediates are
    O(Sq * block_k) instead of O(Sq * Sk).
    """
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    g = H // KVH
    dev = q.device
    scale = scale if scale is not None else D ** -0.5
    block_k = min(block_k, Sk)
    pad = (-Sk) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nblk = k.shape[1] // block_k
    kv_len = _as_kv_len(kv_len, B, dev)

    qf = (q.float() * scale).reshape(B, Sq, KVH, g, D)
    q_pos = torch.arange(Sq, device=dev) + q_offset
    m_run = torch.full((B, KVH, g, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((B, KVH, g, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, g, Sq, D), dtype=torch.float32, device=dev)
    for i in range(nblk):
        start = i * block_k
        kc = k[:, start:start + block_k].float()
        vc = v[:, start:start + block_k].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc)
        s = _softcap(s, logit_softcap)
        k_pos = start + torch.arange(block_k, device=dev)
        msk = _mask(q_pos[None], k_pos[None], causal=causal, window=window,
                    kv_len=kv_len)                       # (B or 1, q, k)
        msk = msk & (k_pos < Sk)[None, None, :]
        s = torch.where(msk[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
        m_run = m_new
    o = acc / torch.clamp(l_run, min=1e-30)[..., None]
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return o.to(q.dtype)
