"""Plain-torch reference oracles for the attention, SSD and grouped-GEMM
kernels.

The torch twin of ``repro.kernels.ref``:

- ``mha_naive``       : materializes the full scores. The ground-truth oracle.
- ``mha_chunked``     : online softmax over kv blocks (a Python loop in place
                        of ``jax.lax.scan``). Numerically equal to the naive
                        tier with O(block) intermediates; the plain version of
                        the flash-attention kernel and the CPU execution path.
- ``ssd_naive``       : quadratic-time Mamba2 SSD, the scan's oracle.
- ``ssd_chunked``     : dense intra-chunk products and a sequential
                        inter-chunk recurrence; the plain version of the SSD
                        kernel.
- ``ssd_decode_step`` : the single-token recurrent update.
- ``gmm_naive``       : the per-expert matmul bank; the plain version of the
                        grouped-GEMM kernel.

All compute in fp32 whatever the input dtype and return the input's dtype
(the SSD states are fp32).
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


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------


def _ssd_inputs(x, dt, a_log, b, c):
    """fp32 u = x * dt, dt * A, and b, c repeated from groups to heads."""
    rep = x.shape[2] // b.shape[2]
    A = -torch.exp(a_log.float())                                 # (H,)
    dtf = dt.float()
    u = x.float() * dtf[..., None]                                # (B,L,H,P)
    bh = b.repeat_interleave(rep, dim=2).float()                  # (B,L,H,N)
    ch = c.repeat_interleave(rep, dim=2).float()
    return u, dtf * A, bh, ch


def ssd_naive(x, dt, a_log, b, c, d_skip, *, chunk_size=None):
    """Quadratic-time SSD reference.

    x:  (B, L, H, P) inputs        dt: (B, L, H) softplus'd step sizes
    a_log: (H,) (A = -exp(a_log))  b, c: (B, L, G, N) input/output projections
    d_skip: (H,) skip connection.  Heads map to groups h -> h // (H // G).
    y_t = sum_{s<=t} exp(sum_{r=s+1..t} dt_r*A) (C_t.B_s) dt_s x_s + D x_t
    Returns y (B, L, H, P) and final state (B, H, P, N) fp32.
    """
    del chunk_size
    L = x.shape[1]
    u, log_a, bh, ch = _ssd_inputs(x, dt, a_log, b, c)
    cum = torch.cumsum(log_a, dim=1).transpose(1, 2)              # (B,H,L)
    cb = torch.einsum("bthn,bshn->bhts", ch, bh)                  # (B,H,L,L)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    # select before exp: above the diagonal cum_t - cum_s > 0 may overflow
    diff = torch.where(causal, cum[..., :, None] - cum[..., None, :], 0.0)
    w = torch.where(causal, cb * torch.exp(diff), 0.0)
    y = torch.einsum("bhts,bshp->bthp", w, u)
    y = y + x.float() * d_skip.float()[None, None, :, None]
    # final state: S = sum_s exp(cum_L - cum_s) u_s b_s^T
    w_end = torch.exp(cum[..., -1:] - cum)                        # (B,H,L)
    state = torch.einsum("bhs,bshp,bshn->bhpn", w_end, u, bh)
    return y.to(x.dtype), state


def ssd_chunked(x, dt, a_log, b, c, d_skip, *, chunk_size=128):
    """Chunked SSD: dense intra-chunk + sequential inter-chunk recurrence.

    Mathematical twin of the SSD kernel (a Python loop over chunks in place
    of ``jax.lax.scan``). Same returns as :func:`ssd_naive`.
    """
    B, L, H, P = x.shape
    N = b.shape[3]
    Q = min(chunk_size, L)
    if L % Q:
        raise ValueError(f"L={L} must be a multiple of the chunk {Q}")
    u, log_a, bh, ch = _ssd_inputs(x, dt, a_log, b, c)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    state = torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for start in range(0, L, Q):
        u_, b_, c_ = (t[:, start:start + Q] for t in (u, bh, ch))
        cum = torch.cumsum(log_a[:, start:start + Q], dim=1)      # (B,Q,H)
        cum_t = cum.transpose(1, 2)                               # (B,H,Q)
        cb = torch.einsum("bthn,bshn->bhts", c_, b_)
        diff = torch.where(causal, cum_t[..., :, None] - cum_t[..., None, :],
                           0.0)
        w = torch.where(causal, cb * torch.exp(diff), 0.0)
        y = torch.einsum("bhts,bshp->bthp", w, u_)
        # contribution of the carried state
        y = y + torch.einsum("bthn,bhpn->bthp", c_, state) * \
            torch.exp(cum)[..., None]
        ys.append(y)
        # state update
        tot = cum_t[..., -1]                                      # (B,H)
        w_end = torch.exp(tot[..., None] - cum_t)                 # (B,H,Q)
        s_loc = torch.einsum("bhs,bshp,bshn->bhpn", w_end, u_, b_)
        state = state * torch.exp(tot)[..., None, None] + s_loc
    y = torch.cat(ys, dim=1) + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), state


def ssd_decode_step(state, x_t, dt_t, a_log, b_t, c_t, d_skip):
    """Single-token recurrent update.

    state: (B,H,P,N) fp32; x_t: (B,H,P); dt_t: (B,H); b_t, c_t: (B,G,N).
    Returns y_t (B,H,P) in x_t's dtype and the new state.
    """
    rep = x_t.shape[1] // b_t.shape[1]
    A = -torch.exp(a_log.float())
    a = torch.exp(dt_t.float() * A[None])                         # (B,H)
    u = x_t.float() * dt_t.float()[..., None]
    bh = b_t.repeat_interleave(rep, dim=1).float()                # (B,H,N)
    ch = c_t.repeat_interleave(rep, dim=1).float()
    state = state * a[..., None, None] + u[..., None] * bh[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, ch)
    y = y + x_t.float() * d_skip.float()[None, :, None]
    return y.to(x_t.dtype), state


# ---------------------------------------------------------------------------
# Grouped (per-expert) matmul
# ---------------------------------------------------------------------------


def gmm_naive(x, w):
    """x: (E, C, d), w: (E, d, f) -> (E, C, f) with fp32 accumulation.

    A product of two bf16 values is exact in fp32, so upcasting before the
    product gives the reference's ``preferred_element_type=float32`` sums;
    the result is rounded to x's dtype once.
    """
    return torch.bmm(x.float(), w.float()).to(x.dtype)
