"""Flash attention for Hopper: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.flash_attention`` (``flash_attention_pallas``).
The kernel is ``csrc/flash_attention.cu``, FlashAttention-3's forward
structure on the primitives of ``csrc/hopper.cuh``: one block per (128-row q
tile, head, batch; 64 rows at head_dim 160 and 256); a producer thread loads
Q and 96-row K/V tiles (64 at 256) by TMA into a 2-stage ring of
128-byte-swizzled boxes completed on mbarriers; consumer warpgroups of 64 q
rows each compute S = Q K^T and O += P V with ``wgmma`` (P from registers,
V through the transpose bit) and the online softmax in fp32 between them.
It takes bf16 and head_dim 64, 112 (zamba2-7b), 128, 160 (stablelm-12b) or
256 (gemma2-9b), in 64-column boxes: 112 is computed at 128 and 160 at 192,
their pad columns zero and never stored. The block's shape depends on the
head dim (``TILES``): up to 128, two consumer warpgroups and a producer
warpgroup; at 160 and 256, where O alone takes 96 or 128 registers a
thread, one consumer warpgroup and a producer warp, so that a thread may
hold 255 registers. Its source note gives its bound on the H100 and the
design.

``flash_attention_cuda`` routes by where the tensors lie: on the CPU it runs
the plain version (the torch twin of ``ref.mha_chunked``), through which
autograd differentiates; on a CUDA tensor it launches the kernel or raises.
It never falls back from one to the other. In grad mode, with an input that
requires grad, the CUDA path is ``FlashAttentionFn``: the forward kernel also
writes each row's log-sum-exp, and the backward is ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd_cuda``), held against ``flash_attention_bwd_plain``,
autograd through the plain version in fp32. Serving keeps the forward alone,
with no log-sum-exp written. The backward takes every head dim the forward
takes, on the same primitives: producer warps feed tiles by TMA, consumer
warpgroups run the products on ``wgmma`` (the tile plan: ``BWD_TILES``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, ref

BOX = 64               # bf16 columns of one 128-byte-swizzled TMA box
# head_dim -> (consumer warpgroups of 64 q rows, kv rows per tile, K/V tiles
# in the ring, producer threads): the kernel's Tiles<D>
TILES = {64: (2, 96, 2, 128), 112: (2, 96, 2, 128), 128: (2, 96, 2, 128),
         160: (1, 96, 2, 32), 256: (1, 64, 2, 32)}
HEAD_DIMS = tuple(TILES)
# The backward's tile plan, the kernel's Tiles<D>: head_dim -> (the 64-column
# boxes of each column part of dK and dV, q rows of a dkdv step, the dkdv
# kernel's stages, the dq kernel's stages). A dkdv block owns 64 keys: two
# consumer warpgroups (one forms P and owns dV, the other forms dS and owns
# dK) and a producer warp streaming Q and dO tiles of a step's rows. A dq
# block owns 64 q rows: one consumer warpgroup and a producer warp
# streaming 32-row K and V tiles. dK and dV of a part take 64 fp32
# registers a thread per two boxes, so at 160 (run at 192) and 256 their
# columns are cut into parts of at most two boxes, one block each.
BWD_TILES = {64: ((1,), 64, 3, 4), 112: ((2,), 64, 3, 4), 128: ((2,), 64, 3, 4),
             160: ((2, 1), 64, 2, 4), 256: ((2, 2), 32, 2, 4)}
BWD_HEAD_DIMS = tuple(BWD_TILES)
BWD_ROWS = 64          # keys of a dkdv block, q rows of a dq block
BWD_KEY_STEP = 32      # keys of a dq step
SM_SMEM = 233472       # shared memory of one Hopper SM; each block reserves 1 KB more


def head_dim_boxes(d: int) -> int:
    """64-column boxes that carry one row of head_dim ``d``."""
    return -(-d // BOX)


def padded_head_dim(d: int) -> int:
    """The width the products run at: ``d`` rounded up to whole boxes (112
    runs at 128 and 160 at 192, the last box's columns past ``d``
    zero-filled by TMA)."""
    return head_dim_boxes(d) * BOX


def block_q(d: int) -> int:
    """q rows of one block at head_dim ``d``: 64 per consumer warpgroup."""
    return 64 * TILES[d][0]


def block_threads(d: int) -> int:
    """Threads of one block at head_dim ``d``: the consumer warpgroups and
    the producer (a warpgroup, or one warp at 160 and 256)."""
    return 128 * TILES[d][0] + TILES[d][3]


def smem_bytes(d: int = 128) -> int:
    """Dynamic shared memory of one block at head_dim ``d`` (counterpart of
    ``vmem_bytes``).

    The ``block_q(d)``-row Q tile and ``stages`` K and V tiles of
    ``TILES[d]``'s rows, each row ``padded_head_dim(d)`` bf16 wide in
    128-byte boxes; 128 bytes of mbarriers; 1 KB of slack to align the tiles
    to the swizzle's 1024-byte atoms. Must stay within the 232 448 bytes a
    block may use on Hopper.
    """
    _, block_k, stages, _ = TILES[d]
    rows = block_q(d) + 2 * stages * block_k
    return rows * head_dim_boxes(d) * BOX * 2 + 128 + 1024


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                             f, i, i, f, i, i, p]
    lib.flash_attention_fwd_bf16.restype = i
    lib.flash_attention_smem_bytes.argtypes = [i]
    lib.flash_attention_smem_bytes.restype = i
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_bf16.argtypes = [p] * 10 + [i] * 6 + [f, i, i, f, i, p]
    lib.flash_attention_bwd_bf16.restype = i
    lib.flash_attention_bwd_smem_bytes.argtypes = [i, i]
    lib.flash_attention_bwd_smem_bytes.restype = i
    return lib


def bwd_smem_bytes(d: int, kernel: str) -> int:
    """Dynamic shared memory of one block of the backward's ``dkdv`` or
    ``dq`` kernel at head_dim ``d``: dkdv, the 64-row K and V tiles, its
    stages of Q and dO tiles of a step's rows with their LSE and Delta in
    fp32, and two buffers of P dy (64 keys x a step's rows, fp32); dq, the
    64-row Q and dO tiles and its stages of 32-row K and V tiles; each row
    ``padded_head_dim(d)`` bf16 in 128-byte boxes; 128 bytes of mbarriers;
    1 KB of slack to align the tiles to the swizzle's 1024-byte atoms. Must
    stay within the 232 448 bytes a block may use on Hopper."""
    _, q_step, dkdv_stages, dq_stages = BWD_TILES[d]
    row = padded_head_dim(d) * 2
    if kernel == "dkdv":
        tiles = 2 * BWD_ROWS * row + dkdv_stages * 2 * q_step * row
        vectors = 2 * BWD_ROWS * q_step * 4 + dkdv_stages * 2 * q_step * 4
        return tiles + vectors + 128 + 1024
    return (2 * BWD_ROWS + 2 * dq_stages * BWD_KEY_STEP) * row + 128 + 1024


def bwd_blocks_per_sm(d: int, kernel: str) -> int:
    """Blocks of the backward's ``dkdv`` or ``dq`` kernel one SM holds at
    head_dim ``d``: a dkdv block is nine warps (a thread may hold 168
    registers), one an SM; dq blocks are five warps, two an SM wherever two
    blocks' shared memory fits (ten warps: 168 registers again), else one
    (255)."""
    if kernel == "dkdv":
        return 1
    return 2 if 2 * (bwd_smem_bytes(d, kernel) + 1024) <= SM_SMEM else 1


def check_inputs(q, k, v) -> None:
    """Raise ``ValueError`` for what the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("expected q (B,Sq,H,D) and k, v (B,Sk,KVH,D)")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not supported; the kernel takes "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0,
                          scale=None, q_offset=0, kv_valid=None):
    """The kernel's function in plain torch (fp32 inside, q's dtype out)."""
    kv_len = None if kv_valid is None else min(int(kv_valid), k.shape[1])
    return ref.mha_chunked(q, k, v, causal=causal, window=window,
                           logit_softcap=softcap, scale=scale,
                           q_offset=q_offset, kv_len=kv_len)


def _forward(q, k, v, *, causal, window, softcap, scale, q_offset,
             kv_valid, with_lse: bool):
    """Launch the forward kernel: (out, the rows' base-2 log-sum-exp (B, H,
    Sq) fp32 or None)."""
    check_inputs(q, k, v)
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    scale = D ** -0.5 if scale is None else float(scale)
    kv_valid = Sk if kv_valid is None else min(int(kv_valid), Sk)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Sk, H, KVH, D, scale, int(causal), int(window),
            float(softcap), int(q_offset), kv_valid, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(cudaError_t {err})")
    flash_attention_cuda.launches += 1
    return out, lse


def flash_attention_cuda(q, k, v, *, causal=True, window=0, softcap=0.0,
                         scale=None, q_offset=0, kv_valid=None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KVH, D) -> (B, Sq, H, D).

    CPU tensors take the plain version. CUDA tensors launch the kernel on the
    current stream; ``flash_attention_cuda.launches`` counts the launches. On
    the card, in grad mode with an input that requires grad, the call goes
    through ``FlashAttentionFn``, whose backward is the backward kernel.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_offset=q_offset, kv_valid=kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    opts = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                q_offset=q_offset, kv_valid=kv_valid)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        check_bwd_inputs(q, q_offset)
        return FlashAttentionFn.apply(q, k, v, opts)
    return _forward(q, k, v, **opts, with_lse=False)[0]


flash_attention_cuda.launches = 0


def check_bwd_inputs(q, q_offset=0) -> None:
    """Raise ``ValueError`` for what the backward kernel does not take (it
    takes every head dim the forward takes)."""
    if q_offset:
        raise ValueError("the backward kernel takes q_offset 0 only "
                         "(training passes no offset)")


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel, keeping q, k, v, the output and the rows'
    log-sum-exp; the backward kernel for the gradients."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        out, lse = _forward(q, k, v, **opts, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        o = ctx.opts
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, dout.contiguous(), lse, causal=o["causal"],
            window=o["window"], softcap=o["softcap"], scale=o["scale"],
            kv_valid=o["kv_valid"])
        return dq, dk, dv, None


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *, causal=True,
                             window=0, softcap=0.0, scale=None, kv_valid=None):
    """Gradients (dq, dk, dv) of the attention ``out`` = flash(q, k, v) for
    the output gradient ``dout``, from the forward's ``lse`` (B, H, Sq), fp32,
    base 2: kernels on the current stream (Delta = rowsum(dout * out), then
    dK and dV per K/V tile and column part, then dQ per q tile).
    ``flash_attention_bwd_cuda.launches`` counts the calls. CUDA tensors
    only; no q_offset; every head dim of ``HEAD_DIMS``.
    """
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention backward kernel for device "
                         f"{q.device}; on the CPU autograd differentiates the "
                         f"plain version")
    check_inputs(q, k, v)
    check_bwd_inputs(q)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous() \
                or t.data_ptr() % 16 or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"bf16 tensor shaped like q on its device")
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 (B, H, Sq) = "
                         f"{(B, H, Sq)}, got {tuple(lse.shape)} {lse.dtype}")
    scale = D ** -0.5 if scale is None else float(scale)
    kv_valid = Sk if kv_valid is None else min(int(kv_valid), Sk)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib().flash_attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KVH, D, scale,
            int(causal), int(window), float(softcap), kv_valid, stream)
    if err:
        raise RuntimeError(f"flash_attention backward kernel launch failed "
                           f"(cudaError_t {err})")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


def flash_attention_bwd_plain(q, k, v, dout, *, causal=True, window=0,
                              softcap=0.0, scale=None, kv_valid=None):
    """The backward kernel's function in plain torch: autograd through
    ``flash_attention_plain`` in fp32; (dq, dk, dv) in the inputs' dtype."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        out = flash_attention_plain(qf, kf, vf, causal=causal, window=window,
                                    softcap=softcap, scale=scale,
                                    kv_valid=kv_valid)
        grads = torch.autograd.grad(out, (qf, kf, vf), dout.float())
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def attention_lse_plain(q, k, *, causal=True, window=0, softcap=0.0,
                        scale=None, q_offset=0, kv_valid=None):
    """The rows' log-sum-exp that the forward kernel writes, in plain torch:
    (B, H, Sq) fp32 in base 2 (log2 of the sum of e^y over the visible keys,
    y the scaled and softcapped score); -inf for a row that sees no key."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    qf = q.float().reshape(B, Sq, KVH, H // KVH, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kv_len = None if kv_valid is None else ref._as_kv_len(
        min(int(kv_valid), Sk), B, q.device)
    keep = ref._mask(torch.arange(Sq, device=q.device)[None] + q_offset,
                     torch.arange(Sk, device=q.device)[None], causal=causal,
                     window=window, kv_len=kv_len)
    s = s.masked_fill(~keep[:, None, None], float("-inf"))
    return (torch.logsumexp(s, dim=-1) / math.log(2.0)).reshape(B, H, Sq)
