"""Flash attention for Hopper: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.flash_attention`` (``flash_attention_pallas``).
The kernel is ``csrc/flash_attention.cu``, FlashAttention-3's forward
structure on the primitives of ``csrc/hopper.cuh``: one block per (128-row q
tile, head, batch); a producer warpgroup loads Q and K/V tiles (``TILES``:
128 rows up to head_dim 128, 96 at 160, 64 at 256) by TMA into a 2-stage
ring of 128-byte-swizzled boxes completed on mbarriers, and hands its
registers by setmaxnreg to two consumer warpgroups of 64 q rows each, which
compute S = Q K^T and O += P V with ``wgmma`` (P from registers, V through
the transpose bit) and the online softmax in fp32 between them, in up to 240
registers a thread. It takes bf16 and head_dim 64, 112 (zamba2-7b), 128, 160
(stablelm-12b) or 256 (gemma2-9b), in 64-column boxes: 112 is computed at
128 and 160 at 192, their pad columns zero and never stored. A call whose
grid is under one wave of the card's SMs over several K/V tiles (one-row
decode and cross-attention) is split over the keys (``split_count``): each
block takes a share of the tiles and writes its partial output and
log-sum-exp, and the last of a group to finish merges them in split order;
at one q row a kv head's query heads share a block (``packed_group``). Its
source note gives its bound on the H100 and the design.

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
``flash_attention_split_plain`` is the split path's arithmetic in plain
torch (each split's partial output and log-sum-exp, merged in the kernel's
order), which the tests hold against the reference.

On ``meta`` tensors both wrappers take the kernel's path without launching
it: they return outputs (and the forward's log-sum-exp, the backward's
Delta scratch) of the kernel's shapes and dtypes, and a running census
(``repro_torch.census``) records each call with its cost from
``attention_cost`` and ``attention_bwd_cost``, the counts the bounds in
``chip_smoke.py`` read too. On CPU tensors under a census the plain versions
run as one forward and one backward call (``census.plain_kernel``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import census
from . import _build, ref

BOX = 64               # bf16 columns of one 128-byte-swizzled TMA box
BLOCK_Q = 128          # q rows of a forward block: two consumer warpgroups of 64
BLOCK_THREADS = 384    # the consumer warpgroups and a producer warpgroup
# head_dim -> (kv rows per tile, K/V tiles in the ring): the kernel's Tiles<D>
TILES = {64: (128, 2), 112: (128, 2), 128: (128, 2), 160: (96, 2), 256: (64, 2)}
HEAD_DIMS = tuple(TILES)
# The backward's tile plan, the kernel's Tiles<D>: head_dim -> (q rows of a
# dkdv step, the dkdv kernel's stages, the dq kernel's stages). A dkdv block
# owns 64 keys: two consumer warpgroups (one forms P and owns dV, the other
# forms dS and owns dK) and a producer warpgroup, one warp of which streams
# Q and dO tiles of a step's rows; setmaxnreg gives the consumers 240
# registers a thread, so each holds its whole D-wide accumulator (128
# registers at 256) and S^T and dP^T are computed once a step at every head
# dim. A dq block streams 32-row K and V tiles past 64 q rows a consumer
# warpgroup: one warpgroup and a producer warp (two blocks an SM up to 128),
# two warpgroups and a producer warpgroup at 160 (``bwd_dq_rows``).
BWD_TILES = {64: (64, 3, 4), 112: (64, 3, 4), 128: (64, 3, 4), 160: (64, 2, 4),
             256: (32, 2, 4)}
BWD_HEAD_DIMS = tuple(BWD_TILES)
BWD_ROWS = 64          # keys of a dkdv block, q rows of a dq block
BWD_KEY_STEP = 32      # keys of a dq step
SM_SMEM = 233472       # shared memory of one Hopper SM; each block reserves 1 KB more
SMS = 132              # SMs of an H100 SXM: one wave of forward blocks (one an SM)
MAX_GROUP = 64         # query heads of one kv head that one block's rows may pack


def head_dim_boxes(d: int) -> int:
    """64-column boxes that carry one row of head_dim ``d``."""
    return -(-d // BOX)


def padded_head_dim(d: int) -> int:
    """The width the products run at: ``d`` rounded up to whole boxes (112
    runs at 128 and 160 at 192, the last box's columns past ``d``
    zero-filled by TMA)."""
    return head_dim_boxes(d) * BOX


def packed_group(Sq: int, H: int, KVH: int) -> int:
    """Query heads that share one forward block: at one q row (decode,
    cross-attention) the ``H / KVH`` heads of a kv head become the block's
    rows, so that each K/V tile is read once for the group; 0 (one head a
    block) otherwise."""
    G = H // KVH
    return G if Sq == 1 and 1 < G <= MAX_GROUP else 0


def split_count(B, Sq, Sk, H, KVH, D, *, kv_valid=None, sms: int = SMS) -> int:
    """Blocks that each forward block's K/V tiles are cut into: for a few q
    rows (at most 64, one consumer warpgroup's; decode's one row) where the
    grid (q tiles x heads x batch, or kv heads x batch when packed) is under
    one wave of ``sms`` blocks and the visible keys span two tiles or more,
    as many as keep the grid within one wave, at most one a tile; else 1.
    (More rows make the merge a block's worth of work after the last split,
    for a grid whose blocks are each short anyway.)"""
    kv = Sk if kv_valid is None else min(int(kv_valid), Sk)
    tiles = -(-kv // TILES[D][0])
    group = packed_group(Sq, H, KVH)
    blocks = B * (KVH if group else H * -(-Sq // BLOCK_Q))
    if Sq > 64 or blocks >= sms or tiles < 2:
        return 1
    return max(1, min(tiles, sms // blocks))


def split_tiles(t_begin: int, t_end: int, splits: int) -> list[tuple[int, int]]:
    """The kernel's cut of a block's tiles [t_begin, t_end) into ``splits``
    runs of ceil(n / splits) tiles in order (the last ones may be short or
    empty)."""
    per = -(-(t_end - t_begin) // splits)
    out = []
    for s in range(splits):
        lo = min(t_end, t_begin + s * per)
        out.append((lo, min(t_end, lo + per)))
    return out


def smem_bytes(d: int = 128) -> int:
    """Dynamic shared memory of one block at head_dim ``d`` (counterpart of
    ``vmem_bytes``).

    The ``BLOCK_Q``-row Q tile and ``stages`` K and V tiles of
    ``TILES[d]``'s rows, each row ``padded_head_dim(d)`` bf16 wide in
    128-byte boxes; 128 bytes of mbarriers; 1 KB of slack to align the tiles
    to the swizzle's 1024-byte atoms. Must stay within the 232 448 bytes a
    block may use on Hopper.
    """
    block_k, stages = TILES[d]
    rows = BLOCK_Q + 2 * stages * block_k
    return rows * head_dim_boxes(d) * BOX * 2 + 128 + 1024


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd_bf16.argtypes = [p] * 8 + [i] * 6 + [f, i, i, f] + \
        [i] * 4 + [p]
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


def bwd_dq_rows(d: int) -> int:
    """q rows of a dq block at head_dim ``d``: 64 (one consumer warpgroup),
    128 at 160 (two, each K/V step read for both; at 256 two spilled)."""
    return 128 if head_dim_boxes(d) == 3 else 64


def bwd_smem_bytes(d: int, kernel: str) -> int:
    """Dynamic shared memory of one block of the backward's ``dkdv`` or
    ``dq`` kernel at head_dim ``d``: dkdv, the 64-row K and V tiles, its
    stages of Q and dO tiles of a step's rows with their LSE and Delta in
    fp32, and two buffers of P dy (64 keys x a step's rows, fp32); dq, its
    ``bwd_dq_rows``-row Q and dO tiles and its stages of 32-row K and V
    tiles; each row ``padded_head_dim(d)`` bf16 in 128-byte boxes; 128 bytes
    of mbarriers; 1 KB of slack to align the tiles to the swizzle's
    1024-byte atoms. Must stay within the 232 448 bytes a block may use on
    Hopper."""
    q_step, dkdv_stages, dq_stages = BWD_TILES[d]
    row = padded_head_dim(d) * 2
    if kernel == "dkdv":
        tiles = 2 * BWD_ROWS * row + dkdv_stages * 2 * q_step * row
        vectors = 2 * BWD_ROWS * q_step * 4 + dkdv_stages * 2 * q_step * 4
        return tiles + vectors + 128 + 1024
    return (2 * bwd_dq_rows(d) + 2 * dq_stages * BWD_KEY_STEP) * row + 128 + 1024


def bwd_blocks_per_sm(d: int, kernel: str) -> int:
    """Blocks of the backward's ``dkdv`` or ``dq`` kernel one SM holds at
    head_dim ``d``: a dkdv block is twelve warps (168 registers a thread at
    launch, 240 for the consumers after setmaxnreg), one an SM; dq blocks
    are five warps, two an SM up to head_dim 128 (ten warps: 168 registers
    a thread), one at 256 (255), and twelve at 160, one an SM (as dkdv)."""
    if kernel == "dkdv":
        return 1
    return 2 if 2 * (bwd_smem_bytes(d, kernel) + 1024) <= SM_SMEM else 1


def attended_pairs(Sq, Sk, *, causal=True, window=0, q_offset=0,
                   kv_valid=None) -> int:
    """(q, k) pairs the masks leave for these inputs: the work the data needs."""
    kv_valid = Sk if kv_valid is None else min(int(kv_valid), Sk)
    qp = np.arange(q_offset, q_offset + Sq, dtype=np.int64)
    hi = np.minimum(kv_valid, qp + 1) if causal else np.full(Sq, kv_valid)
    lo = np.maximum(0, qp - window + 1) if window else 0
    return int(np.maximum(hi - lo, 0).sum())


def attention_cost(B, Sq, Sk, H, KVH, D, *, causal=True, window=0, q_offset=0,
                   kv_valid=None, with_lse=False) -> tuple[int, int]:
    """(FLOPs, HBM bytes) of one forward call: S = Q K^T and O = P V, 4 B H D
    an attended pair; q, k, v read and the output written once in bf16, and
    the rows' log-sum-exp in fp32 where it is written."""
    pairs = attended_pairs(Sq, Sk, causal=causal, window=window,
                           q_offset=q_offset, kv_valid=kv_valid)
    nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Sk * KVH * D)
    return 4 * B * H * D * pairs, nbytes + (4 * B * H * Sq if with_lse else 0)


def attention_bwd_cost(B, Sq, Sk, H, KVH, D, *, causal=True, window=0,
                       kv_valid=None) -> tuple[int, int]:
    """(FLOPs, HBM bytes) of one backward call: the five products (S, dP,
    dV, dK, dQ), 10 B H D an attended pair; q, k, v, o, dO and the LSE read
    and dQ, dK, dV written once."""
    pairs = attended_pairs(Sq, Sk, causal=causal, window=window,
                           kv_valid=kv_valid)
    nbytes = 2 * (6 * B * Sq * H * D + 4 * B * Sk * KVH * D) + 4 * B * H * Sq
    return 10 * B * H * D * pairs, nbytes


def _cost(q, k, opts, with_lse=False):
    B, Sq, H, D = q.shape
    return attention_cost(B, Sq, k.shape[1], H, k.shape[2], D,
                          causal=opts["causal"], window=opts["window"],
                          q_offset=opts["q_offset"], kv_valid=opts["kv_valid"],
                          with_lse=with_lse)


def _bwd_cost(q, k, opts):
    B, Sq, H, D = q.shape
    return attention_bwd_cost(B, Sq, k.shape[1], H, k.shape[2], D,
                              causal=opts["causal"], window=opts["window"],
                              kv_valid=opts["kv_valid"])


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


# per (card, stream): the split path's int32 counters, zeroed once (each
# call leaves them 0; one per group of splits, and a split call's groups are
# its unsplit grid's blocks, under one wave), and its fp32 scratch, grown as
# needed. A stream's calls run in order, so each may reuse what the last
# one left.
_SPLIT_SCRATCH: dict = {}


def _split_scratch(index: int, stream: int, n: int) -> tuple[int, int]:
    """Addresses of the counters and of at least ``n`` floats of scratch
    (one-row calls are host-bound: the common case is one lookup)."""
    held = _SPLIT_SCRATCH.get((index, stream))
    if held is None or held[4] < n:
        counters = held[0] if held else torch.zeros(SMS * 8, dtype=torch.int32,
                                                    device=f"cuda:{index}")
        scratch = torch.empty(n, dtype=torch.float32, device=f"cuda:{index}")
        held = _SPLIT_SCRATCH[(index, stream)] = (
            counters, scratch, counters.data_ptr(), scratch.data_ptr(), n)
    return held[2], held[3]


def _on_card(device, launch):
    """``launch(stream)`` with the raw handle of ``device``'s current stream,
    the thread's current device switched to ``device`` around it only where
    it is not that already. (A one-row call is host-bound, and entering
    ``torch.cuda.device`` and building ``torch.cuda.current_stream()`` were
    most of its wrapper's host time.)"""
    index = device.index
    if index == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return launch(torch._C._cuda_getCurrentRawStream(index))


@functools.lru_cache(maxsize=1024)
def _plan(B, Sq, Sk, H, KVH, D, kv_valid, index) -> tuple[int, int]:
    """(packed_group, split_count) of a forward call on card ``index`` (its
    SM count; None: an H100's ``SMS``, as on meta tensors)."""
    sms = SMS if index is None else \
        torch.cuda.get_device_properties(index).multi_processor_count
    return packed_group(Sq, H, KVH), split_count(B, Sq, Sk, H, KVH, D,
                                                 kv_valid=kv_valid, sms=sms)


def _forward(q, k, v, *, causal, window, softcap, scale, q_offset,
             kv_valid, with_lse: bool):
    """Launch the forward kernel: (out, the rows' base-2 log-sum-exp (B, H,
    Sq) fp32 or None). A split call (``split_count`` > 1) takes fp32
    scratch for the splits' partial outputs and log-sum-exps and a counter
    per group of splits (``_split_scratch``), and adds one to
    ``flash_attention_cuda.split_launches``. On meta tensors the outputs
    alone, unlaunched."""
    opts = dict(causal=causal, window=window, q_offset=q_offset,
                kv_valid=kv_valid)
    with census.kernel("flash_attention", lambda: _cost(q, k, opts, with_lse)):
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
        group, splits = _plan(B, Sq, Sk, H, KVH, D, kv_valid,
                              None if q.is_meta else q.device.index)
        if q.is_meta:
            return out, lse

        def launch(stream):
            part_o = part_lse = counters = None
            if splits > 1:                    # O's partials, then the LSEs
                n = splits * B * Sq * H
                counters, part_o = _split_scratch(q.device.index, stream,
                                                  n * (D + 1))
                part_lse = part_o + 4 * n * D
            return _lib().flash_attention_fwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), part_o, part_lse, counters,
                B, Sq, Sk, H, KVH, D, scale, int(causal), int(window),
                float(softcap), int(q_offset), kv_valid, group, splits, stream)
        err = _on_card(q.device, launch)
        if err:
            raise RuntimeError(f"flash_attention kernel launch failed "
                               f"(cudaError_t {err})")
        flash_attention_cuda.launches += 1
        if splits > 1:
            flash_attention_cuda.split_launches += 1
        return out, lse


def flash_attention_cuda(q, k, v, *, causal=True, window=0, softcap=0.0,
                         scale=None, q_offset=0, kv_valid=None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KVH, D) -> (B, Sq, H, D).

    CPU tensors take the plain version. CUDA tensors launch the kernel on the
    current stream; ``flash_attention_cuda.launches`` counts the calls and
    ``flash_attention_cuda.split_launches`` those split over the keys.
    Meta tensors take the kernel's path unlaunched (the module's docstring).
    On the card, in grad mode with an input that requires grad, the call goes
    through ``FlashAttentionFn``, whose backward is the backward kernel.
    """
    opts = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                q_offset=q_offset, kv_valid=kv_valid)
    if q.device.type == "cpu":
        if census.active() is None:
            return flash_attention_plain(q, k, v, **opts)
        bwd_opts = {n: o for n, o in opts.items() if n != "q_offset"}
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        return census.plain_kernel(
            "flash_attention", lambda: _cost(q, k, opts, with_lse=grad),
            lambda *qkv: flash_attention_plain(*qkv, **opts), (q, k, v),
            lambda qkv, grads: flash_attention_bwd_plain(*qkv, grads[0],
                                                         **bwd_opts),
            lambda: _bwd_cost(q, k, opts))
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        check_bwd_inputs(q, q_offset)
        return FlashAttentionFn.apply(q, k, v, opts)
    return _forward(q, k, v, **opts, with_lse=False)[0]


flash_attention_cuda.launches = 0
flash_attention_cuda.split_launches = 0


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
        ctx.opts, ctx.site = opts, census.site()
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        o = ctx.opts
        with census.at(ctx.site), \
                census.kernel("flash_attention_bwd", lambda: _bwd_cost(q, k, o)):
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
    dK and dV per K/V tile, then dQ per q tile).
    ``flash_attention_bwd_cuda.launches`` counts the calls. CUDA tensors
    (meta tensors: the outputs alone, unlaunched); no q_offset; every head
    dim of ``HEAD_DIMS``.
    """
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no flash-attention backward kernel for device "
                         f"{q.device}; on the CPU autograd differentiates the "
                         f"plain version")
    opts = dict(causal=causal, window=window, kv_valid=kv_valid)
    with census.kernel("flash_attention_bwd", lambda: _bwd_cost(q, k, opts)):
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
        if q.is_meta:
            return dq, dk, dv
        err = _on_card(q.device, lambda stream: _bwd_lib().flash_attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KVH, D, scale,
            int(causal), int(window), float(softcap), kv_valid, stream))
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


def split_partials_plain(q, k, v, splits: int, *, causal=True, window=0,
                         softcap=0.0, scale=None, q_offset=0, kv_valid=None):
    """The split path's partial results in plain torch (fp32): each split's
    normalized output (splits, B, Sq, H, D) and base-2 log-sum-exp (splits,
    B, H, Sq), over the keys the kernel gives it: per block of ``BLOCK_Q``
    rows (one row of a kv head's packed heads at Sq = 1) the K/V tiles some
    row may see, cut by ``split_tiles``. A row a split's keys leave empty
    has log-sum-exp -inf and output 0."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = D ** -0.5 if scale is None else scale
    kv_valid = Sk if kv_valid is None else min(int(kv_valid), Sk)
    bk, bq = TILES[D][0], BLOCK_Q
    step = 0 if packed_group(Sq, H, KVH) else 1
    # (B, KVH, G, Sq, Sk) scores in base 2, masked to -inf
    qf = q.float().reshape(B, Sq, KVH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s * (1.0 / math.log(2.0))
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    keep = (kpos[None] < kv_valid).expand(Sq, Sk)
    if causal:
        keep = keep & (kpos[None] <= qpos[:, None])
    if window:
        keep = keep & (qpos[:, None] - kpos[None] < window)
    part_o = q.new_zeros((splits, B, Sq, H, D), dtype=torch.float32)
    part_lse = q.new_full((splits, B, H, Sq), -math.inf, dtype=torch.float32)
    vf = v.float()
    for q0 in range(0, Sq, bq):
        rows = min(bq, Sq - q0)
        first = q_offset + q0
        last = first + (rows - 1) * step
        kv_end = min(kv_valid, last + 1) if causal else kv_valid
        kv_begin = max(0, first - window + 1) if window else 0
        t_begin = kv_begin // bk
        t_end = max(t_begin, -(-kv_end // bk))
        for i, (lo, hi) in enumerate(split_tiles(t_begin, t_end, splits)):
            ks = slice(lo * bk, min(hi * bk, Sk))
            if hi <= lo:
                continue
            sc = s[..., q0:q0 + rows, ks]
            kp = keep[q0:q0 + rows, ks]
            sc = sc.masked_fill(~kp, -math.inf)
            m = sc.amax(-1, keepdim=True)
            seen = torch.isfinite(m)
            p = torch.where(seen, torch.exp2(sc - torch.where(seen, m, 0)), 0)
            lsum = p.sum(-1, keepdim=True)
            o = torch.einsum("bhgqk,bkhd->bqhgd", p / lsum.clamp_min(1e-30), vf[:, ks])
            part_o[i, :, q0:q0 + rows] = o.reshape(B, rows, H, D)
            lse2 = torch.where(seen, m + torch.log2(lsum), -math.inf)
            part_lse[i, :, :, q0:q0 + rows] = lse2[..., 0].reshape(B, H, rows)
    return part_o, part_lse


def merge_splits_plain(part_o, part_lse):
    """The merge kernel's arithmetic: each row's splits combined in split
    order, LSE2 = log2 sum_i 2^LSE2_i, O = sum_i 2^(LSE2_i - LSE2) O_i; a
    row no split saw gives O = 0 and LSE2 = -inf. (out fp32 (B, Sq, H, D),
    lse (B, H, Sq))."""
    m = part_lse.amax(0)
    seen = torch.isfinite(m)
    m0 = torch.where(seen, m, 0)
    total = torch.zeros_like(m)
    for lse_i in part_lse:
        total = total + torch.exp2(lse_i - m0)
    lse = torch.where(seen, m0 + torch.log2(total), -math.inf)
    out = torch.zeros_like(part_o[0])
    for o_i, lse_i in zip(part_o, part_lse):
        w = torch.where(seen, torch.exp2(lse_i - torch.where(seen, lse, 0)), 0)
        out = out + w.permute(0, 2, 1)[..., None] * o_i
    return out, lse


def flash_attention_split_plain(q, k, v, splits: int, *, causal=True, window=0,
                                softcap=0.0, scale=None, q_offset=0,
                                kv_valid=None):
    """The split path in plain torch: ``split_partials_plain`` merged by
    ``merge_splits_plain``; the output in q's dtype."""
    out, _ = merge_splits_plain(*split_partials_plain(
        q, k, v, splits, causal=causal, window=window, softcap=softcap,
        scale=scale, q_offset=q_offset, kv_valid=kv_valid))
    return out.to(q.dtype)

