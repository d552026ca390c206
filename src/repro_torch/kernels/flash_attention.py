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
the plain version (the torch twin of ``ref.mha_chunked``); on a CUDA tensor it
launches the kernel or raises. It never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from ._autograd import refuse_grad

BOX = 64               # bf16 columns of one 128-byte-swizzled TMA box
# head_dim -> (consumer warpgroups of 64 q rows, kv rows per tile, K/V tiles
# in the ring, producer threads): the kernel's Tiles<D>
TILES = {64: (2, 96, 2, 128), 112: (2, 96, 2, 128), 128: (2, 96, 2, 128),
         160: (1, 96, 2, 32), 256: (1, 64, 2, 32)}
HEAD_DIMS = tuple(TILES)


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
    lib.flash_attention_fwd_bf16.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                             f, i, i, f, i, i, p]
    lib.flash_attention_fwd_bf16.restype = i
    lib.flash_attention_smem_bytes.argtypes = [i]
    lib.flash_attention_smem_bytes.restype = i
    return lib


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


def flash_attention_cuda(q, k, v, *, causal=True, window=0, softcap=0.0,
                         scale=None, q_offset=0, kv_valid=None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KVH, D) -> (B, Sq, H, D).

    CPU tensors take the plain version. CUDA tensors launch the kernel on the
    current stream; ``flash_attention_cuda.launches`` counts the launches. On
    the card an input that requires grad, in grad mode, raises (no backward).
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_offset=q_offset, kv_valid=kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    refuse_grad("flash_attention", q, k, v)
    check_inputs(q, k, v)
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    scale = D ** -0.5 if scale is None else float(scale)
    kv_valid = Sk if kv_valid is None else min(int(kv_valid), Sk)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, KVH, D, scale, int(causal), int(window),
            float(softcap), int(q_offset), kv_valid, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(cudaError_t {err})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
