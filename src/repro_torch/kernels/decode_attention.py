"""Decode attention for Hopper: the CUDA kernel's wrapper and its plain version.

One query row a head (a decode step) against a bf16 KV cache. The
reference's decode attention (``repro.kernels.ops.decode_attention``) is
plain jnp, not a Pallas kernel; its port was plain torch, which made fp32
copies of the whole allocated cache on every layer of every step. The
kernel is ``csrc/decode_attention.cu``: split over the visible positions
(``split_count``), two launches a call (scores with each split's row max and
sum of exp, then P V), each bf16 K and V element of the visible prefix
read once. Its source note gives its bound on the H100 and the design.

``decode_attention_plain`` is that arithmetic in plain torch: fp32 scores of
the stored K (the reference's ``preferred_element_type``), the masks, an
fp32 softmax, P rounded to V's dtype before the PV product, accumulated in
fp32. ``decode_scores`` and ``decode_pv`` are its two halves, which
``ops.decode_attention_split`` (a cache split by position across ranks)
shares.

``decode_attention_cuda`` routes by where the tensors lie: on the CPU it runs
the plain version; on a CUDA tensor it launches the kernel or raises. It
never falls back from one to the other. On ``meta`` tensors it takes the
kernel's path unlaunched and returns the output's shape. A running census
(``repro_torch.census``) records each call, on every device, as one
``decode_attention_kernel`` call with ``decode_attention_cost`` at the
visible length.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import census
from . import _build, ref

KERNEL = "decode_attention_kernel"  # the census's name of one call
HEAD_DIMS = (64, 112, 128, 160, 256)
MAX_GROUP = 12         # query heads a kv head may serve (the kernel's rows)
SMS = 132              # SMs of an H100 SXM
FILL = 16              # blocks an SM the split count aims for
MIN_RUN = 128          # positions worth a split of their own


def decode_attention_cost(B, Sq, Sk, H, KVH, D) -> tuple[int, int]:
    """(FLOPs, HBM bytes) of one decode attention over Sk positions: the
    score and PV products, 4 B H D Sq Sk; the bf16 cache's K and V read and
    q and the output read or written once. The kernel is called with Sk the
    visible length, the positions it reads."""
    return 4 * B * H * D * Sq * Sk, 2 * (2 * B * Sk * KVH * D + 2 * B * Sq * H * D)


def visible_range(Sk: int, q_offset: int, kv_len: int, window: int = 0) -> tuple[int, int]:
    """[lo, hi): the positions a query at ``q_offset`` sees in a cache of
    ``Sk``: causal and under ``kv_len``, from the window's start."""
    hi = min(int(kv_len), int(q_offset) + 1, Sk)
    lo = max(0, int(q_offset) - window + 1) if window else 0
    return lo, hi


def split_count(pairs: int, visible: int, sms: int = SMS) -> int:
    """Runs the visible positions of each of ``pairs`` (batch row, kv head)
    are cut into: enough that the grid holds about ``FILL`` blocks an SM,
    and at most one for every ``MIN_RUN`` positions begun."""
    return max(1, min(-(-visible // MIN_RUN), -(-FILL * sms // pairs)))


def split_step(D: int, g: int) -> int:
    """Positions one block step of the kernel covers at head_dim ``D`` and
    ``g`` query heads a kv head: its lane groups (one a position, D / 8
    lanes rounded up to 8, 16 or 32, of 256 threads) times the positions a
    lane keeps in flight (8 up to g = 2, 4 up to 4, else 2)."""
    lanes = 8 if D <= 64 else 16 if D <= 128 else 32
    return 256 // lanes * (8 if g <= 2 else 4 if g <= 4 else 2)


def split_ranges(lo: int, hi: int, splits: int, step: int = 1) -> list[tuple[int, int]]:
    """The kernel's cut of [lo, hi) into ``splits`` runs in order, each
    ceil(n / splits) positions rounded up to a multiple of ``step``
    (``split_step``); the last ones may be short or empty."""
    per = -(-(-(-(hi - lo) // splits)) // step) * step
    out = []
    for s in range(splits):
        start = min(hi, lo + s * per)
        out.append((start, min(hi, start + per)))
    return out


def decode_scores(q, k, *, window, logit_softcap, scale, q_offset, kv_len,
                  bf16_kv, k_start=0, causal=True):
    """Masked fp32 scores (B, KVH, g, Sq, Sk) of q against keys at global
    positions ``k_start`` onwards.

    bf16_kv mirrors the reference's mixed precision: scores of the stored K
    in fp32 (the reference's ``preferred_element_type``). A product of two
    bf16 values is exact in fp32, so contracting fp32 copies gives those
    fp32 sums; an einsum on the bf16 tensors themselves would round the
    scores to bf16."""
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


def decode_pv(p, v, q, bf16_kv, out_dtype=None):
    """(B, KVH, g, Sq, Sk) probabilities times V -> (B, Sq, H, D); with
    bf16_kv, P rounded to V's dtype first, then accumulated in fp32."""
    B, Sq, H, D = q.shape
    if bf16_kv:
        p = p.to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.float(), v.float())
    return o.reshape(B, Sq, H, D).to(out_dtype or q.dtype)


def decode_attention_plain(q, k, v, *, window=0, logit_softcap=0.0, scale=None,
                           q_offset, kv_len, bf16_kv: bool = True):
    """The kernel's function in plain torch, over the whole cache (positions
    the masks hide get P = 0). q_offset and kv_len may be ints or tensors."""
    s = decode_scores(q, k, window=window, logit_softcap=logit_softcap,
                      scale=scale, q_offset=q_offset, kv_len=kv_len,
                      bf16_kv=bf16_kv)
    return decode_pv(torch.softmax(s, dim=-1), v, q, bf16_kv)


def check_inputs(q, k, v, *, q_offset, kv_len, window, bf16_kv) -> tuple[int, int]:
    """Raise ``ValueError`` for what the kernel does not take; else the
    visible range [lo, hi)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("expected q (B,1,H,D) and k, v (B,Sk,KVH,D)")
    B, Sq, H, D = q.shape
    if Sq != 1:
        raise ValueError(f"the kernel takes one query row, not {Sq}")
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not supported; the kernel takes "
                         f"{HEAD_DIMS}")
    if H // k.shape[2] > MAX_GROUP:
        raise ValueError(f"{H // k.shape[2]} query heads a kv head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if not bf16_kv:
        raise ValueError("the kernel takes the bf16-cache arithmetic only")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if any(isinstance(x, torch.Tensor) for x in (q_offset, kv_len)):
        raise ValueError("the kernel takes q_offset and kv_len as ints")
    lo, hi = visible_range(k.shape[1], q_offset, kv_len, window)
    if hi <= lo:
        raise ValueError(f"no visible position (q_offset {q_offset}, kv_len "
                         f"{kv_len}, window {window})")
    return lo, hi


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_bf16.argtypes = [p] * 6 + [i] * 9 + [f, f, p]
    lib.decode_attention_bf16.restype = i
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# per (card, stream): the int32 counters (one a kv head of the batch, zeroed
# once: each call leaves them 0) and the fp32 scratch (scores, split
# statistics, partial outputs), grown as needed. A stream's calls run in
# order, so each may reuse what the last one left.
_SCRATCH: dict = {}


def _scratch(index: int, stream: int, floats: int, counters: int) -> tuple[int, int]:
    """Addresses of at least ``floats`` fp32 of scratch and ``counters``
    zeroed int32 counters on card ``index`` for ``stream``."""
    held = _SCRATCH.get((index, stream))
    if held is None or held[4] < floats or held[5] < counters:
        dev = f"cuda:{index}"
        floats = max(floats, held[4] if held else 0)
        counters = max(counters, held[5] if held else 0)
        cnt = torch.zeros(counters, dtype=torch.int32, device=dev)
        buf = torch.empty(floats, dtype=torch.float32, device=dev)
        held = _SCRATCH[(index, stream)] = (buf, cnt, buf.data_ptr(),
                                            cnt.data_ptr(), floats, counters)
    return held[2], held[3]


def _arguments(q, k, lo, hi, *, window, softcap, scale, q_offset, kv_len) -> tuple:
    """The kernel's arguments after q, k, v and the output's addresses, on
    the current device's current stream."""
    B, _, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    index = q.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    splits = split_count(B * KVH, hi - lo, _sms(index))
    floats = B * H * Sk + 2 * B * H * splits + (B * H * splits * D if splits > 1 else 0)
    buf, counters = _scratch(index, stream, floats, B * KVH)
    scale = D ** -0.5 if scale is None else float(scale)
    return (buf, counters, B, Sk, H, KVH, D, int(q_offset), int(kv_len), int(window),
            splits, scale, float(softcap), stream)


def decode_attention_cuda(q, k, v, *, window=0, logit_softcap=0.0, scale=None,
                          q_offset, kv_len, bf16_kv: bool = True):
    """q: (B, 1, H, D); k, v: (B, Sk, KVH, D) -> (B, 1, H, D) in q's dtype.

    CPU tensors take the plain version (which also takes tensor positions,
    several query rows and fp32 caches). CUDA tensors launch the kernel on
    the current stream, or raise on what it does not take;
    ``decode_attention_cuda.launches`` counts the calls. Meta tensors take
    the kernel's path unlaunched."""
    kw = dict(window=window, logit_softcap=logit_softcap, scale=scale,
              q_offset=q_offset, kv_len=kv_len, bf16_kv=bf16_kv)
    if q.device.type == "cpu":
        if census.active() is None:
            return decode_attention_plain(q, k, v, **kw)
        B, Sq, H, D = q.shape
        lo, hi = visible_range(k.shape[1], q_offset, kv_len, window)
        with census.kernel(KERNEL, lambda: decode_attention_cost(
                B, Sq, max(hi - lo, 0), H, k.shape[2], D)):
            return decode_attention_plain(q, k, v, **kw)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no decode-attention kernel for device {q.device}")
    if not q.is_meta and q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device.index):
            return decode_attention_cuda(q, k, v, **kw)
    lo, hi = check_inputs(q, k, v, q_offset=q_offset, kv_len=kv_len,
                          window=window, bf16_kv=bf16_kv)
    B, _, H, D = q.shape
    KVH = k.shape[2]
    # planned before the bracket, so that a span's device interval holds
    # little more than the two kernels
    args = None if q.is_meta else _arguments(
        q, k, lo, hi, window=window, softcap=logit_softcap, scale=scale,
        q_offset=q_offset, kv_len=kv_len)
    with census.kernel(KERNEL, lambda: decode_attention_cost(B, 1, hi - lo, H, KVH, D)):
        out = torch.empty_like(q)
        if args is None:
            return out
        err = _lib().decode_attention_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           out.data_ptr(), *args)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed (cudaError_t {err})")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
