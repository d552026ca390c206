"""Mamba2 SSD scan for Hopper: the CUDA kernels' wrapper and their plain
versions.

Counterpart of ``repro.kernels.ssd_scan`` (``ssd_scan_pallas``). The kernels
are in ``csrc/ssd_scan.cu``; ``ssd_variant`` picks one from the shapes and
the dtype:

- ``"wgmma"``: bf16 with P = 64, N = 64 or 128 and a chunk that is a
  multiple of 64 up to 256, every model shape. The chunk-state decomposition
  of arXiv:2405.21060 in three kernels launched by one wrapper call:
  ``chunk_state`` (each chunk's local state, a P x N product over the
  chunk's steps on wgmma), ``state_pass`` (the only sequential part: the
  states entering each chunk and the final state, on the CUDA cores) and
  ``chunk_scan`` (per 64-row t tile, C S_in^T and the causal (C B^T ⊙ decay)
  x on wgmma). A producer warp feeds 64-row tiles by TMA into a 2-stage
  mbarrier ring. Each product whose operand is fp32 (x · w, W, S_in) splits
  that operand into bf16 hi + lo and runs twice into the same fp32 sums
  (``split_bf16``).
- ``"fma"``: fp32, and bf16 shapes outside that set: one thread block per
  (P-slice, head, batch), a loop over the chunks that carries the fp32 state
  in shared memory, 64 x 64 tiles of the causal (t, s) square, fp32 FMA
  products.

Both read x, b and c in the model's layout, form u = x * dt and the decay
themselves, and add the D skip in fp32 before rounding y once; the source
note gives the bound on the H100 and the designs. ``chunk_states_plain``,
``state_pass_plain``, ``chunk_scan_plain`` and ``ssd_decomposed_plain`` are
the wgmma variant's three stages in plain torch (with ``split=True`` at its
precision), for the tests; no main path calls them.

``ssd_scan_cuda`` routes by where the tensors lie: on the CPU it runs the
plain version (the torch twin of ``ref.ssd_chunked``); on a CUDA tensor it
launches the variant ``ssd_variant`` names or raises. Nothing falls back to
another variant or to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from ._autograd import refuse_grad

MAX_CHUNK = 256       # the kernels' scans: one step a thread (fma, 256 threads), two (wgmma, 128)
MAX_STATE = 128       # widest N the kernels keep per thread
WGMMA_TILE = 64       # wgmma variant: steps of an s tile, rows of a t tile, the one head_dim
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
VARIANTS = ("wgmma", "fma")
MAX_GRID_Z = 65535    # wgmma variant: chunk_scan's grid holds B * L / chunk on its z axis


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = [p] * 8 + [i] * 8 + [p]
    lib.ssd_scan_fwd.restype = i
    lib.ssd_scan_smem_bytes.argtypes = [i]
    lib.ssd_scan_smem_bytes.restype = i
    lib.ssd_scan_wgmma_fwd.argtypes = [p] * 12 + [i] * 7 + [p]
    lib.ssd_scan_wgmma_fwd.restype = i
    lib.ssd_scan_wgmma_smem_bytes.argtypes = [i, i]
    lib.ssd_scan_wgmma_smem_bytes.restype = i
    return lib


def ssd_variant(x, b, chunk: int) -> str:
    """The kernel that takes these operands, from their shapes and dtype.

    ``"wgmma"`` for bf16 with head_dim P = 64, state width N = 64 or 128 and
    a chunk (``min(chunk, L)``, as the wrapper uses it) that is a multiple of
    64 up to 256; ``"fma"`` otherwise.
    """
    P, N, Q = x.shape[-1], b.shape[-1], min(chunk, x.shape[1])
    if x.dtype == torch.bfloat16 and P == WGMMA_TILE and N in (64, 128) \
            and Q % WGMMA_TILE == 0 and 0 < Q <= MAX_CHUNK:
        return "wgmma"
    return "fma"


def smem_bytes(n: int) -> int:
    """Shared memory of one fma block at state width ``n`` (the kernel's
    layout: cum and dt of a chunk, 64-row tiles of c and b, of u and of the
    decay weights, and the 32-row state slice; rows of n padded by 4
    floats)."""
    ld = n + 4
    return 4 * (2 * MAX_CHUNK + 2 * 64 * ld + 64 * 32 + 64 * 68 + 32 * ld)


def wgmma_smem_bytes(kernel: str, n: int) -> int:
    """Dynamic shared memory of one wgmma-variant block at state width
    ``n``: ``"chunk_state"`` holds a ring of 2 stages of an x box and n/64
    b boxes (64 x 64 bf16 each, 8 KB); ``"chunk_scan"`` also the t tile of C
    and the entering state's hi and lo (n/64 boxes each). Then a full and an
    empty mbarrier a stage (chunk_scan: two more, for C and the state) and 1
    KB of slack to align to the 128-byte swizzle's 1024-byte atoms."""
    box, nb, stages = WGMMA_TILE * 128, n // 64, 2
    ring = stages * (1 + nb) * box
    if kernel == "chunk_state":
        return ring + 2 * stages * 8 + 1024
    return 3 * nb * box + ring + (2 + 2 * stages) * 8 + 1024


def check_inputs(x, dt, a_log, b, c, d_skip, chunk: int) -> None:
    """Raise ``ValueError`` for what the kernels do not take."""
    if x.dim() != 4 or dt.dim() != 3 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError("expected x (B,L,H,P), dt (B,L,H), b and c (B,L,G,N)")
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if dt.shape != (B, L, H) or b.shape[:2] != (B, L) or G == 0 or H % G \
            or a_log.shape != (H,) or d_skip.shape != (H,):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, b/c {tuple(b.shape)}, a_log "
                         f"{tuple(a_log.shape)}, d_skip {tuple(d_skip.shape)}")
    if P % 16:
        raise ValueError(f"head_dim P={P} is not a multiple of 16")
    if N % 16 or not 16 <= N <= MAX_STATE:
        raise ValueError(f"d_state N={N}: the kernel takes a multiple of 16 "
                         f"up to {MAX_STATE}")
    if not 1 <= chunk <= MAX_CHUNK or L % chunk:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_CHUNK}] and "
                         f"divide L={L}")
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"x, b, c are {x.dtype}, {b.dtype}, {c.dtype}; the "
                         f"kernel takes one of {tuple(DTYPES)} for all three")
    if dt.dtype != torch.float32:
        raise ValueError(f"dt is {dt.dtype}; the kernel takes float32")
    wgmma = ssd_variant(x, b, chunk) == "wgmma"
    if wgmma and B * (L // chunk) > MAX_GRID_Z:
        raise ValueError(f"B * L / chunk = {B * (L // chunk)} exceeds the "
                         f"wgmma grid's {MAX_GRID_Z}")
    for name, t in (("x", x), ("dt", dt), ("b", b), ("c", c)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if wgmma and name != "dt" and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned, which TMA needs")


def ssd_scan_plain(x, dt, a_log, b, c, d_skip, *, chunk=128):
    """The kernels' function in plain torch (fp32 inside, x's dtype out)."""
    return ref.ssd_chunked(x, dt, a_log, b, c, d_skip, chunk_size=chunk)


# ---------------------------------------------------------------------------
# The wgmma variant's three stages in plain torch
# ---------------------------------------------------------------------------


def split_bf16(v):
    """fp32 ``v`` as two bf16 tensors, hi = bf16(v) and lo = bf16(v - hi).

    v - hi is exact in fp32, and hi + lo (exact in fp32 too) keeps about 16
    significant bits of v, a relative error of at most about 2^-17: what a
    bf16 tensor-core product against an exact bf16 operand sees when it runs
    once on hi and once on lo into the same fp32 sums.
    """
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


def _as_operand(v, split: bool):
    """fp32 ``v`` as a split tensor-core operand carries it (hi + lo), or
    unchanged."""
    if not split:
        return v
    hi, lo = split_bf16(v)
    return hi.float() + lo.float()


def chunk_cumsum(dt, a_log, chunk: int):
    """cum (B, L/chunk, chunk, H): sum_{r<=s} dt_r A within each chunk."""
    B, L, H = dt.shape
    A = -torch.exp(a_log.float())
    return torch.cumsum((dt.float() * A).reshape(B, L // chunk, chunk, H), dim=2)


def _by_chunk(t, chunk: int):
    """(B, L, ...) -> (B, L/chunk, chunk, ...) in fp32."""
    return t.float().reshape(t.shape[0], t.shape[1] // chunk, chunk, *t.shape[2:])


def _heads(t, H: int):
    """(B, nc, Q, G, N) groups -> (B, nc, Q, H, N) heads (h reads h / (H/G))."""
    return t.repeat_interleave(H // t.shape[3], dim=3)


def chunk_states_plain(x, dt, a_log, b, *, chunk, split=False):
    """Stage 1: each chunk's local state s_loc (B, nc, H, P, N) = sum_s
    x_s^T (dt_s e^{tot - cum_s}) b_s, and tot (B, nc, H) = cum at the chunk's
    last step. ``split``: x * w as the kernel's hi + lo operand."""
    cum = chunk_cumsum(dt, a_log, chunk)                         # (B,nc,Q,H)
    tot = cum[:, :, -1]
    w = _by_chunk(dt, chunk) * torch.exp(tot[:, :, None] - cum)
    xw = _as_operand(_by_chunk(x, chunk) * w[..., None], split)  # (B,nc,Q,H,P)
    bh = _heads(_by_chunk(b, chunk), x.shape[2])
    return torch.einsum("bcshp,bcshn->bchpn", xw, bh), tot


def state_pass_plain(s_loc, tot):
    """Stage 2: S <- e^{tot_c} S + s_loc_c over the chunks. Returns the state
    entering each chunk (B, nc, H, P, N; zero for the first) and the final
    state (B, H, P, N)."""
    S = torch.zeros_like(s_loc[:, 0])
    entering = []
    for ci in range(s_loc.shape[1]):
        entering.append(S)
        S = S * torch.exp(tot[:, ci])[..., None, None] + s_loc[:, ci]
    return torch.stack(entering, 1), S


def chunk_scan_plain(x, dt, a_log, b, c, d_skip, s_in, *, chunk, split=False):
    """Stage 3: y (B, L, H, P) in x's dtype from the entering states:
    y_t = sum_{s<=t} (c_t . b_s) e^{cum_t - cum_s} dt_s x_s + e^{cum_t}
    (c_t . S_in) + D x_t. ``split``: W and S_in as hi + lo operands."""
    B, L, H, P = x.shape
    cum = chunk_cumsum(dt, a_log, chunk).transpose(2, 3)        # (B,nc,H,Q)
    bh, ch = (_heads(_by_chunk(t, chunk), H) for t in (b, c))
    xs = _by_chunk(x, chunk)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    cb = torch.einsum("bcthn,bcshn->bchts", ch, bh)
    # select before exp: above the diagonal cum_t - cum_s > 0 may overflow
    diff = torch.where(causal, cum[..., :, None] - cum[..., None, :], 0.0)
    dts = _by_chunk(dt, chunk).transpose(2, 3)[..., None, :]    # (B,nc,H,1,Q)
    w = torch.where(causal, cb * torch.exp(diff) * dts, 0.0)
    y = torch.einsum("bchts,bcshp->bcthp", _as_operand(w, split), xs)
    y = y + torch.einsum("bcthn,bchpn->bcthp", ch, _as_operand(s_in, split)) \
        * torch.exp(cum).transpose(2, 3)[..., None]
    y = y.reshape(B, L, H, P) + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype)


def ssd_decomposed_plain(x, dt, a_log, b, c, d_skip, *, chunk=128, split=False):
    """The three stages composed: the wgmma variant's function (with
    ``split``, at its precision) in plain torch; returns y in x's dtype and
    the final state in fp32."""
    chunk = min(chunk, x.shape[1])
    s_loc, tot = chunk_states_plain(x, dt, a_log, b, chunk=chunk, split=split)
    s_in, state = state_pass_plain(s_loc, tot)
    y = chunk_scan_plain(x, dt, a_log, b, c, d_skip, s_in, chunk=chunk,
                         split=split)
    return y, state


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------


def _launch(variant: str, x, dt, a_log, b, c, d_skip, chunk: int):
    """Run one variant on CUDA tensors (no dispatch, no launch count): the
    wrapper's launch, also called directly to time one variant against the
    other."""
    check_inputs(x, dt, a_log, b, c, d_skip, chunk)
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if variant == "wgmma" and ssd_variant(x, b, chunk) != "wgmma":
        raise ValueError(f"the wgmma variant does not take P={P}, N={N}, "
                         f"chunk {chunk}, {x.dtype}")
    a_log = a_log.to(x.device, torch.float32).contiguous()
    d_skip = d_skip.to(x.device, torch.float32).contiguous()
    y = torch.empty_like(x)
    state = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "wgmma":
            nc = L // chunk
            s_loc = torch.empty(B, nc, H, P, N, dtype=torch.float32, device=x.device)
            tot = torch.empty(B, nc, H, dtype=torch.float32, device=x.device)
            s_hi = torch.empty(B, nc, H, P, N, dtype=torch.bfloat16, device=x.device)
            s_lo = torch.empty_like(s_hi)
            err = _lib().ssd_scan_wgmma_fwd(
                x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                c.data_ptr(), d_skip.data_ptr(), y.data_ptr(), state.data_ptr(),
                s_loc.data_ptr(), tot.data_ptr(), s_hi.data_ptr(), s_lo.data_ptr(),
                B, L, H, P, G, N, chunk, stream)
        else:
            err = _lib().ssd_scan_fwd(
                x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                c.data_ptr(), d_skip.data_ptr(), y.data_ptr(), state.data_ptr(),
                B, L, H, P, G, N, chunk, DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan {variant} kernel launch failed "
                           f"(cudaError_t {err})")
    return y, state


def ssd_scan_cuda(x, dt, a_log, b, c, d_skip, *, chunk=128):
    """x: (B,L,H,P); dt: (B,L,H); a_log, d_skip: (H,); b, c: (B,L,G,N)
    -> y (B,L,H,P) in x's dtype, final state (B,H,P,N) fp32.

    CPU tensors take the plain version. CUDA tensors launch the variant that
    ``ssd_variant`` names on the current stream; ``ssd_scan_cuda.launches``
    counts the wrapper's launches (one per call, whatever the variant
    launches inside) and ``ssd_scan_cuda.variant_launches`` them by variant.
    On the card an input that requires grad, in grad mode, raises (no
    backward).
    """
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a_log, b, c, d_skip, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {x.device}")
    refuse_grad("ssd_scan", x, dt, a_log, b, c, d_skip)
    chunk = min(chunk, x.shape[1])
    variant = ssd_variant(x, b, chunk)
    out = _launch(variant, x, dt, a_log, b, c, d_skip, chunk)
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.variant_launches[variant] += 1
    return out


ssd_scan_cuda.launches = 0
ssd_scan_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)
