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

The backward is ``csrc/ssd_scan_bwd.cu`` (no Pallas counterpart: the
reference differentiates ``ref.ssd_chunked``), launched by
``ssd_scan_bwd_cuda`` in the variant ``ssd_bwd_variant`` names (the
forward's rule, so a model shape takes ``wgmma`` both ways):

- ``"wgmma"``: five kernels. ``chunk_state``, the forward's own kernel run
  over two halves, forms each chunk's local state and local state gradient
  on wgmma; ``state_pass`` carries the states forward and their gradients
  back over the chunks on the CUDA cores and writes both as bf16 hi + lo;
  ``rows`` (per 64-row t tile: C B^T,
  dY X^T, V B) gives dc and d cum's row part, ``cols`` (per 64-row s tile:
  B C^T, X dY^T, W^T dY, V^T C) dx, db and d cum's column part, both fed by
  TMA; ``reduce`` takes d cum's reverse scan and sums db and dc over each
  group's heads.
- ``"fma"``: fp32 FMA on the CUDA cores, three kernels. ``states``
  recomputes the state entering each chunk and, in reverse, the gradient of
  the state leaving it; ``chunks`` forms every per-step gradient of one
  chunk and one P-slice; ``reduce`` sums the per-head and per-slice
  partials.

Neither uses atomics: a backward repeats bitwise. ``ssd_scan_bwd_plain`` is
the fma decomposition in plain torch (``bwd_states_plain``,
``bwd_chunks_plain``, ``bwd_log_decay_plain``, ``bwd_reduce_plain``) and
``ssd_scan_bwd_wgmma_plain`` the wgmma one (``bwd_chunk_states_plain``,
``bwd_state_pass_plain``, ``bwd_rows_plain``, ``bwd_cols_plain``; with
``split=True`` at its precision), for the tests; no main path calls them.

``ssd_scan_cuda`` routes by where the tensors lie: on the CPU it runs the
plain version (the torch twin of ``ref.ssd_chunked``), which autograd
differentiates; on a CUDA tensor it launches the variant ``ssd_variant``
names or raises, and in grad mode with an input that requires grad it goes
through ``SsdScanFn``, whose backward is the backward kernel. Nothing falls
back to another variant or to the plain version. ``_launch`` and
``_launch_bwd`` run a named variant (no dispatch, no count), so that the
tests and ``chip_smoke.py`` can hold and time ``fma`` at the shapes that
take ``wgmma``.

On ``meta`` tensors ``_launch``, ``_launch_bwd`` and the wrappers take the
kernels' path without launching them: they return outputs (and allocate the
scratch) of the kernels' shapes and dtypes, and a running census
(``repro_torch.census``) records each call with its cost from ``ssd_cost``
and ``ssd_bwd_cost``, the counts the bounds in ``chip_smoke.py`` read too.
On CPU tensors under a census the plain versions run as one forward and one
backward call (``census.plain_kernel``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import census
from . import _build, ref

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


def ssd_cost(B, L, H, P, N, G, chunk, esize: int = 2) -> tuple[int, int]:
    """(FLOPs, HBM bytes) of one scan, per (b, h, chunk) the causal half of
    C B^T and of W u (Q^2 (N + P)) plus the state term and update (4 Q N
    P); x and y, dt (fp32), b and c, a_log and d_skip (fp32) read or written
    once and the fp32 final state, ``esize`` bytes an element of x, b, c."""
    flops = B * H * (L // chunk) * (chunk ** 2 * (N + P) + 4 * chunk * N * P)
    nbytes = (2 * B * L * H * P * esize + B * L * H * 4
              + 2 * B * L * G * N * esize + 2 * H * 4 + B * H * P * N * 4)
    return flops, nbytes


def ssd_bwd_cost(B, L, H, P, N, G, chunk, esize: int = 2) -> tuple[int, int]:
    """(FLOPs, HBM bytes) of one backward, per (b, h, chunk): C B^T and dY
    U^T over the causal half (Q^2 N + Q^2 P), W^T dY, V B and V^T C (Q^2 P +
    2 Q^2 N), the state terms dY S_in, B Gs^T and U Gs (6 Q N P) and the
    chunk's two state products (4 Q N P); x, dy and dx, dt and ddt (fp32),
    b, c, db and dc, a_log, d_skip and their gradients (fp32) read or
    written once."""
    Q = chunk
    flops = B * H * (L // Q) * (Q * Q * (3 * N + 2 * P) + 10 * Q * N * P)
    nbytes = (3 * B * L * H * P * esize + 2 * B * L * H * 4
              + 4 * B * L * G * N * esize + 4 * H * 4)
    return flops, nbytes


def _cost(x, b, chunk, cost=ssd_cost):
    B, L, H, P = x.shape
    return cost(B, L, H, P, b.shape[3], b.shape[2], min(chunk, L),
                x.element_size())


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
# The backward kernels' three stages in plain torch
# ---------------------------------------------------------------------------


def bwd_states_plain(x, dt, a_log, b, c, dy, dstate=None, *, chunk):
    """Stage 1 of the backward: the state entering each chunk, s_in (B, nc,
    H, P, N), and the gradient of the state leaving each chunk, g (B, nc, H,
    P, N): g of the last chunk is ``dstate`` (zero if None), and in reverse
    g_{c-1} = e^{tot_c} g_c + sum_t e^{cum_t} dy_t c_t^T (the wgmma stages
    ``bwd_chunk_states_plain`` and ``bwd_state_pass_plain`` in fp32)."""
    s_loc, ds_loc, tot = bwd_chunk_states_plain(x, dt, a_log, b, c, dy, chunk=chunk)
    s_in, g, _ = bwd_state_pass_plain(s_loc, ds_loc, tot, dstate)
    return s_in, g


def bwd_chunks_plain(x, dt, a_log, b, c, d_skip, dy, s_in, g, *, chunk):
    """Stage 2: every gradient of each chunk given its entering state s_in
    and the gradient g of its leaving state, with u = dt x, W_ts = (c_t .
    b_s) e^{cum_t - cum_s} and V_ts = (dy_t . u_s) e^{cum_t - cum_s} for
    s <= t (the decay masked before it is exponentiated), M = (C B^T) o V:

    - du_s = sum_t W_ts dy_t + e^{tot - cum_s} g b_s; dx = dt du + D dy;
    - dc_t = sum_s V_ts b_s + e^{cum_t} s_in^T dy_t (per head);
    - db_s = sum_t V_ts c_t + e^{tot - cum_s} g^T u_s (per head);
    - d cum_t = sum_s M_ts - sum_t' M_t't + e^{cum_t} dy_t . (s_in c_t) - K_t,
      K_s = e^{tot - cum_s} u_s . (g b_s), and the last step also gets
      d tot = sum_s K_s + e^{tot} <g, s_in>;
    - d_skip's partial sum dy . x.

    Returns dx (x's dtype), x . du and d cum (B, L, H), db and dc per head
    (B, L, H, N), and d_skip's partials (B, nc, H), all but dx in fp32.
    ``bwd_log_decay_plain`` turns x . du and d cum into ddt and da_log's
    partials (the kernel does it at the end of the same block)."""
    B, L, H, P = x.shape
    cum = chunk_cumsum(dt, a_log, chunk)                         # (B,nc,Q,H)
    tot = cum[:, :, -1]
    xs, dys, dts = (_by_chunk(t, chunk) for t in (x, dy, dt))
    us = xs * dts[..., None]
    bh, ch = (_heads(_by_chunk(t, chunk), H) for t in (b, c))
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    ct = cum.transpose(2, 3)                                     # (B,nc,H,Q)
    diff = torch.where(causal, ct[..., :, None] - ct[..., None, :], 0.0)
    decay = torch.where(causal, torch.exp(diff), 0.0)            # (B,nc,H,t,s)
    cb = torch.einsum("bcthn,bcshn->bchts", ch, bh)
    w = cb * decay
    v = torch.einsum("bcthp,bcshp->bchts", dys, us) * decay
    m = cb * v
    w_end = torch.exp(tot[:, :, None] - cum)                     # (B,nc,Q,H)
    gb = torch.einsum("bcshn,bchpn->bcshp", bh, g)
    du = torch.einsum("bchts,bcthp->bcshp", w, dys) + w_end[..., None] * gb
    dx = dts[..., None] * du + d_skip.float()[:, None] * dys
    dcs = torch.einsum("bcthp,bchpn->bcthn", dys, s_in) * torch.exp(cum)[..., None]
    dc = torch.einsum("bchts,bcshn->bcthn", v, bh) + dcs
    db = torch.einsum("bchts,bcthn->bcshn", v, ch) \
        + w_end[..., None] * torch.einsum("bcshp,bchpn->bcshn", us, g)
    k = w_end * (us * gb).sum(-1)                                # (B,nc,Q,H)
    dcum = (m.sum(-1) - m.sum(-2)).transpose(2, 3) + (ch * dcs).sum(-1) - k
    dcum[:, :, -1] += k.sum(2) + torch.exp(tot) * (g * s_in).sum((-1, -2))
    return (dx.reshape(B, L, H, P).to(x.dtype), (xs * du).sum(-1).reshape(B, L, H),
            dcum.reshape(B, L, H), db.reshape(B, L, H, -1),
            dc.reshape(B, L, H, -1), (dys * xs).sum((2, 4)))


def bwd_log_decay_plain(dt, a_log, xdu, dcum, *, chunk):
    """The log-decay's gradient: d la = the reverse cumulative sum of d cum
    within each chunk, ddt = x . du + A d la (B, L, H), and da_log's
    partials A sum_r dt_r d la_r (B, nc, H)."""
    B, L, H = dt.shape
    A = -torch.exp(a_log.float())
    dla = _by_chunk(dcum, chunk).flip(2).cumsum(2).flip(2)       # (B,nc,Q,H)
    ddt = xdu + A * dla.reshape(B, L, H)
    return ddt, A * (_by_chunk(dt, chunk) * dla).sum(2)


def bwd_reduce_plain(db_h, dc_h, da_part, dd_part, G: int):
    """Stage 3: db and dc summed over each group's heads (B, L, G, N), and
    da_log's and d_skip's partials over their leading two axes (H,)."""
    B, L, H, N = db_h.shape
    db, dc = (t.reshape(B, L, G, H // G, N).sum(3) for t in (db_h, dc_h))
    return db, dc, da_part.sum((0, 1)), dd_part.sum((0, 1))


def ssd_scan_bwd_plain(x, dt, a_log, b, c, d_skip, dy, dstate=None, *, chunk=128):
    """The backward kernels' function in plain torch, stage by stage:
    gradients (dx, ddt, da_log, db, dc, dd_skip) of ``ssd_scan_plain`` for
    the output gradient ``dy`` and the final state's ``dstate`` (None: zero),
    each in its input's dtype."""
    chunk = min(chunk, x.shape[1])
    s_in, g = bwd_states_plain(x, dt, a_log, b, c, dy, dstate, chunk=chunk)
    dx, xdu, dcum, db_h, dc_h, dd_part = bwd_chunks_plain(
        x, dt, a_log, b, c, d_skip, dy, s_in, g, chunk=chunk)
    ddt, da_part = bwd_log_decay_plain(dt, a_log, xdu, dcum, chunk=chunk)
    db, dc, da, dd = bwd_reduce_plain(db_h, dc_h, da_part, dd_part, G=b.shape[2])
    return (dx, ddt.to(dt.dtype), da.to(a_log.dtype), db.to(b.dtype),
            dc.to(c.dtype), dd.to(d_skip.dtype))


# ---------------------------------------------------------------------------
# The wgmma backward's stages in plain torch
# ---------------------------------------------------------------------------


def bwd_chunk_states_plain(x, dt, a_log, b, c, dy, *, chunk, split=False):
    """Stage 1 of the wgmma backward: each chunk's local state s_loc and tot
    as ``chunk_states_plain`` gives them, and its local state gradient
    ds_loc (B, nc, H, P, N) = sum_t (e^{cum_t} dy_t)^T c_t. ``split``: x w and
    dy e^{cum} as the kernel's hi + lo operands."""
    s_loc, tot = chunk_states_plain(x, dt, a_log, b, chunk=chunk, split=split)
    cum = chunk_cumsum(dt, a_log, chunk)                         # (B,nc,Q,H)
    dyw = _as_operand(_by_chunk(dy, chunk) * torch.exp(cum)[..., None], split)
    ch = _heads(_by_chunk(c, chunk), x.shape[2])
    return s_loc, torch.einsum("bcthp,bcthn->bchpn", dyw, ch), tot


def bwd_state_pass_plain(s_loc, ds_loc, tot, dstate=None, *, split=False):
    """Stage 2: the state entering each chunk, s_in, and the gradient of the
    state leaving it, g (B, nc, H, P, N; g of the last chunk is ``dstate``,
    zero if None), each as the kernel's hi + lo operand carries it with
    ``split``; and d tot's state term e^{tot} <g, s_in> (B, nc, H), with g
    in fp32 and s_in as carried."""
    s_in, _ = state_pass_plain(s_loc, tot)
    G = torch.zeros_like(s_loc[:, 0]) if dstate is None else dstate.float()
    leaving = []
    for ci in reversed(range(s_loc.shape[1])):
        leaving.append(G)
        G = G * torch.exp(tot[:, ci])[..., None, None] + ds_loc[:, ci]
    g = torch.stack(leaving[::-1], 1)
    s_in = _as_operand(s_in, split)
    sg = torch.exp(tot) * (g * s_in).sum((-1, -2))
    return s_in, _as_operand(g, split), sg


def _bwd_pairs(x, dt, a_log, b, c, dy, chunk):
    """What both passes form per (t, s) pair: cum (B, nc, Q, H), C B^T and
    (dY X^T) dt_s, and the decay e^{cum_t - cum_s} masked to s <= t before
    it is exponentiated, each (B, nc, H, t, s)."""
    H = x.shape[2]
    cum = chunk_cumsum(dt, a_log, chunk)
    ct = cum.transpose(2, 3)                                     # (B,nc,H,Q)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    diff = torch.where(causal, ct[..., :, None] - ct[..., None, :], 0.0)
    decay = torch.where(causal, torch.exp(diff), 0.0)
    bh, ch = (_heads(_by_chunk(t, chunk), H) for t in (b, c))
    cb = torch.einsum("bcthn,bcshn->bchts", ch, bh)
    dts = _by_chunk(dt, chunk).transpose(2, 3)[..., None, :]    # (B,nc,H,1,s)
    dyx = torch.einsum("bcthp,bcshp->bchts", _by_chunk(dy, chunk),
                       _by_chunk(x, chunk)) * dts
    return cum, cb, dyx, decay


def bwd_rows_plain(x, dt, a_log, b, c, dy, s_in, *, chunk, split=False):
    """Stage 3, the row pass: dc per head (B, L, H, N) = sum_s V_ts b_s +
    e^{cum_t} s_in^T dy_t, and d cum's row part (B, L, H) = sum_s M_ts +
    c_t . (e^{cum_t} s_in^T dy_t), with V = (dY X^T) dt_s o decay and M =
    (C B^T) o V. ``split``: V as hi + lo (s_in comes carried from stage 2)."""
    B, L, H, P = x.shape
    cum, cb, dyx, decay = _bwd_pairs(x, dt, a_log, b, c, dy, chunk)
    v = dyx * decay
    bh, ch = (_heads(_by_chunk(t, chunk), H) for t in (b, c))
    dcs = torch.einsum("bcthp,bchpn->bcthn", _by_chunk(dy, chunk), s_in) \
        * torch.exp(cum)[..., None]
    dc = torch.einsum("bchts,bcshn->bcthn", _as_operand(v, split), bh) + dcs
    row = (cb * v).sum(-1).transpose(2, 3) + (ch * dcs).sum(-1)
    return dc.reshape(B, L, H, -1), row.reshape(B, L, H)


def bwd_cols_plain(x, dt, a_log, b, c, d_skip, dy, g, *, chunk, split=False):
    """Stage 3, the column pass, with W = (C B^T) o decay, V = (dY X^T) dt_s
    o decay, M = (C B^T) o V and u_s = dt_s x_s:

    - du_s = sum_t W_ts dy_t + e^{tot - cum_s} g b_s; dx = dt du + D dy;
    - db per head = sum_t V_ts c_t + e^{tot - cum_s} dt_s g^T x_s;
    - d cum's column part = -sum_t M_ts - K_s, K_s = u_s . (e^{tot - cum_s}
      g b_s).

    Returns dx (x's dtype), x . du and the column part (B, L, H), db per
    head (B, L, H, N), and per (B, nc, H) the chunk's sum of K_s (d tot's
    term) and d_skip's partial dy . x. ``split``: W and V as hi + lo (g comes
    carried from stage 2)."""
    B, L, H, P = x.shape
    cum, cb, dyx, decay = _bwd_pairs(x, dt, a_log, b, c, dy, chunk)
    tot = cum[:, :, -1]
    xs, dys, dts = (_by_chunk(t, chunk) for t in (x, dy, dt))
    bh, ch = (_heads(_by_chunk(t, chunk), H) for t in (b, c))
    w_end = torch.exp(tot[:, :, None] - cum)                     # (B,nc,Q,H)
    du_state = w_end[..., None] * torch.einsum("bcshn,bchpn->bcshp", bh, g)
    k = dts * (xs * du_state).sum(-1)                            # (B,nc,Q,H)
    db_state = (dts * w_end)[..., None] * torch.einsum("bcshp,bchpn->bcshn", xs, g)
    v = dyx * decay
    du = torch.einsum("bchts,bcthp->bcshp", _as_operand(cb * decay, split), dys) \
        + du_state
    db = torch.einsum("bchts,bcthn->bcshn", _as_operand(v, split), ch) + db_state
    dx = dts[..., None] * du + d_skip.float()[:, None] * dys
    col = -(cb * v).sum(-2).transpose(2, 3) - k
    return (dx.reshape(B, L, H, P).to(x.dtype), (xs * du).sum(-1).reshape(B, L, H),
            col.reshape(B, L, H), db.reshape(B, L, H, -1), k.sum(2),
            (dys * xs).sum((2, 4)))


def ssd_scan_bwd_wgmma_plain(x, dt, a_log, b, c, d_skip, dy, dstate=None, *,
                             chunk=128, split=False):
    """The wgmma backward's function in plain torch, stage by stage (with
    ``split``, at its precision): local states, the state pass, the row and
    column passes, then d tot into each chunk's last step, the log-decay's
    reverse scan and the sums over heads. Gradients as
    ``ssd_scan_bwd_plain``."""
    chunk = min(chunk, x.shape[1])
    B, L, H, _ = x.shape
    s_loc, ds_loc, tot = bwd_chunk_states_plain(x, dt, a_log, b, c, dy, chunk=chunk,
                                                split=split)
    s_in, g, sg = bwd_state_pass_plain(s_loc, ds_loc, tot, dstate, split=split)
    dc_h, row = bwd_rows_plain(x, dt, a_log, b, c, dy, s_in, chunk=chunk, split=split)
    dx, xdu, col, db_h, k_sum, dd_part = bwd_cols_plain(
        x, dt, a_log, b, c, d_skip, dy, g, chunk=chunk, split=split)
    dcum = (row + col).reshape(B, L // chunk, chunk, H)
    dcum[:, :, -1] += k_sum + sg
    ddt, da_part = bwd_log_decay_plain(dt, a_log, xdu, dcum.reshape(B, L, H),
                                       chunk=chunk)
    db, dc, da, dd = bwd_reduce_plain(db_h, dc_h, da_part, dd_part, G=b.shape[2])
    return (dx, ddt.to(dt.dtype), da.to(a_log.dtype), db.to(b.dtype),
            dc.to(c.dtype), dd.to(d_skip.dtype))


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------


def _launch(variant: str, x, dt, a_log, b, c, d_skip, chunk: int):
    """Run one variant on CUDA tensors (no dispatch, no launch count): the
    wrapper's launch, also called directly to time one variant against the
    other. On meta tensors the outputs alone, unlaunched."""
    with census.kernel("ssd_scan", lambda: _cost(x, b, chunk)):
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
        if variant == "wgmma":
            nc = L // chunk
            s_loc = torch.empty(B, nc, H, P, N, dtype=torch.float32, device=x.device)
            tot = torch.empty(B, nc, H, dtype=torch.float32, device=x.device)
            s_hi = torch.empty(B, nc, H, P, N, dtype=torch.bfloat16, device=x.device)
            s_lo = torch.empty_like(s_hi)
        if x.is_meta:
            return y, state
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            if variant == "wgmma":
                err = _lib().ssd_scan_wgmma_fwd(
                    x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                    c.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
                    state.data_ptr(), s_loc.data_ptr(), tot.data_ptr(),
                    s_hi.data_ptr(), s_lo.data_ptr(), B, L, H, P, G, N, chunk,
                    stream)
            else:
                err = _lib().ssd_scan_fwd(
                    x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                    c.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
                    state.data_ptr(), B, L, H, P, G, N, chunk, DTYPES[x.dtype],
                    stream)
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
    Meta tensors take the kernels' path unlaunched (the module's docstring).
    On the card, in grad mode with an input that requires grad, the call
    goes through ``SsdScanFn``, whose backward is the backward kernel.
    """
    args = (x, dt, a_log, b, c, d_skip)
    if x.device.type == "cpu":
        if census.active() is None:
            return ssd_scan_plain(*args, chunk=chunk)
        return census.plain_kernel(
            "ssd_scan", lambda: _cost(x, b, chunk),
            lambda *a: ssd_scan_plain(*a, chunk=chunk), args,
            lambda a, grads: ssd_scan_bwd_plain(
                *a, torch.zeros_like(x) if grads[0] is None else grads[0],
                grads[1], chunk=chunk),
            lambda: _cost(x, b, chunk, ssd_bwd_cost))
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no SSD kernel for device {x.device}")
    chunk = min(chunk, x.shape[1])
    variant = ssd_variant(x, b, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        out = SsdScanFn.apply(*args, chunk, variant)
    else:
        out = _launch(variant, *args, chunk)
    if not x.is_meta:
        ssd_scan_cuda.launches += 1
        ssd_scan_cuda.variant_launches[variant] += 1
    return out


ssd_scan_cuda.launches = 0
ssd_scan_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)


class SsdScanFn(torch.autograd.Function):
    """The forward kernel (the variant the wrapper picked), keeping its
    inputs; the backward kernel for the six gradients. The backward
    recomputes the chunks' states, so the forward saves nothing more."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d_skip, chunk, variant):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a_log, b, c, d_skip)
        ctx.chunk, ctx.site = chunk, census.site()
        return _launch(variant, x, dt, a_log, b, c, d_skip, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a_log, b, c, d_skip = ctx.saved_tensors
        with census.at(ctx.site), census.kernel(
                "ssd_scan_bwd", lambda: _cost(x, b, ctx.chunk, ssd_bwd_cost)):
            dy = torch.zeros_like(x) if dy is None else dy.contiguous()
            dstate = None if dstate is None else dstate.contiguous()
            grads = ssd_scan_bwd_cuda(x, dt, a_log, b, c, d_skip, dy, dstate,
                                      chunk=ctx.chunk)
        return (*grads, None, None)


def bwd_slice(p: int) -> int:
    """Columns of P one block of the fma backward takes (P must be a multiple
    of 16): 64, 32 or 16, the widest that divides P."""
    return next(ps for ps in (64, 32, 16) if p % ps == 0)


def ssd_bwd_variant(x, b, chunk: int) -> str:
    """The backward kernel that takes these operands: ``ssd_variant``'s rule,
    so a model shape takes ``"wgmma"`` both ways."""
    return ssd_variant(x, b, chunk)


def bwd_smem_bytes(kernel: str, n: int, ps: int) -> int:
    """Dynamic shared memory of one fma backward block at state width ``n``
    and P-slice ``ps`` (rows of n and of ps padded by 4 floats): ``"states"``
    holds cum and dt of a chunk, a 64-row tile of b (or c) and of u (or dy)
    and the ps x n state slice; ``"chunks"`` five per-step vectors, 64-row
    tiles of c, b, dy and u, the W and V tiles and the slices of the
    entering state and of its gradient."""
    ldn, ldp, ldw = n + 4, ps + 4, 64 + 4
    if kernel == "states":
        return 4 * (2 * MAX_CHUNK + 64 * ldn + 64 * ldp + ps * ldn)
    return 4 * (5 * MAX_CHUNK + 2 * 64 * ldn + 2 * 64 * ldp + 2 * 64 * ldw
                + 2 * ps * ldn)


BWD_WGMMA_KERNELS = ("chunk_state", "rows", "cols")


def bwd_wgmma_smem_bytes(kernel: str, n: int) -> int:
    """Dynamic shared memory of one wgmma backward block at state width
    ``n``, in 64 x 64 bf16 boxes of 8 KB (n/64 boxes for a tile of b, c or a
    state): ``"chunk_state"`` the forward's, run over (dy, c) too;
    ``"rows"`` the t tile's c and dy, the entering state's hi
    and lo, and a ring of 2 stages of an x box and a b tile; ``"cols"`` the
    s tile's b, x and dy, the state gradient's hi and lo, and a ring of 2
    stages of a dy box and a c tile. Then 8 bytes a barrier (a full and an
    empty one a stage; rows and cols two more) and 1 KB of slack to align to
    the 128-byte swizzle's 1024-byte atoms."""
    if kernel == "chunk_state":             # the forward's own kernel
        return wgmma_smem_bytes("chunk_state", n)
    box, nb, stages = WGMMA_TILE * 128, n // 64, 2
    ring = stages * (1 + nb) * box
    tiles = {"rows": 3 * nb + 1, "cols": 3 * nb + 2}[kernel]
    return tiles * box + ring + (2 + 2 * stages) * 8 + 1024


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bwd.argtypes = [p] * 21 + [i] * 8 + [p]
    lib.ssd_scan_bwd.restype = i
    lib.ssd_scan_bwd_smem_bytes.argtypes = [i, i, i]
    lib.ssd_scan_bwd_smem_bytes.restype = i
    lib.ssd_scan_bwd_wgmma.argtypes = [p] * 29 + [i] * 7 + [p]
    lib.ssd_scan_bwd_wgmma.restype = i
    lib.ssd_scan_bwd_wgmma_smem_bytes.argtypes = [i, i]
    lib.ssd_scan_bwd_wgmma_smem_bytes.restype = i
    return lib


def check_bwd_inputs(variant: str, x, dt, a_log, b, c, d_skip, dy, dstate,
                     chunk: int) -> None:
    """Raise ``ValueError`` for what the backward variant does not take: the
    forward's ``check_inputs``, dy shaped like x, dstate (B,H,P,N) fp32 or
    None, and for ``wgmma`` its shapes and a 16-byte aligned dy (TMA)."""
    check_inputs(x, dt, a_log, b, c, d_skip, chunk)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous() \
            or dy.device != x.device:
        raise ValueError("dy must be a contiguous tensor shaped like x, of "
                         "its dtype, on its device")
    B, L, H, P = x.shape
    N = b.shape[3]
    if dstate is not None and (dstate.shape != (B, H, P, N) or not
                               dstate.is_contiguous() or dstate.device != x.device
                               or dstate.dtype != torch.float32):
        raise ValueError(f"dstate must be contiguous fp32 {(B, H, P, N)} on "
                         f"x's device")
    if variant == "wgmma":
        if ssd_bwd_variant(x, b, min(chunk, L)) != "wgmma":
            raise ValueError(f"the wgmma backward does not take P={P}, N={N}, "
                             f"chunk {chunk}, {x.dtype}")
        if dy.data_ptr() % 16:
            raise ValueError("dy is not 16-byte aligned, which TMA needs")
    elif variant != "fma":
        raise ValueError(f"no SSD backward variant {variant!r}")


def _launch_bwd(variant: str, x, dt, a_log, b, c, d_skip, dy, dstate, chunk: int):
    """Run one backward variant on CUDA tensors (no dispatch, no launch
    count): the wrapper's launch, also called directly to hold and time one
    variant against the other. On meta tensors the outputs alone (and the
    scratch), unlaunched."""
    with census.kernel("ssd_scan_bwd",
                       lambda: _cost(x, b, chunk, ssd_bwd_cost)):
        check_bwd_inputs(variant, x, dt, a_log, b, c, d_skip, dy, dstate, chunk)
        if x.device.type not in ("cuda", "meta"):
            raise ValueError(f"no SSD backward kernel for device {x.device}")
        B, L, H, P = x.shape
        G, N = b.shape[2], b.shape[3]
        chunk = min(chunk, L)
        nc, dev, f32 = L // chunk, x.device, torch.float32
        a32 = a_log.to(dev, f32).contiguous()
        d32 = d_skip.to(dev, f32).contiguous()
        dx, db, dc = torch.empty_like(x), torch.empty_like(b), torch.empty_like(c)
        ddt = torch.empty(B, L, H, dtype=f32, device=dev)
        da, dd = (torch.empty(H, dtype=f32, device=dev) for _ in range(2))
        ptrs = [t.data_ptr() for t in (x, dt, a32, b, c, d32, dy)] + \
            [None if dstate is None else dstate.data_ptr()] + \
            [t.data_ptr() for t in (dx, ddt, da, db, dc, dd)]
        # scratch: the chunk states, and the partials the last kernel sums
        if variant == "wgmma":
            s_loc, ds_loc = (torch.empty(B, nc, H, P, N, dtype=f32, device=dev)
                             for _ in range(2))
            tot = torch.empty(B, nc, H, dtype=f32, device=dev)
            halves = [torch.empty(B, nc, H, P, N, dtype=torch.bfloat16, device=dev)
                      for _ in range(4)]                    # s_hi, s_lo, g_hi, g_lo
            sg_part = torch.empty(B, nc, H, P * N // 1024, dtype=f32, device=dev)
            db_part, dc_part = (torch.empty(B, L, H, N, dtype=f32, device=dev)
                                for _ in range(2))
            dcum_row, dcum_col, xdu = (torch.empty(B, L, H, dtype=f32, device=dev)
                                       for _ in range(3))
            k_part, dd_part = (torch.empty(B, nc, chunk // WGMMA_TILE, H, dtype=f32,
                                           device=dev) for _ in range(2))
            scratch = [s_loc, ds_loc, tot, *halves, sg_part, db_part, dc_part, dcum_row,
                       dcum_col, xdu, k_part, dd_part]
        else:
            nsl = P // bwd_slice(P)
            s_in, g = (torch.empty(B, nc, H, P, N, dtype=f32, device=dev) for _ in range(2))
            ddt_part = torch.empty(nsl, B, L, H, dtype=f32, device=dev)
            db_part, dc_part = (torch.empty(nsl, B, L, H, N, dtype=f32, device=dev)
                                for _ in range(2))
            da_part, dd_part = (torch.empty(nsl, B, nc, H, dtype=f32, device=dev)
                                for _ in range(2))
            scratch = [s_in, g, ddt_part, db_part, dc_part, da_part, dd_part]
        if not x.is_meta:
            ptrs += [t.data_ptr() for t in scratch]
            _bwd_launch(variant, ptrs, B, L, H, P, G, N, chunk, x.dtype, dev)
        return (dx, ddt, da.to(a_log.device, a_log.dtype), db, dc,
                dd.to(d_skip.device, d_skip.dtype))


def _bwd_launch(variant, ptrs, B, L, H, P, G, N, chunk, dtype, dev):
    """The backward variant's kernels on the card, over ``_launch_bwd``'s
    tensors' pointers."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "wgmma":
            err = _bwd_lib().ssd_scan_bwd_wgmma(*ptrs, B, L, H, P, G, N, chunk, stream)
        else:
            err = _bwd_lib().ssd_scan_bwd(*ptrs, B, L, H, P, G, N, chunk,
                                          DTYPES[dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan {variant} backward kernel launch failed "
                           f"(cudaError_t {err})")


def ssd_scan_bwd_cuda(x, dt, a_log, b, c, d_skip, dy, dstate=None, *, chunk=128):
    """Gradients (dx, ddt, da_log, db, dc, dd_skip) of ``ssd_scan`` for the
    output gradient ``dy`` (x's shape and dtype) and the final state's
    ``dstate`` ((B,H,P,N) fp32; None: zero), each in its input's dtype, fp32
    inside: the variant ``ssd_bwd_variant`` names, on the current stream
    (``wgmma``: chunk_state, state_pass, rows, cols, reduce; ``fma``:
    states, chunks, reduce). ``ssd_scan_bwd_cuda.launches`` counts the calls
    and ``ssd_scan_bwd_cuda.variant_launches`` them by variant. CUDA tensors
    (meta tensors: the gradients alone, unlaunched); it takes what the
    forward's ``check_inputs`` takes, and for ``wgmma`` a 16-byte aligned
    dy."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no SSD backward kernel for device {x.device}; on "
                         f"the CPU autograd differentiates the plain version")
    variant = ssd_bwd_variant(x, b, min(chunk, x.shape[1]))
    out = _launch_bwd(variant, x, dt, a_log, b, c, d_skip, dy, dstate, chunk)
    if not x.is_meta:
        ssd_scan_bwd_cuda.launches += 1
        ssd_scan_bwd_cuda.variant_launches[variant] += 1
    return out


ssd_scan_bwd_cuda.launches = 0
ssd_scan_bwd_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)
