"""Grouped (per-expert) matmul for Hopper: the CUDA kernel's wrapper and its
plain version.

Counterpart of ``repro.kernels.moe_gmm`` (``gmm_pallas``). The kernels are in
``csrc/moe_gmm.cu``; ``gmm_variant`` picks one from the shapes and the dtype:

- ``"wgmma"``: bf16 with d and f multiples of 8, every model shape. A
  persistent grid over (expert, C-tile, f-tile) tiles; a producer thread
  feeds x and w tiles 64 deep by TMA into a ring of swizzled stages
  completed on mbarriers, and consumer warpgroups multiply them with
  ``wgmma`` (x K-major, w MN-major through the transpose bit); the output
  tile leaves through shared memory by a TMA store. Prefill
  (C > 64) takes 128 x 256 tiles, two blocks to a cluster sharing each w tile
  by TMA multicast; decode (C <= 64) 64 x 64 tiles (``WGMMA_TILES``).
- ``"mma"``: bf16 shapes TMA cannot address (d or f not a multiple of 8):
  ``mma.sync`` from two ``cp.async`` stages 32 deep.
- ``"fma"``: fp32, in fp32 FMA.

Every path keeps the sum over d in fp32 and rounds the output once to x's
dtype; ragged C, d and f are zero-filled or masked inside the kernel, never
padded on the host. The source note gives the bound on the H100 and the
design.

``gmm_cuda`` routes by where the tensors lie: on the CPU it runs the plain
version (the torch twin of ``ref.gmm_naive``), through which autograd
differentiates; on a CUDA tensor it launches the chosen variant or raises.
Nothing falls back to another variant or to the plain version. In grad mode,
with an input that requires grad, the CUDA path is ``GmmFn``, whose backward
is ``gmm_bwd_cuda``: dx = dy w^T and dw = x^T dy. ``gmm_bwd_variant`` picks
its route from the shapes and the dtype:

- ``"wgmma_bwd"``: where the forward takes ``"wgmma"`` (every model shape).
  Two launches of the wgmma kernel instantiated for the operands' majorness,
  each operand read as stored: dx reads w (E, d, f) as a K-major B (f is the
  contraction and the contiguous axis), dw reads x (E, C, d) as an MN-major
  A through wgmma's transpose bit and dy (E, C, f) as an MN-major B. No
  transposed copy is made.
- ``"mma"`` / ``"fma"``: bf16 shapes TMA cannot address, and fp32: the
  forward's kernels on contiguous transposes (w^T is (E, f, d), x^T (E, d,
  C)).

Its plain version is ``gmm_bwd_plain``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

BLOCK_C = 128          # mma / fma paths: rows of the capacity buffer per block
BLOCK_F = 128          # mma / fma paths: output columns per block
BLOCK_D = 32           # mma path: depth of one bf16 d tile (one pipeline stage)
WGMMA_BLOCK_D = 64     # wgmma path: depth of one stage (one 128-byte box)
# wgmma path, by C tile (64 rows where C <= 64, else 128): (f columns per
# tile, stages in the ring)
WGMMA_TILES = {64: (64, 8), 128: (256, 3)}
MAX_EXPERTS = 65535    # the grid's third dimension (mma / fma paths)
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
VARIANTS = ("wgmma", "mma", "fma")
BWD_VARIANTS = ("wgmma_bwd", "mma", "fma")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_gmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_gmm_fwd.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.moe_gmm_fwd.restype = i
    lib.moe_gmm_smem_bytes.argtypes = [i]
    lib.moe_gmm_smem_bytes.restype = i
    lib.moe_gmm_wgmma_fwd.argtypes = [p, p, p, i, i, i, i, p]
    lib.moe_gmm_wgmma_fwd.restype = i
    lib.moe_gmm_wgmma_bwd.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.moe_gmm_wgmma_bwd.restype = i
    lib.moe_gmm_wgmma_smem_bytes.argtypes = [i]
    lib.moe_gmm_wgmma_smem_bytes.restype = i
    lib.moe_gmm_encode_ns.argtypes = [p, p, i, i, i, i, i]
    lib.moe_gmm_encode_ns.restype = ctypes.c_double
    return lib


def gmm_variant(x, w) -> str:
    """The kernel that takes these operands, from their shapes and dtype.

    ``"wgmma"`` for bf16 whose d and f are multiples of 8 (TMA needs row
    strides that are multiples of 16 bytes), ``"mma"`` for other bf16
    shapes, ``"fma"`` for fp32.
    """
    if x.dtype == torch.float32:
        return "fma"
    d, f = x.shape[-1], w.shape[-1]
    return "wgmma" if d % 8 == 0 and f % 8 == 0 else "mma"


def gmm_bwd_variant(x, w) -> str:
    """The backward's route for these operands, from their shapes and dtype:
    ``"wgmma_bwd"`` where the forward takes ``"wgmma"`` (bf16, d and f
    multiples of 8), else the forward's variant on transposed copies
    (``"mma"`` for other bf16 shapes, ``"fma"`` for fp32)."""
    variant = gmm_variant(x, w)
    return "wgmma_bwd" if variant == "wgmma" else variant


def wgmma_bwd_tiles(C: int) -> dict:
    """Output rows of one wgmma block (``WGMMA_TILES``' key) in each product
    of the backward: dx's rows are C, tiled as the forward's; dw's are d,
    always the 128-row tile."""
    return {"dx": 64 if C <= 64 else 128, "dw": 128}


def wgmma_smem_bytes(block_c: int = 128) -> int:
    """Dynamic shared memory of one wgmma block: its stages of a
    (block_c x 64) x tile and a (64 x block_f) w tile in bf16
    (``WGMMA_TILES``), the (block_c x block_f) bf16 output tile that the
    TMA store reads, one full and one empty mbarrier a stage, and 1 KB of
    slack to align the ring to the 128-byte swizzle's 1024-byte atoms."""
    block_f, stages = WGMMA_TILES[block_c]
    stage = (block_c + block_f) * WGMMA_BLOCK_D * 2
    return stages * stage + block_c * block_f * 2 + 2 * stages * 8 + 1024


def smem_bytes(dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one block of the mma (bf16) or fma (fp32) path:
    bf16, two stages of a (128 x 32) x tile and a (32 x 128) w tile, rows
    padded by 8 elements; fp32, one (16 x 129) transposed x tile and one
    (16 x 128) w tile."""
    if dtype == torch.bfloat16:
        return 2 * (BLOCK_C * (BLOCK_D + 8) + BLOCK_D * (BLOCK_F + 8)) * 2
    return (16 * (BLOCK_C + 1) + 16 * BLOCK_F) * 4


def check_inputs(x, w) -> None:
    """Raise ``ValueError`` for what the kernel does not take."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError("expected x (E, C, d) and w (E, d, f)")
    E, C, d = x.shape
    if w.shape[0] != E or w.shape[1] != d:
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if min(E, C, d, w.shape[2]) < 1 or E > MAX_EXPERTS:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}: every "
                         f"dimension must be >= 1 and E <= {MAX_EXPERTS}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"x and w are {x.dtype} and {w.dtype}; the kernel "
                         f"takes one of {tuple(DTYPES)} for both")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if gmm_variant(x, w) == "wgmma" and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned, which TMA needs")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")


def gmm_plain(x, w):
    """The kernel's function in plain torch (fp32 sums, x's dtype out)."""
    return ref.gmm_naive(x, w)


def _launch(x, w, counter):
    """Launch the kernel ``gmm_variant`` names for x @ w; ``counter`` (a
    wrapper) counts it by variant."""
    check_inputs(x, w)
    E, C, d = x.shape
    f = w.shape[2]
    variant = gmm_variant(x, w)
    out = torch.empty(E, C, f, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "wgmma":
            err = _lib().moe_gmm_wgmma_fwd(x.data_ptr(), w.data_ptr(),
                                           out.data_ptr(), E, C, d, f, stream)
        else:
            err = _lib().moe_gmm_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                     E, C, d, f, DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"moe_gmm {variant} kernel launch failed "
                           f"(cudaError_t {err})")
    counter.variant_launches[variant] += 1
    return out


def gmm_cuda(x, w):
    """x: (E, C, d), w: (E, d, f) -> (E, C, f) in x's dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel that
    ``gmm_variant`` names on the current stream; ``gmm_cuda.launches`` counts
    the launches and ``gmm_cuda.variant_launches`` them by variant. On the
    card, in grad mode with an input that requires grad, the call goes
    through ``GmmFn``, whose backward is ``gmm_bwd_cuda``.
    """
    if x.device.type == "cpu":
        return gmm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped-GEMM kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GmmFn.apply(x, w)
    return _forward(x, w)


def _forward(x, w):
    out = _launch(x, w, gmm_cuda)
    gmm_cuda.launches += 1
    return out


gmm_cuda.launches = 0
gmm_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)


class GmmFn(torch.autograd.Function):
    """The grouped-GEMM kernel, keeping x and w; ``gmm_bwd_cuda`` for the
    gradients."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return gmm_bwd_cuda(x, w, dy.contiguous())


def gmm_bwd_cuda(x, w, dy):
    """Gradients (dx, dw) of y = x @ w per expert for the output gradient
    ``dy`` (E, C, f): dx = dy w^T (E, C, d) and dw = x^T dy (E, d, f), two
    kernel launches on the route ``gmm_bwd_variant`` names.
    ``gmm_bwd_cuda.launches`` counts the calls and
    ``gmm_bwd_cuda.variant_launches`` the kernel launches by route. CUDA
    tensors only.
    """
    if x.device.type != "cuda":
        raise ValueError(f"no grouped-GEMM backward kernel for device "
                         f"{x.device}; on the CPU autograd differentiates the "
                         f"plain version")
    if dy.shape != (x.shape[0], x.shape[1], w.shape[2]):
        raise ValueError(f"dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)} @ w {tuple(w.shape)}")
    variant = gmm_bwd_variant(x, w)
    if variant != "wgmma_bwd":
        dx = _launch(dy, w.transpose(1, 2).contiguous(), gmm_bwd_cuda)
        dw = _launch(x.transpose(1, 2).contiguous(), dy, gmm_bwd_cuda)
        gmm_bwd_cuda.launches += 1
        return dx, dw
    check_inputs(x, w)
    if dy.dtype != x.dtype or not dy.is_contiguous() or dy.data_ptr() % 16 \
            or dy.device != x.device:
        raise ValueError("dy must be a contiguous, 16-byte aligned tensor of "
                         "x's dtype on its device")
    E, C, d = x.shape
    f = w.shape[2]
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().moe_gmm_wgmma_bwd(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                                       dx.data_ptr(), dw.data_ptr(), E, C, d, f,
                                       stream)
    if err:
        raise RuntimeError(f"moe_gmm backward kernel launch failed "
                           f"(cudaError_t {err})")
    gmm_bwd_cuda.variant_launches["wgmma_bwd"] += 2
    gmm_bwd_cuda.launches += 1
    return dx, dw


gmm_bwd_cuda.launches = 0
gmm_bwd_cuda.variant_launches = dict.fromkeys(BWD_VARIANTS, 0)


def gmm_bwd_plain(x, w, dy):
    """The backward's function in plain torch: the two einsums, fp32 sums,
    the inputs' dtypes out."""
    xf, wf, dyf = x.float(), w.float(), dy.float()
    dx = torch.einsum("ecf,edf->ecd", dyf, wf)
    dw = torch.einsum("ecd,ecf->edf", xf, dyf)
    return dx.to(x.dtype), dw.to(w.dtype)
