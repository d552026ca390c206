"""Grouped (per-expert) matmul for Hopper: the CUDA kernel's wrapper and its
plain version.

Counterpart of ``repro.kernels.moe_gmm`` (``gmm_pallas``). The kernel is
``csrc/moe_gmm.cu``: one thread block per (f-tile, C-tile, expert), a loop
over d that stages x and w tiles through shared memory with ``cp.async`` (two
stages), ``mma.sync`` bf16 products with the fp32 accumulator in registers,
and the output rounded once to x's dtype. fp32 inputs take an FMA path of the
same tiling. Ragged C, d and f are masked inside the kernel; nothing is
padded on the host. Its source note gives its bound on the H100 and the
design.

``gmm_cuda`` routes by where the tensors lie: on the CPU it runs the plain
version (the torch twin of ``ref.gmm_naive``); on a CUDA tensor it launches
the kernel or raises. It never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

BLOCK_C = 128          # rows of the capacity buffer per block
BLOCK_F = 128          # output columns per block
BLOCK_D = 32           # depth of one bf16 d tile (one pipeline stage)
MAX_EXPERTS = 65535    # the grid's third dimension
DTYPES = {torch.bfloat16: 0, torch.float32: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_gmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_gmm_fwd.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.moe_gmm_fwd.restype = i
    lib.moe_gmm_smem_bytes.argtypes = [i]
    lib.moe_gmm_smem_bytes.restype = i
    return lib


def smem_bytes(dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one block (the kernel's layout): bf16, two stages of
    a (128 x 32) x tile and a (32 x 128) w tile, rows padded by 8 elements;
    fp32, one (16 x 129) transposed x tile and one (16 x 128) w tile."""
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
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")


def gmm_plain(x, w):
    """The kernel's function in plain torch (fp32 sums, x's dtype out)."""
    return ref.gmm_naive(x, w)


def gmm_cuda(x, w):
    """x: (E, C, d), w: (E, d, f) -> (E, C, f) in x's dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel on the
    current stream; ``gmm_cuda.launches`` counts the launches.
    """
    if x.device.type == "cpu":
        return gmm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped-GEMM kernel for device {x.device}")
    check_inputs(x, w)
    E, C, d = x.shape
    f = w.shape[2]
    out = torch.empty(E, C, f, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().moe_gmm_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 E, C, d, f, DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"moe_gmm kernel launch failed (cudaError_t {err})")
    gmm_cuda.launches += 1
    return out


gmm_cuda.launches = 0
