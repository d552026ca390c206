"""Mamba2 SSD scan for Hopper: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.ssd_scan`` (``ssd_scan_pallas``). The kernel is
``csrc/ssd_scan.cu``: one thread block per (P-slice, head, batch), a loop over
the chunks that carries the fp32 state in shared memory, 64 x 64 tiles of the
causal (t, s) square, fp32 FMA products. It reads x, b and c in bf16 or fp32
in the model's layout, forms u = x * dt and the decay itself, and adds the D
skip in fp32 before rounding y once; its source note gives its bound on the
H100 and the design.

``ssd_scan_cuda`` routes by where the tensors lie: on the CPU it runs the
plain version (the torch twin of ``ref.ssd_chunked``); on a CUDA tensor it
launches the kernel or raises. It never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

MAX_CHUNK = 256       # the kernel's scan gives each of 256 threads one step
MAX_STATE = 128       # widest N the kernel keeps per thread
DTYPES = {torch.bfloat16: 0, torch.float32: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = [p] * 8 + [i] * 8 + [p]
    lib.ssd_scan_fwd.restype = i
    lib.ssd_scan_smem_bytes.argtypes = [i]
    lib.ssd_scan_smem_bytes.restype = i
    return lib


def smem_bytes(n: int) -> int:
    """Shared memory of one block at state width ``n`` (the kernel's layout:
    cum and dt of a chunk, 64-row tiles of c and b, of u and of the decay
    weights, and the 32-row state slice; rows of n padded by 4 floats)."""
    ld = n + 4
    return 4 * (2 * MAX_CHUNK + 2 * 64 * ld + 64 * 32 + 64 * 68 + 32 * ld)


def check_inputs(x, dt, a_log, b, c, d_skip, chunk: int) -> None:
    """Raise ``ValueError`` for what the kernel does not take."""
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
    for name, t in (("x", x), ("dt", dt), ("b", b), ("c", c)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def ssd_scan_plain(x, dt, a_log, b, c, d_skip, *, chunk=128):
    """The kernel's function in plain torch (fp32 inside, x's dtype out)."""
    return ref.ssd_chunked(x, dt, a_log, b, c, d_skip, chunk_size=chunk)


def ssd_scan_cuda(x, dt, a_log, b, c, d_skip, *, chunk=128):
    """x: (B,L,H,P); dt: (B,L,H); a_log, d_skip: (H,); b, c: (B,L,G,N)
    -> y (B,L,H,P) in x's dtype, final state (B,H,P,N) fp32.

    CPU tensors take the plain version. CUDA tensors launch the kernel on the
    current stream; ``ssd_scan_cuda.launches`` counts the launches.
    """
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a_log, b, c, d_skip, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {x.device}")
    chunk = min(chunk, x.shape[1])
    check_inputs(x, dt, a_log, b, c, d_skip, chunk)
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    a_log = a_log.to(x.device, torch.float32).contiguous()
    d_skip = d_skip.to(x.device, torch.float32).contiguous()
    y = torch.empty_like(x)
    state = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), d_skip.data_ptr(), y.data_ptr(), state.data_ptr(),
            B, L, H, P, G, N, chunk, DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed (cudaError_t {err})")
    ssd_scan_cuda.launches += 1
    return y, state


ssd_scan_cuda.launches = 0
