"""The rule for a CUDA kernel that has no backward kernel yet: it takes no
input that requires grad (the SSD scan's, until its backward lands)."""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise where a CUDA kernel would drop a gradient.

    The kernels write their outputs through ctypes, outside autograd, so an
    output carries no ``grad_fn``: with grad mode on and an input that
    requires grad, ``backward()`` would silently stop at the kernel. The
    flash-attention and grouped-GEMM kernels have backward kernels
    (``torch.autograd.Function``s); the SSD scan's is queued (ROADMAP.md A10,
    the SSD backward kernel). Until it lands its wrapper raises instead of
    falling back to its plain version.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward yet (the SSD backward "
            "kernel is queued in ROADMAP.md A10), and an input requires grad; "
            "run under torch.no_grad() or torch.inference_mode(), or on the "
            "CPU, where the plain version differentiates")
