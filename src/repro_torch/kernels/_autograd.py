"""The kernels' one autograd rule: no CUDA kernel takes an input that
requires grad."""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise where a CUDA kernel would drop a gradient.

    The kernels write their outputs through ctypes, outside autograd, so an
    output carries no ``grad_fn``: with grad mode on and an input that
    requires grad, ``backward()`` would silently stop at the kernel. The
    backward kernels come with training (ROADMAP.md A10); until then the
    wrapper raises instead of falling back to its plain version.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward yet (training on the "
            "card comes with ROADMAP.md A10), and an input requires grad; "
            "run under torch.no_grad() or torch.inference_mode(), or on the "
            "CPU, where the plain version differentiates")
