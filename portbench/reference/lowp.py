"""The control: the reference computed one precision below the
configuration's.

The configurations state bf16 weights and activations, so the control
rounds both operands of every product to fp8 (e4m3, the H100's tensor-core
fp8) with one absmax scale a tensor, as an fp8 GEMM takes them, and
accumulates in fp32. Everything else (norms, softmax, the router, the loss,
the optimizer) stays as in the reference.
"""
from __future__ import annotations

import torch

from .decoder import Precision

E4M3_MAX = 448.0


def fp8(x):
    """x rounded to e4m3 under a per-tensor absmax scale, back in fp32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()      # rounded forward, straight-through grad


class FP8(Precision):
    def mm(self, a, b):
        return fp8(a) @ fp8(b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, fp8(a), fp8(b))
