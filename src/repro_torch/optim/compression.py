"""Int8 error-feedback gradient compression (1-bit-Adam family, arXiv:2102.02888).

Counterpart of ``repro.optim.compression``: gradients are quantized to int8
with per-tensor absmax scales before an all-reduce; the quantization
residual is fed back into the next step's gradient (error feedback keeps
convergence). ``compressed_psum`` is the all-reduce, over a process group:
the scale is reduced by MAX so that every rank dequantizes alike, the int8
payload is summed as int32, and the result is divided by the group's size.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..tree import leaves, unflatten


def init_error_state(grads):
    return unflatten(grads, (torch.zeros(g.shape, dtype=torch.float32,
                                         device=g.device)
                             for g in leaves(grads)))


def _quantize(g32, scale):
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)


def compress(g, err):
    """Returns (quantized int8, scale, new error residual)."""
    g = g.to(torch.float32) + err
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = _quantize(g, scale)
    new_err = g - q.to(torch.float32) * scale
    return q, scale, new_err


def decompress(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum(g, err, group=None):
    """Error-feedback int8 all-reduce over ``group`` (every rank calls it).

    The int8 payload is what crosses the links (summed as int32); the fp32
    scale goes by a separate max-reduce so all ranks dequantize alike.
    Returns (the mean over the group, the new residual)."""
    g32 = g.to(torch.float32) + err
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)   # shared scale
    q = _quantize(g32, scale)
    new_err = g32 - q.to(torch.float32) * scale
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    n = dist.get_world_size(group)
    return total.to(torch.float32) * scale / n, new_err


def compression_ratio(tree) -> float:
    """HBM/link bytes saved: fp32 -> int8 + one scale per tensor."""
    raw = sum(x.numel() * 4 for x in leaves(tree))
    comp = sum(x.numel() * 1 + 4 for x in leaves(tree))
    return raw / comp
