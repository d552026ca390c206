"""Learning-rate schedules (warmup + cosine decay).

Counterpart of ``repro.optim.schedule``: the same formula in fp32, so that
a step's learning rate equals the reference's.
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), an fp32 tensor on
    ``step``'s device (the CPU for an int)."""
    step = torch.as_tensor(step).to(torch.float32)
    f32 = dict(dtype=torch.float32, device=step.device)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                     (1 + torch.cos(torch.tensor(math.pi, **f32) * t)))
    return torch.where(step < warmup_steps, warm, cos)
