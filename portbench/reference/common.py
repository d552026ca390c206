"""What every family's plain reference shares: fp32 products with TF32
off, the precision hook that the control replaces (``lowp.py``), the leaf
paths of a nested dict of weights, and the forward over a family's layers
(the serve check's logits; the train reference's kept inputs)."""
from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def fp32_exact():
    """TF32 off for every product made inside (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


class Precision:
    """fp32 products; the control's subclass rounds their operands."""

    def mm(self, a, b):
        return a @ b

    def einsum(self, eq, a, b):
        return torch.einsum(eq, a, b)


FP32 = Precision()


def leaves(tree, prefix: str = "") -> dict:
    """Leaf path ('/'-joined, after ``prefix``) -> tensor, in sorted order.

    A module-level walk, not a closure: a nested function that calls itself
    is a reference cycle, and one that also held ``out`` would keep every
    tensor it returned alive until the garbage collector ran (1.6 GB a layer
    of the 7B train reference, an fp32 layer and its gradients)."""
    out: dict = {}
    _walk(tree, (), prefix, out)
    return out


def _walk(t, path: tuple, prefix: str, out: dict):
    if isinstance(t, dict):
        for k in sorted(t):
            _walk(t[k], path + (k,), prefix, out)
    else:
        out[prefix + "/".join(path)] = t


def hidden_states(family, params, model: dict, tokens, prec: Precision = FP32,
                  kept: list | None = None):
    """The last layer's output over tokens (B, S), ``family``'s layers run
    one at a time from their fp32 copies; each layer's input is appended
    to ``kept`` where one is given."""
    x = family.embed(params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for group, n, kind, *_ in family.layer_plan(model):
        for i in range(n):
            if kept is not None:
                kept.append(x)
            x, _ = family.layer_forward(family.layer_weights(params, group, i), x,
                                        model, kind, positions, prec=prec)
    return x


@torch.no_grad()
def forward_logits(family, params, model: dict, tokens, positions=None,
                   prec: Precision = FP32):
    """``family``'s fp32 logits of tokens (B, S) at the given positions (all
    of them where None): (B, len(positions), V)."""
    with fp32_exact():
        x = hidden_states(family, params, model, tokens, prec)
        if positions is not None:
            x = x[:, positions]
        return family.logits(params, x, prec)
