"""The plain reference's train step: loss, gradients and AdamW, in fp32.

The forward runs one layer at a time without autograd and keeps each
layer's input; the loss is taken over the final norm's input in blocks of
rows; then each layer, last first, is run again under autograd from its
kept input and back-propagated from the gradient of its output. The
gradients are fp32, one tensor a leaf. AdamW follows the configuration:
the gradients clipped by their global norm, the moments and the params
stored in the configuration's dtypes (bf16 moments, bf16 params, the
router fp32) and every operation on them in fp32, a leaf updated one layer
at a time, weight decay on leaves of two dims or more, the learning rate
of a warm-up and cosine schedule.
"""
from __future__ import annotations

import math

import torch

from .decoder import (FP32, Precision, block, cross_entropy_sum, fp32_exact,
                      hidden_states, leaves)


def loss_and_grads(params, model: dict, tokens, labels, prec: Precision = FP32):
    """(cross-entropy, {leaf path: fp32 gradient}, {leaf path: its sum of
    squares}) of ce + the MoE layers' load-balance losses, at the weights
    ``params``."""
    with fp32_exact():
        grads = {p: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                 for p, t in leaves(params).items()}
        squares = {p: 0.0 for p in grads}
        n = tokens.numel()
        with torch.no_grad():
            x_final, kept = hidden_states(params, model, tokens, prec,
                                          keep_inputs=True)
        scale = params["final_norm"]["scale"].to(torch.float32, copy=True)
        head = params["lm_head"].to(torch.float32, copy=True)
        scale.requires_grad_(True)
        head.requires_grad_(True)
        d = x_final.shape[-1]
        flat = x_final.reshape(-1, d)
        g = torch.empty_like(flat)
        ce = 0.0
        rows = 2048
        for lo in range(0, flat.shape[0], rows):
            xb = flat[lo:lo + rows].detach().requires_grad_(True)
            with torch.enable_grad():
                part = cross_entropy_sum(xb, labels.reshape(-1)[lo:lo + rows],
                                         {"final_norm": {"scale": scale},
                                          "lm_head": head}, prec) / n
                part.backward()
            g[lo:lo + rows] = xb.grad
            ce += float(part.detach())
        for path, t in (("final_norm/scale", scale), ("lm_head", head)):
            grads[path].copy_(t.grad)
            squares[path] += float(t.grad.square().sum())
        g = g.view_as(x_final)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for group, i, kind, x_in in reversed(kept):
            def leafy(t):
                if isinstance(t, dict):
                    return {k: leafy(v) for k, v in t.items()}
                return t[i].to(torch.float32, copy=True).requires_grad_(True)
            lw = leafy(params["groups"][group])
            xi = x_in.detach().requires_grad_(True)
            with torch.enable_grad():
                y, aux = block(lw, xi, model, kind, positions, prec=prec)
                obj = (y * g).sum()
                if aux is not None:
                    obj = obj + aux
                obj.backward()
            for path, t in leaves(lw, f"groups/{group}/").items():
                grads[path][i].copy_(t.grad)
                squares[path] += float(t.grad.square().sum())
            g = xi.grad
            del lw, xi, y, obj
        grads["embed"].index_add_(0, tokens.reshape(-1).long(), g.reshape(-1, d))
        squares["embed"] = float(grads["embed"].square().sum())
        return ce, grads, squares


def learning_rate(step: int, opt: dict) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay
    to a tenth of it at ``total_steps``."""
    peak, warm, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


def adamw(params, grads, squares, moments, count: int, opt: dict, lr: float) -> dict:
    """One AdamW step in place, given each leaf's gradient and its sum of
    squares; returns {leaf: ‖clip · g‖} (fp32), the gradient as the update
    takes it."""
    by_path = leaves(params)
    gnorm = math.sqrt(sum(squares[p] for p in by_path))
    clip = min(1.0, opt["grad_clip"] / max(gnorm, 1e-12)) if opt["grad_clip"] else 1.0
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    corr1, corr2 = 1 - b1 ** count, 1 - b2 ** count
    seen = {}
    for path, p in by_path.items():
        m, v, gl = moments["m"][path], moments["v"][path], grads[path]
        seen[path] = clip * math.sqrt(squares[path])
        cuts = [slice(i, i + 1) for i in range(p.shape[0])] if p.dim() >= 3 else [...]
        for s in cuts:
            g = gl[s] * clip
            m_f = b1 * m[s].float() + (1 - b1) * g
            v_f = b2 * v[s].float() + (1 - b2) * g.square()
            step = (m_f / corr1) / (torch.sqrt(v_f / corr2) + eps)
            if wd and p.dim() >= 2:
                step = step + wd * p[s].float()
            p[s] = (p[s].float() - lr * step).to(p.dtype)
            m[s] = m_f.to(m.dtype)
            v[s] = v_f.to(v.dtype)
    return seen


def train_steps(params, model: dict, batches, opt: dict,
                prec: Precision = FP32) -> dict:
    """Run the steps of ``batches`` (each (tokens, labels)) from ``params``
    (updated in place) and zero moments of ``opt["moment_dtype"]``.
    Returns {"loss": [ce of each step], "first_grad": {leaf: ‖clip g‖} of
    step 1}."""
    mdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[opt["moment_dtype"]]
    moments = {k: {p: torch.zeros(t.shape, dtype=mdt, device=t.device)
                   for p, t in leaves(params).items()}
               for k in ("m", "v")}
    losses, first = [], None
    for n, (tokens, labels) in enumerate(batches):
        ce, grads, squares = loss_and_grads(params, model, tokens, labels, prec)
        with torch.no_grad(), fp32_exact():
            seen = adamw(params, grads, squares, moments, n + 1, opt,
                         learning_rate(n, opt))
        del grads
        losses.append(ce)
        first = first or seen
    return {"loss": losses, "first_grad": first}
