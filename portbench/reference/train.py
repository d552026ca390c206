"""The plain reference's train step: loss, gradients and AdamW, in fp32,
for any family (``reference/<family>.py``), with no complete set of fp32
gradients alive at once.

A step makes two passes over the layers. The first runs the forward one
layer at a time without autograd and keeps each layer's input; takes the
loss over the last layer's output in blocks of rows, with its gradient
there and that of the weights outside the layers (``outer_weights``);
runs each layer, last first, again under autograd from its kept input,
back-propagates the gradient from above, adds each leaf's sum of squares
and drops the gradients; and back-propagates what reaches the first layer
through the embedding. From the sums of squares come
the global norm, the clip and the first gradient's norms; the head and the
embedding are updated. The second pass back-propagates each layer again,
last first, from the same kept input and the same gradient from above, and
updates that layer's leaves as soon as it has passed the gradient on. A
leaf that several layers share (``leaf_of`` gives it no index) sums its
gradient over them and is updated after the last.

AdamW follows the configuration: the gradients clipped by their global
norm, the moments and the params stored in the configuration's dtypes
(bf16 moments, bf16 params, the router fp32) and every operation on them
in fp32, weight decay on leaves of two dims or more, the learning rate of
a warm-up and cosine schedule. The arithmetic is that of one pass with
every gradient kept; only the order in which leaves are updated differs.
"""
from __future__ import annotations

import functools
import math

import torch

from .common import FP32, Precision, fp32_exact, hidden_states, leaves

ROWS = 2048        # rows of the loss head a block


def learning_rate(step: int, opt: dict) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay
    to a tenth of it at ``total_steps``."""
    peak, warm, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


def adamw_update(p, m, v, g, at, clip: float, count: int, opt: dict, lr: float):
    """One AdamW step in place on ``p[at]``, ``m[at]``, ``v[at]`` from their
    fp32 gradient g; weight decay where the leaf p has two dims or more."""
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    corr1, corr2 = 1 - b1 ** count, 1 - b2 ** count
    g = g * clip
    m_f = b1 * m[at].float() + (1 - b1) * g
    v_f = b2 * v[at].float() + (1 - b2) * g.square()
    step = (m_f / corr1) / (torch.sqrt(v_f / corr2) + eps)
    if wd and p.dim() >= 2:
        step = step + wd * p[at].float()
    p[at] = (p[at].float() - lr * step).to(p.dtype)
    m[at] = m_f.to(m.dtype)
    v[at] = v_f.to(v.dtype)


def _add(into: dict, grads: dict):
    for path, g in grads.items():
        into[path] = into[path] + g if path in into else g


class _Step:
    """One step's two passes over ``family``'s layers (see the module's
    text), the params and the moments updated in place."""

    def __init__(self, family, params, model, moments, prec: Precision):
        self.family, self.params, self.model = family, params, model
        self.moments, self.prec = moments, prec
        self.by_path = leaves(params)
        self.layers = [(group, i, kind) for group, n, kind, *_ in family.layer_plan(model)
                       for i in range(n)]

    def forward(self, tokens) -> tuple:
        """(the last layer's output, each layer's input), without autograd."""
        kept: list = []
        with torch.no_grad():
            x = hidden_states(self.family, self.params, self.model, tokens, self.prec, kept)
        return x, kept

    def head(self, x, labels, n: int, outer: dict) -> tuple:
        """(cross-entropy over n tokens, its gradient at the last layer's
        output x); the outer weights' gradients accumulate in their
        ``grad``."""
        d = x.shape[-1]
        flat, labels = x.reshape(-1, d), labels.reshape(-1).long()
        g = torch.empty_like(flat)
        ce = 0.0
        for lo in range(0, flat.shape[0], ROWS):
            xb = flat[lo:lo + ROWS].detach().requires_grad_(True)
            with torch.enable_grad():
                lg = self.family.logits(outer, xb, self.prec)
                gold = lg.gather(-1, labels[lo:lo + ROWS, None])[:, 0]
                part = (torch.logsumexp(lg, -1) - gold).sum() / n
                part.backward()
            g[lo:lo + ROWS] = xb.grad
            ce += float(part.detach())
        return ce, g.view_as(x)

    def backward(self, kept, g, shared: dict, take, drop: bool = False):
        """Each layer, last first, under autograd from its kept input and
        the gradient g at its output. Each of its leaves' fp32 gradients
        goes to ``take(leaf path, index, gradient)``, or, for a leaf the
        layers share, is summed into ``shared``. With ``drop`` each kept
        input is let go once used. Returns the gradient at the first
        layer's input."""
        fam = self.family
        positions = torch.arange(kept[0].shape[1], device=kept[0].device)
        for k in reversed(range(len(self.layers))):
            group, i, kind = self.layers[k]
            lw = fam.layer_weights(self.params, group, i)
            for t in leaves(lw).values():
                t.requires_grad_(True)
            xi = kept[k].detach().requires_grad_(True)
            if drop:
                kept[k] = None
            with torch.enable_grad():
                y, aux = fam.layer_forward(lw, xi, self.model, kind, positions,
                                           prec=self.prec)
                obj = (y * g).sum()
                if aux is not None:
                    obj = obj + aux
                obj.backward()
            for path, t in leaves(lw).items():
                leaf, at = fam.leaf_of(group, i, path)
                if at is None:
                    _add(shared, {leaf: t.grad})
                else:
                    take(leaf, at, t.grad)
            g = xi.grad
            del lw, xi, y, obj
        return g

    def update(self, path: str, at, g, *, clip: float, count: int, opt: dict,
               lr: float):
        """AdamW on leaf ``path`` from its gradient g (``at`` None), or on
        its slice ``at`` from that slice's; a whole leaf of three dims or
        more a slice at a time."""
        p, m, v = self.by_path[path], self.moments["m"][path], self.moments["v"][path]
        if at is not None:
            cuts = [(at, g)]
        elif p.dim() >= 3:
            cuts = [(s, g[s]) for s in range(p.shape[0])]
        else:
            cuts = [(..., g)]
        with torch.no_grad():
            for s, gs in cuts:
                adamw_update(p, m, v, gs, s, clip, count, opt, lr)
        self.updated.add(path)

    def run(self, tokens, labels, count: int, opt: dict, lr: float) -> tuple:
        """One step: (cross-entropy, {leaf: ‖clip · g‖}, the norm of each
        leaf's gradient as the update takes it)."""
        x_last, kept = self.forward(tokens)
        outer_w = self.family.outer_weights(self.params)
        for t in leaves(outer_w).values():
            t.requires_grad_(True)
        ce, g_top = self.head(x_last, labels, tokens.numel(), outer_w)
        del x_last
        # pass 1: every leaf's sum of squares, the layers' gradients dropped
        squares = {p: 0.0 for p in self.by_path}
        shared: dict = {}

        def square(path, at, g):
            squares[path] += float(g.square().sum())
        g_in = self.backward(kept, g_top, shared, square)
        with torch.enable_grad():
            self.family.embed(outer_w, tokens).backward(g_in)
        outer = {p: t.grad for p, t in leaves(outer_w).items()}
        del g_in, outer_w
        for path, g in {**outer, **shared}.items():
            squares[path] = float(g.square().sum())
        gnorm = math.sqrt(sum(squares[p] for p in self.by_path))
        clip = min(1.0, opt["grad_clip"] / max(gnorm, 1e-12)) if opt["grad_clip"] else 1.0
        seen = {p: clip * math.sqrt(squares[p]) for p in self.by_path}
        # the head and the embedding now; pass 2 updates each layer's slices
        self.updated = set()
        adam = functools.partial(self.update, clip=clip, count=count, opt=opt, lr=lr)
        for path, g in outer.items():
            adam(path, None, g)
        del outer
        shared = {}
        self.backward(kept, g_top, shared, adam, drop=True)
        for path, g in shared.items():
            adam(path, None, g)
        if self.updated != set(self.by_path):
            raise ValueError("the family's pieces leave out "
                             f"{sorted(set(self.by_path) - self.updated)}")
        return ce, seen


def train_steps(family, params, model: dict, batches, opt: dict,
                prec: Precision = FP32) -> dict:
    """Run the steps of ``batches`` (each (tokens, labels)) of ``family``'s
    model from ``params`` (updated in place) and zero moments of
    ``opt["moment_dtype"]``. Returns {"loss": [ce of each step],
    "first_grad": {leaf: ‖clip g‖} of step 1}."""
    mdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[opt["moment_dtype"]]
    moments = {k: {p: torch.zeros(t.shape, dtype=mdt, device=t.device)
                   for p, t in leaves(params).items()}
               for k in ("m", "v")}
    step = _Step(family, params, model, moments, prec)
    losses, first = [], None
    with fp32_exact():
        for n, (tokens, labels) in enumerate(batches):
            ce, seen = step.run(tokens, labels, n + 1, opt, learning_rate(n, opt))
            losses.append(ce)
            first = first or seen
    return {"loss": losses, "first_grad": first}
