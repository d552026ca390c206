"""The train step: loss, microbatch accumulation, remat.

Counterpart of ``repro.runtime.train``. ``build_train_step`` returns a
(state, batch) -> (state, metrics) function over a state of
``{"params", "opt": {"m", "v", "count"}, "step"}``. The step updates the
state's tensors in place (``optim/adamw.py`` says why) and returns the same
dict with a new ``step``. On the card the attention and grouped-GEMM kernels
take their gradients through their backward kernels; on the CPU autograd
differentiates their plain versions. The mesh path (sharded state,
``state_shardings``, ``jit_train_step``) is ROADMAP.md A11.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from ..optim import adamw
from ..optim.schedule import warmup_cosine
from ..tree import leaves, unflatten


@dataclass(frozen=True)
class TrainOptions:
    remat_policy: str | None = "full"    # None | full | dots | minimal
    microbatches: int = 1
    opt: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)
    warmup_steps: int = 100
    total_steps: int = 10_000
    scan_unroll: int = 1                 # no effect: the layers are a loop


def cross_entropy(logits, labels):
    """logits: (B, S, V); labels: (B, S) int. Mean NLL in fp32: the
    log-sum-exp minus the gold logit."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def init_train_state(model, generator: torch.Generator, opts: TrainOptions):
    """Random params on ``generator``'s device, zero moments, step 0."""
    params = model.init(generator)
    return {"params": params, "opt": adamw.init_opt_state(params, opts.opt),
            "step": torch.zeros((), dtype=torch.int32,
                                device=generator.device)}


def _check_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "the mesh path (sharded state, expert parallelism) is ROADMAP.md "
            "A11; train on one device with mesh=None")


def build_grad_fn(model, opts: TrainOptions, mesh=None) -> Callable:
    """(params, batch) -> (grads, metrics): the step's gradients, a tree
    like ``params``, and ``{"loss": ce, "aux_loss": aux}`` fp32 scalars.

    Loss is ce + aux. With ``microbatches`` k > 1 the batch is split in k
    along its leading axis and the gradients g / k are summed into fp32
    zeros, so they are fp32 (with k = 1 they have the params' dtype), and
    the metrics are the last microbatch's, as in the reference.
    """
    _check_mesh(mesh)

    def loss_fn(params, batch):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, _, aux = model.apply(params, inputs, mode="train",
                                     remat_policy=opts.remat_policy,
                                     scan_unroll=opts.scan_unroll)
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux, {"loss": ce.detach(), "aux_loss": aux.detach()}

    def grads_of(params, batch):
        ps = list(leaves(params))
        for p in ps:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = loss_fn(params, batch)
                grads = torch.autograd.grad(loss, ps, allow_unused=True)
        finally:
            for p in ps:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(ps, grads)]
        return unflatten(params, iter(grads)), metrics

    def grad_fn(params, batch):
        k = opts.microbatches
        if k == 1:
            return grads_of(params, batch)
        n = next(iter(batch.values())).shape[0]
        if n % k:
            raise ValueError(f"batch of {n} does not split into {k} microbatches")
        acc = None
        for i in range(k):
            mb = {name: t[i * n // k:(i + 1) * n // k] for name, t in batch.items()}
            grads, metrics = grads_of(params, mb)
            if acc is None:
                acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                       for g in leaves(grads)]
            for a, g in zip(acc, leaves(grads)):
                a.add_(g / k)    # g / k in g's dtype, summed in fp32
            del grads
        return unflatten(params, iter(acc)), metrics

    return grad_fn


def build_train_step(model, opts: TrainOptions, mesh=None) -> Callable:
    """(state, batch) -> (state, metrics): one AdamW step at the learning
    rate of ``warmup_cosine(state["step"])``; metrics ``loss``, ``aux_loss``,
    ``grad_norm`` and ``lr``, fp32 scalars."""
    grad_fn = build_grad_fn(model, opts, mesh)

    def train_step(state, batch):
        grads, metrics = grad_fn(state["params"], batch)
        lr = warmup_cosine(state["step"], peak_lr=opts.opt.lr,
                           warmup_steps=opts.warmup_steps,
                           total_steps=opts.total_steps)
        new_p, new_opt, opt_metrics = adamw.apply_updates(
            state["params"], grads, state["opt"], opts.opt, lr=lr)
        del grads
        new_state = {"params": new_p, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {**metrics, **opt_metrics}

    return train_step
