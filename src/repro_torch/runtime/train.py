"""The train step: loss, microbatch accumulation, remat, shardings.

Counterpart of ``repro.runtime.train``. ``build_train_step`` returns a
(state, batch) -> (state, metrics) function over a state of
``{"params", "opt": {"m", "v", "count"}, "step"}``. The step updates the
state's tensors in place (``optim/adamw.py`` says why) and returns the same
dict with a new ``step``. On the card the attention and grouped-GEMM kernels
take their gradients through their backward kernels; on the CPU autograd
differentiates their plain versions.

The mesh path, one process per device (``jit_train_step``): the state is a
tree of DTensors placed by ``state_shardings`` (the rule table's
assignments; moments as their params, int8 scales, ``count`` and ``step``
replicated), so a rank holds the reference's share of it. A step takes the
rank's batch shard, moves each layer group's weights on use to the blocks
it computes with (``use_specs``: the dense layers' blocks of heads, MLP
columns and vocabulary over the model axis, ``models/tp.py``; the expert
weights their expert-parallel blocks, ``models/moe.py``; every other dim
gathered whole), and back-propagates the rank's loss over the number of
ranks; each weight's move is differentiable, so its gradient arrives summed
over every rank that used it and reduced to the rank's own shard (a
reduce-scatter over the split dims, a sum over the axes that hold copies:
the mean over the batch shards). With the vocabulary split, the loss is
the vocab-parallel cross-entropy. AdamW then updates the shards in place.
The SSM blocks compute whole on each rank (ROADMAP.md A14).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable

import torch

from .. import census, collectives
from ..models import tp as tp_mod
from ..models.common import tree_map_specs
from ..models.moe import LOCAL, DistContext, expert_specs
from ..optim import adamw
from ..optim.schedule import warmup_cosine
from ..tree import leaves, leaves_with_path, unflatten
from . import sharding as shd


@dataclass(frozen=True)
class TrainOptions:
    remat_policy: str | None = "full"    # None | full | dots | minimal
    microbatches: int = 1
    opt: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)
    warmup_steps: int = 100
    total_steps: int = 10_000
    fsdp_experts: bool = True
    scan_unroll: int = 1                 # no effect: the layers are a loop


def cross_entropy(logits, labels, vocab=None):
    """logits: (B, S, V); labels: (B, S) int. Mean NLL in fp32: the
    log-sum-exp minus the gold logit.

    ``vocab``: the ``models/tp.py`` view over which the logits are split by
    vocabulary (the rank's block of V), or None. Split, the log-sum-exp is
    the global max (not differentiated: it cancels) plus the log of the
    psum of the ranks' exp-sums, and the gold logit comes from the rank
    that holds it, psummed."""
    logits = logits.to(torch.float32)
    labels = labels.long()
    if vocab is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.mean(lse - gold)
    with census.at(("loss",)):
        m = vocab.pmax(logits.amax(dim=-1))
        lse = torch.log(vocab.psum(torch.exp(logits - m[..., None]).sum(-1))) + m
        n = logits.shape[-1]
        local = labels - vocab.rank * n
        own = (local >= 0) & (local < n)
        gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        gold = vocab.psum(torch.where(own, gold, gold.new_zeros(())))
    return torch.mean(lse - gold)


def make_dist(mesh, opts: TrainOptions) -> DistContext:
    if mesh is None:
        return LOCAL
    return DistContext(mesh=mesh, data_axes=shd.batch_axes(mesh),
                       model_axis="model", fsdp_experts=opts.fsdp_experts,
                       ep=True)


def init_train_state(model, generator: torch.Generator, opts: TrainOptions):
    """Random params on ``generator``'s device, zero moments, step 0."""
    params = model.init(generator)
    return {"params": params, "opt": adamw.init_opt_state(params, opts.opt),
            "step": torch.zeros((), dtype=torch.int32,
                                device=generator.device)}


def abstract_train_state(model, opts: TrainOptions):
    """The train state as meta-device tensors (shapes and dtypes only)."""
    params = model.abstract()
    return {"params": params, "opt": adamw.init_opt_state(params, opts.opt),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def state_shardings(model, mesh, opts: TrainOptions, rules=None):
    """The assignment of every leaf of the train state (moments inherit
    their params'; int8 scales, ``count`` and ``step`` are replicated)."""
    p_shard = shd.tree_shardings(model.axes(), model.abstract(), mesh, rules)
    if opts.opt.moment_dtype == "int8":
        m_shard = tree_map_specs(lambda s: {"q": s, "scale": ()}, p_shard)
    else:
        m_shard = p_shard
    return {"params": p_shard,
            "opt": {"m": m_shard, "v": m_shard, "count": ()},
            "step": ()}


def batch_shardings(batch_abstract, mesh):
    return {k: shd.data_spec(a.shape, mesh) for k, a in batch_abstract.items()}


def distribute_train_state(state, model, mesh, opts: TrainOptions, rules=None):
    """A full train state (the same on every rank) as DTensors placed by
    ``state_shardings``: each rank keeps its own shard."""
    return shd.distribute(state, state_shardings(model, mesh, opts, rules), mesh)


# the logical axes whose model-axis assignment a rank computes with
TP_AXES = ("heads", "kv_heads", "mlp", "vocab")


def use_specs(model, dist: DistContext, rules=None):
    """The block of each weight a rank computes with, as GSPMD uses the
    reference's shardings: the experts of an expert-parallel MoE layer in
    the EP body's layout (the reference's shard_map in-specs, after the
    stacked ``layers`` dim); every other weight with the model-axis
    assignment of its TP_AXES dims as ``rules`` store it (tensor parallel,
    ``models/tp.py``), whole on every other dim (an FSDP dim is gathered
    on use)."""
    if dist.mesh is None:
        return unflatten(model.specs, (() for _ in leaves(model.specs)))
    ep = expert_specs(dist) if dist.ep else None
    stored = shd.tree_shardings(model.axes(), model.abstract(), dist.mesh,
                                rules)
    ax = dist.model_axis

    def one(path, axes):
        if ep is not None and len(path) > 1 and path[-2] == "moe" and \
                path[-1] in ("w_gate", "w_up", "w_down"):
            return (None, *ep["wd" if path[-1] == "w_down" else "w"])
        spec = shd.tree_at(stored, path)
        spec = spec + (None,) * (len(axes) - len(spec))
        out = [ax if name in TP_AXES and ax in shd.spec_axes(entry) else None
               for name, entry in zip(axes, spec)]
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    return unflatten(model.specs, (
        one(path, spec.axes) for path, spec in leaves_with_path(model.specs)))


@dataclass(frozen=True)
class TPDistContext(DistContext):
    """A mesh's ``DistContext`` with what tensor parallelism reads
    (``models/tp.py``): the block of each weight a rank computes with
    (``use_specs``) and each cache leaf's placement, as trees like the
    params' and the cache's."""

    use: object = None
    cache_specs: object = None


def tp_dist(model, dist: DistContext, rules=None) -> DistContext:
    """``dist`` with the use blocks its forward computes with."""
    if dist.mesh is None:
        return dist
    return TPDistContext(**{f.name: getattr(dist, f.name)
                            for f in dataclasses.fields(dist)},
                         use=use_specs(model, dist, rules))


def split_axes_of(spec_tree) -> list:
    """Per leaf, in leaf order, the mesh axes its shards are split over."""
    return [tuple(a for e in spec for a in shd.spec_axes(e))
            for _, spec in leaves_with_path(spec_tree)]


def build_grad_fn(model, opts: TrainOptions, mesh=None, rules=None) -> Callable:
    """(params, batch) -> (grads, metrics): the step's gradients, a tree
    like ``params``, and ``{"loss": ce, "aux_loss": aux}`` fp32 scalars.

    Loss is ce + aux. With ``microbatches`` k > 1 the batch is split in k
    along its leading axis and the gradients g / k are summed into fp32
    zeros, so they are fp32 (with k = 1 they have the params' dtype), and
    the metrics are the last microbatch's, as in the reference.

    With a mesh, ``params`` are this rank's local shards and ``stored``
    their assignments, ``batch`` the whole batch (the same on every rank),
    each microbatch of which a rank cuts to its rows by ``data_spec``, as
    the reference shards each microbatch; the gradients are of the shards,
    summed over the ranks, and the metrics the means over the batch
    shards. ``rules`` is the rule table the state is stored by.
    """
    dist = tp_dist(model, make_dist(mesh, opts), rules)
    world = 1 if mesh is None else mesh.size()
    use = getattr(dist, "use", None)
    vocab = tp_mod.of(dist) if tp_mod.vocab_split(dist, model.cfg) else None

    def loss_fn(params, batch, stored):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        if mesh is not None:
            params = shd.gather_on_use(params, stored, use, mesh)
        logits, _, aux = model.apply(params, inputs, mode="train", dist=dist,
                                     remat_policy=opts.remat_policy,
                                     scan_unroll=opts.scan_unroll)
        ce = cross_entropy(logits, batch["labels"], vocab)
        if mesh is None:
            return ce + aux, {"loss": ce.detach(), "aux_loss": aux.detach()}
        # the rank's share of the mean over every rank's loss (ranks on the
        # model axis hold copies); the metrics are the means themselves
        every = mesh.mesh_dim_names
        with census.at(("metrics",)):
            return (ce + aux) / world, {
                "loss": collectives.pmean(ce.detach(), mesh, every),
                "aux_loss": collectives.pmean(aux.detach(), mesh, every)}

    def grads_of(params, batch, stored=None):
        ps = list(leaves(params))
        for p in ps:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = loss_fn(params, batch, stored)
                grads = torch.autograd.grad(loss, ps, allow_unused=True)
        finally:
            for p in ps:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(ps, grads)]
        return unflatten(params, iter(grads)), metrics

    def rows(batch):   # the rows this rank computes
        return batch if mesh is None else shd.local_batch(batch, mesh)

    def grad_fn(params, batch, stored=None):
        k = opts.microbatches
        if k == 1:
            return grads_of(params, rows(batch), stored)
        n = next(iter(batch.values())).shape[0]
        if n % k:
            raise ValueError(f"batch of {n} does not split into {k} microbatches")
        acc = None
        for i in range(k):
            mb = {name: t[i * n // k:(i + 1) * n // k] for name, t in batch.items()}
            grads, metrics = grads_of(params, rows(mb), stored)
            if acc is None:
                acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                       for g in leaves(grads)]
            for a, g in zip(acc, leaves(grads)):
                a.add_(g / k)    # g / k in g's dtype, summed in fp32
            del grads
        return unflatten(params, iter(acc)), metrics

    return grad_fn


def build_train_step(model, opts: TrainOptions, mesh=None, rules=None) -> Callable:
    """(state, batch) -> (state, metrics): one AdamW step at the learning
    rate of ``warmup_cosine(state["step"])``; metrics ``loss``, ``aux_loss``,
    ``grad_norm`` and ``lr``, fp32 scalars. With a mesh the state is a tree
    of DTensors (``distribute_train_state``) and the batch the global one,
    the same on every rank: see the module's docstring; ``rules`` the rule
    table the state is stored by."""
    grad_fn = build_grad_fn(model, opts, mesh, rules)
    if mesh is not None:
        return _mesh_step(grad_fn, opts, mesh)

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


def _mesh_step(grad_fn, opts: TrainOptions, mesh) -> Callable:
    from torch.distributed.tensor import DTensor

    def replicated(t):
        return DTensor.from_local(t, mesh, shd.placements((), mesh),
                                  run_check=False)

    def train_step(state, batch):
        stored = shd.spec_tree_of(state["params"])
        params = shd.local_tree(state["params"])
        opt = shd.local_tree(state["opt"])
        step = state["step"].to_local()
        grads, metrics = grad_fn(params, batch, stored)
        lr = warmup_cosine(step, peak_lr=opts.opt.lr,
                           warmup_steps=opts.warmup_steps,
                           total_steps=opts.total_steps)
        with census.at(("optimizer",)):
            _, new_opt, opt_metrics = adamw.apply_updates(
                params, grads, opt, opts.opt, lr=lr, mesh=mesh,
                split_axes=split_axes_of(stored))
        del grads
        # params and moments were updated in place through their local
        # tensors; the new count and step are new tensors
        new_state = {"params": state["params"],
                     "opt": {**state["opt"], "count": replicated(new_opt["count"])},
                     "step": replicated(step + 1)}
        return new_state, {**metrics, **opt_metrics}

    return train_step


def jit_train_step(model, opts: TrainOptions, mesh, batch_abstract,
                   rules=None) -> Callable:
    """The mesh train step (the reference's pjit'd step; nothing is
    compiled here): it takes a state distributed to ``state_shardings``
    with ``rules`` (``distribute_train_state``), which it checks, and a
    batch of ``batch_abstract``'s shapes, whose rows a rank takes by
    ``batch_shardings`` (all of them where the batch does not split over
    the batch axes)."""
    del batch_abstract   # the step cuts each batch as it comes
    step = build_train_step(model, opts, mesh, rules)
    want = state_shardings(model, mesh, opts, rules)

    def checked_step(state, batch):
        if shd.spec_tree_of(state) != want:
            raise ValueError("the train state is not placed as state_shardings says")
        return step(state, batch)

    return checked_step
