"""What the kernel wrappers and the collectives report to a running census.

``launch/op_cost.py`` counts one step's work on ``meta`` tensors (or on the
CPU) by a dispatch mode; this module is its narrow interface to the code it
watches, so that the kernels and ``collectives.py`` import nothing of
``launch/``. With no census active every function here is a no-op.

- ``kernel(name, cost)`` brackets one kernel call: the census records the
  call under ``name`` with ``cost()``, the call's (FLOPs, HBM bytes) from the
  kernel's own counts, and counts none of the ops inside it (it still tracks
  their memory). A call nested in another (a backward wrapper called from its
  autograd Function) is the outer one's.
- ``collective(op, tensors, group_size)`` records one collective by its
  result tensors, at the current site.
- ``at(path)`` names the site (a layer group, block or weight, e.g.
  ``groups/g0/attn/wo``) of what runs inside it; ``site()`` reads it, so that
  an autograd Function's backward can return to the site of its forward.
- ``plain_kernel`` runs a kernel's plain version on CPU tensors as the card
  runs the kernel, under a census only: one call of the forward and, in
  grad mode, an autograd Function whose backward is one call of the plain
  backward, each returning contiguous tensors as the kernels write them.
  Autograd through the plain version's own ops would put its steps, not
  the backward kernel, into the count; so a CPU run and a meta trace of one
  step count alike.
"""
from __future__ import annotations

import contextlib

import torch

_active = None          # the running census (launch/op_cost.py::OpCensus)
_site: tuple = ()       # the current site, one path segment each


def active():
    """The running census, or None."""
    return _active


def set_active(census):
    """Make ``census`` (or None) the running one; returns the previous."""
    global _active
    prev, _active = _active, census
    return prev


_NO_CENSUS = contextlib.nullcontext()


def kernel(name: str, cost):
    """A context for one call of kernel ``name``; ``cost`` is a function
    giving its (FLOPs, HBM bytes), called only when a census is active.
    (With none it is a shared no-op: a one-row kernel call is host-bound.)"""
    return _NO_CENSUS if _active is None else _active.kernel(name, cost)


def collective(op: str, tensors, group_size: int) -> None:
    """One collective ``op`` over a group of ``group_size`` ranks, whose
    result is ``tensors`` (one tensor or several)."""
    if _active is not None:
        _active.collective(op, tensors, group_size, site())


def site() -> tuple:
    return _site


@contextlib.contextmanager
def at(path: tuple):
    """Run the body at the site ``path`` (a tuple of path segments)."""
    global _site
    if _active is None:
        yield
        return
    saved, _site = _site, tuple(path)
    try:
        yield
    finally:
        _site = saved


class _PlainKernel(torch.autograd.Function):
    """A kernel's plain forward and plain backward, each one call of a
    kernel under the census (``plain_kernel``)."""

    @staticmethod
    def forward(ctx, call, *inputs):
        name, cost, fwd, bwd, bwd_cost = call
        ctx.call, ctx.site = call, site()
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        with kernel(name, cost):
            return _contiguous(fwd(*inputs))

    @staticmethod
    def backward(ctx, *grads):
        name, _, _, bwd, bwd_cost = ctx.call
        with at(ctx.site), kernel(name + "_bwd", bwd_cost):
            return (None, *_contiguous(bwd(ctx.saved_tensors, grads)))


def _contiguous(out):
    if isinstance(out, tuple):
        return tuple(t.contiguous() for t in out)
    return out.contiguous()


def plain_kernel(name: str, cost, fwd, inputs, bwd, bwd_cost):
    """``fwd(*inputs)``, the plain version of kernel ``name`` on CPU tensors,
    as one call of it; when an input requires grad, through an autograd
    Function whose backward ``bwd(inputs, output_grads)`` (the plain
    backward; an unused output's gradient is None) is one call of
    ``name + "_bwd"`` with ``bwd_cost``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _PlainKernel.apply((name, cost, fwd, bwd, bwd_cost), *inputs)
    with kernel(name, cost):
        return _contiguous(fwd(*inputs))
