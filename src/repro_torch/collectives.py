"""Differentiable collectives over the named axes of a ``DeviceMesh``.

Every result is contiguous, as the kernels take their operands.

The port runs one process per device (SPMD), each on its own shard: the
counterpart of a ``shard_map`` body. Every rank back-propagates its own
scalar, and a collective's backward is its transpose, as JAX transposes it
inside ``shard_map``: a tiled all-gather's is a reduce-scatter (sum), an
all-to-all's the reverse all-to-all, an all-reduce's (``psum``) an
all-reduce of the cotangents. So the gradient a rank's shard receives is the
sum over every rank's use of it.

``torch.distributed.nn.functional`` has such functions, but its all-gather's
backward fails on a gloo subgroup (it indexes the group by global rank), so
these are written out on ``torch.distributed``'s tensor collectives, which
run on gloo (the CPU tests) and NCCL (the card) alike.

Axes over which a dim is split jointly, such as (pod, data), are gathered
innermost first, so the result is pod-major, as DTensor lays it out.

Each collective reports its result to a running census (``census.py``;
none runs outside the dry-run and its tests), at the site that issued it:
a Function's backward runs at its forward's site.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import census


# the names torch 2.13 gives the tiled all-gather and reduce-scatter (the
# older ones warn there); earlier releases have only the older names
_all_gather_tiled = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_tiled = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def group(mesh, axis: str):
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def _gather(x, dim: int, pg):
    n = dist.get_world_size(pg)
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0], *moved.shape[1:]))
    _all_gather_tiled(out, moved, group=pg)
    census.collective("all-gather", out, n)
    return out.movedim(0, dim).contiguous()


def _scatter_sum(g, dim: int, pg):
    n = dist.get_world_size(pg)
    moved = g.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n, *moved.shape[1:]))
    _reduce_scatter_tiled(out, moved, group=pg)
    census.collective("reduce-scatter", out, n)
    return out.movedim(0, dim).contiguous()


def _exchange(x, split: int, concat: int, pg):
    """Tiled all-to-all: chunk i of ``split`` goes to rank i; the chunks
    received are concatenated along ``concat`` in rank order."""
    n = dist.get_world_size(pg)
    inp = torch.stack(x.chunk(n, dim=split)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=pg)
    census.collective("all-to-all", out, n)
    return torch.cat(out.unbind(0), dim=concat)


def _sum(x, pg):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=pg)
    census.collective("all-reduce", out, dist.get_world_size(pg))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.pg, ctx.site = dim, pg, census.site()
        return _gather(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        with census.at(ctx.site):
            return _scatter_sum(g, ctx.dim, ctx.pg), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, pg):
        ctx.split, ctx.concat, ctx.pg = split, concat, pg
        ctx.site = census.site()
        return _exchange(x, split, concat, pg)

    @staticmethod
    def backward(ctx, g):
        with census.at(ctx.site):
            return _exchange(g, ctx.concat, ctx.split, ctx.pg), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg, ctx.site = pg, census.site()
        return _sum(x, pg)

    @staticmethod
    def backward(ctx, g):
        with census.at(ctx.site):
            return _sum(g, ctx.pg), None


class _Replicated(torch.autograd.Function):
    """A tensor every rank of ``pg`` holds alike, used by each: forward the
    identity, backward the sum of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg, ctx.site = pg, census.site()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with census.at(ctx.site):
            return _sum(g, ctx.pg), None


class _Slice(torch.autograd.Function):
    """A replicated tensor's block along ``dim`` at the rank's index in
    ``pg``: backward gathers the blocks' cotangents into the whole."""

    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.pg, ctx.site = dim, pg, census.site()
        n, i = dist.get_world_size(pg), dist.get_rank(pg)
        return x.chunk(n, dim=dim)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        with census.at(ctx.site):
            return _gather(g, ctx.dim, ctx.pg), None, None


def all_gather(x, mesh, axes, dim: int):
    """Tiled all-gather along ``dim`` over ``axes`` (one name or several,
    outer first)."""
    for a in reversed(_names(axes)):
        x = _AllGather.apply(x, dim, group(mesh, a))
    return x


def all_to_all(x, mesh, axis: str, split: int, concat: int):
    return _AllToAll.apply(x, split, concat, group(mesh, axis))


def psum(x, mesh, axes):
    for a in _names(axes):
        x = _AllReduce.apply(x, group(mesh, a))
    return x


def pmean(x, mesh, axes):
    n = 1
    for a in _names(axes):
        n *= axis_size(mesh, a)
    return psum(x, mesh, axes) / n


def pmax(x, mesh, axes):
    """All-reduce by MAX over ``axes``; not differentiable."""
    out = x.detach().contiguous().clone()
    for a in _names(axes):
        pg = group(mesh, a)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=pg)
        census.collective("all-reduce", out, dist.get_world_size(pg))
    return out


def _names(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _dim_on(spec: tuple, axis: str):
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if axis in names:
            return dim
    return None


def _entry(spec: tuple, dim: int) -> tuple[str, ...]:
    entry = spec[dim] if dim < len(spec) else None
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class _ShareSlice(torch.autograd.Function):
    """A tensor's block along ``dim`` at the rank's index in ``pg``:
    backward places the rank's cotangent in its block of zeros, its share
    of the whole's cotangent, which the collectives before it sum."""

    @staticmethod
    def forward(ctx, x, dim, pg):
        n, i = dist.get_world_size(pg), dist.get_rank(pg)
        ctx.dim, ctx.i, ctx.shape = dim, i, x.shape
        return x.chunk(n, dim=dim)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out.narrow(ctx.dim, ctx.i * g.shape[ctx.dim], g.shape[ctx.dim]).copy_(g)
        return out, None, None


def _relayout(x, dim: int, stored: tuple, use: tuple, mesh):
    """Dim ``dim`` moved from its store's split to its use's where either
    is joint (several axes, outer first, as (pod, data)): gathered whole
    over the store's axes, innermost first, then cut to the use's block,
    outermost first; the use's axes that the store replicates sum the
    ranks' shares of the gradient, as the gather's backward sums them over
    the store's."""
    s_ax, u_ax = _entry(stored, dim), _entry(use, dim)
    others = {a for spec in (stored, use) for d in range(len(spec)) if d != dim
              for a in _entry(spec, d)}
    if others & (set(s_ax) | set(u_ax)):
        raise NotImplementedError(
            f"dim {dim} moves from {s_ax} to {u_ax}, whose axes split other "
            f"dims too")
    live = [a for a in mesh.mesh_dim_names if axis_size(mesh, a) > 1]
    for a in u_ax:
        if a not in s_ax and a in live:
            x = _Replicated.apply(x, group(mesh, a))
    for a in reversed(s_ax):
        if a in live:
            x = _AllGather.apply(x, dim, group(mesh, a))
    for a in u_ax:
        if a in live:
            x = _ShareSlice.apply(x, dim, group(mesh, a))
    return x


def to_use(x, stored: tuple, use: tuple, mesh):
    """A weight's local shard, stored by the assignment ``stored``, moved to
    the block this rank computes with under ``use`` (differentiably): on
    each mesh axis a dim the store splits and the use does not is gathered,
    a dim the use splits and the store does not is cut to the rank's block,
    and a weight the store and the use both replicate is used alike by the
    axis' ranks, so its gradient is their sum. A dim split jointly over
    several axes (as (pod, data)) in the store or the use, not alike in
    both, is gathered whole and cut again (``_relayout``). An axis of size
    1 moves nothing and needs no collective."""
    moved = set()
    for dim in range(max(len(stored), len(use))):
        s_ax, u_ax = _entry(stored, dim), _entry(use, dim)
        if s_ax != u_ax and max(len(s_ax), len(u_ax)) > 1:
            x = _relayout(x, dim, stored, use, mesh)
            moved |= set(s_ax) | set(u_ax)
    for a in reversed(mesh.mesh_dim_names):
        if axis_size(mesh, a) == 1 or a in moved:
            continue
        s, u = _dim_on(stored, a), _dim_on(use, a)
        if s == u and s is not None:
            continue
        pg = group(mesh, a)
        if u is None and s is None:
            x = _Replicated.apply(x, pg)
        elif u is None:
            x = _AllGather.apply(x, s, pg)
        elif s is None:
            x = _Slice.apply(x, u, pg)
        else:
            raise NotImplementedError(
                f"axis {a} splits dim {s} in store and dim {u} in use")
    return x
