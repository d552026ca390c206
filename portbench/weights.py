"""The weights, drawn on the device from the seed.

The program's parameter layout (its ``ParamSpec`` tree: each leaf's shape,
axes, kind of init and dtype) says which tensors to make; the values are
the benchmark's: each leaf is drawn by one ``randn`` in the dtype it is
served in, from one generator on the device, and scaled in place (a
stacked leaf holds every layer, so a model is a few dozen calls). The same
seed gives the same weights, and ``leaves`` gives them again one at a time
in the same order, for a reference that must start from them after the
program has changed its own copy.
"""
from __future__ import annotations

import math

import torch


def _walk(spec, path=()):
    if isinstance(spec, dict):
        for k in sorted(spec):
            yield from _walk(spec[k], path + (k,))
    else:
        yield path, spec


def _std(spec) -> float:
    if spec.init == "embed":
        return spec.scale or 1.0
    dims = [n for n, a in zip(spec.shape, spec.axes) if a not in ("layers", "group")]
    return spec.scale or 1.0 / math.sqrt(max(math.prod(dims[:-1]) if len(dims) > 1
                                             else dims[0], 1))


def leaves(specs, seed: int, device, default=torch.bfloat16):
    """(path, tensor) of every leaf, drawn in sorted-path order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for path, spec in _walk(specs):
        dtype = spec.dtype or default
        if spec.init == "zeros":
            yield path, torch.zeros(spec.shape, dtype=dtype, device=device)
        elif spec.init == "ones":
            yield path, torch.ones(spec.shape, dtype=dtype, device=device)
        else:
            t = torch.randn(spec.shape, generator=gen, dtype=dtype, device=device)
            yield path, t.mul_(_std(spec))


def draw(specs, seed: int, device, default=torch.bfloat16) -> dict:
    """The whole nested dict of weights (empty blocks kept as empty dicts)."""
    def skeleton(spec):
        return {k: skeleton(v) for k, v in spec.items()} \
            if isinstance(spec, dict) else None
    out = skeleton(specs)
    for path, t in leaves(specs, seed, device, default):
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = t
    return out
