"""Tensor parallelism over the model axis: what a block computes with.

GSPMD derives this in the reference from the rule table's shardings; here
it is written out. On a mesh, the forward's ``dist`` (a
``runtime/train.py::TPDistContext``) holds in ``use`` the block of each
weight a rank computes with (``use_specs``: the stored ``model``
assignment of ``heads``, ``kv_heads``, ``mlp`` and ``vocab``) and in
``cache_specs`` the placement of each cache leaf. A ``TP`` is one module's
view of both: which dims of its weights and cache leaves are split over
``model``, the rank's index there, and the collectives over it.

The modules read it so: column-parallel projections (q/k/v heads, the MLP's
gate and up columns, the vocabulary's logits) compute the rank's block;
row-parallel ones (``wo``, ``w_down``) give partial sums, reduced by a psum
over ``model`` before their bias is added once. The activations between
blocks are the same on every rank of the model axis. A rank's own scalar
loss is back-propagated, so a replicated activation's cotangent on a rank
is its share; the psums' backward sums the shares where they meet a split
weight, and ``collectives.to_use`` sums a replicated weight's gradient over
the ranks. Where ``model`` has size 1, or there is no mesh, nothing is
split and no collective runs: the local path's arithmetic, bitwise.
"""
from __future__ import annotations

import torch

from .. import collectives
from ..runtime.sharding import spec_axes


def unstack(tree):
    """Per-layer assignments of a tree of stacked leaves' (the leading
    ``layers`` entry dropped)."""
    if isinstance(tree, dict):
        return {k: unstack(v) for k, v in tree.items()}
    return None if tree is None else tuple(tree[1:])


class TP:
    """One module's tensor-parallel view: ``specs`` maps its weights to
    their use assignments, ``cache`` its cache leaves to their placements
    (per layer: no ``layers`` entry)."""

    def __init__(self, dist=None, specs=None, cache=None):
        self.dist, self.specs, self.cache = dist, specs or {}, cache or {}
        mesh = getattr(dist, "mesh", None)
        self.size = 1 if mesh is None or specs is None else \
            collectives.axis_size(mesh, dist.model_axis)

    def _child(self, specs, cache) -> "TP":
        return TP(self.dist, specs if self.size > 1 else None, cache)

    def sub(self, key: str) -> "TP":
        """The view of submodule ``key``, on the same cache leaves."""
        return self._child(self.specs.get(key), self.cache)

    def block(self, key: str) -> "TP":
        """The view of block ``key``, with its own cache leaves."""
        return self._child(self.specs.get(key), self.cache.get(key))

    def group(self, *path: str) -> "TP":
        """The per-layer view of the stacked group at ``path``."""
        specs, cache = self.specs, self.cache
        for k in path:
            specs, cache = (specs or {}).get(k), (cache or {}).get(k)
        return self._child(unstack(specs), unstack(cache))

    def with_cache(self, cache) -> "TP":
        return self._child(self.specs, cache)

    def _on(self, spec, dim: int) -> bool:
        return self.size > 1 and spec is not None and dim < len(spec) and \
            self.dist.model_axis in spec_axes(spec[dim])

    def split(self, leaf: str, dim: int) -> bool:
        """Whether dim ``dim`` of weight ``leaf`` is the rank's block."""
        return self._on(self.specs.get(leaf), dim)

    def cache_split(self, leaf: str, dim: int) -> bool:
        """Whether dim ``dim`` of cache leaf ``leaf`` is the rank's block."""
        return self._on(self.cache.get(leaf), dim)

    @property
    def rank(self) -> int:
        if self.size == 1:
            return 0
        return torch.distributed.get_rank(
            collectives.group(self.dist.mesh, self.dist.model_axis))

    def psum(self, x):
        return collectives.psum(x, self.dist.mesh, self.dist.model_axis)

    def pmax(self, x):
        return collectives.pmax(x, self.dist.mesh, self.dist.model_axis)

    def gather(self, x, dim: int):
        return collectives.all_gather(x, self.dist.mesh, self.dist.model_axis,
                                      dim)


def of(dist) -> TP:
    """The whole model's view under ``dist`` (no mesh: nothing split)."""
    return TP(dist, getattr(dist, "use", None), getattr(dist, "cache_specs", None))


def vocab_split(dist, cfg) -> bool:
    """Whether the logits are the rank's block of the vocabulary: the
    output embedding's vocab dim is split over model."""
    tp = of(dist)
    return tp.split("embed", 0) if cfg.tie_embeddings else tp.split("lm_head", 1)


def embed_lookup(table, tokens, tp: TP):
    """``table[tokens]``; on a vocab-split table the rank's rows, the others
    zero, summed over model: exactly one rank gives each row."""
    if not tp.split("embed", 0):
        return table[tokens]
    n = table.shape[0]
    local = tokens - tp.rank * n
    own = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return tp.psum(torch.where(own[..., None], rows, rows.new_zeros(())))
