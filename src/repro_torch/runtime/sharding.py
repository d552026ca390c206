"""Logical-axis sharding rules (MaxText-style) for DP/FSDP/TP/EP/SP, on
torch's ``DeviceMesh``.

Counterpart of ``repro.runtime.sharding``, with its rule table copied.
Every parameter/cache leaf carries a tuple of *logical* axis names (see
``models.common.ParamSpec``). A rule table maps logical names to mesh axes
with graceful fallback: an assignment is only used if the dimension size is
divisible by the mesh-axis product and no mesh axis is claimed twice within
one tensor; otherwise the next candidate (or replication) applies.

``spec_for_axes`` returns the per-dimension assignment that the reference's
``PartitionSpec`` holds, as a plain tuple (an entry is ``None``, one mesh
axis, or a tuple of axes a dimension is split over jointly), and needs only
the mesh's axis names and sizes: a ``DeviceMesh``, or a ``MeshShape`` for
meshes no process could hold (the 16x16 and 2x16x16 production shapes).
``placements`` turns an assignment into DTensor placements on a mesh,
``distribute`` / ``gather_full`` move a tree between full tensors and
DTensors holding each rank's shard, and ``gather_on_use`` moves a step's
weights from their stored shards to the blocks a rank computes with.
"""
from __future__ import annotations

import collections.abc
import math
from typing import Mapping, NamedTuple, Sequence

import torch

from .. import census, collectives

# Candidate mesh-axis assignments per logical axis, in priority order.
# Each candidate is a tuple of mesh axes the dim is sharded over (jointly).
DEFAULT_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    # data-parallel batch (pod-major so cross-pod traffic is pure DP)
    "batch": (("pod", "data"), ("data",), ()),
    # tensor parallel
    "vocab": (("model",), ()),
    "heads": (("model",), ()),
    "kv_heads": (("model",), ()),
    "mlp": (("model",), ()),
    "experts": (("model",), ()),
    "ssm_in": (("model",), ()),
    "ssm_inner": (("model",), ()),
    "ssm_conv": (("model",), ()),
    "ssm_heads": (("model",), ()),
    # FSDP: weight-stationary dims sharded over the data axis
    "embed": (("data",), ()),
    "src_embed": (("data",), ()),
    "vision_embed": (("data",), ()),
    "expert_mlp": (("data",), ()),   # second-choice FSDP dim for experts
    # sequence parallelism (activations / KV caches)
    "kv_seq": (("model",), ()),
    "seq": ((), ()),
    # always replicated
    "layers": ((),),
    "group": ((),),
    "embed_norm": ((),),
    "head_dim": ((),),
    "state": ((),),
    "conv": ((),),
    "router_in": ((),),
    "experts_in": ((),),
}

# Serving-time rules: weights are read-only at serve time, so FSDP-sharding
# their embed dims only forces a re-gather on every step. Replicating the
# embed dims leaves dense weights TP-only and, because ``expert_mlp`` is the
# next candidate for the data axis, gives expert weights the 2D EP(model) x
# TP(data) layout that ``models/moe.py``'s ``expert_tp`` computes on.
SERVING_RULES: dict[str, tuple[tuple[str, ...], ...]] = dict(
    DEFAULT_RULES,
    embed=((),), src_embed=((),), vision_embed=((),))

# Order in which dims of one tensor get to claim mesh axes (TP before FSDP
# before SP; earlier = higher priority).
PRIORITY = (
    "experts", "vocab", "heads", "mlp", "ssm_in", "ssm_inner", "ssm_heads",
    "kv_heads", "batch", "embed", "src_embed", "vision_embed", "expert_mlp",
    "ssm_conv", "kv_seq", "seq",
)


class MeshShape(NamedTuple):
    """A mesh by its axis names and sizes alone, with no process group."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or a ``MeshShape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def _prio(name: str | None) -> int:
    if name in PRIORITY:
        return PRIORITY.index(name)
    return len(PRIORITY)


def spec_for_axes(axes: Sequence[str | None], shape: Sequence[int],
                  mesh, rules: Mapping | None = None) -> tuple:
    """Resolve one tensor's logical axes to its per-dimension assignment."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    sizes = mesh_sizes(mesh)
    assignment: dict[int, tuple[str, ...]] = {}
    taken: set[str] = set()
    order = sorted(range(len(axes)), key=lambda i: _prio(axes[i]))
    for i in order:
        name = axes[i]
        if name is None:
            continue
        for cand in rules.get(name, ((),)):
            cand = tuple(a for a in cand if a in sizes)
            if not cand:
                assignment[i] = ()
                break
            prod = math.prod(sizes[a] for a in cand)
            if shape[i] % prod == 0 and not (set(cand) & taken):
                assignment[i] = cand
                taken |= set(cand)
                break
        else:
            assignment[i] = ()
    parts = []
    for i in range(len(axes)):
        a = assignment.get(i, ())
        parts.append(a if len(a) > 1 else (a[0] if a else None))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes one entry of an assignment names, outer first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of an assignment: ``Shard(dim)`` on each mesh axis
    that splits ``dim`` (a dim split jointly over (pod, data) is ``Shard``
    on both, in the mesh's order, which DTensor reads as pod-major),
    ``Replicate()`` on every other axis."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in spec_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{entry} splits dim {dim} against the mesh's "
                             f"axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def tree_shardings(logical_tree, abstract_tree, mesh,
                   rules: Mapping | None = None):
    """The assignment of every leaf of a (logical axes, tensor) tree pair;
    the abstract tree's leaves need only a ``shape``."""
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(v, abstract_tree[k], mesh, rules)
                for k, v in logical_tree.items()}
    return spec_for_axes(logical_tree, abstract_tree.shape, mesh, rules)


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def data_spec(shape: Sequence[int], mesh,
              logical: Sequence[str | None] = None) -> tuple:
    """Assignment of an input batch array; dim 0 is the global batch."""
    logical = logical or ("batch",) + (None,) * (len(shape) - 1)
    return spec_for_axes(logical, shape, mesh)


def cache_logical_axes(cache_tree):
    """Logical axes for a decode-cache tree (see transformer.init_cache)."""

    def one(name, leaf):
        if name in ("k", "v", "ck", "cv"):
            return ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        if name == "conv":
            return ("layers", "batch", "conv", "ssm_conv")
        if name == "ssm":
            return ("layers", "batch", "ssm_heads", "head_dim", "state")
        return tuple([None] * leaf.dim())

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return one(name, tree)

    return walk(cache_tree)


def mesh_axis_size(mesh, name: str) -> int:
    return mesh_sizes(mesh).get(name, 1)


# ---------------------------------------------------------------------------
# Full tensors <-> each rank's shard (DTensor)
# ---------------------------------------------------------------------------


def local_part(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view): each split dim
    cut into equal chunks, the chunk at the rank's coordinate on the dim's
    mesh axes (flattened outer first)."""
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    sizes = mesh_sizes(mesh)
    out = full
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            n, idx = n * sizes[a], idx * sizes[a] + coord[a]
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"split {n} ways")
        out = out.chunk(n, dim=dim)[idx]
    return out


def distribute(tree, spec_tree, mesh):
    """Full tensors (the same on every rank) -> DTensors holding each rank's
    own shard, by the assignments of ``spec_tree`` (a copy of the block, so
    the full tensor can be freed)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: distribute(v, spec_tree[k], mesh) for k, v in tree.items()}
    part = local_part(tree, spec_tree, mesh)
    if part.shape != tree.shape:
        part = part.contiguous().clone()
    return DTensor.from_local(part, mesh, placements(spec_tree, mesh),
                              run_check=False)


def local_tree(tree):
    """Each DTensor leaf's local shard (the same storage); other leaves as
    they are."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    to_local = getattr(tree, "to_local", None)
    return to_local().detach() if to_local is not None else tree


def gather_full(tree):
    """DTensor leaves gathered to full tensors (a collective: every rank of
    the mesh calls it); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: gather_full(v) for k, v in tree.items()}
    full = getattr(tree, "full_tensor", None)
    return full() if full is not None else tree


def spec_tree_of(tree):
    """The assignment each DTensor leaf is stored with, read back from its
    placements (None for a plain tensor or an int)."""
    if isinstance(tree, dict):
        return {k: spec_tree_of(v) for k, v in tree.items()}
    pl = getattr(tree, "placements", None)
    if pl is None:
        return None
    names = axis_names(tree.device_mesh)
    parts: list[list[str]] = [[] for _ in range(tree.dim())]
    for name, p in zip(names, pl):
        if p.is_shard():
            parts[p.dim].append(name)
    spec = [tuple(a) if len(a) > 1 else (a[0] if a else None) for a in parts]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


# ---------------------------------------------------------------------------
# A step's rows and weights on a rank
# ---------------------------------------------------------------------------


def local_batch(batch, mesh):
    """The rank's rows of a full batch (the same on every rank), cut by
    ``data_spec``."""
    return {k: local_part(t, data_spec(t.shape, mesh), mesh)
            for k, t in batch.items()}


class _GatherOnUse(collections.abc.Mapping):
    """A ``groups`` dict whose groups are gathered when the forward reads
    them, one layer group at a time."""

    def __init__(self, tree, fn, path):
        self._tree, self._fn, self._path = tree, fn, path

    def __getitem__(self, key):
        return _gathered(self._tree[key], self._fn, self._path + (key,))

    def __iter__(self):
        return iter(self._tree)

    def __len__(self):
        return len(self._tree)


def _gathered(tree, fn, path=()):
    if isinstance(tree, dict):
        if path[-1:] == ("groups",):
            return _GatherOnUse(tree, fn, path)
        return {k: _gathered(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def tree_at(tree, path):
    """The subtree of ``tree`` at the key ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def gather_on_use(local, stored, use, mesh):
    """The params tree a forward reads: each local shard (assignment from
    ``stored``) moved to its block under ``use`` by
    ``collectives.to_use``, differentiably; eagerly outside the ``groups``
    dicts, one layer group at a time inside them, when the forward reads
    it."""
    def move(path, t):
        with census.at(path):
            return collectives.to_use(t, tree_at(stored, path),
                                      tree_at(use, path), mesh)

    return _gathered(local, move)
