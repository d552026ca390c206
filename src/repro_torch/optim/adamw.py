"""AdamW with optionally low-precision moments.

Counterpart of ``repro.optim.adamw``: the same update, the same numbers.
``moment_dtype``: float32 (default) | bfloat16 | int8; int8 moments are a
``{"q": int8, "scale": fp32 scalar}`` pair per leaf with a per-tensor absmax
scale over the whole leaf, rounded half to even as the reference rounds.

Two differences of form, none of number:

- The update is in place: params and moments are overwritten (JAX returns
  new arrays). At deepseek-7b's full width two copies of the state would not
  fit one card.
- A large leaf is updated in slices along its leading axis
  (``SLICE_ELEMENTS`` at a time). The reference's update makes about seven
  fp32 temporaries of each leaf: for deepseek-7b's stacked FFN leaf (30,
  4096, 11008), 1.35e9 elements, about 38 GB. The update is elementwise and
  written with one rounding per operation, so a slice gives the same bits
  as the whole. int8 moments need the absmax of the whole new moment before
  any slice is quantized, so they take two passes: the first finds the
  absmaxes, the second recomputes the moments and quantizes them.

On a mesh each rank updates its own shard of each leaf (the update is
elementwise), given ``split_axes``: per leaf, the mesh axes its shards are
split over. The global norm then sums each element once across the mesh (a
leaf's sums of squares are all-reduced over its split axes only, never over
the axes that hold copies), and an int8 moment's absmax, like the
reference's replicated scale, is the whole leaf's (an all-reduce by MAX).

Weight decay applies where ``p.ndim >= 2``, as in the reference; stacked
per-layer norm scales have a leading ``layers`` axis, so they are decayed
too (ROADMAP.md C records this quirk of the reference, mirrored here).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import collectives
from ..tree import leaves, unflatten

SLICE_ELEMENTS = 1 << 25   # elements of a leaf updated at once (128 MB in fp32)
NORM_ELEMENTS = 1 << 26    # elements of a leaf squared at once by global_norm


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def _is_q(x) -> bool:
    return isinstance(x, dict) and "q" in x


def _quantize(x, scale):
    """int8 of x at a given absmax scale: round half to even, clipped."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _absmax_scale(amax):
    return torch.clamp(amax, min=1e-12) / 127.0


def _q_store(x, dtype: str):
    if dtype == "float32":
        return x.to(torch.float32)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    if dtype == "int8":
        scale = _absmax_scale(x.abs().max())
        return {"q": _quantize(x, scale), "scale": scale.to(torch.float32)}
    raise ValueError(dtype)


def _q_load(x):
    if _is_q(x):
        return x["q"].to(torch.float32) * x["scale"]
    return x.to(torch.float32)


def init_opt_state(params, cfg: AdamWConfig):
    def zeros(p):
        if cfg.moment_dtype == "int8":   # _q_store of zeros, without them
            zero = torch.zeros((), dtype=torch.float32, device=p.device)
            return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                    "scale": _absmax_scale(zero)}
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
            cfg.moment_dtype)
        if dt is None:
            raise ValueError(cfg.moment_dtype)
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    first = next(leaves(params), None)
    dev = first.device if first is not None else None

    def moment():
        return unflatten(params, map(zeros, leaves(params)))

    return {"m": moment(), "v": moment(),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _slices(p, limit: int):
    """Index ranges along the leading axis that keep a slice within
    ``limit`` elements (the whole of a 0-d, 1-d or small leaf)."""
    if p.dim() == 0 or p.numel() <= limit:
        return [...]
    rows = max(1, limit // max(1, p.numel() // p.shape[0]))
    return [slice(i, min(i + rows, p.shape[0])) for i in range(0, p.shape[0], rows)]


def global_norm(tree, mesh=None, split_axes=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, summed leaf by
    leaf in the reference's order; a large leaf is squared NORM_ELEMENTS at
    a time (a fixed cut, so the sum does not depend on SLICE_ELEMENTS).
    With a mesh, the leaves are local shards and ``split_axes`` names, per
    leaf, the mesh axes its shards are split over: each piece's sum is
    all-reduced over those before the pieces are added in the same order."""
    parts, owner = [], []
    for i, x in enumerate(leaves(tree)):
        for s in _slices(x, NORM_ELEMENTS):
            parts.append(torch.sum(torch.square(x[s].to(torch.float32))))
            owner.append(i)
    if mesh is not None:
        parts = _sum_over_splits(parts, owner, mesh, split_axes)
    total = None
    for part in parts:
        total = part if total is None else total + part
    return torch.sqrt(total)


def _sum_over_splits(parts, owner, mesh, split_axes):
    """Each part summed over its leaf's split axes: one all-reduce per
    distinct set of axes, over the parts that share it."""
    out = list(parts)
    by_axes: dict[tuple, list[int]] = {}
    for j, i in enumerate(owner):
        if split_axes[i]:
            by_axes.setdefault(tuple(split_axes[i]), []).append(j)
    for axes, idx in by_axes.items():
        summed = collectives.psum(torch.stack([parts[j] for j in idx]), mesh, axes)
        for j, v in zip(idx, summed.unbind(0)):
            out[j] = v
    return out


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: AdamWConfig, lr=None, *,
                  mesh=None, split_axes=None):
    """One AdamW step, in place. Returns (params, opt_state, metrics): the
    same dicts, their tensors overwritten, and a new ``count``. With a
    mesh, every tree holds this rank's shards and ``split_axes`` lists, in
    leaf order, the mesh axes each leaf's shards are split over."""
    lr = cfg.lr if lr is None else lr
    count = opt_state["count"] + 1
    gnorm = global_norm(grads, mesh, split_axes)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0) \
        if cfg.grad_clip else 1.0
    # bias corrections in fp32, as the reference takes them
    c32 = count.to(torch.float32)
    corr1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=c32.device), c32)
    corr2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=c32.device), c32)
    lr32 = torch.as_tensor(lr, dtype=torch.float32, device=c32.device)

    def moments(g, m, v):
        """New fp32 moments of one slice, from the stored ones."""
        g = g.to(torch.float32) * clip
        m_f = cfg.b1 * _q_load(m) + (1 - cfg.b1) * g
        v_f = cfg.b2 * _q_load(v) + (1 - cfg.b2) * torch.square(g)
        return m_f, v_f

    def new_param(p, m_f, v_f):
        step = (m_f / corr1) / (torch.sqrt(v_f / corr2) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:   # decay follows the leaf's rank
            step = step + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr32 * step).to(p.dtype)

    def part(x, s):
        if _is_q(x):
            return {"q": x["q"][s], "scale": x["scale"]}
        return x[s]

    for i, (p, g, m, v) in enumerate(zip(leaves(params), leaves(grads),
                                         leaves(opt_state["m"], _is_q),
                                         leaves(opt_state["v"], _is_q))):
        cuts = _slices(p, SLICE_ELEMENTS)
        if _is_q(m):
            # pass 1: the absmax of the whole new moments
            amax_m = amax_v = torch.zeros((), dtype=torch.float32, device=p.device)
            for s in cuts:
                m_f, v_f = moments(g[s], part(m, s), part(v, s))
                amax_m = torch.maximum(amax_m, m_f.abs().max())
                amax_v = torch.maximum(amax_v, v_f.abs().max())
            if mesh is not None and split_axes[i]:   # the whole leaf's absmax
                amax_m, amax_v = collectives.pmax(
                    torch.stack([amax_m, amax_v]), mesh, split_axes[i]).unbind(0)
            scale_m, scale_v = _absmax_scale(amax_m), _absmax_scale(amax_v)
            # pass 2: the same moments again, quantized; the params updated
            for s in cuts:
                m_f, v_f = moments(g[s], part(m, s), part(v, s))
                p[s] = new_param(p[s], m_f, v_f)
                m["q"][s] = _quantize(m_f, scale_m)
                v["q"][s] = _quantize(v_f, scale_v)
            m["scale"].copy_(scale_m)
            v["scale"].copy_(scale_v)
            continue
        for s in cuts:
            m_f, v_f = moments(g[s], m[s], v[s])
            p[s] = new_param(p[s], m_f, v_f)
            m[s] = m_f.to(m.dtype)
            v[s] = v_f.to(v.dtype)
    opt_state["count"] = count
    metrics = {"grad_norm": gnorm, "lr": lr32}
    return params, opt_state, metrics
