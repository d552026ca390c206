"""Fine-grained mixture-of-experts (DeepSeekMoE / Kimi-K2 style).

Counterpart of ``repro.models.moe``: token-choice top-k routing with a fixed
capacity, sort-based dispatch into an (E, C, d) buffer, the expert FFNs
through the grouped matmul (``ops.gmm``: the CUDA kernel on the card), and a
weighted combine.

Distribution (expert parallelism), one process per device: each rank runs
``_moe_ep_body`` on its data shard's tokens (the same on every rank of the
model axis, as the reference's ``P(data, None)`` in-spec gives them),
builds an (E, C_local, d) dispatch buffer, and a tiled all-to-all over the
model axis exchanges it for an (E_local, C_local * ep, d) buffer, which the
grouped matmul takes at that per-shard shape. Expert weights arrive sharded
on the model axis; with ``fsdp_experts`` also over the data axes, and are
all-gathered there inside the body. The collectives are the differentiable
ones of ``repro_torch.collectives``: each rank's backward reaches the
experts of every rank it sent tokens to, and the caller sums the weights'
gradients over the ranks that used them, as ``shard_map``'s transpose does.

Nothing here reads a tensor back to the host: capacity comes from shapes,
histograms are ``scatter_add_`` and every selection is ``torch.where``, so
a layer never waits for the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import collectives
from ..kernels import ops
from .common import ParamSpec
from .ffn import _act, apply_ffn
from .tp import TP


@dataclass(frozen=True)
class DistContext:
    """How apply-fns should distribute themselves (None mesh = local)."""

    mesh: object = None
    data_axes: tuple = ("data",)     # batch axes (may include 'pod')
    model_axis: str = "model"
    fsdp_experts: bool = False       # expert weights FSDP'd over data axis
    ep: bool = True                  # expert-parallel all-to-all on
    # serving: expert weights stored 2D, EP over the model axis and f
    # (expert_mlp) TP over the data axes; gate/up produce an f-sharded hidden
    # locally, the down projection contracts f and psums over data
    expert_tp: bool = False
    # serving: cap per-expert capacity at decode time (0 = the default rule)
    capacity_cap: int = 0


LOCAL = DistContext()


def moe_specs(cfg) -> dict:
    d, m = cfg.d_model, cfg.moe
    spec = {
        "router": ParamSpec((d, m.num_experts), ("router_in", "experts_in"),
                            dtype=torch.float32),
        "w_gate": ParamSpec((m.num_experts, d, m.d_ff_expert),
                            ("experts", "embed", "expert_mlp")),
        "w_up": ParamSpec((m.num_experts, d, m.d_ff_expert),
                          ("experts", "embed", "expert_mlp")),
        "w_down": ParamSpec((m.num_experts, m.d_ff_expert, d),
                            ("experts", "expert_mlp", "embed")),
    }
    if m.num_shared:
        f_sh = m.num_shared * m.d_ff_expert
        spec["shared"] = {
            "w_gate": ParamSpec((d, f_sh), ("embed", "mlp")),
            "w_up": ParamSpec((d, f_sh), ("embed", "mlp")),
            "w_down": ParamSpec((f_sh, d), ("mlp", "embed")),
        }
    return spec


def _capacity(n_tokens: int, cfg, cap: int = 0) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    c = max(8, -(-c // 8) * 8)  # round up to 8
    if cap:
        c = min(c, max(cap, 1))
    return c


def _route(x2d, router_w, cfg):
    """Top-k routing. x2d: (T, d). Returns topk_idx (T,k), weights (T,k), aux.

    ``jax.lax.top_k`` puts the lower expert first among equal probabilities;
    a stable descending sort does the same (``torch.topk`` promises no order).
    """
    m = cfg.moe
    logits = x2d.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_p, topk_idx = topk_p[:, :m.top_k], topk_idx[:, :m.top_k]
    topk_w = topk_p / topk_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux (Switch-style): E * sum_e f_e * p_e
    E, n = m.num_experts, topk_idx.numel()
    f_e = torch.zeros(E, dtype=torch.float32, device=x2d.device).scatter_add_(
        0, topk_idx.reshape(-1),
        torch.full((n,), 1.0 / n, dtype=torch.float32, device=x2d.device))
    p_e = probs.mean(0)
    aux = E * torch.sum(f_e * p_e) * m.router_aux_coef
    return topk_idx, topk_w.to(x2d.dtype), aux


def _dispatch_indices(topk_idx, E: int, C: int):
    """Sort-based dispatch metadata.

    Returns gather_idx (E, C) (token index per slot; T = empty slot) and inv
    (T*k,), the slot of each assignment in the flattened (t, j) order, E*C
    for a dropped one.

    The reference writes each dropped assignment to slot (E-1, C-1) with the
    value T in one scatter, and XLA applies it in order, so the last write
    wins: the slot holds T whenever expert E-1 gets more than C assignments,
    and the kept assignment there reads the pad row (its expert output is
    zero). This is mirrored, not repaired: the kept assignments are
    scattered alone, then that one slot is set where the count says so.
    """
    T, k = topk_idx.shape
    dev = topk_idx.device
    e_flat = topk_idx.reshape(-1)                       # (T*k,)
    order = torch.argsort(e_flat, stable=True)
    es = e_flat[order]
    ts = (torch.arange(T * k, device=dev) // k)[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, 0) - counts           # exclusive cumsum
    pos = torch.arange(T * k, device=dev) - starts[es]
    keep = pos < C
    slot = torch.where(keep, es * C + pos, E * C)       # E*C: dropped
    # every dropped assignment lands in the spare entry E*C with the value
    # T, so their order does not matter; kept slots are distinct
    flat = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    flat.scatter_(0, slot, torch.where(keep, ts, T))
    gather_idx = flat[:E * C].view(E, C)
    gather_idx[E - 1, C - 1] = torch.where(counts[E - 1] > C, T,
                                           gather_idx[E - 1, C - 1])
    inv = torch.empty(T * k, dtype=torch.int64, device=dev)
    inv.scatter_(0, order, slot)
    return gather_idx, inv


def _expert_ffn(x_e, wg, wu, wd, cfg):
    """x_e: (E, C, d) grouped tokens -> grouped outputs, via ``ops.gmm``.

    The activation runs in fp32 on g and u and is rounded to x's dtype
    before the down projection, as in the reference."""
    act = _act(cfg.mlp_act)
    g = ops.gmm(x_e, wg)
    u = ops.gmm(x_e, wu)
    return ops.gmm((act(g.float()) * u.float()).to(x_e.dtype), wd)


def _moe_local(x2d, p, cfg):
    """Single-device MoE: route -> dispatch -> gmm -> combine."""
    T, d = x2d.shape
    m = cfg.moe
    C = _capacity(T, cfg)
    topk_idx, topk_w, aux = _route(x2d, p["router"], cfg)
    gather_idx, inv = _dispatch_indices(topk_idx, m.num_experts, C)
    x_pad = torch.cat([x2d, x2d.new_zeros(1, d)])
    x_e = x_pad[gather_idx]                              # (E, C, d)
    y_e = _expert_ffn(x_e, p["w_gate"], p["w_up"], p["w_down"], cfg)
    y_flat = torch.cat([y_e.reshape(m.num_experts * C, d), y_e.new_zeros(1, d)])
    y_tok = y_flat[inv].reshape(T, m.top_k, d)           # dropped -> zeros
    out = torch.einsum("tkd,tk->td", y_tok.float(), topk_w.float())
    return out.to(x2d.dtype), aux


def expert_specs(dist: DistContext) -> dict:
    """The assignments the EP body takes the expert weights in (the
    reference's shard_map in-specs): (w_gate / w_up, w_down)."""
    data = dist.data_axes if len(dist.data_axes) > 1 else dist.data_axes[0]
    if dist.expert_tp:     # 2D: EP over model, f TP'd over data
        return {"w": (dist.model_axis, None, data),
                "wd": (dist.model_axis, data)}
    if dist.fsdp_experts:
        return {"w": (dist.model_axis, data), "wd": (dist.model_axis, None, data)}
    return {"w": (dist.model_axis,), "wd": (dist.model_axis,)}


def _moe_ep_body(x_local, router_w, wg, wu, wd, *, cfg, dist: DistContext):
    """One rank's EP step: x_local (T_loc, d), the rank's data shard; the
    expert weights in ``expert_specs(dist)``'s layout (E_loc, ...)."""
    m = cfg.moe
    T, d = x_local.shape
    C = _capacity(T, cfg, dist.capacity_cap)
    mesh, ax = dist.mesh, dist.model_axis
    if dist.fsdp_experts and not dist.expert_tp:
        wg = collectives.all_gather(wg, mesh, dist.data_axes, dim=1)
        wu = collectives.all_gather(wu, mesh, dist.data_axes, dim=1)
        wd = collectives.all_gather(wd, mesh, dist.data_axes, dim=2)

    topk_idx, topk_w, aux = _route(x_local, router_w, cfg)
    gather_idx, inv = _dispatch_indices(topk_idx, m.num_experts, C)
    x_pad = torch.cat([x_local, x_local.new_zeros(1, d)])
    x_e = x_pad[gather_idx]                              # (E, C, d)
    # dispatch: split experts across shards, concat capacity
    x_e = collectives.all_to_all(x_e, mesh, ax, split=0, concat=1)  # (E_loc, C*ep, d)
    if dist.expert_tp:
        # weights (E_loc, d, f_loc) / (E_loc, f_loc, d): gate/up emit an
        # f-sharded hidden locally; down contracts f -> psum over data
        act = _act(cfg.mlp_act)
        g = ops.gmm(x_e, wg)
        u = ops.gmm(x_e, wu)
        h = (act(g.float()) * u.float()).to(x_e.dtype)
        y_e = collectives.psum(ops.gmm(h, wd), mesh, dist.data_axes)
    else:
        y_e = _expert_ffn(x_e, wg, wu, wd, cfg)
    # combine: reverse exchange
    y_e = collectives.all_to_all(y_e, mesh, ax, split=1, concat=0)  # (E, C, d)
    E = m.num_experts
    y_flat = torch.cat([y_e.reshape(E * C, d), y_e.new_zeros(1, d)])
    y_tok = y_flat[inv].reshape(T, m.top_k, d)
    out = torch.einsum("tkd,tk->td", y_tok.float(), topk_w.float())
    aux = collectives.pmean(aux, mesh, dist.data_axes)
    aux = collectives.pmean(aux, mesh, ax)
    return out.to(x_local.dtype), aux


def apply_moe(p, x, *, cfg, dist: DistContext = LOCAL, tp: TP = TP()):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar). With a mesh (and
    ``dist.ep``), x is the rank's data shard and the expert weights are in
    ``expert_specs(dist)``'s layout; the shared experts are tensor parallel
    by ``tp`` (the layer's view)."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    if dist.mesh is None or not dist.ep:
        out, aux = _moe_local(x2d, p, cfg)
    else:
        with tp.at():
            out, aux = _moe_ep_body(x2d, p["router"], p["w_gate"], p["w_up"],
                                    p["w_down"], cfg=cfg, dist=dist)
    if cfg.moe.num_shared:
        out = out + apply_ffn(p["shared"], x, cfg=cfg,
                              tp=tp.sub("shared")).reshape(B * S, d)
    return out.reshape(B, S, d), aux
