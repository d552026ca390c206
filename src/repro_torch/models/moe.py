"""Fine-grained mixture-of-experts (DeepSeekMoE / Kimi-K2 style), local path.

Counterpart of the single-device path of ``repro.models.moe``: token-choice
top-k routing with a fixed capacity, sort-based dispatch into an (E, C, d)
buffer, the expert FFNs through the grouped matmul (``ops.gmm``: the CUDA
kernel on the card), and a weighted combine. The expert-parallel path
(``DistContext``, the all-to-all exchange) is ROADMAP.md A11.

Nothing here reads a tensor back to the host: capacity comes from shapes,
histograms are ``scatter_add_`` and every selection is ``torch.where``, so
a layer never waits for the card.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .common import ParamSpec
from .ffn import _act, apply_ffn


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


def _capacity(n_tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8


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


def apply_moe(p, x, *, cfg):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    B, S, d = x.shape
    out, aux = _moe_local(x.reshape(B * S, d), p, cfg)
    if cfg.moe.num_shared:
        out = out + apply_ffn(p["shared"], x, cfg=cfg).reshape(B * S, d)
    return out.reshape(B, S, d), aux
