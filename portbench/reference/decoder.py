"""The plain reference of the default family: the dense and MoE decoders
in fp32 torch.

It imports nothing of the program. It reads the weights the benchmark drew
(a nested dict of tensors, each layer's weights stacked on a leading axis,
as the benchmark hands them to the program too) and computes every product
in fp32 with TF32 off, one layer at a time: a layer's weights are cast to
fp32 when it runs, so that the reference fits beside the bf16 weights.

What it computes is the configuration's model: RMSNorm (eps 1e-6), RoPE on
interleaved pairs, causal GQA attention, a SiLU-gated FFN; in MoE layers a
softmax router in fp32, top-k by a stable descending sort (the lower expert
first among equals), the top-k weights normalised to sum 1, each expert
keeping the first ``capacity`` of its assignments in token order (the
configuration's ``capacity_factor``), two shared experts always on, and the
Switch load-balance loss. ``Precision`` puts the operands of every product
through a lower precision for the control (``lowp.py``).

As a family (a configuration without a ``reference`` key names this one;
``portbench/README.md``) it gives the layer plan, a layer's fp32 weights
and where each of its leaves lives (``leaf_of``), one layer's forward from
its input, the weights outside the layers as fp32 copies, the embedding,
the logits, and for the metric readers ``forward_flops``, the model FLOPs
from the configuration's widths. ``common.forward_logits`` (the serve
check) and ``train.py`` (the train reference) run the layers from these.
"""
from __future__ import annotations

import torch

from ..yardstick import attended_pairs
from .common import FP32, Precision, fp32_exact

EPS = 1e-6


def layer_plan(model: dict) -> list[tuple[str, int, str, int]]:
    """(group key, layers, kind of the second block, its FFN width) in
    order: the dense decoder's one group; the MoE decoder's leading dense
    layers and then its MoE layers."""
    moe = model.get("moe")
    if not moe:
        return [("g0", model["n_layers"], "ffn", model["d_ff"])]
    groups, k = [], moe.get("first_k_dense", 0)
    if k:
        groups.append((f"g{len(groups)}", k, "ffn", moe["d_ff_dense"]))
    groups.append((f"g{len(groups)}", model["n_layers"] - k, "moe", 0))
    return groups


def layer_weights(params, group: str, i: int) -> dict:
    """Layer ``i`` of a group, every leaf an fp32 copy."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t[i].to(torch.float32, copy=True)
    return walk(params["groups"][group])


def leaf_of(group: str, i: int, path: str) -> tuple[str, int]:
    """Where leaf ``path`` of layer ``i``'s weights lives: (the params'
    leaf path, its index on the leading axis)."""
    return f"groups/{group}/{path}", i


def rms_norm(x, w):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * w


def rope(x, positions, theta: float):
    """x (B, S, H, D), positions (S,) int: rotate the pairs (0::2, 1::2)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).reshape(x.shape)


def attention(q, k, v, q_pos, k_pos, prec: Precision = FP32, rows: int = 1024):
    """Causal softmax attention, fp32: q (B, Sq, H, D) at positions q_pos,
    k and v (B, Sk, KVH, D) at k_pos; the query rows in blocks of ``rows``
    to bound the scores' memory."""
    B, Sq, H, D = q.shape
    g = H // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    out = []
    for lo in range(0, Sq, rows):
        s = prec.einsum("bqhd,bkhd->bhqk", q[:, lo:lo + rows], k) * D ** -0.5
        mask = k_pos[None, :] <= q_pos[lo:lo + rows, None]
        s = s.masked_fill(~mask, float("-inf"))
        out.append(prec.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v))
    return torch.cat(out, 1)


def ffn(p, x, prec: Precision = FP32):
    return prec.mm(torch.nn.functional.silu(prec.mm(x, p["w_gate"])) *
                   prec.mm(x, p["w_up"]), p["w_down"])


def capacity(tokens: int, moe: dict) -> int:
    """An expert's slots for a call over ``tokens`` tokens: tokens x top_k
    x capacity_factor / experts, plus one, rounded up to 8, at least 8."""
    c = int(tokens * moe["top_k"] * moe.get("capacity_factor", 1.25)
            / moe["num_experts"]) + 1
    return max(8, -(-c // 8) * 8)


def moe_block(p, x2d, moe: dict, prec: Precision = FP32):
    """x2d (T, d) -> (out (T, d), load-balance loss)."""
    T, d = x2d.shape
    E, k = moe["num_experts"], moe["top_k"]
    probs = torch.softmax(x2d @ p["router"], -1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    weight = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_e.reshape(-1)
    counts = torch.bincount(flat_e, minlength=E)
    # the rank of each assignment among its expert's, in (token, slot) order
    order = torch.argsort(flat_e, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(flat_e.numel(), device=x2d.device) - starts[flat_e[order]]
    kept = rank < capacity(T, moe)
    out = torch.zeros_like(x2d)
    token = torch.arange(T * k, device=x2d.device) // k
    flat_w = weight.reshape(-1)
    for e in range(E):
        sel = torch.nonzero((flat_e == e) & kept).flatten()
        if sel.numel() == 0:
            continue
        t = token[sel]
        pe = {n: p[n][e] for n in ("w_gate", "w_up", "w_down")}
        out.index_add_(0, t, ffn(pe, x2d[t], prec) * flat_w[sel, None])
    if moe.get("num_shared"):
        out = out + ffn(p["shared"], x2d, prec)
    f_e = counts.float() / flat_e.numel()
    aux = E * torch.sum(f_e * probs.mean(0)) * moe.get("router_aux_coef", 0.01)
    return out, aux


def layer_forward(lp, x, model: dict, kind: str, positions, cache=None, at: int = 0,
                  prec: Precision = FP32):
    """One layer (attention, then the FFN or MoE block) over x (B, S, d)
    fp32 at ``positions``. With ``cache`` (a dict of fp32 k and v of
    (B, max_len, KVH, D)), the new keys are written at ``at`` and the
    queries attend to every cached position up to theirs. Returns
    (x, load-balance loss or None)."""
    B, S, d = x.shape
    H, KVH = model["n_heads"], model["n_kv_heads"]
    D = model.get("head_dim") or d // H
    a = lp["b0"]
    h = rms_norm(x, a["norm"]["scale"])
    q = prec.mm(h, a["attn"]["wq"].reshape(d, -1)).view(B, S, H, D)
    k = prec.mm(h, a["attn"]["wk"].reshape(d, -1)).view(B, S, KVH, D)
    v = prec.mm(h, a["attn"]["wv"].reshape(d, -1)).view(B, S, KVH, D)
    theta = model.get("rope_theta", 10000.0)
    q, k = rope(q, positions, theta), rope(k, positions, theta)
    k_pos = positions
    if cache is not None:
        cache["k"][:, at:at + S] = k
        cache["v"][:, at:at + S] = v
        k, v = cache["k"][:, :at + S], cache["v"][:, :at + S]
        k_pos = torch.arange(at + S, device=x.device)
    o = attention(q, k, v, positions, k_pos, prec)
    x = x + prec.mm(o.reshape(B, S, H * D), a["attn"]["wo"].reshape(H * D, d))
    f = lp["b1"]
    h = rms_norm(x, f["norm"]["scale"])
    if kind == "moe":
        out, aux = moe_block(f["moe"], h.reshape(B * S, d), model["moe"], prec)
        return x + out.view(B, S, d), aux
    return x + ffn(f["ffn"], h, prec), None


def outer_weights(params) -> dict:
    """The weights outside the layers (the embedding, the final norm, the
    head) as fp32 copies, nested as in ``params``."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t.to(torch.float32, copy=True)
    return {k: walk(v) for k, v in params.items() if k != "groups"}


def embed(weights, tokens):
    """The first layer's input (B, S, d) in fp32, from ``params`` or
    ``outer_weights``."""
    return weights["embed"][tokens].float()


def logits(weights, x, prec: Precision = FP32):
    """fp32 logits (…, V) of the last layer's outputs x, from ``params`` or
    ``outer_weights``."""
    h = rms_norm(x, weights["final_norm"]["scale"].float())
    return prec.mm(h, weights["lm_head"].float())


@torch.no_grad()
def generate(params, model: dict, prompts, new_tokens: int):
    """Greedy decoding through an fp32 KV cache: the prefill over the
    prompts (B, S), then one token a step. Returns (tokens (B, new),
    logits (B, new, V)) of each produced token."""
    with fp32_exact():
        B, S = prompts.shape
        d, KVH = model["d_model"], model["n_kv_heads"]
        D = model.get("head_dim") or d // model["n_heads"]
        caches = {(g, i): {n: torch.zeros(B, S + new_tokens, KVH, D,
                                          device=prompts.device)
                           for n in ("k", "v")}
                  for g, L, _, _ in layer_plan(model) for i in range(L)}
        toks, outs, scores, at = prompts, [], [], 0
        for _ in range(new_tokens):
            x = embed(params, toks)
            positions = torch.arange(at, at + toks.shape[1], device=prompts.device)
            for group, n, kind, _ in layer_plan(model):
                for i in range(n):
                    x, _ = layer_forward(layer_weights(params, group, i), x, model, kind,
                                         positions, caches[group, i], at)
            at += toks.shape[1]
            last = logits(params, x[:, -1])
            toks = torch.argmax(last, -1)[:, None]
            outs.append(toks)
            scores.append(last)
        return torch.cat(outs, 1), torch.stack(scores, 1)


# --- the model's work, for the metric readers ---

def matmul_params(model: dict) -> dict:
    """Parameters a token multiplies through, by kind, from a
    configuration's widths: ``attn`` and ``dense`` (every layer's
    attention and dense FFN), ``routed`` (the experts a token is sent to:
    top_k of them), ``shared`` and ``router`` (MoE layers), ``lm_head``.
    The embedding lookup multiplies nothing."""
    d, L = model["d_model"], model["n_layers"]
    hd = model.get("head_dim") or d // model["n_heads"]
    attn = d * hd * (2 * model["n_heads"] + 2 * model["n_kv_heads"])
    out = {"attn": L * attn, "lm_head": d * model["vocab_size"],
           "dense": 0, "routed": 0, "shared": 0, "router": 0}
    moe = model.get("moe")
    if not moe:
        out["dense"] = L * 3 * d * model["d_ff"]
        return out
    dense_layers = moe.get("first_k_dense", 0)
    out["dense"] = dense_layers * 3 * d * moe["d_ff_dense"]
    moe_layers = L - dense_layers
    f = moe["d_ff_expert"]
    out["routed"] = moe_layers * moe["top_k"] * 3 * d * f
    out["shared"] = moe_layers * moe["num_shared"] * 3 * d * f
    out["router"] = moe_layers * d * moe["num_experts"]
    return out


def forward_flops(model: dict, rows: int, Sq: int, q_offset: int = 0) -> float:
    """Model FLOPs of a forward over ``rows`` rows of ``Sq`` new positions
    after ``q_offset`` earlier ones: 2 x the parameters each new position
    multiplies through (the lm_head included), plus the causal attention
    products, 4 rows H D a pair a layer. A prefill has ``q_offset`` 0, a
    decode step ``Sq`` 1; a train step is 3 x the forward (remat's
    recompute not counted). Every term is a whole number, exact in a
    float below 2**53, so sums of them do not depend on their order."""
    per_token = sum(matmul_params(model).values())
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    pairs = attended_pairs(Sq, q_offset + Sq, q_offset=q_offset)
    attn = 4 * rows * model["n_heads"] * hd * pairs * model["n_layers"]
    return 2.0 * per_token * rows * Sq + attn
