"""The plain reference: the dense and MoE decoders in fp32 torch.

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
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

EPS = 1e-6


@contextmanager
def fp32_exact():
    """TF32 off for every product made inside (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


class Precision:
    """fp32 products; the control's subclass rounds their operands."""

    def mm(self, a, b):
        return a @ b

    def einsum(self, eq, a, b):
        return torch.einsum(eq, a, b)


FP32 = Precision()


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
    """Layer ``i`` of a group, every leaf cast to fp32."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t[i].float()
    return walk(params["groups"][group])


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


def block(lp, x, model: dict, kind: str, positions, cache=None, at: int = 0,
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


def hidden_states(params, model: dict, tokens, prec: Precision = FP32, *,
                  keep_inputs: bool = False):
    """The final norm's input over tokens (B, S), and with
    ``keep_inputs`` every layer's input (fp32) with the layers' kinds."""
    x = params["embed"][tokens].float()
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    kept = []
    for group, n, kind, _ in layer_plan(model):
        for i in range(n):
            if keep_inputs:
                kept.append((group, i, kind, x))
            x, _ = block(layer_weights(params, group, i), x, model, kind,
                         positions, prec=prec)
    return x, kept


def logits_at(params, x):
    """Logits (…, V) in fp32 of final-norm inputs x."""
    h = rms_norm(x, params["final_norm"]["scale"].float())
    return h @ params["lm_head"].float()


@torch.no_grad()
def forward_logits(params, model: dict, tokens, positions=None,
                   prec: Precision = FP32):
    """fp32 logits of tokens (B, S) at the given positions (all of them
    where None): (B, len(positions), V)."""
    with fp32_exact():
        x, _ = hidden_states(params, model, tokens, prec)
        if positions is not None:
            x = x[:, positions]
        h = rms_norm(x, params["final_norm"]["scale"].float())
        return prec.mm(h, params["lm_head"].float())


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
        toks, outs, logits, at = prompts, [], [], 0
        for _ in range(new_tokens):
            x = params["embed"][toks].float()
            positions = torch.arange(at, at + toks.shape[1], device=prompts.device)
            for group, n, kind, _ in layer_plan(model):
                for i in range(n):
                    x, _ = block(layer_weights(params, group, i), x, model, kind,
                                 positions, caches[group, i], at)
            at += toks.shape[1]
            last = logits_at(params, x[:, -1])
            toks = torch.argmax(last, -1)[:, None]
            outs.append(toks)
            logits.append(last)
        return torch.cat(outs, 1), torch.stack(logits, 1)


def leaves(tree, prefix: str = "") -> dict:
    """Leaf path ('/'-joined, after ``prefix``) -> tensor, in sorted order."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out[prefix + "/".join(path)] = t
    walk(tree, ())
    return out


def cross_entropy_sum(h_final, labels, params, prec: Precision = FP32,
                      rows: int = 2048):
    """Σ over rows of (log-sum-exp - gold logit), fp32, in blocks of
    ``rows`` so that the (rows, V) logits stay small."""
    h_final = h_final.reshape(-1, h_final.shape[-1])
    labels = labels.reshape(-1).long()
    total = h_final.new_zeros(())
    scale, head = params["final_norm"]["scale"], params["lm_head"]
    for lo in range(0, h_final.shape[0], rows):
        lg = prec.mm(rms_norm(h_final[lo:lo + rows], scale), head)
        gold = lg.gather(-1, labels[lo:lo + rows, None])[:, 0]
        total = total + (torch.logsumexp(lg, -1) - gold).sum()
    return total

