"""A configuration's family (``reference/<family>.py``, named by its
``reference`` key; ``decoder`` where it names none): a family defined only
here drives the serve check, the train reference, the control and the three
MFU readers with no runner or reader edited; the default family's work
formulas are the ones the benchmark had before families, bitwise; and the
streamed train reference gives the one-pass reference's losses, first
gradients and weights, bitwise, the serve check's logits the ones from
before families."""
import copy
import json
import math
import time
import types
from pathlib import Path
from types import SimpleNamespace as NS

import pytest
import torch

from portbench import control, harness, weights, yardstick
from portbench.reference import decoder
from portbench.reference import train as ref_train
from portbench.reference.common import FP32, forward_logits, fp32_exact, leaves
from portbench.reference.lowp import FP8

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 77


# --- a family defined only in this file -------------------------------------

def plain_family(calls: list):
    """The dense decoder written out again, one flat dict of weights a
    layer, with a work formula of its own; every call is recorded in
    ``calls`` as (function, its arguments, keywords' values last)."""
    fam = types.ModuleType("portbench.reference.plain_dense_for_test")

    def rms(x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * w

    def rotate(x, positions, theta):
        D = x.shape[-1]
        ang = positions.float()[:, None] / theta ** (
            torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        a, b = x[..., 0::2], x[..., 1::2]
        return torch.stack([a * cos - b * sin, b * cos + a * sin], -1).flatten(-2)

    def layer_plan(model):
        return [("g0", model["n_layers"], "dense")]

    def layer_weights(params, group, i):
        return {p: t[i].to(torch.float32, copy=True)
                for p, t in leaves(params["groups"][group]).items()}

    def leaf_of(group, i, path):
        return f"groups/{group}/{path}", i

    def layer_forward(lw, x, model, kind, positions, prec):
        B, S, d = x.shape
        H, KVH = model["n_heads"], model["n_kv_heads"]
        D = d // H
        h = rms(x, lw["b0/norm/scale"])
        q, k, v = (prec.mm(h, lw[f"b0/attn/{w}"].reshape(d, -1)).view(B, S, n, D)
                   for w, n in (("wq", H), ("wk", KVH), ("wv", KVH)))
        q, k = rotate(q, positions, model["rope_theta"]), rotate(k, positions,
                                                                 model["rope_theta"])
        k, v = k.repeat_interleave(H // KVH, 2), v.repeat_interleave(H // KVH, 2)
        s = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1),
                          float("-inf"))
        o = prec.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).reshape(B, S, d)
        x = x + prec.mm(o, lw["b0/attn/wo"].reshape(d, d))
        h = rms(x, lw["b1/norm/scale"])
        f = torch.nn.functional.silu(prec.mm(h, lw["b1/ffn/w_gate"])) * \
            prec.mm(h, lw["b1/ffn/w_up"])
        return x + prec.mm(f, lw["b1/ffn/w_down"]), None

    def outer_weights(params):
        return {"embed": params["embed"].float().clone(),
                "final_norm": {"scale": params["final_norm"]["scale"].float().clone()},
                "lm_head": params["lm_head"].float().clone()}

    def embed(weights, tokens):
        return weights["embed"][tokens].float()

    def logits(weights, x, prec):
        return prec.mm(rms(x, weights["final_norm"]["scale"].float()),
                       weights["lm_head"].float())

    def forward_flops(model, rows, Sq, q_offset):
        """Not the decoder's: 1e6 a new position, 1e3 a pair attended."""
        pairs = yardstick.attended_pairs(Sq, q_offset + Sq, q_offset=q_offset)
        return 1e6 * rows * Sq + 1e3 * rows * pairs

    for name, fn in dict(locals()).items():
        if callable(fn) and name not in ("rms", "rotate", "fam"):
            def recorded(*a, _fn=fn, _name=name, **kw):
                calls.append((_name, a + tuple(kw.values())))
                return _fn(*a, **kw)
            setattr(fam, name, recorded)
    return fam


DENSE = {"name": "tiny", "family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
         "n_kv_heads": 2, "d_ff": 96, "vocab_size": 256, "rope_theta": 10000.0,
         "tie_embeddings": False, "param_dtype": "float32", "activ_dtype": "float32"}
SERVE = {"kind": "serve", "batch": 2, "prompt_lengths": [8, 12], "new_tokens": 4,
         "warmup_new_tokens": 2, "check": {"requests": 4}, "trace": {}}


@pytest.fixture
def family(monkeypatch):
    """The family above, importable by the name a configuration gives."""
    calls: list = []
    fam = plain_family(calls)
    monkeypatch.setitem(__import__("sys").modules, fam.__name__, fam)
    conf = {"reference": fam.__name__.rsplit(".", 1)[1], "model": DENSE}
    assert harness.family(conf) is fam
    return NS(fam=fam, calls=calls, conf=conf)


def _names(calls):
    return {name for name, _ in calls}


def test_a_new_family_drives_the_serve_check_its_control_and_readers(family):
    cell = "ds7b.agent_turn"
    ctx, got = harness.drive(cell, SEED, 0.0, False, started=time.perf_counter(),
                             device="cpu", conf=family.conf, mix=SERVE)
    limit = harness.limits(cell)
    assert got["checks"]["widest_gap"] < limit["widest_gap"] / 10
    logits = [a for name, a in family.calls if name == "logits"]
    assert logits and all(a[2] is FP32 for a in logits)

    family.calls.clear()
    prefill = harness.reader("prefill_mfu").read(ctx, got, None)
    batches = got["run"].batches
    assert [a[1:] for _, a in family.calls] == [(b.rows, b.prompt_len, 0) for b in batches]
    want = sum(1e6 * b.rows * b.prompt_len + 1e3 * b.rows * b.prompt_len *
               (b.prompt_len + 1) / 2 for b in batches)
    assert prefill == pytest.approx(100 * want / (sum(b.ttft_ms() for b in batches) / 1e3
                                                  * yardstick.PEAK_BF16_FLOPS))

    family.calls.clear()
    decode = harness.reader("decode_mfu").read(ctx, got, None)
    assert [a[1:] for _, a in family.calls] == [
        (b.rows, 1, b.prompt_len + i) for b in batches for i in range(b.decode_steps)]
    want = sum(1e6 * b.rows + 1e3 * b.rows * (b.prompt_len + i + 1)
               for b in batches for i in range(b.decode_steps))
    assert decode == pytest.approx(100 * want / (sum(b.decode_ms() for b in batches) / 1e3
                                                 * yardstick.PEAK_BF16_FLOPS))

    family.calls.clear()
    got = control.readings(cell, SEED, 0.0, device="cpu", conf=family.conf, mix=SERVE)
    assert any(isinstance(a[2], FP8) for name, a in family.calls if name == "logits")
    assert got["control"]["widest_gap"] > got["program"]["widest_gap"]


def test_a_new_family_drives_the_train_reference_its_control_and_reader(family):
    cell = "ds7b.finetune"
    from portbench import traffic
    mix = dict(traffic.load("finetune.2x4096"), batch=2, seq_len=16, trace={"steps": 0})
    ctx, got = harness.drive(cell, SEED, 0.0, False, started=time.perf_counter(),
                             device="cpu", conf=family.conf, mix=mix)
    limit = harness.limits(cell)
    assert all(got["checks"][k] < v / 10 for k, v in limit.items()), got["checks"]
    assert {"layer_plan", "layer_weights", "leaf_of", "layer_forward", "outer_weights",
            "embed", "logits"} <= _names(family.calls)

    family.calls.clear()
    mfu = harness.reader("train_mfu").read(ctx, got, None)
    assert family.calls == [("forward_flops", (DENSE, 2, 16, 0))]
    flops = 3 * (1e6 * 2 * 16 + 1e3 * 2 * 136)
    steps = got["run"].steps
    assert mfu == pytest.approx(100 * flops * len(steps) /
                                (sum(s for s, _ in steps) * yardstick.PEAK_BF16_FLOPS))

    family.calls.clear()
    got = control.readings(cell, SEED, 0.0, device="cpu", conf=family.conf, mix=mix)
    assert any(isinstance(a[-1], FP8) for name, a in family.calls if name == "layer_forward")
    assert got["control"]["loss_gap"] > got["program"]["loss_gap"]


# --- the default family's work: the formulas from before families ------------

def parent_matmul_params(model):
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
    f = moe["d_ff_expert"]
    out["routed"] = (L - dense_layers) * moe["top_k"] * 3 * d * f
    out["shared"] = (L - dense_layers) * moe["num_shared"] * 3 * d * f
    out["router"] = (L - dense_layers) * d * moe["num_experts"]
    return out


def parent_attn(model, B, S):
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    return 4 * B * model["n_heads"] * hd * yardstick.attended_pairs(S, S) * model["n_layers"]


def parent_forward_flops(model, B, S):
    return 2.0 * sum(parent_matmul_params(model).values()) * B * S + parent_attn(model, B, S)


def parent_train_flops(model, B, S):
    return 6.0 * sum(parent_matmul_params(model).values()) * B * S + \
        3.0 * parent_attn(model, B, S)


def parent_decode_flops(m, batches):
    per_token = sum(parent_matmul_params(m).values())
    D = m.get("head_dim") or m["d_model"] // m["n_heads"]
    flops = 0.0
    for b in batches:
        t, n = b.untraced_decode()
        first = b.decode_steps - n
        kv = sum(b.prompt_len + i + 1 for i in range(first, b.decode_steps))
        flops += 2.0 * per_token * b.rows * n + \
            4.0 * b.rows * m["n_heads"] * D * kv * m["n_layers"]
    return flops


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_default_family_work_is_the_formulas_from_before(cell):
    conf = harness.config(cell["config"])
    fam = harness.family(conf)
    assert fam is decoder
    m = conf["model"]
    from portbench import traffic
    mix = traffic.load(cell["traffic"])
    assert sum(fam.matmul_params(m).values()) == sum(parent_matmul_params(m).values())
    if mix["kind"] == "train":
        B, S = mix["batch"], mix["seq_len"]
        assert 3 * fam.forward_flops(m, B, S, 0) == parent_train_flops(m, B, S)
        ctx = NS(model=m, mix=mix, family=fam)
        steps = [(1.25, B * S)] * 5
        parent = 100.0 * parent_train_flops(m, B, S) * 3 / (3.75 * yardstick.PEAK_BF16_FLOPS)
        assert harness.reader("train_mfu").read(ctx, {"run": NS(steps=steps)}, None) == parent
        return
    B, new = mix["batch"], mix["new_tokens"]
    for S in mix["prompt_lengths"]:
        assert fam.forward_flops(m, B, S, 0) == parent_forward_flops(m, B, S)
    # a window's batches: one traced (its slice closed after 5 steps), the rest not
    batches = [NS(rows=B, prompt_len=S, decode_steps=new - 1,
                  untraced_decode=(lambda k=k: (7.5 + k, new - 1 - (5 if k == 0 else 0))))
               for k, S in enumerate(mix["prompt_lengths"] * 2)]
    ms = sum(b.untraced_decode()[0] for b in batches)
    want = 100.0 * parent_decode_flops(m, batches) / (ms / 1e3 * yardstick.PEAK_BF16_FLOPS)
    ctx = NS(model=m, mix=mix, family=fam)
    assert harness.reader("decode_mfu").read(ctx, {"run": NS(batches=batches)}, None) == want
    ttft = [NS(rows=B, prompt_len=S, ttft_ms=lambda: 250.0) for S in mix["prompt_lengths"]]
    want = 100.0 * sum(parent_forward_flops(m, B, S) for S in mix["prompt_lengths"]) / \
        (0.25 * len(ttft) * yardstick.PEAK_BF16_FLOPS)
    assert harness.reader("prefill_mfu").read(ctx, {"run": NS(batches=ttft)}, None) == want


# --- the reference's arithmetic against the code from before families -----

def parent_cross_entropy_sum(h_final, labels, params, prec=FP32, rows=2048):
    h_final = h_final.reshape(-1, h_final.shape[-1])
    labels = labels.reshape(-1).long()
    total = h_final.new_zeros(())
    scale, head = params["final_norm"]["scale"], params["lm_head"]
    for lo in range(0, h_final.shape[0], rows):
        lg = prec.mm(decoder.rms_norm(h_final[lo:lo + rows], scale), head)
        gold = lg.gather(-1, labels[lo:lo + rows, None])[:, 0]
        total = total + (torch.logsumexp(lg, -1) - gold).sum()
    return total


@torch.no_grad()
def parent_forward_logits(params, model, tokens, positions, prec):
    with fp32_exact():
        x = params["embed"][tokens].float()
        at = torch.arange(tokens.shape[1])
        for group, n, kind, _ in decoder.layer_plan(model):
            for i in range(n):
                x, _ = decoder.layer_forward(decoder.layer_weights(params, group, i), x,
                                             model, kind, at, prec=prec)
        h = decoder.rms_norm(x[:, positions], params["final_norm"]["scale"].float())
        return prec.mm(h, params["lm_head"].float())


def one_pass_steps(params, model, batches, opt):
    """The train reference as it was before it streamed (every fp32
    gradient kept, then AdamW leaf by leaf), on the decoder family."""
    mdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[opt["moment_dtype"]]
    by_path = leaves(params)
    moments = {k: {p: torch.zeros(t.shape, dtype=mdt) for p, t in by_path.items()}
               for k in ("m", "v")}
    losses, first = [], None
    for n, (tokens, labels) in enumerate(batches):
        with fp32_exact():
            grads = {p: torch.zeros(t.shape, dtype=torch.float32) for p, t in by_path.items()}
            squares = {p: 0.0 for p in grads}
            x = params["embed"][tokens].float()
            positions = torch.arange(tokens.shape[1])
            kept = []
            with torch.no_grad():
                for group, L, kind, _ in decoder.layer_plan(model):
                    for i in range(L):
                        kept.append((group, i, kind, x))
                        x, _ = decoder.layer_forward(decoder.layer_weights(params, group, i),
                                                     x, model, kind, positions)
            scale = params["final_norm"]["scale"].to(torch.float32, copy=True)
            head = params["lm_head"].to(torch.float32, copy=True)
            scale.requires_grad_(True)
            head.requires_grad_(True)
            xb = x.reshape(-1, x.shape[-1]).detach().requires_grad_(True)
            with torch.enable_grad():
                part = parent_cross_entropy_sum(
                    xb, labels.reshape(-1), {"final_norm": {"scale": scale},
                                             "lm_head": head}) / tokens.numel()
                part.backward()
            ce = 0.0 + float(part.detach())
            for path, t in (("final_norm/scale", scale), ("lm_head", head)):
                grads[path].copy_(t.grad)
                squares[path] += float(t.grad.square().sum())
            g = xb.grad.view_as(x)
            for group, i, kind, x_in in reversed(kept):
                lw = decoder.layer_weights(params, group, i)
                for t in leaves(lw).values():
                    t.requires_grad_(True)
                xi = x_in.detach().requires_grad_(True)
                with torch.enable_grad():
                    y, aux = decoder.layer_forward(lw, xi, model, kind, positions)
                    obj = (y * g).sum() + (aux if aux is not None else 0)
                    obj.backward()
                for path, t in leaves(lw, f"groups/{group}/").items():
                    grads[path][i].copy_(t.grad)
                    squares[path] += float(t.grad.square().sum())
                g = xi.grad
            grads["embed"].index_add_(0, tokens.reshape(-1).long(), g.reshape(-1, x.shape[-1]))
            squares["embed"] = float(grads["embed"].square().sum())
            gnorm = math.sqrt(sum(squares[p] for p in by_path))
            clip = min(1.0, opt["grad_clip"] / max(gnorm, 1e-12))
            lr = ref_train.learning_rate(n, opt)
            seen = {}
            with torch.no_grad():
                for path, p in by_path.items():
                    seen[path] = clip * math.sqrt(squares[path])
                    cuts = [slice(i, i + 1) for i in range(p.shape[0])] \
                        if p.dim() >= 3 else [...]
                    m, v = moments["m"][path], moments["v"][path]
                    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
                    corr1, corr2 = 1 - b1 ** (n + 1), 1 - b2 ** (n + 1)
                    for s in cuts:
                        gs = grads[path][s] * clip
                        m_f = b1 * m[s].float() + (1 - b1) * gs
                        v_f = b2 * v[s].float() + (1 - b2) * gs.square()
                        step = (m_f / corr1) / (torch.sqrt(v_f / corr2) + eps)
                        if wd and p.dim() >= 2:
                            step = step + wd * p[s].float()
                        p[s] = (p[s].float() - lr * step).to(p.dtype)
                        m[s] = m_f.to(m.dtype)
                        v[s] = v_f.to(v.dtype)
        losses.append(ce)
        first = first or seen
    return {"loss": losses, "first_grad": first}


MOE = {"name": "tinymoe", "family": "moe", "n_layers": 3, "d_model": 64, "n_heads": 4,
       "n_kv_heads": 4, "d_ff": 0, "vocab_size": 256, "tie_embeddings": False,
       "param_dtype": "bfloat16", "activ_dtype": "bfloat16",
       "moe": {"num_experts": 8, "top_k": 2, "num_shared": 2, "d_ff_expert": 32,
               "capacity_factor": 1.0, "router_aux_coef": 0.01, "first_k_dense": 1,
               "d_ff_dense": 96}}
OPT = {"lr": 3e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
       "grad_clip": 1.0, "warmup_steps": 0, "total_steps": 100}


@pytest.mark.parametrize("model,moments", [(dict(DENSE, param_dtype="bfloat16"), "bfloat16"),
                                           (DENSE, "float32"), (MOE, "bfloat16")],
                         ids=["dense-bf16", "dense-fp32", "moe-bf16"])
def test_streamed_reference_is_the_one_pass_one_bitwise(model, moments):
    """Bitwise: each number is made by the same operations on the same
    operands (a layer's gradient is computed twice, alike), and AdamW is
    elementwise, so updating a leaf a slice at a time changes no bit."""
    from repro_torch.models.model_zoo import build_model
    spec = build_model(harness.Context({}, {"model": model}, {}, 0, 0, None, None, 0)
                       .program_config()).specs
    dtype = torch.bfloat16 if model["param_dtype"] == "bfloat16" else torch.float32
    params = weights.draw(spec, 5, "cpu", dtype)
    g = torch.Generator().manual_seed(6)
    batches = [(torch.randint(0, 256, (2, 24), generator=g),
                torch.randint(0, 256, (2, 24), generator=g)) for _ in range(3)]
    opt = dict(OPT, moment_dtype=moments)
    ours, theirs = copy.deepcopy(params), copy.deepcopy(params)
    got = ref_train.train_steps(decoder, ours, model, batches, opt)
    want = one_pass_steps(theirs, model, batches, opt)
    assert got["loss"] == want["loss"]
    assert got["first_grad"] == want["first_grad"]
    assert min(want["first_grad"].values()) > 0
    for path, t in leaves(theirs).items():
        assert torch.equal(leaves(ours)[path], t), path
        assert not torch.equal(t, leaves(params)[path]), path


@pytest.mark.parametrize("prec", [FP32, FP8()], ids=["fp32", "fp8"])
@pytest.mark.parametrize("model", [dict(DENSE, param_dtype="bfloat16"), MOE],
                         ids=["dense-bf16", "moe-bf16"])
def test_serve_logits_are_the_ones_from_before_families(model, prec):
    """The serve check's and its control's logits through the family's
    pieces: the same operations on the same operands as the decoder's own
    forward had, so the same bits."""
    from repro_torch.models.model_zoo import build_model
    spec = build_model(harness.Context({}, {"model": model}, {}, 0, 0, None, None, 0)
                       .program_config()).specs
    params = weights.draw(spec, 9, "cpu", torch.bfloat16)
    tokens = torch.randint(0, 256, (2, 20), generator=torch.Generator().manual_seed(4))
    at = torch.arange(12, 20)
    want = parent_forward_logits(params, model, tokens, at, prec)
    assert torch.equal(forward_logits(decoder, params, model, tokens, at, prec), want)


def test_a_layers_tensors_are_freed_without_the_garbage_collector():
    """The train reference lets go of a layer's fp32 weights and gradients
    as soon as it is done with them (at 7B, 1.6 GB a layer): no reference
    cycle holds them until the collector runs."""
    import gc
    import weakref
    params = {"groups": {"g0": {"b0": {"w": torch.zeros(3, 4, 5)}}}}
    was = gc.isenabled()
    gc.disable()
    try:
        lw = decoder.layer_weights(params, "g0", 1)
        for t in leaves(lw).values():
            t.requires_grad_(True)
        gone = weakref.ref(leaves(lw)["b0/w"])
        del lw, t
        assert gone() is None
    finally:
        if was:
            gc.enable()


def shared_family():
    """A family whose layers all use one shared leaf (index None) besides
    their own, and whose loss head is the embedding (tied)."""
    fam = types.ModuleType("portbench.reference.shared_tied_for_test")
    fam.layer_plan = lambda model: [("g0", model["n_layers"], "mix")]
    fam.layer_weights = lambda params, group, i: {
        "w": params["groups"][group]["w"][i].to(torch.float32, copy=True),
        "shared": params["shared"].to(torch.float32, copy=True)}
    fam.leaf_of = lambda group, i, path: \
        ("shared", None) if path == "shared" else (f"groups/{group}/{path}", i)
    fam.layer_forward = lambda lw, x, model, kind, positions, prec: \
        (x + prec.mm(torch.tanh(prec.mm(x, lw["w"])), lw["shared"]), None)
    fam.outer_weights = lambda params: {"embed": params["embed"].to(torch.float32,
                                                                     copy=True)}
    fam.embed = lambda weights, tokens: weights["embed"][tokens].float()
    fam.logits = lambda weights, x, prec: prec.mm(x, weights["embed"].T)
    return fam


def test_streamed_reference_sums_a_shared_leaf_and_a_tied_head():
    """Against autograd over the whole model and AdamW on whole leaves: the
    shared leaf's gradient summed over its layers, the tied embedding's
    over the head and the lookup. Within 1e-5: autograd sums those
    contributions in another order."""
    L, V, d = 3, 40, 16
    g = torch.Generator().manual_seed(8)
    params = {"embed": torch.randn(V, d, generator=g) * 0.3,
              "groups": {"g0": {"w": torch.randn(L, d, d, generator=g) / 4}},
              "shared": torch.randn(d, d, generator=g) / 4}
    batches = [(torch.randint(0, V, (2, 12), generator=g),
                torch.randint(0, V, (2, 12), generator=g)) for _ in range(2)]
    opt = dict(OPT, lr=1e-2, eps=1e-3, grad_clip=0.5, moment_dtype="float32")
    ours = copy.deepcopy(params)
    got = ref_train.train_steps(shared_family(), ours, {"n_layers": L}, batches, opt)

    theirs = leaves(copy.deepcopy(params))
    moments = {k: {p: torch.zeros_like(t) for p, t in theirs.items()} for k in ("m", "v")}
    losses, first = [], None
    for n, (tokens, labels) in enumerate(batches):
        P = {p: t.clone().requires_grad_(True) for p, t in theirs.items()}
        x = P["embed"][tokens]
        for i in range(L):
            x = x + torch.tanh(x @ P["groups/g0/w"][i]) @ P["shared"]
        loss = torch.nn.functional.cross_entropy(x.reshape(-1, d) @ P["embed"].T,
                                                 labels.reshape(-1), reduction="sum")
        (loss / tokens.numel()).backward()
        norms = {p: float(t.grad.square().sum()) ** 0.5 for p, t in P.items()}
        clip = min(1.0, opt["grad_clip"] / math.sqrt(sum(v ** 2 for v in norms.values())))
        with torch.no_grad():
            for p, t in theirs.items():
                ref_train.adamw_update(t, moments["m"][p], moments["v"][p], P[p].grad, ...,
                                       clip, n + 1, opt, ref_train.learning_rate(n, opt))
        losses.append(float(loss.detach()) / tokens.numel())
        first = first or {p: clip * v for p, v in norms.items()}
    assert clip < 1.0
    assert got["loss"] == pytest.approx(losses, rel=1e-6)
    assert got["first_grad"] == pytest.approx(first, rel=1e-5)
    for p, t in leaves(ours).items():
        torch.testing.assert_close(t, theirs[p], rtol=1e-5, atol=1e-6)
        assert not torch.equal(t, leaves(params)[p])
