#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one or
outside a checkout of the repository. Phases, each printed as one JSON line:

1. card:    the card's name and power limit, and the kernel build time
            (``nvcc`` builds ``src/repro_torch/csrc/*.cu`` at first use).
2. kernel:  the flash-attention kernel against its plain PyTorch version on
            the card, bf16, on the kernel-test grid and on the serving shape
            (B=4, S=2048, H=KVH=32, D=128, causal): elementwise within 2e-2,
            and the worst row and the whole output within relative-norm
            limits that two injected faults (the last K/V tile dropped or
            stale) are shown to exceed. At the serving shape, kernel and
            plain version against an fp32-output reference (what rounding P
            to bf16 adds), and medians of CUDA-event timings of the kernel,
            the plain version and ``F.scaled_dot_product_attention`` (a
            yardstick the port never calls).
3. serve:   the main path: ``ServeSession.generate`` on deepseek-7b at full
            width (30 layers, d_model 4096) with random bf16 weights from a
            seeded generator, two batches of 4 prompts of 2048 tokens, 64 new
            greedy tokens each. The kernel's launch count is reset just before
            and read just after; every prefill must launch it once per layer.
4. agree:   one full-width prefill through the kernel and the same prefill
            through the plain attention: logits at every prompt position
            within a stated multiple of the network's own bf16 noise floor,
            argmax equal wherever the top-2 margin exceeds that limit, and a
            prefill with an injected fault shown to exceed it.
5. trace:   torch.profiler over one prefill and a few decode steps: device
            busy time, idle share and the kernels that take the most time.

Then a ``kernels`` line (one entry per kernel of the path), the card's
``nvidia-smi`` name and power limit, and last the device line. Any failure
raises, so the script never prints the last line after a failed phase.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

KERNEL_TOL = 2e-2          # bf16 kernel vs plain, elementwise (the JAX kernel tests' bf16 tolerance)
ROW_RTOL = 2e-2            # worst (b, q, h) row: |kernel - plain| / |plain|, 2-norms over D
NORM_RTOL = 5e-3           # whole output: |kernel - plain| / |plain|, 2-norms
FLOOR_MULT = 3.0           # full-width logits: limit = FLOOR_MULT x the noise floor (phase 4)
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth

# (name, B, Sq, Sk, H, KVH, D, options): the TestFlashAttention grid of
# tests/test_kernels.py at head_dim 64 and 128 (the kernel's), one non-causal
# cross case, and the serving prefill shape.
GRID = [
    ("mha", 1, 128, 128, 4, 4, 64, {}),
    ("gqa_2to1", 2, 128, 128, 4, 2, 64, {}),
    ("ragged_100", 1, 100, 100, 4, 2, 64, {}),
    ("cross_64x192", 1, 64, 192, 2, 2, 128, {}),
    ("window_32", 1, 128, 128, 4, 2, 64, {"window": 32}),
    ("softcap_20", 1, 128, 128, 4, 2, 64, {"softcap": 20.0}),
    ("window_32_softcap_20", 1, 128, 128, 4, 2, 64, {"window": 32, "softcap": 20.0}),
    ("decode_q99_kv100", 1, 1, 256, 4, 2, 64, {"q_offset": 99, "kv_valid": 100}),
    ("noncausal_cross_70x130", 1, 70, 130, 4, 2, 128, {"causal": False}),
]
SERVE_SHAPE = ("serve_prefill", 4, 2048, 2048, 32, 32, 128, {})
KV_TILE = 64               # the kernel's K/V tile (BLOCK_K), the unit of the injected faults
SERVE_BATCHES, SERVE_BATCH, PROMPT_LEN, MAX_NEW = 2, 4, 2048, 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Median time of ``fn`` on the card, CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attended_pairs(Sq, Sk, *, causal=True, window=0, q_offset=0, kv_valid=None):
    """(q, k) pairs the masks leave for these inputs: the work the data needs."""
    kv_valid = Sk if kv_valid is None else min(kv_valid, Sk)
    total = 0
    for i in range(Sq):
        qp = q_offset + i
        hi = min(kv_valid, qp + 1) if causal else kv_valid
        lo = max(0, qp - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def attention_bound_ms(B, Sq, Sk, H, KVH, D, opts) -> tuple[float, str]:
    """Least time on the card and what sets it: operations at the bf16 peak
    or bytes (each input read once, the output written once) at HBM rate."""
    pairs = attended_pairs(Sq, Sk, causal=opts.get("causal", True),
                           window=opts.get("window", 0),
                           q_offset=opts.get("q_offset", 0),
                           kv_valid=opts.get("kv_valid"))
    flops = 4 * B * H * D * pairs
    nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Sk * KVH * D)   # q, o, k, v in bf16
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_card():
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    _build.build("flash_attention")
    build_s = time.perf_counter() - t0
    lib = fa._lib()
    for d in fa.HEAD_DIMS:
        if lib.flash_attention_smem_bytes(d) != fa.smem_bytes(d=d):
            raise AssertionError(f"smem_bytes({d}) disagrees with the kernel")
    emit({"phase": "card", "card": card_line(),
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "smem_bytes_d128": fa.smem_bytes(d=128)})


def rel_errors(got, want) -> tuple[float, float]:
    """(worst row, whole tensor) of |got - want| / |want|, 2-norms; a row is
    one (b, q, h) vector over D."""
    d, w = got.float() - want.float(), want.float()
    rows = d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    return rows.max().item(), (d.norm() / w.norm()).item()


def injected_faults(q, k, v, kw):
    """The plain version's output under two faults a tiled kernel can have
    that move only the longest rows: the last K/V tile dropped, and the last
    tile computed with the previous tile's K/V (a stale pipeline stage)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    Sk = k.shape[1]
    dropped = flash_attention_plain(q, k, v, **{**kw, "kv_valid": Sk - KV_TILE})
    ks, vs = k.clone(), v.clone()
    ks[:, -KV_TILE:] = k[:, -2 * KV_TILE:-KV_TILE]
    vs[:, -KV_TILE:] = v[:, -2 * KV_TILE:-KV_TILE]
    return {"last_tile_dropped": dropped,
            "last_tile_stale": flash_attention_plain(q, ks, vs, **kw)}


def phase_kernel():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst, failures, timing = 0.0, [], None
    for name, B, Sq, Sk, H, KVH, D, opts in GRID + [SERVE_SHAPE]:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, KVH, D), rnd(B, Sk, KVH, D)
        kw = dict(causal=opts.get("causal", True), window=opts.get("window", 0),
                  softcap=opts.get("softcap", 0.0),
                  q_offset=opts.get("q_offset", 0),
                  kv_valid=opts.get("kv_valid"))
        got = flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, **kw)
        err = (got.float() - want.float()).abs().max().item()
        row_rel, norm_rel = rel_errors(got, want)
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), atol=KERNEL_TOL, rtol=KERNEL_TOL) \
            and row_rel <= ROW_RTOL and norm_rel <= NORM_RTOL
        worst = max(worst, err)
        line = {"phase": "kernel", "shape": name,
                "B_Sq_Sk_H_KVH_D": [B, Sq, Sk, H, KVH, D], "options": opts,
                "max_abs_err": err, "tol": KERNEL_TOL,
                "row_rel_err": row_rel, "row_rtol": ROW_RTOL,
                "norm_rel_err": norm_rel, "norm_rtol": NORM_RTOL}
        if name == SERVE_SHAPE[0]:
            # the checks must have the power to see a one-tile fault
            line["faults"] = {}
            for fault, out in injected_faults(q, k, v, kw).items():
                f_row, f_norm = rel_errors(out, want)
                line["faults"][fault] = {"row_rel_err": f_row,
                                         "norm_rel_err": f_norm}
                if f_row <= ROW_RTOL or f_norm <= NORM_RTOL:
                    failures.append(f"{name}: limits miss {fault}")
                del out
            # what rounding P to bf16 adds: both against fp32 output
            exact = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
            line["vs_fp32_output"] = {
                "kernel_norm_rel_err": rel_errors(got, exact)[1],
                "plain_norm_rel_err": rel_errors(want, exact)[1],
                "kernel_max_abs_err": (got.float() - exact).abs().max().item(),
                "plain_max_abs_err": (want.float() - exact).abs().max().item()}
            del exact
        emit({**line, "ok": ok})
        if not ok:
            failures.append(name)
        if name == SERVE_SHAPE[0] and ok:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            bound_ms, bound_by = attention_bound_ms(B, Sq, Sk, H, KVH, D, opts)
            timing = {
                "ms": cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw)),
                "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, **kw),
                                    warmup=1, iters=5),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            emit({"phase": "kernel_timing", "shape": name, **timing})
        del q, k, v, got, want
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")
    return worst, timing


def _sync_s(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_serve():
    """The main path: returns the model pieces phase 4 reuses and the launches."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.serve import ServeOptions, ServeSession, \
        build_prefill_step

    cfg = get_config("deepseek-7b")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params, init_s = _sync_s(lambda: model.init(gen))
    sess = ServeSession(model, params, ServeOptions(), device="cuda")
    prompts = [torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT_LEN),
                             generator=gen, device="cuda")
               for _ in range(SERVE_BATCHES)]
    torch.cuda.reset_peak_memory_stats()

    flash_attention_cuda.launches = 0
    outs, gen_s = [], []
    for p in prompts:
        out, s = _sync_s(lambda: sess.generate(p, max_new_tokens=MAX_NEW))
        outs.append(out)
        gen_s.append(s)
    launches = flash_attention_cuda.launches

    peak = torch.cuda.max_memory_allocated()
    for out in outs:
        if out.shape != (SERVE_BATCH, MAX_NEW) or bool(
                ((out < 0) | (out >= cfg.vocab_size)).any()):
            raise AssertionError(f"bad generate output {tuple(out.shape)}")
    if launches < cfg.n_layers * SERVE_BATCHES:
        raise AssertionError(f"flash-attention kernel launched {launches} "
                             f"times; expected >= {cfg.n_layers} per batch")

    # prefill alone, same entry point the session uses, for the split
    prefill = build_prefill_step(model, ServeOptions())
    pre_s = []
    for p in prompts:
        cache = model.init_cache(SERVE_BATCH, PROMPT_LEN + MAX_NEW, device="cuda")
        with torch.inference_mode():
            _, s = _sync_s(lambda: prefill(params, {"tokens": p}, cache))
        pre_s.append(s)
        del cache
    prefill_ms = 1e3 * statistics.median(pre_s)
    decode_ms = (1e3 * statistics.median(gen_s) - prefill_ms) / (MAX_NEW - 1)
    emit({"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": model.param_count(),
          "batches": SERVE_BATCHES, "batch": SERVE_BATCH,
          "prompt_len": PROMPT_LEN, "max_new": MAX_NEW,
          "init_s": init_s, "generate_s": gen_s, "prefill_ms": prefill_ms,
          "decode_ms_per_token": decode_ms,
          "tok_per_s": SERVE_BATCHES * SERVE_BATCH * MAX_NEW / sum(gen_s),
          "max_memory_allocated": peak, "flash_attention_launches": launches})
    return model, params, prompts[0], launches


def phase_agree(model, params, prompts):
    """Full-width prefill logits, at every prompt position, through the
    kernel vs the plain attention.

    Each of the 30 layers rounds activations to bf16, and random weights
    pass any rounding difference on from layer to layer, so no fixed
    tolerance fits. The limit is FLOOR_MULT times a noise floor measured in
    this run against the same plain prefill: the larger of two attentions
    that differ from it only in rounding, the naive oracle (fp32 summation
    order) and a plain attention that rounds P to bf16 before the PV
    product as the kernel does. A prefill whose attention drops the last
    K/V tile in every layer must exceed the max-abs limit, or the check
    could not see such a fault. The whole-tensor norm bounds faults that
    move every position; a fault in the last 64 of 2048 positions stays
    below the network's own noise in it.
    """
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)

    def plain_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                        scale=None, q_offset=0, kv_len=None):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=logit_softcap, scale=scale,
                                     q_offset=q_offset, kv_valid=kv_len)

    def naive_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                        scale=None, q_offset=0, kv_len=None):
        return ref.mha_naive(q, k, v, causal=causal, window=window,
                             logit_softcap=logit_softcap, scale=scale,
                             q_offset=q_offset, kv_len=kv_len)

    def p_bf16_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                         scale=None, q_offset=0, kv_len=None):
        """Full scores in fp32, the row sum of fp32 P, PV from bf16 P."""
        if not causal or window or logit_softcap or q_offset or kv_len:
            raise NotImplementedError("causal self-attention only")
        B, S, H, D = q.shape
        KVH = k.shape[2]
        scale = D ** -0.5 if scale is None else scale
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        out = torch.empty_like(q)
        for b in range(B):      # one batch row at a time bounds the scores
            qb = q[b].float().reshape(S, KVH, H // KVH, D)
            s = torch.einsum("qhgd,khd->hgqk", qb, k[b].float()) * scale
            s = s.masked_fill(~keep, ref.NEG_INF)
            p = torch.exp(s - s.amax(-1, keepdim=True))
            o = torch.einsum("hgqk,khd->qhgd", p.to(v.dtype).float(), v[b].float())
            out[b] = (o / p.sum(-1).permute(2, 0, 1)[..., None]).reshape(S, H, D)
        return out

    def dropped_tile_attention(q, k, v, **kw):
        return plain_attention(q, k, v, **{**kw, "kv_len": k.shape[1] - KV_TILE})

    B, S = prompts.shape

    def run(attention=None):
        """(B, S, vocab) fp32 logits of one prefill, as the session's step."""
        cache = model.init_cache(B, S, device="cuda")
        with torch.inference_mode(), mock.patch.object(
                ops, "flash_attention", attention or ops.flash_attention):
            return model.apply(params, {"tokens": prompts}, mode="prefill",
                               cache=cache, cache_index=0)[0]

    def diffs(got, want):
        d = got - want
        return d.abs().max().item(), (d.norm() / want.norm()).item()

    with_kernel = run()
    before = flash_attention_cuda.launches
    with_plain = run(plain_attention)
    order_abs, order_rel = diffs(run(naive_attention), with_plain)
    p_abs, p_rel = diffs(run(p_bf16_attention), with_plain)
    floor_abs, floor_rel = max(order_abs, p_abs), max(order_rel, p_rel)
    fault_abs, fault_rel = diffs(run(dropped_tile_attention), with_plain)
    if flash_attention_cuda.launches != before:
        raise AssertionError("a plain run launched the kernel")
    diff_abs, diff_rel = diffs(with_kernel, with_plain)
    tol_abs, tol_rel = FLOOR_MULT * floor_abs, FLOOR_MULT * floor_rel
    top2 = with_plain.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > tol_abs
    same = with_kernel.argmax(-1) == with_plain.argmax(-1)
    n_decided, n_same = int(decided.sum()), int(same[decided].sum())
    ok = bool(torch.isfinite(with_kernel).all()) and diff_abs <= tol_abs \
        and diff_rel <= tol_rel and n_same == n_decided
    power = fault_abs > tol_abs
    emit({"phase": "agree", "positions": B * S,
          "max_abs_logit_diff": diff_abs, "norm_rel_logit_diff": diff_rel,
          "floor_fp32_order": {"max_abs": order_abs, "norm_rel": order_rel},
          "floor_p_bf16": {"max_abs": p_abs, "norm_rel": p_rel},
          "floor_mult": FLOOR_MULT, "tol_abs": tol_abs, "tol_rel": tol_rel,
          "fault_last_tile_dropped": {"max_abs": fault_abs,
                                      "norm_rel": fault_rel},
          "logit_absmax": with_plain.abs().max().item(),
          "argmax_decided": n_decided, "argmax_equal_where_decided": n_same,
          "argmax_equal_all": int(same.sum()), "ok": ok, "power": power})
    if not ok:
        raise AssertionError("full-width logits disagree between the kernel "
                             "and the plain attention")
    if not power:
        raise AssertionError("the logit limit does not catch a dropped tile")


TRACE_DECODE_STEPS = 8


def _self_device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def phase_trace(model, params, prompts):
    """Where the time goes: torch.profiler over one full-width prefill and
    TRACE_DECODE_STEPS decode steps after it, off the main path's count.

    Per window: host wall time per step (profiler on, so it overstates the
    host side), device busy time per step (kernel time summed; one stream),
    the idle share, and the kernels that take the most device time.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serve import (ServeOptions, build_decode_step,
                                           build_prefill_step)

    prefill = build_prefill_step(model, ServeOptions())
    decode = build_decode_step(model, ServeOptions())
    B, S = prompts.shape
    cache = model.init_cache(B, S + TRACE_DECODE_STEPS + 1, device="cuda")
    state = {}

    def run_prefill():
        state["tok"] = prefill(params, {"tokens": prompts}, cache)[0].argmax(-1)[:, None]

    def run_decode():
        tok = state["tok"]
        for i in range(TRACE_DECODE_STEPS):
            tok, _, _ = decode(params, cache, tok, S + i)

    with torch.inference_mode():
        run_prefill()
        run_decode()                    # warm-up of both windows
        for name, fn, steps in (("prefill", run_prefill, 1),
                                ("decode", run_decode, TRACE_DECODE_STEPS)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0) / steps
            kernels = [(e.key, _self_device_us(e) / 1e3 / steps, e.count // steps)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            busy_ms = sum(ms for _, ms, _ in kernels)
            top = sorted(kernels, key=lambda k: -k[1])[:8]
            emit({"phase": "trace", "window": name, "steps": steps,
                  "wall_ms_per_step": wall_ms,
                  "device_busy_ms_per_step": busy_ms if busy_ms else "not measured",
                  "idle_share": 1 - busy_ms / wall_ms if busy_ms else "not measured",
                  "kernel_launches_per_step": sum(n for _, _, n in kernels),
                  "top_kernels": [{"name": k[:80], "ms_per_step": ms, "calls": n}
                                  for k, ms, n in top]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_card()
    worst_err, timing = phase_kernel()
    model, params, prompts, launches = phase_serve()
    phase_agree(model, params, prompts)
    phase_trace(model, params, prompts)
    emit({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": launches,
        "max_abs_err": worst_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "shape": "B=4 S=2048 H=KVH=32 D=128 causal bf16",
    }]})
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
