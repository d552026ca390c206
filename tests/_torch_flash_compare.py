"""Time this tree's flash-attention kernels against another checkout's, on one card.

    python3 tests/_torch_flash_compare.py --other DIR [--out FILE]

DIR is the ``src/repro_torch`` of another checkout (say the parent commit,
unpacked by ``git archive`` into a directory that ``.gitignore`` lists).
Both trees' ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``
are built, each with its own headers, and driven through each tree's own
wrapper module (the other one imported from DIR), at the forward and
backward shapes ``chip_smoke.py`` times. Each shape is timed in turns
(other, this, this, other, twice): medians of CUDA events around one call,
host work included; the time a call takes in a run of calls issued back to
back (50, or 400 at one q row; the device's time where it is the longer,
the host's where it is: a one-row call's case) and the host's time to
issue them (``issue_ms``); and the device time of one call (torch.profiler);
beside ``F.scaled_dot_product_attention``'s (a yardstick neither tree
calls) and the bound of ``chip_smoke.py``. The two trees' outputs are
compared too.
One JSON line per shape, then a summary line; with ``--out`` the lines also
go to FILE.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def other_module(tree: Path):
    """The other tree's ``kernels/flash_attention.py``, its libraries built
    from its own ``csrc/`` (into its own ``csrc/build/``) and bound by its
    own signatures."""
    from repro_torch.kernels import _build
    spec = importlib.util.spec_from_file_location(
        "repro_torch.kernels._other_flash_attention", tree / "kernels" / "flash_attention.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    here = _build.CSRC, _build.BUILD_DIR
    _build.CSRC, _build.BUILD_DIR = tree / "csrc", tree / "csrc" / "build"
    try:
        mod._lib()            # cached: later calls get the other tree's libraries
        mod._bwd_lib()
    finally:
        _build.CSRC, _build.BUILD_DIR = here
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    other = other_module(args.other.resolve())
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    emit({"card": cs.card_line(), "other": str(args.other)})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def back_to_back_ms(fn, n):
        """(ms a call to issue n calls, ms a call to issue and finish them)."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e3 * (t1 - t0) / n, 1e3 * (time.perf_counter() - t0) / n

    def timed(calls, n=50):
        ms = {name: [] for name in calls}
        run = {name: [] for name in calls}
        issue = {name: [] for name in calls}
        for name in ["other", "this", "this", "other"] * 2:
            ms[name].append(cs.cuda_ms(calls[name], warmup=3, iters=20))
            host, total = back_to_back_ms(calls[name], n)
            issue[name].append(host)
            run[name].append(total)
        return {f"{name}_ms": v for name, v in ms.items()} | {
            f"{name}_back_to_back_ms": v for name, v in run.items()} | {
            f"{name}_issue_ms": v for name, v in issue.items()} | {
            f"{name}_device_ms": cs.device_ms(calls[name]) for name in calls}

    summary = {}
    for name, B, Sq, Sk, H, KVH, D, opts in [
            cs.SERVE_SHAPE, cs.ZAMBA_SHAPE, *cs.FAMILY_SHAPES, cs.VLM_DECODE_CROSS,
            cs.SEAMLESS_ENCODER, cs.SEAMLESS_CROSS, cs.TP_FLASH_FWD]:
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, KVH, D), rnd(B, Sk, KVH, D)
        kw = dict(causal=opts.get("causal", True), window=opts.get("window", 0),
                  softcap=opts.get("softcap", 0.0), scale=opts.get("scale"),
                  q_offset=opts.get("q_offset", 0), kv_valid=opts.get("kv_valid"))
        calls = {"other": lambda: other.flash_attention_cuda(q, k, v, **kw),
                 "this": lambda: fa.flash_attention_cuda(q, k, v, **kw)}
        diff = (calls["this"]().float() - calls["other"]().float()).abs().max().item()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=kw["causal"], scale=kw["scale"], enable_gqa=H != KVH)
        line = {"pass": "forward", "shape": name, "B_Sq_Sk_H_KVH_D": [B, Sq, Sk, H, KVH, D],
                "options": opts, "max_abs_diff": diff, **timed(calls, 400 if Sq == 1 else 50),
                "library_ms": cs.cuda_ms(sdpa), "library_device_ms": cs.device_ms(sdpa),
                "bound_ms": cs.attention_bound_ms(B, Sq, Sk, H, KVH, D, opts)[0],
                "splits": fa.split_count(B, Sq, Sk, H, KVH, D, kv_valid=kw["kv_valid"])}
        emit(line)
        summary[f"forward:{name}"] = line
        del q, k, v
    for name, B, Sq, Sk, H, KVH, D, opts in cs.FLASH_TRAIN_SHAPES + [cs.TP_FLASH_BWD]:
        q, k, v, do = rnd(B, Sq, H, D), rnd(B, Sk, KVH, D), rnd(B, Sk, KVH, D), rnd(B, Sq, H, D)
        kw = dict(causal=opts.get("causal", True), window=opts.get("window", 0),
                  softcap=opts.get("softcap", 0.0), scale=opts.get("scale"),
                  kv_valid=opts.get("kv_valid"))
        o, lse = fa._forward(q, k, v, q_offset=0, with_lse=True, **kw)
        calls = {"other": lambda: other.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw),
                 "this": lambda: fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)}
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(calls["this"](), calls["other"]()))
        qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
        ref = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=kw["scale"],
                                             enable_gqa=H != KVH)

        def sdpa_bwd():
            return torch.autograd.grad(ref, (qs, ks, vs), do.transpose(1, 2),
                                       retain_graph=True)
        line = {"pass": "backward", "shape": name, "B_Sq_Sk_H_KVH_D": [B, Sq, Sk, H, KVH, D],
                "options": opts, "max_abs_diff": diff, **timed(calls),
                "library_ms": cs.cuda_ms(sdpa_bwd),
                "library_note": "sdpa's backward" + (" (no softcap)" if kw["softcap"] else ""),
                "bound_ms": cs.attention_bwd_bound_ms(B, Sq, Sk, H, KVH, D, opts)[0]}
        emit(line)
        summary[f"backward:{name}"] = line
        del q, k, v, do, o, lse, ref, qs, ks, vs
    emit({"summary": {
        key: {"this_over_other": statistics.median(l["this_ms"]) / statistics.median(l["other_ms"]),
              "back_to_back_this_over_other": statistics.median(l["this_back_to_back_ms"]) /
              statistics.median(l["other_back_to_back_ms"]),
              "issue_this_over_other": statistics.median(l["this_issue_ms"]) /
              statistics.median(l["other_issue_ms"]),
              "device_this_over_other": l["this_device_ms"] / l["other_device_ms"]
              if isinstance(l["this_device_ms"], float) and
              isinstance(l["other_device_ms"], float) else "not measured"}
        for key, l in summary.items()}})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
