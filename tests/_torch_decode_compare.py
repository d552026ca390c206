"""Time the decode-attention kernel at the model shapes, on one card.

    python3 tests/_torch_decode_compare.py [--out FILE] [--repeat N]

At each shape of ``SHAPES`` (deepseek-7b's per-layer call at the two serve
cells of ``portbench/``, gemma2-9b's global and local layers,
stablelm-12b's): the kernel against its plain version (max-abs and
worst-row errors; the worst row within ``ROW_RTOL`` of the output's scale
and every element within ``ATOL``; twice bitwise equal), and the time of
one call in runs issued back to back over ``LAYERS`` caches in turn (as a
decode step's layers call it: each cache cold in L2; each kernel's device
time by torch.profiler too) beside its byte bound (``decode_attention_cost``
over the visible positions), the plain version,
``F.scaled_dot_product_attention`` over the visible slice of the cache
(``library_ms``: a yardstick the port never calls; no softcap) and the
port's flash forward called with one causal query row (``flash_ms``: the
other hand-written one-row path, which the port keeps for cross-attention;
its error against the plain version too). Then a planted fault: at each
deepseek-7b shape, on the same random inputs, the kernel over the cache
without its middle split's keys must leave ``ROW_RTOL``. ``--repeat`` runs
the shapes that many times. One JSON line per shape and run, then the
faults'; with ``--out`` the lines also go to FILE. Exits 1 when a check
fails.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# one layer's call: name -> (B, H, KVH, D, cache positions, kv_len, options).
# deepseek-7b at the serve cells (the agent turn's longest prompt, 8632, at
# its 9th new token; RAG's 1200 at its 100th); gemma2-9b and stablelm-12b at
# chip_smoke.py's serve shape (4 x 2048, 48 new tokens), gemma2-9b's local
# layers also past their window (a 6144-token prompt)
SHAPES = {
    "ds7b_agent_turn": (4, 32, 32, 128, 8656, 8640, {}),
    "ds7b_rag_synth": (32, 32, 32, 128, 1400, 1300, {}),
    "gemma2_global": (4, 16, 8, 256, 2096, 2072,
                      {"logit_softcap": 50.0, "scale": 224 ** -0.5}),
    "gemma2_local": (1, 16, 8, 256, 6152, 6150,
                     {"window": 4096, "logit_softcap": 50.0, "scale": 224 ** -0.5}),
    "stablelm": (4, 32, 8, 160, 2096, 2072, {}),
}
LAYERS = 8          # caches a timed run goes through in turn
ATOL = 2e-2         # elementwise (and relative), against the plain version
ROW_RTOL = 1e-2     # the worst (b, h) row: |kernel - plain| / |plain|, 2-norms over D


def inputs(shape, gen, layers: int = 1):
    """q, ``layers`` (k, v) caches and the call's options, random bf16 on
    the card."""
    import torch
    B, H, KVH, D, Sk, kv_len, opts = shape

    def rnd(*dims):
        return torch.randn(dims, generator=gen, device="cuda").bfloat16()
    caches = [(rnd(B, Sk, KVH, D), rnd(B, Sk, KVH, D)) for _ in range(layers)]
    return rnd(B, 1, H, D), caches, {"q_offset": kv_len - 1, "kv_len": kv_len, **opts}


def layers_ms(call, layers: int, rounds: int = 5) -> float:
    """ms of one ``call(layer)`` in runs issued back to back over the
    ``layers`` caches in turn (CUDA events around each run; the median over
    ``rounds`` after one)."""
    import statistics

    import torch
    for layer in range(layers):
        call(layer)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for layer in range(layers):
            call(layer)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / layers)
    return statistics.median(times)


def case(name: str, gen) -> dict:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as da
    B, H, KVH, D, Sk, kv_len, opts = SHAPES[name]
    q, caches, kw = inputs(SHAPES[name], gen, LAYERS)
    lo, hi = da.visible_range(Sk, kv_len - 1, kv_len, opts.get("window", 0))
    k, v = caches[0]
    got = da.decode_attention_cuda(q, k, v, **kw)
    again = da.decode_attention_cuda(q, k, v, **kw)
    want = da.decode_attention_plain(q, k, v, **kw)

    def sdpa(layer):
        kl, vl = (t[:, lo:hi].transpose(1, 2) for t in caches[layer])
        return F.scaled_dot_product_attention(q.transpose(1, 2), kl, vl,
                                              scale=opts.get("scale"),
                                              enable_gqa=H != KVH)
    try:
        library_ms = layers_ms(sdpa, LAYERS)
    except (TypeError, RuntimeError) as e:      # no enable_gqa in this torch
        library_ms = f"not measured ({type(e).__name__})"
    kernel_ms = layers_ms(lambda i: da.decode_attention_cuda(q, *caches[i], **kw), LAYERS)
    flash = flash_one_row(q, caches, kw, want) if not opts else {}
    split = cs.device_split(lambda: [da.decode_attention_cuda(q, *c, **kw) for c in caches], 3)
    device = {re.search(r"decode_\w+_kernel", e["name"])[0]: e["ms"] / LAYERS
              for e in split} if isinstance(split, list) else split
    bound, by = cs.bound_ms(da.decode_attention_cost(B, 1, hi - lo, H, KVH, D))
    return {"shape": f"B={B} H={H} KVH={KVH} D={D} cache={Sk} kv_len={kv_len} "
                     f"visible={hi - lo} {opts or ''}".strip(),
            "splits": da.split_count(B * KVH, hi - lo,
                                     torch.cuda.get_device_properties(0).multi_processor_count),
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "row_rel_err": cs.rel_errors(got, want)[0],
            "within": within(got, want),
            "bitwise_repeat": torch.equal(got, again),
            "kernel_ms": kernel_ms, "device_ms_by_kernel": device,
            "bound_ms": bound, "bound_by": by, "roofline": bound / kernel_ms,
            "plain_ms": layers_ms(lambda i: da.decode_attention_plain(q, *caches[i], **kw),
                                  LAYERS, rounds=3),
            "library_ms": library_ms, **flash}


def within(got, want) -> bool:
    import torch

    import chip_smoke as cs
    return cs.rel_errors(got, want)[0] <= ROW_RTOL and torch.allclose(
        got.float(), want.float(), atol=ATOL, rtol=ATOL)


def flash_one_row(q, caches, kw, want) -> dict:
    """The flash forward on the same call (one causal row at q_offset over
    kv_valid positions): its time as ``layers_ms`` takes it, its split count
    and its error against the decode kernel's plain version (the flash
    kernel rounds P before normalising it)."""
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    fkw = dict(causal=True, q_offset=kw["q_offset"], kv_valid=kw["kv_len"])
    got = fa.flash_attention_cuda(q, *caches[0], **fkw)
    B, _, H, D = q.shape
    Sk, KVH = caches[0][0].shape[1:3]
    return {"flash_ms": layers_ms(lambda i: fa.flash_attention_cuda(q, *caches[i], **fkw),
                                  len(caches)),
            "flash_splits": fa.split_count(B, 1, Sk, H, KVH, D, kv_valid=kw["kv_len"]),
            "flash_row_rel_err": cs.rel_errors(got, want)[0]}


def fault(name: str, gen) -> dict:
    """One split's keys dropped, on the random inputs of shape ``name``."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as da
    B, H, KVH, D, Sk, kv_len, _ = SHAPES[name]
    q, [(k, v)], kw = inputs(SHAPES[name], gen)
    want = da.decode_attention_plain(q, k, v, **kw)
    splits = da.split_count(B * KVH, kv_len,
                            torch.cuda.get_device_properties(0).multi_processor_count)
    ranges = [r for r in da.split_ranges(0, kv_len, splits, da.split_step(D, H // KVH))
              if r[1] > r[0]]
    a, b = ranges[len(ranges) // 2]
    kd, vd = (torch.cat([t[:, :a], t[:, b:]], 1).contiguous() for t in (k, v))
    n = kv_len - (b - a)
    whole = da.decode_attention_cuda(q, k, v, **kw)
    dropped = da.decode_attention_cuda(q, kd, vd, q_offset=n - 1, kv_len=n)
    err = {label: cs.rel_errors(got, want)[0]
           for label, got in (("whole", whole), ("split_dropped", dropped))}
    return {"name": name, "splits": splits, "dropped": [a, b],
            **{f"{label}_row_rel_err": e for label, e in err.items()},
            "whole_within": within(whole, want),
            "fault_exceeds": err["split_dropped"] > ROW_RTOL}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    emit({"card": cs.card_line(), "torch": torch.__version__})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ok = True
    for run in range(args.repeat):
        for name in SHAPES:
            line = case(name, gen)
            ok = ok and line["within"] and line["bitwise_repeat"]
            emit({"run": run, "name": name, **line})
            torch.cuda.empty_cache()
    for name in ("ds7b_agent_turn", "ds7b_rag_synth"):
        planted = fault(name, gen)
        emit({"fault": planted})
        ok = ok and planted["whole_within"] and planted["fault_exceeds"]
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
