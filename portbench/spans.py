"""The program's spans (``repro_torch.census``) joined with the device trace
of a ``--trace 1`` run.

The program records spans while torch.profiler is on, so the log holds the
traced slice's spans: the session's ``serve.generate``, ``serve.prefill``
and ``serve.decode_step``, ``decode_attention``, ``train.step`` and
``train.optimizer``, and a span per kernel-wrapper call. Their host and
device intervals are in ns on the clock the profiler stamps its events
with; the trace's operations are in µs on it. A span still open when the
slice closed (RAG's closes inside a decode step) has its device interval
cut at the slice's last device operation. A program without the recorder
gives no log, and every reader of it reads None.

    python3 portbench/spans.py --workload ds7b.rag_synth --seed 7

runs one traced run of a cell and prints one JSON object: the cell's
per-layer metrics and check, the slice's device operations, its ten
longest idle gaps each put down to a span, how the prefill's flash spans
hold their kernels on the trace's clock, the traced decode steps' device
time beside the untraced ones' of the same prompt length, the optimizer
spans' device time, and the host µs a span costs, recorded and not.
"""
from __future__ import annotations

import bisect

import torch

OUTSIDE = "outside the program"


def log():
    """The spans the program recorded, device intervals resolved; None when
    it records none (or has no recorder)."""
    from repro_torch import census
    read = getattr(census, "spans", None)
    if read is None:
        return None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return [s for s in read() if s.device is not None] or None


def slice_end_us(trace) -> float | None:
    return max((e for _, _, e in trace.ops), default=None) if trace else None


def device_us(span, end_us=None) -> tuple[float, float]:
    """A span's device interval in µs, cut at ``end_us`` (the slice's end)."""
    s, e = span.device[0] / 1e3, span.device[1] / 1e3
    if end_us is not None:
        s, e = min(s, end_us), min(e, end_us)
    return s, e


def device_s(span, end_us=None) -> float:
    s, e = device_us(span, end_us)
    return (e - s) / 1e6


def under(spans, name: str, ancestor: str) -> list[tuple]:
    """(span, its nearest ancestor named ``ancestor``) for each span named
    ``name`` that has one."""
    by = {s.id: s for s in spans}
    out = []
    for s in spans:
        if s.name != name:
            continue
        p = by.get(s.parent)
        while p is not None and p.name != ancestor:
            p = by.get(p.parent)
        if p is not None:
            out.append((s, p))
    return out


def ops_inside(trace, intervals) -> int:
    """The device operations that start inside any of ``intervals`` (µs,
    disjoint)."""
    spans = sorted(intervals)
    starts = [s for s, _ in spans]
    n = 0
    for _, t, _ in trace.ops:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < spans[i][1]:
            n += 1
    return n


def owner_at(spans, t_ns: float) -> str:
    """The innermost span open on the host at ``t_ns``: of those open then,
    the one opened last."""
    best = None
    for s in spans:
        end = s.host[1]
        if s.host[0] <= t_ns and (end is None or t_ns < end):
            if best is None or s.host[0] >= best.host[0]:
                best = s
    return OUTSIDE if best is None else best.name


def idle_gaps(trace, spans, n: int = 10) -> list:
    """The ``n`` longest stretches with nothing on the device, each as
    [the innermost span open on the host when it ended, seconds]."""
    gaps, end = [], None
    for _, s, e in sorted(trace.ops, key=lambda o: o[1]):
        if end is not None and s > end:
            gaps.append((s - end, s))
        if end is None or e > end:
            end = e
    gaps.sort(key=lambda g: -g[0])
    return [[owner_at(spans or [], t * 1e3), d / 1e6] for d, t in gaps[:n]]


def clock_join(trace, spans, kernel: str = "flash_fwd_kernel") -> dict:
    """How the ``flash_attention`` spans under ``serve.prefill`` hold their
    ``kernel`` ops: how many hold exactly one, and [least, largest] µs from
    a span's device start to its op's start (``lead_us``) and from the op's
    end to the span's end (``tail_us``); negative: the op sticks out."""
    ops = sorted((s, e) for n, s, e in trace.ops if kernel in n)
    calls = under(spans, "flash_attention", "serve.prefill")
    held, lead, tail = 0, [], []
    for sp, _ in calls:
        a, b = device_us(sp)
        mid = (a + b) / 2
        inside = [(s, e) for s, e in ops if a <= s < b]
        held += len(inside) == 1
        if not ops:
            continue
        s, e = min(ops, key=lambda o: abs((o[0] + o[1]) / 2 - mid))
        lead.append(s - a)
        tail.append(b - e)
    return {"spans": len(calls), "holding_one": held,
            "lead_us": [min(lead, default=None), max(lead, default=None)],
            "tail_us": [min(tail, default=None), max(tail, default=None)]}


def _span_cost_us(n: int = 2000) -> dict:
    """Host µs per span: recorded (under the profiler, two CUDA events on
    the card) and not."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import census
    out = {}
    for on in (False, True):
        prof = profile(activities=[ProfilerActivity.CUDA]) if on else None
        if prof:
            prof.__enter__()
        t = time.perf_counter()
        for i in range(n):
            with census.span("cost", index=i):
                pass
        out["recorded" if on else "off"] = (time.perf_counter() - t) / n * 1e6
        if prof:
            prof.__exit__(None, None, None)
    census.clear_spans()
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import statistics
    import sys
    import time
    from pathlib import Path

    started = time.perf_counter()
    root = Path(__file__).resolve().parent.parent
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / ".portbench_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / ".portbench_cache" / "torch_extensions"))
    sys.path[:0] = [str(root), str(root / "src")]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)

    from portbench import harness
    torch.cuda.set_device(0)
    bench = harness.manifest()
    ctx, got = harness.drive(args.workload, args.seed, args.seconds, True,
                             started=started)
    trace = ctx.tracer.trace
    spans = log()
    out = {"workload": args.workload, "seed": args.seed,
           "per_layer": harness.per_layer(bench, ctx, got),
           "device_ops": len(trace.ops), "busy_s": trace.busy_s(),
           "window_s": trace.window_s, "spans": len(spans or []),
           "idle_gaps": idle_gaps(trace, spans), "checks": got["checks"],
           "end_to_end": got["end_to_end"]}
    if spans:
        end = slice_end_us(trace)
        steps = [s for s in spans if s.name == "serve.decode_step"]
        if steps:
            out["decode_step_device_ms"] = 1e3 * statistics.mean(
                device_s(s, end) for s in steps)
        opt = [s for s in spans if s.name == "train.optimizer"]
        if opt:
            out["optimizer_device_ms"] = [1e3 * device_s(s) for s in opt]
        out["clock_join"] = clock_join(trace, spans)
        bs = getattr(got["run"], "batches", [])
        same = [b.decode_ms() / b.decode_steps for b in bs
                if not b.traced and b.prompt_len == next(
                    r.prompt_len for r in bs if r.traced)]
        if same:
            out["decode_step_ms_same_shape"] = statistics.mean(same)
        out["span_cost_us"] = _span_cost_us()
    run = got["run"]
    if hasattr(run, "steps"):
        out["step_s"] = [s for s, _ in run.steps]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
