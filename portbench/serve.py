"""A serve cell: one client's closed loop of batches through
``repro_torch.runtime.serve.ServeSession.generate``.

The session's prefill and decode steps are wrapped, on that session
instance, in the benchmark's own code: a CUDA event after the prefill marks
the batch's first token, and the decode steps are counted (and the traced
slice closed after the mix's ``trace.decode_steps`` of them). A batch is
due when it starts; it starts when the last one's tokens are on the host.
The window runs whole cycles of the mix's prompt lengths and starts none
after ``--seconds``.
"""
from __future__ import annotations

import random
import statistics
import time
from dataclasses import dataclass, field

import torch

from . import traffic, weights
from .reference.common import FP32, forward_logits


@dataclass
class BatchRecord:
    index: int
    rows: int
    prompt_len: int
    new_tokens: int
    start: object = None          # CUDA events
    first_token: object = None
    end: object = None
    t_end: float = 0.0            # host clock
    decode_steps: int = 0
    traced: bool = False
    resumed: object = None        # CUDA event where a traced slice ended mid-batch
    steps_traced: int = 0
    prompts: torch.Tensor = None
    served: torch.Tensor = None

    def ttft_ms(self) -> float:
        return self.start.elapsed_time(self.first_token)

    def decode_ms(self) -> float:
        return self.first_token.elapsed_time(self.end)

    def untraced_decode(self) -> tuple[float, int]:
        """(ms, steps) of the decode steps outside the traced slice: all of
        an untraced batch's; those after the slice closed in a traced one."""
        if not self.traced:
            return self.decode_ms(), self.decode_steps
        if self.resumed is None:
            return 0.0, 0
        return self.resumed.elapsed_time(self.end), self.decode_steps - self.steps_traced


class _HostEvent:
    """A CUDA event's stand-in on the CPU (the tests' runs): the host's
    clock when recorded."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def _event(device):
    if device.type != "cuda":
        return _HostEvent()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@dataclass
class ServeRun:
    batches: list = field(default_factory=list)
    window_s: float = 0.0
    peak_bytes: int = 0


def wrap_steps(session, state: dict, tracer, trace_steps: int, device):
    """Put the benchmark's spans around the session's two steps."""
    prefill, decode = session._prefill, session._decode

    def timed_prefill(*args, **kw):
        out = prefill(*args, **kw)
        rec = state.get("batch")
        if rec is not None:
            rec.first_token = _event(device)
        return out

    def counted_decode(*args, **kw):
        out = decode(*args, **kw)
        rec = state.get("batch")
        if rec is not None:
            rec.decode_steps += 1
            if rec.traced and tracer.open and rec.decode_steps == trace_steps:
                tracer.stop()
                rec.resumed, rec.steps_traced = _event(device), rec.decode_steps
        return out

    session._prefill, session._decode = timed_prefill, counted_decode


def run(ctx) -> dict:
    """Set up, warm up, run the window and check it. Returns the cell's
    numbers for the harness (``ctx``: see ``harness.Context``)."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.serve import ServeOptions, ServeSession

    mix, device = ctx.mix, ctx.device
    model = build_model(ctx.program_config())
    params = weights.draw(model.specs, ctx.seed, device, ctx.param_dtype)
    session = ServeSession(model, params, ServeOptions(), device=device)
    state: dict = {}
    trace_cfg = mix.get("trace", {})
    wrap_steps(session, state, ctx.tracer, trace_cfg.get("decode_steps", 0), device)
    ctx.plant(session)
    reqs = traffic.Requests(mix, model.cfg.vocab_size, ctx.seed, device)

    for b in reqs.warmup():
        session.generate(b.prompts, b.new_tokens).cpu()
    ctx.sync()
    ctx.mark_setup()

    out = ServeRun()
    ctx.reset_peak()
    t0 = time.perf_counter()
    while not (out.batches and len(out.batches) % reqs.cycle == 0 and
               time.perf_counter() - t0 >= ctx.seconds):
        b = reqs.next()
        rec = BatchRecord(b.index, b.prompts.shape[0], b.prompts.shape[1],
                          b.new_tokens, prompts=b.prompts)
        rec.traced = ctx.tracer.on and b.index == trace_cfg.get("batch", 0)
        if rec.traced:
            ctx.tracer.start()
        state["batch"] = rec
        rec.start = _event(device)
        served = session.generate(b.prompts, b.new_tokens)
        rec.end = _event(device)
        rec.served = served
        served.cpu()                       # the replies reach the client
        rec.t_end = time.perf_counter()
        if rec.traced:
            ctx.tracer.stop()
        out.batches.append(rec)
    out.window_s = out.batches[-1].t_end - t0
    out.peak_bytes = ctx.peak()
    state.clear()
    del session
    ctx.free()

    checks = check(ctx, params, out)
    return {"run": out, "checks": checks, "attempted": sum(r.rows for r in out.batches),
            "failed": 0, "end_to_end": end_to_end(out), "params": params}


def end_to_end(run: ServeRun) -> dict:
    tokens = sum(r.rows * r.new_tokens for r in run.batches)
    ttft = [r.ttft_ms() for r in run.batches for _ in range(r.rows)]
    return {"ttft_p90_ms": statistics.quantiles(ttft, n=10, method="inclusive")[8],
            "output_tok_s": tokens / run.window_s,
            "peak_mem_gb": run.peak_bytes / 1e9}


def sample(ctx, run: ServeRun) -> list[tuple[int, list[int]]]:
    """The requests the reference reads: ``check.requests`` of them drawn
    from the seed, one of the longest among them; grouped by batch."""
    reqs = [(i, r) for i, b in enumerate(run.batches) for r in range(b.rows)]
    n = min(ctx.mix["check"]["requests"], len(reqs))
    picked = random.Random(ctx.seed).sample(reqs, n)
    longest = max(b.prompt_len for b in run.batches)
    if not any(run.batches[i].prompt_len == longest for i, _ in picked):
        picked[0] = next(q for q in reqs if run.batches[q[0]].prompt_len == longest)
    by: dict = {}
    for i, r in picked:
        by.setdefault(i, []).append(r)
    return sorted((i, sorted(rows)) for i, rows in by.items())


def served_gaps(ctx, params, run: ServeRun, prec=FP32, pick=None) -> list:
    """Per sampled request, the gap (fp32 logits of the configuration's
    family's reference) by which each served token lies below the
    reference's best. With a lower ``prec`` (the control), the gap of the
    token that ``prec`` puts first instead."""
    fam, gaps = ctx.family, []
    for i, rows in pick or sample(ctx, run):
        b = run.batches[i]
        S, n = b.prompt_len, b.new_tokens
        toks = torch.cat([b.prompts[rows], b.served[rows, :-1]], 1)
        at = torch.arange(S - 1, S - 1 + n, device=toks.device)
        ref = forward_logits(fam, params, ctx.model, toks, at, FP32)
        chosen = b.served[rows]
        if prec is not FP32:
            chosen = forward_logits(fam, params, ctx.model, toks, at, prec).argmax(-1)
        gap = ref.max(-1).values - ref.gather(-1, chosen[..., None])[..., 0]
        gaps.extend(gap.flatten().tolist())
        del ref
    return gaps


def check(ctx, params, run: ServeRun) -> dict:
    gaps = served_gaps(ctx, params, run)
    return {"widest_gap": max(gaps), "served_checked": len(gaps)}
