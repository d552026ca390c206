"""A train cell: the step of ``repro_torch.runtime.train.build_train_step``
over the synthetic stream, one object from set-up to the window's end.

Set-up builds the state (the benchmark's weights, zero moments) and the
step, and drives them through the mix's ``check_steps`` first steps by the
window's own call and feed; those steps are the warm-up. It reads what the
check compares while the state still holds it: each step's loss, every
leaf's first gradient as the optimizer took it (‖m‖ / (1 - b1) after step
1, the moments being zero before it), and every leaf's change ‖p - p0‖
after the last of those steps (p0 drawn again from the seed, leaf by leaf).
The window then runs whole steps, each ending in a sync, and starts none
after ``--seconds``.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import torch

from . import traffic, weights
from .reference import train as ref_train
from .reference.common import FP32, leaves


@dataclass
class TrainRun:
    steps: list = field(default_factory=list)     # (seconds, tokens)
    window_s: float = 0.0
    peak_bytes: int = 0


def _norm(t, minus=None) -> float:
    """‖t - minus‖ in fp32, one slice of the leading axis at a time."""
    total = 0.0
    for i in range(t.shape[0] if t.dim() >= 3 else 1):
        a = t[i] if t.dim() >= 3 else t
        d = a.float() if minus is None else \
            a.float() - (minus[i] if t.dim() >= 3 else minus).float()
        total += float(torch.sum(d.square()))
    return total ** 0.5


def changes(ctx, specs, params) -> dict:
    """{leaf: ‖p - p0‖}, p0 drawn again from the seed one leaf at a time."""
    now = leaves(params)
    return {"/".join(path): _norm(now["/".join(path)], p0)
            for path, p0 in weights.leaves(specs, ctx.seed, ctx.device, ctx.param_dtype)}


def program_options(mix: dict):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import TrainOptions
    o = mix["opt"]
    return TrainOptions(
        remat_policy=mix["remat"], microbatches=mix["microbatches"],
        opt=AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                        weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
                        moment_dtype=o["moment_dtype"]),
        warmup_steps=o["warmup_steps"], total_steps=o["total_steps"])


def feed(ctx, step: int) -> dict:
    b = traffic.train_batch(ctx.mix, ctx.model["vocab_size"], ctx.seed, step)
    return {k: torch.from_numpy(v).to(ctx.device) for k, v in b.items()}


def run(ctx) -> dict:
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import build_train_step

    mix, device = ctx.mix, ctx.device
    model = build_model(ctx.program_config())
    opts = program_options(mix)
    params = weights.draw(model.specs, ctx.seed, device, ctx.param_dtype)
    state = {"params": params, "opt": adamw.init_opt_state(params, opts.opt),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    step_fn = ctx.plant(build_train_step(model, opts))

    seen = {"loss": [], "first_grad": None, "change": None}
    n_check = mix["check_steps"]
    for n in range(n_check):
        state, metrics = step_fn(state, feed(ctx, n))
        seen["loss"].append(float(metrics["loss"]))
        if n == 0:
            b1 = opts.opt.b1
            seen["first_grad"] = {p: _norm(m) / (1 - b1)
                                  for p, m in leaves(state["opt"]["m"]).items()}
    seen["change"] = changes(ctx, model.specs, state["params"])
    ctx.sync()
    ctx.mark_setup()

    out = TrainRun()
    ctx.reset_peak()
    tokens = mix["batch"] * mix["seq_len"]
    traced = mix.get("trace", {}).get("steps", 1)
    t0 = time.perf_counter()
    n = n_check
    while not out.steps or time.perf_counter() - t0 < ctx.seconds:
        if ctx.tracer.on and len(out.steps) == 0:
            ctx.tracer.start()
        batch = feed(ctx, n)
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])                 # the step ends in a sync
        out.steps.append((time.perf_counter() - ts, tokens))
        if ctx.tracer.open and len(out.steps) == traced:
            ctx.tracer.stop()
        n += 1
    out.window_s = time.perf_counter() - t0
    out.peak_bytes = ctx.peak()
    # the program's state is freed before the reference runs, whatever
    # else in the process may still point at it
    for tensor in leaves(state).values():
        tensor.untyped_storage().resize_(0)
    del state, params, metrics, batch
    ctx.free()

    ref = reference_readings(ctx, model.specs)
    return {"run": out, "checks": gaps(seen, ref), "attempted": len(out.steps),
            "failed": 0, "end_to_end": end_to_end(out), "seen": seen, "ref": ref,
            "specs": model.specs}


def end_to_end(run: TrainRun) -> dict:
    return {"train_tok_s": sum(t for _, t in run.steps) / sum(s for s, _ in run.steps),
            "peak_mem_gb": run.peak_bytes / 1e9}


def reference_readings(ctx, specs, prec=FP32) -> dict:
    """The reference's (or the control's) loss of each check step, first
    gradients and changes, from the seed's weights and batches, by the
    configuration's family's pieces."""
    params = weights.draw(specs, ctx.seed, ctx.device, ctx.param_dtype)
    batches = [(b["tokens"], b["labels"]) for b in
               (feed(ctx, n) for n in range(ctx.mix["check_steps"]))]
    got = ref_train.train_steps(ctx.family, params, ctx.model, batches,
                                {**ctx.mix["opt"]}, prec)
    got["change"] = changes(ctx, specs, params)
    return got


def gaps(seen: dict, ref: dict) -> dict:
    """The compared numbers: the worst relative loss gap over the steps;
    the worst leaf's gap of first-gradient norms and of change norms, each
    over the larger of that leaf's and the median leaf's reference norm.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(seen["loss"], ref["loss"]))
    g_ref = ref["first_grad"]
    g_med = statistics.median(g_ref.values())
    grad = max(abs(seen["first_grad"][p] - g) / max(g, g_med) for p, g in g_ref.items())
    moving = [p for p, g in g_ref.items() if g >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][p] for p in moving)
    change = max(abs(seen["change"][p] - ref["change"][p]) / max(ref["change"][p], c_med)
                 for p in moving)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "leaves_left_out": len(g_ref) - len(moving)}
