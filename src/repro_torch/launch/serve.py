"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Batched serving of queued generation requests against a zoo model with random
weights from ``--seed``, through the same ``ServeSession`` path the JAX
launcher drives. Full width on the card by default; ``--reduced`` takes the
small test config and ``--device cpu`` runs on the CPU. Reports throughput
and the median batch latency.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --requests 8 --batch 4 --prompt-len 2048 --max-new 64

``--arch`` takes every architecture of the registry. kimi-k2-1t-a32b,
command-r-plus-104b and llama-3.2-vision-90b run reduced only: at full width
and depth no 80 GB card holds them (``chip_smoke.py`` serves the last two at
full width with their depth cut). The encoder-decoder and the VLM get the
reference's stub frontends: zero frames of the prompt's length, zero
patches of ``vision.num_patches`` (``Model.extra_inputs``). As in the
reference, ``generate`` is greedy whatever ``--temperature`` says.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._bridge import resolve_device
from ..configs.registry import ARCH_IDS, get_config
from ..models.model_zoo import build_model
from ..runtime.serve import ServeOptions, ServeSession


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="deepseek-7b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    sess = ServeSession(model, params,
                        ServeOptions(temperature=args.temperature),
                        device=device)

    rng = np.random.default_rng(args.seed)
    queue = [rng.integers(0, cfg.vocab_size, (args.prompt_len,), dtype=np.int64)
             for _ in range(args.requests)]
    extras = model.extra_inputs(args.batch, args.prompt_len, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    done, lat = 0, []
    sync()
    t0 = time.perf_counter()
    while done < len(queue):
        chunk = queue[done:done + args.batch]
        while len(chunk) < args.batch:     # pad the final batch
            chunk.append(chunk[-1])
        prompts = torch.from_numpy(np.stack(chunk)).to(device)
        ts = time.perf_counter()
        sess.generate(prompts, max_new_tokens=args.max_new, extras=extras)
        sync()
        lat.append(time.perf_counter() - ts)
        done += args.batch
    dt = time.perf_counter() - t0
    toks = args.requests * args.max_new
    p50 = sorted(lat)[len(lat) // 2]
    print(f"[serve] {args.arch} on {device}: {args.requests} reqs, "
          f"{toks / dt:.1f} tok/s, p50 batch latency {p50:.2f}s")
    return {"tok_per_s": toks / dt, "p50_batch_s": p50, "batches": len(lat)}


if __name__ == "__main__":
    main()
