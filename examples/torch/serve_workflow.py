"""End-to-end example on the port (the paper's kind = serving): batched
request serving of a small zoo model, scheduled by Murakkab on the
TPU-cluster model.

1. Murakkab receives a stream of QA jobs (declarative),
2. plans them onto the shared TPU cluster model (warm instances multiplex),
3. and serves the actual generations with a real PyTorch model on
   ``--device``: the card unless ``--device cpu`` asks for the CPU.

    PYTHONPATH=src python examples/torch/serve_workflow.py --requests 12
    PYTHONPATH=src python examples/torch/serve_workflow.py --device cpu

The twin of ``examples/serve_workflow.py`` on ``repro_torch`` (it loads
neither ``jax`` nor ``repro``), with its arguments and defaults. Step 2 is
the reference's planner call on a modelled cluster, not the card, and its
``[murakkab]`` line is the reference script's. The model is the reduced
config, on the card with attention heads that the flash kernels take
(``repro_torch.launch.card``). Its weights come from a seeded
``torch.Generator``: the reference's ``jax.random`` draws cannot be
reproduced without JAX, so the generations are not the reference's.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import numpy as np
import torch

from repro_torch._bridge import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.core import Job, MIN_LATENCY, Murakkab
from repro_torch.launch.card import launch_config
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.serve import ServeOptions, ServeSession


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # --- 1) Murakkab schedules the request stream on the cluster model ------
    system = Murakkab.tpu_cluster(v5e=64, v5p=0, v4_harvest=0, host_cores=64)
    jobs = {
        f"req{i}": (Job(description=f"Answer the user question #{i} over "
                        "the indexed summaries",
                        tasks=(f"Answer question {i} from retrieved context",),
                        constraints=MIN_LATENCY, quality_floor=0.8), i * 0.5)
        for i in range(args.requests)}
    report = system.execute_many(jobs)
    warm = sum(1 for e in report.trace if e.note == "warm")
    print(f"[murakkab] {args.requests} QA jobs: makespan "
          f"{report.makespan_s:.1f}s, energy {report.energy_wh:.2f}Wh, "
          f"warm-instance hits {warm}/{len(report.trace)}")

    # --- 2) real batched serving of the generations --------------------------
    cfg = launch_config(get_config(args.arch, reduced=True), reduced=True,
                        device=device, tag="serve")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    sess = ServeSession(model, params, opts=ServeOptions(), device=device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    outs = []
    for i in range(0, args.requests, args.batch):
        n = min(args.batch, args.requests - i)
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (n, 24),
                                                dtype=np.int64)).to(device)
        outs.append(sess.generate(prompts, max_new_tokens=args.max_new))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total = args.requests * args.max_new
    print(f"[serve] {args.arch} (reduced) on {device}: {total} tokens in "
          f"{dt:.1f}s ({total / dt:.1f} tok/s) across "
          f"{(args.requests + args.batch - 1) // args.batch} batches")
    print("sample generation:", outs[0][0].cpu().numpy())


if __name__ == "__main__":
    main()
