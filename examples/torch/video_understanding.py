"""The paper's full evaluation workflow (Fig. 3) on the port, baseline vs
Murakkab.

    PYTHONPATH=src python examples/torch/video_understanding.py          # simulate
    PYTHONPATH=src python examples/torch/video_understanding.py --real   # on the card
    PYTHONPATH=src python examples/torch/video_understanding.py --real --device cpu

The twin of ``examples/video_understanding.py`` on ``repro_torch`` (it
loads neither ``jax`` nor ``repro``). Without ``--real`` the port's planner
and simulator run on the host and print what the reference script prints,
byte for byte. ``--real`` executes every agent as actual PyTorch work
(``repro_torch.core.executor.RealExecutor``) on ``--device``, the card
unless ``--device cpu`` asks for the CPU: the models at full width on the
card, reduced on the CPU, as the executor defaults. It checks the paper's
claim that baseline and Murakkab produce identical outputs: the
configurations differ only in *where/how* agents run, never in *what* they
compute. The weights and media come from seeded ``torch.Generator``\\ s, as
the executor draws them; the reference's ``jax.random`` draws cannot be
reproduced without JAX, so the outputs are not the reference script's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import torch

from repro_torch._bridge import resolve_device
from repro_torch.core import MIN_COST, Murakkab
from repro_torch.core.executor import Media, RealExecutor
from repro_torch.configs.workflow_video import (PAPER_VIDEOS,
                                                make_baseline_workflow,
                                                make_declarative_job)


def simulate():
    base_sys = Murakkab.paper_cluster()
    base = make_baseline_workflow().execute(base_sys, inputs=PAPER_VIDEOS)
    print("== BASELINE (paper Listing 1: pinned, sequential) ==")
    print(base.trace_str())

    mur_sys = Murakkab.paper_cluster()
    mur_sys.prewarm("nvlm-72b", "gpu", 8)
    mur_sys.prewarm("nvlm-embed", "gpu", 2)
    mur_sys.prewarm("whisper-large", "gpu", 1)
    res = make_declarative_job(MIN_COST).execute(mur_sys)
    print("\n== MURAKKAB (MIN_COST) ==")
    print(res.trace_str())
    print(f"\nspeedup {base.makespan_s / res.makespan_s:.2f}x (paper ~3.4x); "
          f"energy efficiency {base.energy_wh / res.energy_wh:.2f}x "
          f"(paper ~4.5x)")


def real(device):
    device = resolve_device(device)
    media = [Media.synthesize(v.name, v.scenes, v.frames_per_scene, seed=i,
                              device=device)
             for i, v in enumerate(PAPER_VIDEOS)]

    # Murakkab plan
    sys_m = Murakkab.paper_cluster()
    dag_m, plan_m = sys_m.plan(make_declarative_job(MIN_COST))
    out_m = RealExecutor(sys_m.library, device=device).run(dag_m, plan_m, media)

    # baseline plan (pinned)
    sys_b = Murakkab.paper_cluster()
    dag_b, plan_b = sys_b.lower_imperative(make_baseline_workflow(),
                                           PAPER_VIDEOS)
    out_b = RealExecutor(sys_b.library, device=device).run(dag_b, plan_b, media)

    where = "reduced models, CPU" if device.type == "cpu" else \
        f"full-width models, {torch.cuda.get_device_name(device)}"
    print(f"== real execution ({where}) ==")
    for tid, o in out_m.items():
        if tid != "_timings":
            print(f"  {tid:<22s} -> {tuple(o.shape)}")
    summ_m = [v for k, v in out_m.items() if "summar" in k][0]
    summ_b = [v for k, v in out_b.items() if "summar" in k][0]
    same = torch.equal(summ_m, summ_b)
    print(f"\nbaseline and Murakkab summaries identical: {same} "
          f"(paper: 'execution output and accuracy are the same')")
    assert same
    print("timings:", {k: f"{v:.2f}s" for k, v in out_m["_timings"].items()})


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of --real (default cuda; cpu must be "
                         "asked for)")
    args = ap.parse_args()
    if args.real:
        real(args.device)
    else:
        simulate()
