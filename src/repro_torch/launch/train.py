"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro.launch.train``: the fault-tolerant training loop
(checkpoint/restart, straggler monitor, auto-resume from ``--ckpt-dir``) for
any architecture of the registry, with the reference's flags. ``--reduced``
(the default, as in the reference) takes the small test config; ``--full``
the published one. It runs on the card unless ``--device cpu`` asks for the
CPU. On the card every family's step takes its gradients through the
hand-written backward kernels (flash attention, grouped GEMM, SSD scan).

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
        --device cpu --steps 20 --batch 4 --seq 64 --ckpt-dir ckpt/deepseek

``--mesh`` (a sharded run) is ROADMAP.md A11 and raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from .._bridge import resolve_device
from ..checkpointing.manager import CheckpointManager
from ..configs.registry import ARCH_IDS, get_config
from ..data.pipeline import DataConfig, DataIterator
from ..models.model_zoo import build_model
from ..optim.adamw import AdamWConfig
from ..runtime import train as train_rt
from ..runtime.fault_tolerance import (RestartPolicy, StragglerMonitor,
                                       run_with_restarts)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None,
                    choices=(None, "full", "dots", "minimal"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--moment-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"))
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--mesh", default="")           # e.g. "data,model"
    ap.add_argument("--mesh-shape", default="")     # e.g. "16,16"
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError(
            "--mesh: the sharded train step is ROADMAP.md A11; the port "
            "trains on one device")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)
    opts = train_rt.TrainOptions(
        remat_policy=args.remat, microbatches=args.microbatches,
        opt=AdamWConfig(lr=args.lr, moment_dtype=args.moment_dtype),
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps)

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = train_rt.init_train_state(model, gen, opts)
    step_fn = train_rt.build_train_step(model, opts)

    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=args.seq,
                                   global_batch=args.batch,
                                   seed=args.seed), model_cfg=cfg,
                        device=device)
    ckpt = CheckpointManager(
        args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                      f"repro_torch_ckpt_{args.arch}"),
        keep=2)
    # auto-resume
    restored, at = ckpt.restore({"state": state, "data": data.state()})
    if restored is not None:
        state = restored["state"]
        data.restore(restored["data"])
        print(f"[train] resumed from step {at}")

    mon = StragglerMonitor()
    t0 = time.time()

    def timed_step(state, batch):
        ts = time.time()
        out = step_fn(state, batch)
        float(out[1]["loss"])       # waits for the device
        mon.record("worker0", time.time() - ts)
        return out

    state, history, failures = run_with_restarts(
        num_steps=args.steps, state=state, data_iter=data,
        step_fn=timed_step, ckpt_manager=ckpt, save_every=args.save_every,
        policy=RestartPolicy(max_failures=3), log=print)
    dt = time.time() - t0
    if not history:
        print(f"[train] {args.arch}: nothing to do, the checkpoint is at "
              f"step {int(state['step'])} of {args.steps}")
        return {"loss_first": None, "loss_last": None, "steps": 0,
                "failures": failures}
    losses = [h["loss"] for h in history]
    print(f"[train] {args.arch} on {device}: {len(history)} steps in "
          f"{dt:.1f}s ({dt / len(history):.2f}s/step)  "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}  "
          f"failures survived: {failures}")
    return {"loss_first": losses[0], "loss_last": losses[-1],
            "steps": len(history), "failures": failures}


if __name__ == "__main__":
    main()
