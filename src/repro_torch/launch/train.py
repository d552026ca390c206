"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro.launch.train``: the fault-tolerant training loop
(checkpoint/restart, straggler monitor, auto-resume from ``--ckpt-dir``) for
any architecture of the registry, with the reference's flags. ``--reduced``
(the default, as in the reference) takes the small test config; ``--full``
the published one. It runs on the card unless ``--device cpu`` asks for the
CPU. On the card a reduced config takes attention heads that the flash
kernels take (``launch/card.py``), and says so on its first line; every
family's step takes its gradients through the hand-written backward kernels
(flash attention, grouped GEMM, SSD scan).

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
        --device cpu --steps 20 --batch 4 --seq 64 --ckpt-dir ckpt/deepseek

``--mesh data,model --mesh-shape 2,2`` runs the sharded train step
(``runtime.train.jit_train_step``), one process per device, in the process
group that ``torchrun`` describes in the environment (gloo with ``--device
cpu``, NCCL on the cards, each process on the card of its local rank):

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch deepseek-moe-16b --reduced --device cpu --mesh data,model \\
        --mesh-shape 2,2 --steps 4

A process group that is already initialized is used as it is.
"""
from __future__ import annotations

import argparse
import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist

from .._bridge import resolve_device
from ..checkpointing.manager import CheckpointManager
from ..configs.registry import ARCH_IDS, get_config
from ..data.pipeline import DataConfig, DataIterator
from ..models.model_zoo import build_model
from ..optim.adamw import AdamWConfig
from ..runtime import train as train_rt
from .card import launch_config
from .mesh import make_mesh

GROUP_TIMEOUT = datetime.timedelta(seconds=120)
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

    device = resolve_device(args.device)
    mesh, owns_group = None, False
    if args.mesh:
        axes = tuple(args.mesh.split(","))
        shape = tuple(int(x) for x in args.mesh_shape.split(","))
        if not dist.is_initialized():
            dist.init_process_group("gloo" if device.type == "cpu" else "nccl",
                                    timeout=GROUP_TIMEOUT)
            owns_group = True
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        mesh = make_mesh(shape, axes, device_type=device.type)
    try:
        return _run(args, device, mesh)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(args, device, mesh) -> dict:
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = launch_config(get_config(args.arch, reduced=args.reduced),
                        reduced=args.reduced, device=device, tag="train",
                        say=say)
    model = build_model(cfg)
    opts = train_rt.TrainOptions(
        remat_policy=args.remat, microbatches=args.microbatches,
        opt=AdamWConfig(lr=args.lr, moment_dtype=args.moment_dtype),
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps)

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = train_rt.init_train_state(model, gen, opts)
    if mesh is not None:
        state = train_rt.distribute_train_state(state, model, mesh, opts)
        batch_abs = {name: torch.empty((args.batch, args.seq), device="meta")
                     for name in ("tokens", "labels")}
        step_fn = train_rt.jit_train_step(model, opts, mesh, batch_abs)
    else:
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
        say(f"[train] resumed from step {at}")

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
        policy=RestartPolicy(max_failures=3), log=say)
    dt = time.time() - t0
    if not history:
        say(f"[train] {args.arch}: nothing to do, the checkpoint is at "
            f"step {int(state['step'])} of {args.steps}")
        return {"loss_first": None, "loss_last": None, "steps": 0,
                "failures": failures}
    losses = [h["loss"] for h in history]
    where = f"{device}" if mesh is None else \
        f"a {'x'.join(map(str, mesh.shape))} mesh of {device.type}"
    say(f"[train] {args.arch} on {where}: {len(history)} steps in "
        f"{dt:.1f}s ({dt / len(history):.2f}s/step)  "
        f"loss {losses[0]:.3f} -> {losses[-1]:.3f}  "
        f"failures survived: {failures}")
    return {"loss_first": losses[0], "loss_last": losses[-1],
            "steps": len(history), "failures": failures}


if __name__ == "__main__":
    main()
