"""Fault-tolerance demo on the port: injected node failures, straggler
mitigation and elastic remesh planning, the machinery a 1000-node
deployment leans on.

    PYTHONPATH=src python examples/torch/fault_tolerance_demo.py
    PYTHONPATH=src python examples/torch/fault_tolerance_demo.py --device cpu

The twin of ``examples/fault_tolerance_demo.py`` on ``repro_torch`` (it
loads neither ``jax`` nor ``repro``), training on ``--device``: the card
unless ``--device cpu`` asks for the CPU. The model is reduced deepseek-7b,
on the card with attention heads that the flash kernels take
(``repro_torch.launch.card``). Its weights come from a seeded
``torch.Generator``: the reference's ``jax.random`` draws cannot be
reproduced without JAX, so the losses are not the reference's; the
straggler and remesh lines are.
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import torch

from repro_torch._bridge import resolve_device
from repro_torch.checkpointing.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.launch.card import launch_config
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import train as train_rt
from repro_torch.runtime.fault_tolerance import (RestartPolicy, StragglerMonitor,
                                                 plan_remesh, run_with_restarts)

CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_ft_demo")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu must be asked for)")
    device = resolve_device(ap.parse_args().device)
    shutil.rmtree(CKPT, ignore_errors=True)
    cfg = launch_config(get_config("deepseek-7b", reduced=True), reduced=True,
                        device=device, tag="train")
    model = build_model(cfg)
    opts = train_rt.TrainOptions(remat_policy=None)
    state = train_rt.init_train_state(
        model, torch.Generator(device=device).manual_seed(0), opts)
    step = train_rt.build_train_step(model, opts)
    data = DataIterator(DataConfig(cfg.vocab_size, 32, 4), model_cfg=cfg,
                        device=device)
    ckpt = CheckpointManager(CKPT, keep=2, async_save=False)

    # inject two failures (a preemption at step 7 and a crash at step 13)
    injected = {7, 13}

    def fail_hook(s):
        if s in injected:
            injected.discard(s)
            raise RuntimeError(f"injected node failure at step {s}")

    state, hist, failures = run_with_restarts(
        num_steps=20, state=state, data_iter=data, step_fn=step,
        ckpt_manager=ckpt, save_every=5,
        policy=RestartPolicy(max_failures=5), fail_hook=fail_hook, log=print)
    print(f"\nsurvived {failures} injected failures; "
          f"completed {int(state['step'])} steps; "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

    # straggler mitigation policy
    mon = StragglerMonitor(threshold=1.5)
    for i in range(10):
        for w in ("w0", "w1", "w2", "w3"):
            mon.record(w, 1.0 if w != "w3" else 2.5)   # w3 lags
    print(f"stragglers flagged: {mon.stragglers()} "
          f"-> action: {mon.action('w3')}")

    # elastic remesh: lose 64 of 512 devices
    plan = plan_remesh((2, 16, 16), ("pod", "data", "model"),
                       devices_available=448)
    print(f"remesh after losing 64/512 devices: {plan.old_shape} -> "
          f"{plan.new_shape} (uses {plan.devices_used}; resharded axes: "
          f"{plan.resharded_axes}; per-device batch x{plan.batch_scale:.2f})")


if __name__ == "__main__":
    main()
