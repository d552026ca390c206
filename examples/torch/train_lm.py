"""Training example on the port: train a small LM end-to-end with the full
substrate (data pipeline -> AdamW -> checkpoint/restart -> straggler
monitor), then resume from the checkpoint to prove deterministic restart.

    PYTHONPATH=src python examples/torch/train_lm.py --steps 60
    PYTHONPATH=src python examples/torch/train_lm.py --device cpu

The twin of ``examples/train_lm.py`` on ``repro_torch.launch.train`` (it
loads neither ``jax`` nor ``repro``), with its arguments and defaults, on
``--device``: the card unless ``--device cpu`` asks for the CPU. The model
is the reduced config, on the card with attention heads that the flash
kernels take (``repro_torch.launch.card``). Its weights come from a seeded
``torch.Generator``: the reference's ``jax.random`` draws cannot be
reproduced without JAX, so the losses are not the reference's.
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch._bridge import resolve_device
from repro_torch.launch.train import main as train_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args()
    device = str(resolve_device(args.device))

    ckpt = os.path.join(tempfile.gettempdir(),
                        f"repro_torch_example_ckpt_{args.arch}")
    shutil.rmtree(ckpt, ignore_errors=True)

    common = ["--arch", args.arch, "--batch", str(args.batch),
              "--seq", str(args.seq), "--lr", "1e-3", "--ckpt-dir", ckpt,
              "--save-every", "10", "--device", device]
    # phase 1: half the run
    half = args.steps // 2
    r1 = train_main(["--steps", str(half), *common])
    # phase 2: resume to the full step count (auto-restores the checkpoint)
    r2 = train_main(["--steps", str(args.steps), *common])
    assert r2["loss_last"] < r1["loss_first"], "loss must decrease end-to-end"
    print(f"\nOK: loss {r1['loss_first']:.3f} -> {r2['loss_last']:.3f} "
          f"across a checkpoint/resume boundary")


if __name__ == "__main__":
    main()
