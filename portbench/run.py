"""Run one cell of the benchmark once, on the card it is started on.

    python3 portbench/run.py --workload ds7b.agent_turn --seed 7 --seconds 30 --trace 0

The last line on standard output is the result, one JSON object; the last
lines on standard error are the numbers the check compared, each beside its
limit. Without a CUDA card, or with fewer cards than the cell asks for, it
exits with code 2 and prints no result. It exits with code 3 and prints no
result if the process has loaded ``jax``, ``jaxlib``, ``flax`` or ``repro``
(the JAX package) by the time the window has closed.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".portbench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".portbench_cache" / "torch_extensions"))
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    cell = harness.cell_of(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), started=STARTED)
    found = harness.loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
