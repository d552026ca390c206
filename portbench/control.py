"""The control of a cell's check, read on the card: the plain reference
computed one precision below the configuration's (``reference/lowp.py``)
put in the program's place, beside the program's own readings, seed by
seed in one process.

    python3 portbench/control.py --workload ds7b.agent_turn --seeds 11 12 13 --seconds 0

Each seed runs the cell as a benchmark run does (set-up, a window of at
least one whole cycle or step, the check) and then reads the control on
the same requests or steps. One JSON line a seed: the program's numbers
and the control's, under the check's names. ``--fault <name>`` reads the
numbers of the program with one of ``faults.py``'s faults planted instead.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(name: str, seed: int, seconds: float, device="cuda", fault=None,
             conf=None, mix=None) -> dict:
    """The program's and the control's numbers for one seed; with ``fault``
    (a name in ``faults.py``) the numbers of the program with that fault
    planted, and no control. ``conf`` and ``mix`` stand in for the cell's
    own (the tests' tiny sizes)."""
    from portbench import faults, harness, serve, train
    from portbench.reference.lowp import FP8
    planted = {**faults.SERVE, **faults.TRAIN}[fault] if fault else None
    ctx, got = harness.drive(name, seed, seconds, False, started=time.perf_counter(),
                             device=device, fault=planted, conf=conf, mix=mix)
    if fault:
        return {"workload": name, "seed": seed, "fault": fault, "program": got["checks"]}
    if ctx.mix["kind"] == "serve":
        pick = serve.sample(ctx, got["run"])
        control = {"widest_gap": max(serve.served_gaps(ctx, got["params"], got["run"],
                                                       FP8(), pick))}
    else:
        control = train.gaps(train.reference_readings(ctx, got["specs"], FP8()),
                             got["ref"])
    return {"workload": name, "seed": seed, "program": got["checks"],
            "control": control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--fault", default=None,
                    help="read the numbers of the program with this fault planted")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds, fault=args.fault)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
