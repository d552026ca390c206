"""The mesh runs that ``tests/test_torch_mesh.py`` and ``tests/test_torch_tp.py``
read: the reference on four host devices (``tests/_torch_mesh_ref.py``,
``XLA_FLAGS`` set there) and the port as four ranks of a gloo group
(``tests/_torch_mesh_ranks.py``, a ``FileStore`` under the temporary
directory, so no port is opened), started at the same time from the same
inputs, made here.

The two test files may run in different pytest-xdist workers; the pair of
runs is made once for the whole session all the same: the first worker to
ask takes a file lock beside the workers' temporary directories, runs them
and writes what they gave; the others wait on the lock and read it. Every
join has a timeout, so a hang fails the tests instead of the suite.
"""
import fcntl
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import _torch_mesh_ref as ref_side
import _torch_mesh_ranks as rank_side

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT_S = 900
RANKS = range(4)


def _run(cmd, env, log):
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)


def _make(tmp: Path) -> dict:
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **ref_side.make_inputs())
    base = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ranks_dir = tmp / "ranks"
    ranks_dir.mkdir(exist_ok=True)
    procs = {}
    with open(tmp / "ref.log", "w") as ref_log, \
            open(tmp / "ranks.log", "w") as ranks_log:
        procs["reference"] = _run(
            [sys.executable, "tests/_torch_mesh_ref.py", str(inputs),
             str(tmp / "ref.npz")],
            dict(base, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
            ref_log)
        procs["ranks"] = _run(
            [sys.executable, "tests/_torch_mesh_ranks.py", str(inputs),
             str(ranks_dir)], base, ranks_log)
        codes = {}
        for name, p in procs.items():
            try:
                codes[name] = p.wait(timeout=RUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for q in procs.values():
                    q.kill()
                    q.wait()
                codes[name] = "timed out"
    logs = {n: (tmp / f"{'ref' if n == 'reference' else n}.log").read_text()[-4000:]
            for n in procs}
    return {"codes": codes, "logs": logs}


def mesh_runs(tmp_path_factory) -> dict:
    """The runs' outputs: ``ref`` (the reference's npz), ``ranks`` (each
    rank's), ``inputs`` and ``ckpt`` (the sharded checkpoints' directory).
    Raises AssertionError with the logs' tails if a run failed."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent               # shared by the session's workers
    tmp = base / "torch_mesh_runs"
    with open(base / "torch_mesh_runs.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            status = tmp / "status.json"
            if not status.exists():
                tmp.mkdir(exist_ok=True)
                status.write_text(json.dumps(_make(tmp)))
            done = json.loads(status.read_text())
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    assert done["codes"] == {"reference": 0, "ranks": 0}, done
    return {"ref": np.load(tmp / "ref.npz"),
            "ranks": [np.load(tmp / "ranks" / f"rank{r}.npz") for r in RANKS],
            "inputs": np.load(tmp / "inputs.npz"),
            "ckpt": tmp / "ranks" / "ckpt"}
