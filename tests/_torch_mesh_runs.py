"""The mesh runs that the port's mesh tests read, each a pair started at the
same time from the same inputs, made here:

- ``mesh_runs`` (``tests/test_torch_mesh.py``, ``tests/test_torch_tp.py``):
  the reference on four host devices (``tests/_torch_mesh_ref.py``,
  ``XLA_FLAGS`` set here) and the port as four ranks of a gloo group
  (``tests/_torch_mesh_ranks.py``);
- ``pod_runs`` (``tests/test_torch_pod.py``): the (pod 2, data 2, model 2)
  mesh, the reference on eight host devices (``tests/_torch_pod_ref.py``)
  and the port as eight ranks (``tests/_torch_pod_ranks.py``).

The ranks meet through a ``FileStore`` under the temporary directory, so no
port is opened. The test files may run in different pytest-xdist workers;
each pair of runs is made once for the whole session all the same: the
first worker to ask takes the pair's file lock beside the workers'
temporary directories, runs it and writes what it gave; the others wait on
the lock and read it. Every join has a timeout, so a hang fails the tests
instead of the suite.
"""
import fcntl
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT_S = 900
RANKS = range(4)
POD_RANKS = range(8)
# name -> (the reference's script, the ranks' script, devices)
PAIRS = {"mesh": ("_torch_mesh_ref", "_torch_mesh_ranks", len(RANKS)),
         "pod": ("_torch_pod_ref", "_torch_pod_ranks", len(POD_RANKS))}


def _run(cmd, env, log):
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)


def _make(tmp: Path, pair: str) -> dict:
    ref_name, ranks_name, devices = PAIRS[pair]
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **importlib.import_module(ref_name).make_inputs())
    base = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ranks_dir = tmp / "ranks"
    ranks_dir.mkdir(exist_ok=True)
    procs = {}
    with open(tmp / "ref.log", "w") as ref_log, \
            open(tmp / "ranks.log", "w") as ranks_log:
        procs["reference"] = _run(
            [sys.executable, f"tests/{ref_name}.py", str(inputs),
             str(tmp / "ref.npz")],
            dict(base, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}"),
            ref_log)
        procs["ranks"] = _run(
            [sys.executable, f"tests/{ranks_name}.py", str(inputs),
             str(ranks_dir)], dict(base, OMP_NUM_THREADS="1"), ranks_log)
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


def session_runs(tmp_path_factory, pair: str) -> dict:
    """The pair's outputs: ``ref`` (the reference's npz), ``ranks`` (each
    rank's), ``inputs`` and ``ckpt`` (the sharded checkpoints' directory).
    Raises AssertionError with the logs' tails if a run failed."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent               # shared by the session's workers
    tmp = base / f"torch_{pair}_runs"
    with open(base / f"torch_{pair}_runs.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            status = tmp / "status.json"
            if not status.exists():
                tmp.mkdir(exist_ok=True)
                status.write_text(json.dumps(_make(tmp, pair)))
            done = json.loads(status.read_text())
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    assert done["codes"] == {"reference": 0, "ranks": 0}, done
    return {"ref": np.load(tmp / "ref.npz"),
            "ranks": [np.load(tmp / "ranks" / f"rank{r}.npz")
                      for r in range(PAIRS[pair][2])],
            "inputs": np.load(tmp / "inputs.npz"),
            "ckpt": tmp / "ranks" / "ckpt"}


def mesh_runs(tmp_path_factory) -> dict:
    """The (2, 2) and tensor-parallel pair's outputs (``session_runs``)."""
    return session_runs(tmp_path_factory, "mesh")


def pod_runs(tmp_path_factory) -> dict:
    """The (2, 2, 2) pair's outputs (``session_runs``)."""
    return session_runs(tmp_path_factory, "pod")
