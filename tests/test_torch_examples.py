"""The port's examples (``examples/torch/``) against the reference's
(``examples/``), each run as a script in a subprocess.

- The four planner twins (``quickstart.py``, ``rag_workflow.py``,
  ``doc_ingest.py``, ``video_understanding.py`` without ``--real``) print
  what the reference scripts print, byte for byte: the port's runtime is
  the reference's (``tests/test_torch_core.py``).
- The model twins run with ``--device cpu`` and exit 0 (their asserts
  included): ``video_understanding.py --real``, ``serve_workflow.py`` (its
  ``[murakkab]`` line the reference script's), ``train_lm.py`` at its
  defaults (the loss falls across a checkpoint and resume) and
  ``fault_tolerance_demo.py`` (its straggler and remesh lines the
  reference's, built from ``repro.runtime.fault_tolerance`` as the reference
  script builds them: that script trains into a fixed checkpoint directory
  outside the checkout, so it is not run here).
- Without ``--device`` a model twin asks for the card, so on a machine with
  none it raises and runs nothing on the CPU.
- No twin loads ``jax`` or ``repro``: each runs under a wrapper that reports
  the child's ``sys.modules`` on its standard error.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
PLANNERS = ("quickstart.py", "rag_workflow.py", "doc_ingest.py",
            "video_understanding.py")
# a model twin's name -> its arguments on the CPU (the reference script's
# where its lines are compared)
MODEL_RUNS = {
    "video_understanding.py": ["--real"],
    "serve_workflow.py": ["--requests", "4", "--max-new", "4"],
    "train_lm.py": [],
    "fault_tolerance_demo.py": [],
}
# the reference's lines that each model twin must print as they are
REFERENCE_LINES = {"serve_workflow.py": ("[murakkab] ",),
                   "fault_tolerance_demo.py": ("stragglers flagged: ",
                                               "remesh after losing ")}
# examples/fault_tolerance_demo.py's straggler and remesh lines, from the
# same calls on the same records
REFERENCE_FT = """
from repro.runtime.fault_tolerance import StragglerMonitor, plan_remesh
mon = StragglerMonitor(threshold=1.5)
for i in range(10):
    for w in ("w0", "w1", "w2", "w3"):
        mon.record(w, 1.0 if w != "w3" else 2.5)
print(f"stragglers flagged: {mon.stragglers()} "
      f"-> action: {mon.action('w3')}")
plan = plan_remesh((2, 16, 16), ("pod", "data", "model"),
                   devices_available=448)
print(f"remesh after losing 64/512 devices: {plan.old_shape} -> "
      f"{plan.new_shape} (uses {plan.devices_used}; resharded axes: "
      f"{plan.resharded_axes}; per-device batch x{plan.batch_scale:.2f})")
"""
# the restart line's start that the demo's two injected failures (steps 7
# and 13) and its 20 steps fix; the losses after it are the port's
SURVIVED = "survived 2 injected failures; completed 20 steps; "
# what a twin's child reports: the modules of these packages it loaded
WRAPPER = """
import json, os, runpy, sys
path = sys.argv[1]
sys.argv = sys.argv[1:]
sys.path[0] = os.path.dirname(os.path.abspath(path))
try:
    runpy.run_path(path, run_name="__main__")
finally:
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    sys.stderr.write("\\nLOADED " + json.dumps(loaded) + "\\n")
"""


def _run(cmd, env=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **(env or {}))
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=TIMEOUT_S)
    return proc.returncode, proc.stdout, proc.stderr


def _twin(name, *args, env=None):
    return _run([sys.executable, "-c", WRAPPER,
                 f"examples/torch/{name}", *args], env)


def _reference(name, *args):
    return _run([sys.executable, f"examples/{name}", *args])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run, at most four at a time: (kind, name) -> (code, stdout,
    stderr). The CPU runs write their checkpoints under a temporary
    directory of their own."""
    tmp = str(tmp_path_factory.mktemp("examples"))
    jobs = {("reference", n): (_reference, (n,)) for n in PLANNERS}
    jobs.update({("twin", n): (_twin, (n,)) for n in PLANNERS})
    jobs.update({("cpu", n): (lambda n, a: _twin(n, *a, "--device", "cpu",
                                                 env={"TMPDIR": tmp}),
                              (n, args)) for n, args in MODEL_RUNS.items()})
    jobs.update({("no_device", n): (lambda n, a: _twin(
        n, *a, env={"CUDA_VISIBLE_DEVICES": "", "TMPDIR": tmp}), (n, args))
        for n, args in MODEL_RUNS.items()})
    jobs[("reference_model", "serve_workflow.py")] = (
        _reference, ("serve_workflow.py", *MODEL_RUNS["serve_workflow.py"]))
    jobs[("reference_model", "fault_tolerance_demo.py")] = (
        _run, ([sys.executable, "-c", REFERENCE_FT],))
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(fn, *a) for k, (fn, a) in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def _loaded(stderr) -> list:
    lines = [ln for ln in stderr.splitlines() if ln.startswith("LOADED ")]
    assert lines, stderr[-2000:]
    return json.loads(lines[-1][len("LOADED "):])


def _line(stdout, start) -> str:
    found = [ln for ln in stdout.splitlines() if ln.startswith(start)]
    assert len(found) == 1, (start, stdout[-2000:])
    return found[0]


@pytest.mark.parametrize("name", PLANNERS)
def test_planner_twin_prints_the_reference_scripts_output(runs, name):
    """Byte for byte, on the standard output; both exit 0."""
    ref_code, want, ref_err = runs[("reference", name)]
    code, got, err = runs[("twin", name)]
    assert ref_code == 0, ref_err[-2000:]
    assert code == 0, err[-2000:]
    assert want and got == want


@pytest.mark.parametrize("name", list(MODEL_RUNS))
def test_model_twin_runs_on_the_cpu(runs, name):
    """``--device cpu`` at the sizes of MODEL_RUNS: exit 0, every assert of
    the script passed, and the lines the reference script also prints
    equal to its."""
    code, out, err = runs[("cpu", name)]
    assert code == 0, err[-3000:]
    if name == "video_understanding.py":
        assert "summaries identical: True" in out
    elif name == "train_lm.py":
        assert _line(out, "OK: loss ")
        assert "[train] resumed from step 30" in out
    elif name == "fault_tolerance_demo.py":
        assert _line(out, "survived ").startswith(SURVIVED)
    if name in REFERENCE_LINES:
        ref_code, ref_out, ref_err = runs[("reference_model", name)]
        assert ref_code == 0, ref_err[-2000:]
        for start in REFERENCE_LINES[name]:
            got, want = _line(out, start), _line(ref_out, start)
            assert got == want, (got, want)


@pytest.mark.parametrize("name", list(MODEL_RUNS))
def test_model_twin_without_a_device_asks_for_the_card(runs, name):
    """With no ``--device`` on a machine without a card the twin raises
    ``resolve_device``'s error before any work: nothing runs on the CPU
    (the child sees no card, whatever this machine has)."""
    code, out, err = runs[("no_device", name)]
    assert code != 0
    assert "no CUDA device is available" in err, err[-2000:]
    assert "[train]" not in out and "[serve]" not in out and \
        "[murakkab]" not in out


@pytest.mark.parametrize("kind,name", [("twin", n) for n in PLANNERS] +
                         [(k, n) for k in ("cpu", "no_device")
                          for n in MODEL_RUNS])
def test_twin_loads_neither_jax_nor_repro(runs, kind, name):
    assert _loaded(runs[(kind, name)][2]) == []
