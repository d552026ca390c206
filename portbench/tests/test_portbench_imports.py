"""What the benchmark runs loads neither JAX nor the JAX package, and the
plain reference nothing of the program; without a card ``run.py`` prints no
result."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
RUN = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", RUN, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_or_reference_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    if "reference" in path.parts:
        assert "repro_torch" not in tops


def test_a_run_loads_no_jax():
    """Import every module a run imports, the program's with them, and look."""
    names = [m["name"] for m in
             json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]]
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "from portbench import harness, serve, train\n"
            "from portbench.reference import lowp\n"
            "import repro_torch.models.model_zoo, repro_torch.runtime.serve\n"
            "import repro_torch.runtime.train\n"
            f"for m in {names!r}: harness.reader(m)\n"
            "print(harness.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "ds7b.agent_turn", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
