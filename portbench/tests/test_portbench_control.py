"""The control of each cell's check read on the card at the cell's own
size: the fp8 reference in the program's place must fail the cell's
limits on one number at least, and the program pass them all."""
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control is read on a CUDA card")
    from portbench import control, harness
    got = control.readings(cell, 2**31 + 2024, 0.0)
    limit = harness.limits(cell)
    assert all(got["program"][k] <= v for k, v in limit.items()), got
    assert any(got["control"][k] > v for k, v in limit.items()), got
