"""The dry-run on meshes: the production meshes (16 x 16, 2 x 16 x 16) in a
subprocess, so that no pytest worker keeps their fake group; the dry-run's
census on a fake (2, 2) group against a real run of the same steps on four
gloo ranks (``tests/_torch_dryrun_ranks.py``); a weight moved from a (data)
store to a (pod, data) use on those ranks; a train step's gradients with
each layer gathered when it runs against each group gathered whole, on
those ranks; no weight move at a stacked group's site carrying more than
one layer; and the serving rules' decode, which moves no weight."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_dryrun_ranks as rank_side  # noqa: E402

from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime.sharding import MeshShape  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT_S = 600

# the reference's record keys whose meaning carries over, and those the
# port adds; it drops the XLA artifacts (v2_*, scan_cost_raw, compile_s and
# total_s, the lowering plus the compile)
REFERENCE_KEYS = {"arch", "shape", "mesh", "kind", "ok", "serving_rules",
                  "lower_s", "flops_per_device", "hbm_bytes_per_device",
                  "collective_bytes_per_device", "collectives", "memory",
                  "params_total", "params_active", "global_batch", "seq_len"}
ADDED_KEYS = {"kernel_io", "kernel_calls", "peak_bytes_per_device",
              "fits_80gb"}
XLA_KEYS = {"v2_bytes_per_device", "v2_bytes_outer", "v2_bytes_alldepth",
            "v2_kernel_io", "v2_collective_bytes_per_device", "v2_collectives",
            "scan_cost_raw", "compile_s", "total_s"}
PRODUCTION_CELLS = [("deepseek-7b", "train_4k", False, False),
                    ("kimi-k2-1t-a32b", "decode_32k", True, True)]

_PRODUCTION = """
import json, sys
from repro_torch.launch.dryrun import run_cell
print(json.dumps([run_cell(a, s, multi_pod=mp, serving_rules=sr, verbose=False)
                  for a, s, mp, sr in {cells!r}]))
"""


@pytest.fixture(scope="module")
def production():
    proc = subprocess.run(
        [sys.executable, "-c", _PRODUCTION.format(cells=PRODUCTION_CELLS)],
        capture_output=True, text=True, timeout=RUN_TIMEOUT_S, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_reference_keys_are_the_reference_records():
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    for key in REFERENCE_KEYS | XLA_KEYS - {"total_s"}:
        assert f"{key}=" in src or f'"{key}"' in src, key


@pytest.mark.parametrize("i", range(len(PRODUCTION_CELLS)),
                         ids=[f"{a}-{s}" for a, s, *_ in PRODUCTION_CELLS])
def test_production_cells_reach_ok(production, i):
    arch, shape, multi_pod, serving = PRODUCTION_CELLS[i]
    rec = production[i]
    assert rec["ok"] and rec["arch"] == arch and rec["shape"] == shape
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert set(rec) == REFERENCE_KEYS | ADDED_KEYS
    assert rec["serving_rules"] == serving
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    assert rec["flops_per_device"] > 0 and rec["collective_bytes_per_device"] > 0
    assert rec["peak_bytes_per_device"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["collective_bytes_per_device"] == sum(
        c["bytes"] for c in rec["collectives"].values())
    model = build_model(get_config(arch))
    assert rec["params_total"] == model.param_count()
    assert rec["params_active"] == model.active_param_count()


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ranks")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_dryrun_ranks.py"), str(out)],
        capture_output=True, text=True, timeout=RUN_TIMEOUT_S, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]


@pytest.mark.parametrize("case", list(rank_side.CASES))
def test_dry_run_census_equals_a_gloo_run(gloo_ranks, case):
    """Rank 0's census of the real step on four gloo ranks of a (2, 2)
    mesh, and the dry-run's on a fake group of that mesh: every collective
    (op, group size, bytes, shape, issuing site) in order, FLOPs,
    materialized bytes and kernel calls alike."""
    cfg, cell, rules, opts_over = rank_side.case_config(case)
    trace = dryrun.lower_cell(cfg, cell, MeshShape(("data", "model"),
                                                   rank_side.MESH),
                              rules=rules, opts_over=opts_over)
    real, meta = gloo_ranks[0][case], trace.census.summary()
    assert trace.census.collectives == real["collective_list"]
    assert real["collective_list"]
    for key in ("flops", "materialized_bytes", "kernel_calls", "kernel_io",
                "collectives"):
        assert meta[key] == real[key], key


def test_a_pod_data_use_block_moves_on_gloo(gloo_ranks):
    """``collectives.to_use`` from a store split over data to a use split
    jointly over (pod, data) on a (2, 2, 1) mesh: every rank's block, and
    its stored shard's gradient, as numpy has them."""
    assert [r["joint"] for r in gloo_ranks] == [
        {"block_ok": True, "grad_ok": True}] * 4


@pytest.mark.parametrize("arch", list(rank_side.LAYER_GATHER_CASES))
def test_per_layer_gather_gives_the_whole_group_gathers_gradients(
        gloo_ranks, arch):
    """On four gloo ranks of a (2, 2) mesh, a train step's gradients with
    each layer's weights moved to their use blocks when it runs equal
    those with each stacked group moved whole first (the port's move
    before it went per layer), on every rank, bitwise: the same sums in
    the same order."""
    for rank in gloo_ranks:
        got = rank["layer_gather"][arch]
        assert got == {"worst": 0.0, "bitwise": True}, got


_LAYER_CELLS = [("zamba2-7b", "decode_32k"), ("mamba2-370m", "train_4k")]
_LAYERS = """
import json
from repro_torch.configs.base import SHAPE_CELLS
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh_shape
out = {{}}
for arch, shape in {cells!r}:
    trace = dryrun.lower_cell(get_config(arch), SHAPE_CELLS[shape],
                              production_mesh_shape(multi_pod=False))
    out[arch + "/" + shape] = trace.census.collectives
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def layer_cells():
    proc = subprocess.run(
        [sys.executable, "-c", _LAYERS.format(cells=_LAYER_CELLS)],
        capture_output=True, text=True, timeout=RUN_TIMEOUT_S, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", _LAYER_CELLS)
def test_no_weight_move_at_a_group_site_carries_more_than_a_layer(
        layer_cells, arch, shape):
    """On the fake 16 x 16 group, every all-gather, reduce-scatter or
    all-to-all issued at a stacked weight's site (``groups/...``) moves
    one layer's block: its shape drops the ``layers`` dim, and it holds
    no more than one layer's elements. zamba2-7b's decode gathers each
    Mamba2 block's in_proj and conv weights a layer at a time (13 and 81
    layers before, [3584, 13, 14704] at once)."""
    specs = dict((("/".join(p), s) for p, s in
                  leaves_with_path(build_model(get_config(arch)).specs)))
    moves = [c for c in layer_cells[f"{arch}/{shape}"]
             if c["site"].startswith("groups/") and c["site"] in specs
             and c["op"] in ("all-gather", "reduce-scatter", "all-to-all")]
    assert moves
    for c in moves:
        layer = specs[c["site"]].shape[1:]
        assert len(c["shape"]) == len(layer), c
        assert math.prod(c["shape"]) <= math.prod(layer), c


def _weight_gathers(trace, cfg) -> list:
    params = {"/".join(p) for p, _ in leaves_with_path(build_model(cfg).specs)}
    return [c for c in trace.census.collectives
            if c["op"] == "all-gather" and c["site"] in params]


def test_the_serving_rules_decode_moves_no_weight():
    """Under ``--serving-rules`` a decode step issues no weight all-gather
    (dense weights TP-only, experts EP x TP); under the default rules the
    FSDP-split embed dims are gathered on use."""
    cfg = rank_side.case_config("moe_decode")[0]
    cell = ShapeCell("decode", 64, 4, "decode")
    mesh = MeshShape(("data", "model"), (2, 2))
    rules, opts_over = dryrun.serving_options(cell)
    assert rules == dict(shd.SERVING_RULES) and opts_over == {
        "expert_tp": True, "moe_capacity_cap": 4}
    served = dryrun.lower_cell(cfg, cell, mesh, rules=rules, opts_over=opts_over)
    assert not _weight_gathers(served, cfg)
    assert served.census.collectives
    default = dryrun.lower_cell(cfg, cell, mesh)
    assert _weight_gathers(default, cfg)
