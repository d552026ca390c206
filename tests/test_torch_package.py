"""Hygiene of the PyTorch/CUDA port: what it imports, where it runs, what
crosses the bridge, and the on-card script's behaviour without a card."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro_torch import _bridge  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps(bad))
"""


def test_port_imports_neither_jax_nor_repro():
    code = _IMPORT_ALL.format(src=str(ROOT / "src"), root=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


# the mesh path's modules and what each must hold, each imported alone
MESH_MODULES = {
    "repro_torch.runtime.sharding": ("DEFAULT_RULES", "SERVING_RULES", "PRIORITY",
                                     "spec_for_axes", "tree_shardings",
                                     "batch_axes", "data_spec",
                                     "cache_logical_axes", "mesh_axis_size",
                                     "placements"),
    "repro_torch.launch.mesh": ("make_mesh", "make_production_mesh"),
    "repro_torch.optim.compression": ("init_error_state", "compress",
                                      "decompress", "compressed_psum",
                                      "compression_ratio"),
    "repro_torch.collectives": ("all_gather", "all_to_all", "psum", "to_use"),
    "repro_torch.models.moe": ("DistContext", "LOCAL", "_moe_ep_body"),
    "repro_torch.runtime.train": ("make_dist", "abstract_train_state",
                                  "state_shardings", "batch_shardings",
                                  "jit_train_step"),
    "repro_torch.runtime.serve": ("make_dist", "cache_shardings",
                                  "abstract_cache", "jit_prefill_step",
                                  "jit_decode_step"),
    "repro_torch.runtime.fault_tolerance": ("RemeshPlan", "plan_remesh"),
    "repro_torch.census": ("kernel", "collective", "at", "plain_kernel"),
    "repro_torch.launch.op_cost": ("OpCensus", "COLLECTIVES", "_traffic_factor"),
    "repro_torch.launch.dryrun": ("input_specs", "lower_cell", "run_cell",
                                  "save_record", "main"),
    "repro_torch.launch.perf_probe": ("probe", "main"),
}

# the Murakkab runtime's modules and what each must hold, each imported alone
CORE_MODULES = {
    "repro_torch.core": ("Murakkab", "Job", "MIN_COST", "RealExecutor", "Media"),
    "repro_torch.core.dag": ("DAG", "TaskNode"),
    "repro_torch.core.constraints": ("Budget", "Deadline", "Lexicographic",
                                     "Weighted", "as_spec"),
    "repro_torch.core.spec": ("SCENARIOS", "Scenario", "build_node",
                              "input_units"),
    "repro_torch.core.energy": ("CATALOG", "DeviceSpec", "EnergyLedger",
                                "batch_roofline_latency"),
    "repro_torch.core.agents": ("AgentLibrary", "Work", "default_library"),
    "repro_torch.core.profiles": ("CostQuery", "Profile", "ProfileStore"),
    "repro_torch.core.cluster": ("ClusterManager", "Instance", "Pool"),
    "repro_torch.core.admission": ("Admission", "FCFS", "StrictPriority",
                                   "WeightedFair", "get_policy"),
    "repro_torch.core.arrivals": ("PoissonArrivals", "MMPPArrivals",
                                  "SessionArrivals", "TraceArrivals",
                                  "default_mix", "register_preset"),
    "repro_torch.core.faults": ("FaultProfile", "RetryPolicy"),
    "repro_torch.core.scheduler": ("ExecutionPlan", "Scheduler", "TaskConfig"),
    "repro_torch.core.workflow": ("ImperativeWorkflow", "Job", "Workflow",
                                  "VideoInput"),
    "repro_torch.core.orchestrator": ("LLMPlanner", "RulePlanner",
                                      "dag_creation_overhead"),
    "repro_torch.core.engine": ("Engine", "OpenLoopReport", "SimReport",
                                "Submission", "TraceEntry"),
    "repro_torch.core.simulator": ("Simulator", "render_trace"),
    "repro_torch.core.system": ("JobResult", "Murakkab"),
    "repro_torch.core.telemetry": ("TelemetryStore", "TaskRecord", "featurize"),
    "repro_torch.core.router": ("OfflineEvaluator", "Router"),
    "repro_torch.core.autoscale": ("Autoscaler", "PoolPolicy", "ScaleAction"),
    "repro_torch.configs.workflow_video": ("PAPER_VIDEOS",
                                           "calibrate_paper_profiles",
                                           "make_declarative_job",
                                           "make_baseline_workflow"),
    "repro_torch.configs.workflow_rag": ("make_rag_job", "ROUTED_QUERIES"),
    "repro_torch.configs.workflow_docingest": ("make_docingest_job",
                                               "PAPER_DOCS"),
    "repro_torch.configs.workflow_chat": ("make_chat_job", "CHAT_SCENARIO"),
}

_IMPORT_ONE = """
import importlib, json, sys
sys.path[:0] = [{src!r}]
m = importlib.import_module({name!r})
print(json.dumps({{"bad": sorted(n for n in sys.modules
                              if n.split(".")[0] in ("jax", "jaxlib", "repro")),
                  "missing": [a for a in {attrs!r} if not hasattr(m, a)]}}))
"""


def test_mesh_modules_import_neither_jax_nor_repro():
    """Each module of the mesh path, imported alone in a fresh process,
    holds its functions and loads neither ``jax`` nor ``repro``."""
    for name, attrs in MESH_MODULES.items():
        code = _IMPORT_ONE.format(src=str(ROOT / "src"), name=name, attrs=attrs)
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                              text=True, timeout=120, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        assert got == {"bad": [], "missing": []}, (name, got)


@pytest.mark.parametrize("name", sorted(CORE_MODULES))
def test_core_module_imports_neither_jax_nor_repro(name):
    """Each module of the Murakkab runtime, imported alone in a fresh
    process, holds its public names and loads neither ``jax`` nor
    ``repro``."""
    code = _IMPORT_ONE.format(src=str(ROOT / "src"), name=name,
                              attrs=CORE_MODULES[name])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "missing": []}, (name, got)


_PLAN_ALONE = """
import json, sys
sys.path[:0] = [{src!r}]
from repro_torch.configs.workflow_video import make_declarative_job
from repro_torch.core import MIN_COST, Murakkab
r = Murakkab.paper_cluster().execute(make_declarative_job(MIN_COST))
print(json.dumps({{"makespan_s": r.makespan_s.hex(), "energy_wh": r.energy_wh.hex(),
                  "bad": sorted(n for n in sys.modules
                                if n.split(".")[0] in ("jax", "jaxlib", "repro"))}}))
"""


def test_port_plans_the_video_job_alone():
    """In a fresh process that loads neither ``jax`` nor ``repro``, the
    port's ``Murakkab.paper_cluster()`` runs the MIN_COST video job to the
    reference's makespan and energy, bitwise."""
    from repro.configs.workflow_video import make_declarative_job
    from repro.core import MIN_COST, Murakkab
    proc = subprocess.run([sys.executable, "-c",
                           _PLAN_ALONE.format(src=str(ROOT / "src"))],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = Murakkab.paper_cluster().execute(make_declarative_job(MIN_COST))
    assert got == {"makespan_s": want.makespan_s.hex(),
                   "energy_wh": want.energy_wh.hex(), "bad": []}


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in [*PACKAGE.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_source_names_no_jax_or_repro_import(path):
    for line in (ROOT / path).read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            top = words[1].split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), line


def test_build_layer_imports_no_torch():
    """``kernels/_build.py`` builds and loads with nvcc and ctypes alone; the
    wrappers' ``torch.autograd.Function``s live in the kernel modules."""
    for line in Path(_build.__file__).read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            assert words[1].split(".")[0] != "torch", line


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _reduced():
    model = build_model(get_config("deepseek-7b", reduced=True))
    return model, model.init(torch.Generator().manual_seed(0))


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    model, params = _reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.ServeSession(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--reduced", "--requests", "1", "--batch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _bridge.params_from_numpy({"x": np.zeros(2, np.float32)})
    assert _bridge.resolve_device("cpu") == torch.device("cpu")


def test_cpu_ssd_scan_never_builds_the_kernel(no_cuda, monkeypatch):
    def refuse(name):
        raise AssertionError(f"tried to build {name}")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 32, 2, 16), np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.1, (1, 32, 2)).astype(np.float32))
    b, c = (torch.from_numpy(rng.standard_normal((1, 32, 1, 16), np.float32))
            for _ in range(2))
    y, state = ops.ssd_scan(x.bfloat16(), dt, torch.zeros(2), b.bfloat16(),
                            c.bfloat16(), torch.ones(2), chunk=16)
    assert y.dtype == torch.bfloat16 and state.shape == (1, 2, 16, 16)
    model = build_model(get_config("zamba2-7b", reduced=True))
    params = model.init(torch.Generator().manual_seed(0))
    sess = serve.ServeSession(model, params, device="cpu")
    assert sess.generate(torch.zeros(1, 4, dtype=torch.long), 2).shape == (1, 2)


def test_cpu_gmm_never_builds_the_kernel(no_cuda, monkeypatch):
    def refuse(name):
        raise AssertionError(f"tried to build {name}")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 32), np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 32, 16), np.float32))
    out = ops.gmm(x.bfloat16(), w.bfloat16())
    assert out.shape == (2, 8, 16) and out.dtype == torch.bfloat16
    model = build_model(get_config("deepseek-moe-16b", reduced=True))
    params = model.init(torch.Generator().manual_seed(0))
    sess = serve.ServeSession(model, params, device="cpu")
    assert sess.generate(torch.zeros(1, 4, dtype=torch.long), 2).shape == (1, 2)


def test_cpu_attention_never_builds_the_kernel(no_cuda, monkeypatch):
    def refuse(name):
        raise AssertionError(f"tried to build {name}")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 2, 64),
                                                    np.float32)).bfloat16()
               for _ in range(3))
    out = ops.flash_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    model, params = _reduced()
    sess = serve.ServeSession(model, params, device="cpu")
    assert sess.generate(torch.zeros(1, 4, dtype=torch.long), 2).shape == (1, 2)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, ml_dtypes.bfloat16])
def test_bridge_round_trip(dtype):
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(dtype),
            "g": {"b": rng.standard_normal((2,)).astype(dtype)}}
    tensors = _bridge.params_from_numpy(tree, "cpu")
    assert tensors["g"]["b"].shape == (2,)
    back = _bridge.params_to_numpy(tensors)
    for got, want in ((back["a"], tree["a"]), (back["g"]["b"], tree["g"]["b"])):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_bridge_bf16_keeps_values():
    a = np.array([1.0, -2.5, 3.140625], dtype=ml_dtypes.bfloat16)
    t = _bridge.params_from_numpy({"x": a}, "cpu")["x"]
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == [1.0, -2.5, 3.140625]


def test_configs_are_copies_of_the_reference():
    """Every architecture of the reference's registry, in its order, with
    CONFIG and REDUCED equal field for field."""
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JaxModelConfig)]
    assert ARCH_IDS == jax_registry.ARCH_IDS
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        port, ref_mod = registry._MODULES[arch], jax_registry._MODULES[arch]
        assert port.__name__.rsplit(".", 1)[1] == \
            ref_mod.__name__.rsplit(".", 1)[1]
        for name in ("CONFIG", "REDUCED"):
            assert dataclasses.asdict(getattr(port, name)) == \
                dataclasses.asdict(getattr(ref_mod, name))
    assert get_config("deepseek-7b").n_layers == 30
    assert get_config("zamba2-7b").n_layers == 81
    assert get_config("deepseek-moe-16b").n_layers == 28
    assert get_config("gemma2-9b").head_dim_ == 256
    assert get_config("stablelm-12b").head_dim_ == 160
    with pytest.raises(KeyError):
        get_config("llama-2-7b")
    with pytest.raises(KeyError):
        jax_registry.get_config("llama-2-7b")


def test_full_width_size():
    """deepseek-7b at full width: ~6.9e9 parameters, ~13.8 GB in bf16."""
    n = build_model(get_config("deepseek-7b")).param_count()
    assert 6.8e9 < n < 7.0e9


def test_moe_full_width_size():
    """deepseek-moe-16b at full width: ~16.4e9 parameters (~32.8 GB in
    bf16, one card holds it), 14.9e9 of them in the 27 x 64 routed experts."""
    cfg = get_config("deepseek-moe-16b")
    assert 16.3e9 < build_model(cfg).param_count() < 16.5e9
    m = cfg.moe
    experts = (cfg.n_layers - m.first_k_dense) * m.num_experts * 3 * \
        cfg.d_model * m.d_ff_expert
    assert 14.9e9 < experts < 15.0e9


@pytest.mark.parametrize("arch,low,high", [("zamba2-7b", 6.6e9, 6.7e9),
                                           ("mamba2-370m", 3.6e8, 3.8e8)])
def test_ssm_full_width_sizes(arch, low, high):
    """zamba2-7b ~6.67e9 parameters (13.3 GB in bf16, one card holds it);
    mamba2-370m ~3.7e8."""
    assert low < build_model(get_config(arch)).param_count() < high


def test_encdec_full_width_size():
    """seamless-m4t-large-v2 at full width: ~1.83e9 parameters (~3.6 GB in
    bf16): the tied 256 206 x 1024 embedding, 24 decoder layers of (attn,
    cross attn with its K/V projections, ffn of 8192) and 24 encoder layers
    of (attn, ffn)."""
    cfg = get_config("seamless-m4t-large-v2")
    n = build_model(cfg).param_count()
    assert 1.80e9 < n < 1.85e9
    assert cfg.d_model // cfg.n_heads == 64       # a head dim the flash kernel takes


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_fails_without_a_card(chip_smoke, no_cuda, capsys):
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_counts_the_work_the_masks_leave(chip_smoke):
    from repro_torch.kernels import flash_attention as fa
    for kw in ({}, {"window": 5}, {"q_offset": 9, "kv_valid": 10},
               {"causal": False}):
        Sq, Sk = (1, 16) if "q_offset" in kw else (12, 12)
        kv_len = torch.tensor([kw["kv_valid"]]) if "kv_valid" in kw else None
        mask = ref._mask(torch.arange(Sq)[None] + kw.get("q_offset", 0),
                         torch.arange(Sk)[None], causal=kw.get("causal", True),
                         window=kw.get("window", 0), kv_len=kv_len)
        assert fa.attended_pairs(Sq, Sk, **kw) == int(mask.sum())
    ms, by = chip_smoke.attention_bound_ms(4, 2048, 2048, 32, 32, 128, {})
    assert by == "operations" and abs(ms - 0.139) < 0.001


def test_chip_smoke_expects_a_launch_per_block(chip_smoke):
    """Per prefill: one flash launch per attention block (the encoder's and
    the cross-attention blocks' too), one SSD launch per SSM layer, three
    grouped-GEMM launches per MoE layer. Per decode step: one flash launch
    per cross-attention block, one decode-attention call per self-attention
    block and the grouped GEMMs again."""
    want = {"deepseek-7b": {"flash_attention": 30, "gmm": 0, "ssd_scan": 0},
            "zamba2-7b": {"flash_attention": 13, "gmm": 0, "ssd_scan": 81},
            "mamba2-370m": {"flash_attention": 0, "gmm": 0, "ssd_scan": 48},
            "deepseek-moe-16b": {"flash_attention": 28, "gmm": 81,
                                 "ssd_scan": 0},
            "seamless-m4t-large-v2": {"flash_attention": 72, "gmm": 0,
                                      "ssd_scan": 0},
            "gemma2-9b": {"flash_attention": 42, "gmm": 0, "ssd_scan": 0},
            "stablelm-12b": {"flash_attention": 40, "gmm": 0, "ssd_scan": 0},
            "llama-3.2-vision-90b": {"flash_attention": 10, "gmm": 0,
                                     "ssd_scan": 0},
            "command-r-plus-104b": {"flash_attention": 4, "gmm": 0,
                                    "ssd_scan": 0}}
    self_attn = {"deepseek-7b": 30, "zamba2-7b": 13, "deepseek-moe-16b": 28,
                 "seamless-m4t-large-v2": 24, "gemma2-9b": 42, "stablelm-12b": 40,
                 "llama-3.2-vision-90b": 8, "command-r-plus-104b": 4}
    decode = {"deepseek-moe-16b": {"flash_attention": 0, "gmm": 81,
                                   "ssd_scan": 0},
              "seamless-m4t-large-v2": {"flash_attention": 24, "gmm": 0,
                                        "ssd_scan": 0},
              "llama-3.2-vision-90b": {"flash_attention": 2, "gmm": 0,
                                       "ssd_scan": 0}}
    for arch, count in want.items():
        count = {**count, "decode_attention": 0}
        cfg = chip_smoke.path_config(arch)
        assert chip_smoke.expected_launches(cfg) == count
        step = {**decode.get(arch, dict.fromkeys(count, 0)),
                "decode_attention": self_attn.get(arch, 0)}
        assert chip_smoke.expected_launches(cfg, "decode") == step
        assert chip_smoke.generate_launches(cfg, 64) == {
            k: count[k] + 63 * step[k] for k in count}
    assert [a for a, _ in chip_smoke.SERVE_PATHS] == list(want)


def test_chip_smoke_ssd_bound(chip_smoke):
    """The SSD bound at the prefill shapes, B=4, L=2048, chunk 256: zamba2-7b
    4.5e10 FLOPs over 250 MB, by bytes; mamba2-370m 2.2e10 over 77 MB."""
    ms, by = chip_smoke.ssd_bound_ms(4, 2048, 112, 64, 64, 2, 256, "bfloat16")
    assert by == "bytes" and abs(ms - 0.0747) < 0.001
    ms, by = chip_smoke.ssd_bound_ms(4, 2048, 32, 64, 128, 1, 256, "bfloat16")
    assert by == "bytes" and abs(ms - 0.0228) < 0.001
    ms, by = chip_smoke.attention_bound_ms(4, 2048, 2048, 32, 32, 112, {})
    assert by == "operations" and abs(ms - 0.122) < 0.001


def test_chip_smoke_decode_bound(chip_smoke):
    """The decode kernel's bound at deepseek-7b's serve cells, by bytes: the
    agent turn's 4 x 8640 positions of 32 kv heads of 128, K and V in bf16,
    566 MB, 0.169 ms at 3.35 TB/s; RAG's 32 x 1300, 682 MB, 0.204 ms."""
    ms, by = chip_smoke.decode_bound_ms(4, 32, 32, 128, 8640)
    assert by == "bytes" and abs(ms - 0.1690) < 0.0005
    ms, by = chip_smoke.decode_bound_ms(32, 32, 32, 128, 1300)
    assert by == "bytes" and abs(ms - 0.2036) < 0.0005
    names = [shape[0] for shape in chip_smoke.DECODE_SHAPES]
    assert names[:2] == ["ds7b_agent_turn", "ds7b_rag_synth"]
    assert set(chip_smoke.decode_shape_lines()) == set(names)


@pytest.mark.parametrize("case", ["splits", "one_split", "window"])
def test_chip_smoke_decode_faults_exceed_the_row_limit(chip_smoke, case):
    """Each fault of the decode phase moves the worst row past
    DECODE_ROW_RTOL on ordinary random inputs: one split's keys dropped,
    the last position dropped where the call is one split."""
    from repro_torch.kernels import decode_attention as da
    B, H, KVH, D, Sk, kv_len = 2, 4, 2, 64, 1500, 1480
    kw = {"q_offset": kv_len - 1, "kv_len": kv_len}
    if case == "one_split":
        Sk, kv_len = 49, 25
        kw = {"q_offset": kv_len - 1, "kv_len": kv_len}
    elif case == "window":
        kw["window"] = 700
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(shape, generator=gen).bfloat16()
               for shape in ((B, 1, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D)))
    lo, hi = da.visible_range(Sk, kw["q_offset"], kw["kv_len"], kw.get("window", 0))
    splits = da.split_count(B * KVH, hi - lo)
    assert (splits == 1) == (case == "one_split")
    want = da.decode_attention_plain(q, k, v, **kw)
    faults = chip_smoke.decode_faults(q, k, v, kw, splits, da.split_step(D, H // KVH))
    assert len(faults) == 1
    for out in faults.values():
        assert chip_smoke.rel_errors(out, want)[0] > chip_smoke.DECODE_ROW_RTOL


def test_chip_smoke_gmm_bound(chip_smoke):
    """deepseek-moe-16b's expert products: the prefill gate/up (E=64,
    C=968, d=2048, f=1408) is 3.57e11 FLOPs over 0.80 GB, bound by
    operations; the decode gate/up at C=8 moves 373 MB (369 MB of them the
    weights), bound by bytes."""
    ms, by = chip_smoke.gmm_bound_ms(64, 968, 2048, 1408, "bfloat16")
    assert by == "operations" and abs(ms - 0.361) < 0.001
    ms, by = chip_smoke.gmm_bound_ms(64, 8, 2048, 1408, "bfloat16")
    assert by == "bytes" and abs(ms - 0.111) < 0.001
    ms, by = chip_smoke.gmm_bound_ms(64, 968, 1408, 2048, "bfloat16")
    assert by == "operations" and abs(ms - 0.361) < 0.001


def test_chip_smoke_gmm_faults_move_what_they_name(chip_smoke):
    """The step fault drops the last 32 of d; the tile fault zeroes the last
    expert's ragged last C-tile (rows 896-967 of 968) and nothing else."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 200, 64), np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 64, 8), np.float32))
    faults = chip_smoke.gmm_faults(x, w)
    want = torch.bmm(x[..., :32], w[:, :32])
    torch.testing.assert_close(faults["last_d_step_dropped"], want)
    full = torch.bmm(x, w)
    unwritten = faults["last_c_tile_unwritten"]
    assert bool(unwritten[-1, 128:].eq(0).all())
    torch.testing.assert_close(unwritten[-1, :128], full[-1, :128])
    torch.testing.assert_close(unwritten[0], full[0])
    torch.testing.assert_close(chip_smoke.split_d_gmm(x, w), full)


def test_chip_smoke_routing_replay_pins_the_experts(chip_smoke):
    """Recording, RoutingReplay routes as ``moe._route``; replaying, it
    gives every layer the recorded experts (weights renormalised from the
    current router), so the same weights reproduce the recorded run and
    other routers still get the recorded experts."""
    cfg = get_config("deepseek-moe-16b", reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 9)))}
    free = model.apply(params, toks)[0]
    replay = chip_smoke.RoutingReplay()
    with replay.patch():
        recorded = model.apply(params, toks)[0]
    assert replay.count() == 2 * 18               # 2 MoE layers x 18 tokens
    torch.testing.assert_close(recorded, free, rtol=0, atol=0)
    with replay.patch():
        replayed = model.apply(params, toks)[0]
    torch.testing.assert_close(replayed, recorded, rtol=0, atol=0)

    x2d = torch.randn(18, cfg.d_model, generator=torch.Generator().manual_seed(1))
    router = params["groups"]["g1"]["b1"]["moe"]["router"][0]
    other = chip_smoke.RoutingReplay()
    with other.patch():
        other.route(x2d, -router, cfg)
    replay.next = 0
    idx, w, aux = replay.route(x2d, -router, cfg)
    assert torch.equal(idx, replay.ids[0])
    assert not torch.equal(other.ids[0], idx)     # free, it routes otherwise
    assert replay.differing(replay) == 0 and other.differing(other) == 0
    torch.testing.assert_close(w.float().sum(-1), torch.ones(18), atol=1e-2,
                               rtol=0)
    # the aux loss of the replayed ids, as ``_route`` computes it (training
    # differentiates it): with the recording router, the recorded run's
    _, _, aux_free = moe._route(x2d, router, cfg)
    same = chip_smoke.RoutingReplay()
    with same.patch():
        same.route(x2d, router, cfg)
    same.next = 0
    torch.testing.assert_close(same.route(x2d, router, cfg)[2], aux_free)
    assert float(aux) > 0.0


def test_chip_smoke_expects_the_train_launches(chip_smoke):
    """Remat "full" runs every forward launch twice a step (the forward and
    its recompute), and each backward wrapper once per forward call:
    deepseek-7b 30 attention layers, deepseek-moe-16b cut to 8 layers (1
    dense, 7 MoE of 3 expert products), mamba2-370m 48 SSM layers, zamba2-7b
    81 SSM layers and 13 shared attention blocks, all at full depth;
    gemma2-9b cut to 32 layers and stablelm-12b to 20."""
    for arch, attn, gmm, ssm in (("deepseek-7b", 30, 0, 0),
                                 ("deepseek-moe-16b", 8, 21, 0),
                                 ("mamba2-370m", 0, 0, 48),
                                 ("zamba2-7b", 13, 0, 81),
                                 ("gemma2-9b", 32, 0, 0),
                                 ("stablelm-12b", 20, 0, 0)):
        cfg = chip_smoke.train_config(arch)
        assert chip_smoke.expected_train_launches(cfg, 8) == {
            "flash_attention": 16 * attn, "flash_attention_bwd": 8 * attn,
            "gmm": 16 * gmm, "gmm_bwd": 8 * gmm, "ssd_scan": 16 * ssm,
            "ssd_scan_bwd": 8 * ssm}
    assert list(chip_smoke.TRAIN_PATHS) == ["deepseek-7b", "deepseek-moe-16b",
                                            "mamba2-370m", "zamba2-7b",
                                            "gemma2-9b", "stablelm-12b"]


def test_chip_smoke_train_paths_cut_depth_not_width(chip_smoke):
    for arch in chip_smoke.TRAIN_PATHS:
        full, cfg = get_config(arch), chip_smoke.train_config(arch)
        assert cfg.replace(n_layers=full.n_layers) == full
    moe_cfg = chip_smoke.train_config("deepseek-moe-16b")
    assert [gd.repeat for gd in transformer.layer_plan(moe_cfg)] == [1, 7]
    assert 4.5e9 < build_model(moe_cfg).param_count() < 4.7e9
    assert chip_smoke.train_capacity() == 488       # 2 x 2048 tokens, top 6 of 64


def test_chip_smoke_backward_bounds(chip_smoke):
    """The flash backward's five products at deepseek-7b's training shape:
    10 B H D S(S+1)/2 = 1.72e11 FLOPs, 0.174 ms at 989 TFLOP/s; the gmm
    backward's two products at the training capacity."""
    ms, by = chip_smoke.attention_bwd_bound_ms(2, 2048, 2048, 32, 32, 128, {})
    assert by == "operations" and abs(ms - 0.1738) < 1e-3
    ms, by = chip_smoke.gmm_bwd_bound_ms(64, 488, 2048, 1408)
    assert by == "operations" and abs(ms - 4 * 64 * 488 * 2048 * 1408 / 989e9) < 1e-6


def test_chip_smoke_ssd_bwd_bound(chip_smoke):
    """The SSD backward's products at zamba2-7b's training shape (B=2,
    L=2048, chunk 256): Q^2 (3N + 2P) + 10 Q N P a (b, h, chunk), 5.64e10
    FLOPs, 0.057 ms at 989 TFLOP/s, against 0.18 GB moved (0.055 ms)."""
    ms, by = chip_smoke.ssd_bwd_bound_ms(2, 2048, 112, 64, 64, 2, 256, "bfloat16")
    flops = 2 * 112 * 8 * (256 ** 2 * (3 * 64 + 2 * 64) + 10 * 256 * 64 * 64)
    assert abs(flops - 5.64e10) < 0.01e10
    assert by == "operations" and abs(ms - 1e3 * flops / 989e12) < 1e-9
    ms, by = chip_smoke.ssd_bwd_bound_ms(2, 2048, 32, 64, 128, 1, 256, "float32")
    assert by == "operations" and ms > 0.1     # fp32 peak: 67 TFLOP/s


def _ssd_args(seed, B, L, H, P, N, G, dtype=torch.bfloat16):
    """Inputs as chip_smoke.ssd_inputs draws them, on the CPU."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, L, H, P, generator=g) * 0.5).to(dtype)
    dt = torch.exp(math.log(1e-3) + math.log(100.0) * torch.rand(B, L, H, generator=g))
    a_log = torch.log(1.0 + 15.0 * torch.rand(H, generator=g))
    b, c = ((torch.randn(B, L, G, N, generator=g) * 0.3).to(dtype) for _ in range(2))
    dy = torch.randn(B, L, H, P, generator=g).to(dtype)
    return (x, dt, a_log, b, c, torch.randn(H, generator=g)), dy


def test_chip_smoke_ssd_bwd_faults_exceed_the_limits(chip_smoke):
    """At a small bf16 shape with no state cotangent, as the training shapes
    are held: the plain backward is within the ssd_bwd limits of autograd
    through the plain version, and each planted fault moves some gradient
    past them (the state gradient dropped moves dx, db, ddt and da_log, not
    dc, which reads the entering state; the missing reverse scan ddt and
    da_log; db from one head db alone)."""
    from repro_torch.kernels import ssd_scan as ss
    args, dy = _ssd_args(0, 2, 128, 8, 16, 16, 2)
    want = chip_smoke.ssd_grads_plain(args, dy, None, 32)
    plain = ss.ssd_scan_bwd_plain(*args, dy, chunk=32)
    assert all(e["ok"] for e in chip_smoke.ssd_bwd_errors(plain, want).values())
    seen = {f: {g for g, e in chip_smoke.ssd_bwd_errors(grads, want).items()
                if not e["ok"]}
            for f, grads in chip_smoke.ssd_bwd_faults(args, dy, None, 32).items()}
    assert seen["state_grad_not_carried"] == {"dx", "ddt", "da_log", "db"}
    assert seen["dcum_no_reverse_scan"] == {"ddt", "da_log"}
    assert seen["db_one_head"] == {"db"}


def test_chip_smoke_plain_ssd_rounds_each_gradient_once(chip_smoke):
    """The train gate's plain SSD: y and the state bitwise the plain
    version's on the bf16 inputs; under autograd dx and db are the fp32
    gradients rounded once (the plain version on bf16 leaves sums a group's
    heads' db in bf16)."""
    from repro_torch.kernels import ssd_scan as ss
    args, dy = _ssd_args(1, 1, 64, 8, 16, 16, 2)
    for got, want in zip(chip_smoke.plain_ssd(*args, chunk=32),
                         ss.ssd_scan_plain(*args, chunk=32)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    leaves = [a.clone().requires_grad_() for a in args]
    grads = torch.autograd.grad(chip_smoke.plain_ssd(*leaves, chunk=32)[0],
                                leaves, dy)
    want = chip_smoke.ssd_grads_plain(args, dy, None, 32)
    assert torch.equal(grads[0], want[0]) and torch.equal(grads[3], want[3])


def test_chip_smoke_split_ssd_moves_only_the_forward(chip_smoke):
    """The floor run at the wgmma variant's precision: y within its split
    rounding of the plain one, the gradient exactly the plain SSD's."""
    args, dy = _ssd_args(2, 1, 128, 4, 64, 64, 1)
    leaves = [a.clone().requires_grad_() for a in args]
    y_s, _ = chip_smoke.split_ssd(*leaves, chunk=64)
    y_p, _ = chip_smoke.plain_ssd(*args, chunk=64)
    assert (y_s.float() - y_p.float()).norm() <= 1e-3 * y_p.float().norm()
    got = torch.autograd.grad(y_s, leaves, dy)
    leaves_p = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(chip_smoke.plain_ssd(*leaves_p, chunk=64)[0],
                               leaves_p, dy)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("fault", ["dcum_no_reverse_scan", "db_one_head",
                                   "state_grad_not_carried"])
def test_chip_smoke_planted_ssd_faults_reach_the_autograd_function(chip_smoke,
                                                                   monkeypatch, fault):
    """The train phase's SSD faults replace what SsdScanFn's backward gets:
    the faulty gradients in each input's dtype, against the plain
    backward's where the fault leaves a gradient as it is."""
    from types import SimpleNamespace
    from repro_torch.kernels import ssd_scan as ss
    args, dy = _ssd_args(3, 1, 128, 4, 16, 16, 2)
    monkeypatch.setattr(ss, "ssd_scan_bwd_cuda", ss.ssd_scan_bwd_plain)
    ctx = SimpleNamespace(saved_tensors=args, chunk=32, site=())
    want = ss.SsdScanFn.backward(ctx, dy, None)[:6]
    with chip_smoke.planted_ssd_bwd(fault):
        got = ss.SsdScanFn.backward(ctx, dy, None)[:6]
    moved = {n for n, g, w in zip(chip_smoke.SSD_GRADS, got, want)
             if not torch.allclose(g.float(), w.float(), rtol=1e-2, atol=1e-5)}
    assert [g.dtype for g in got] == [a.dtype for a in args]
    assert moved == {"dcum_no_reverse_scan": {"ddt", "da_log"},
                     "db_one_head": {"db"},
                     "state_grad_not_carried": moved}[fault] and moved
    assert chip_smoke.SSD_TRAIN_FAULTS[fault] == (fault == "dcum_no_reverse_scan")


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_chip_smoke_checking_ssd_replays_each_layers_backward(chip_smoke,
                                                             monkeypatch, arch):
    """The train gate's plain SSD checks every SSM layer's backward once
    under remat "full" (the hook fires on the recomputed output), on the
    layer's own inputs: the backward (here its plain version) within the
    limits, each fault past them in some call; the gradients are the plain
    SSD's."""
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.runtime import train as train_rt
    monkeypatch.setattr(ss, "ssd_scan_bwd_cuda", ss.ssd_scan_bwd_plain)
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    grad_fn = train_rt.build_grad_fn(model, train_rt.TrainOptions(remat_policy="full"))
    batch = batch_for_step(DataConfig(cfg.vocab_size, 32, 2), 0, cfg, device="cpu")
    records = []
    with mock.patch.object(ops, "ssd_scan", chip_smoke.checking_ssd(records)):
        got, _ = grad_fn(params, batch)
    with mock.patch.object(ops, "ssd_scan", chip_smoke.plain_ssd):
        want, _ = grad_fn(params, batch)
    assert len(records) == chip_smoke.expected_launches(cfg)["ssd_scan"] > 0
    assert all(e["ok"] for rec in records for e in rec["kernel"].values())
    for fault in ("state_grad_not_carried", "dcum_no_reverse_scan", "db_one_head"):
        assert any(not e["ok"] for rec in records for e in rec[fault].values()), fault
    for (_, a), (_, b) in zip(chip_smoke._flat(got), chip_smoke._flat(want)):
        assert torch.equal(a, b)


def test_chip_smoke_train_flops_count_the_ssd(chip_smoke):
    """Model FLOPs of a training step add 3 x the forward's SSD products an
    SSM layer to 6 x the parameters a token multiplies: mamba2-370m's 48
    layers of 32 heads at B=2, S=2048, chunk 256."""
    model = build_model(chip_smoke.train_config("mamba2-370m"))
    flops = chip_smoke.train_model_flops(model, 2, 2048)
    ssd = 3 * 48 * 2 * 32 * 8 * (256 ** 2 * (128 + 64) + 4 * 256 * 128 * 64)
    embed = math.prod(model.specs["embed"].shape)
    assert flops == 6 * (model.param_count() - embed) * 2 * 2048 + ssd


@pytest.mark.parametrize("kw", [{}, {"window": 8, "softcap": 5.0},
                                {"causal": False}])
def test_chip_smoke_attention_grads_match_autograd(chip_smoke, kw):
    """The formulas that make the Delta fault agree with autograd through
    the plain version, and dropping Delta moves dQ and dK, not dV."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(0)
    q, do = torch.randn(2, 20, 4, 16, generator=g), torch.randn(2, 20, 4, 16, generator=g)
    k, v = torch.randn(2, 20, 2, 16, generator=g), torch.randn(2, 20, 2, 16, generator=g)
    want = fa.flash_attention_bwd_plain(q, k, v, do, **kw)
    for got, w in zip(chip_smoke.attention_grads_naive(q, k, v, do, **kw), want):
        torch.testing.assert_close(got, w, atol=1e-5, rtol=1e-5)
    fault = chip_smoke.attention_grads_naive(q, k, v, do, zero_delta=True, **kw)
    errs = [chip_smoke.grad_errors(f, w) for f, w in zip(fault, want)]
    assert not chip_smoke.within_bwd_limits(errs[0])
    assert not chip_smoke.within_bwd_limits(errs[1])
    assert chip_smoke.within_bwd_limits(errs[2])


@pytest.mark.parametrize("fault", ["first_tile_dk_dropped", "last_tile_dk_dropped",
                                   "delta_zero"])
def test_chip_smoke_planted_faults_reach_the_autograd_function(chip_smoke,
                                                               monkeypatch, fault):
    """The train phase's faults replace what FlashAttentionFn's backward
    gets: one K/V tile's dK zeroed and the rest as the kernel gave it, or
    the gradients with Delta at zero."""
    from types import SimpleNamespace
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(0)
    q, do = torch.randn(1, 150, 4, 16, generator=g), torch.randn(1, 150, 4, 16, generator=g)
    k, v = torch.randn(1, 150, 2, 16, generator=g), torch.randn(1, 150, 2, 16, generator=g)
    opts = dict(causal=True, window=0, softcap=0.0, scale=None, kv_valid=None)

    def kernel(q, k, v, out, dout, lse, *, kv_valid, **kw):
        return chip_smoke.attention_grads_naive(q, k, v, dout, **kw)

    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", kernel)
    ctx = SimpleNamespace(saved_tensors=(q, k, v, q, None), opts=opts, site=())
    want = fa.FlashAttentionFn.backward(ctx, do)[:3]
    with chip_smoke.planted_flash_bwd(fault):
        got = fa.FlashAttentionFn.backward(ctx, do)[:3]
    torch.testing.assert_close(got[2], want[2], atol=1e-6, rtol=1e-6)
    if fault == "delta_zero":
        assert (got[0] - want[0]).norm() > 0.1 * want[0].norm()
        return
    tile = chip_smoke.BWD_KV_TILE
    keys = slice(0, tile) if fault == "first_tile_dk_dropped" else slice(-tile, None)
    rest = slice(tile, None) if fault == "first_tile_dk_dropped" else slice(0, -tile)
    assert torch.equal(got[0], want[0])
    assert bool((got[1][:, keys] == 0).all()) and want[1][:, keys].abs().max() > 0
    assert torch.equal(got[1][:, rest], want[1][:, rest])


def test_chip_smoke_seamless_attention_bounds(chip_smoke):
    """The flash bounds at seamless-m4t-large-v2's shapes over 1500 frames:
    the encoder's self-attention 3.69e10 FLOPs over 49 MB, by operations;
    a cross-attention step (one query row) 24.6 MB, by bytes."""
    for shape, want_ms, want_by in ((chip_smoke.SEAMLESS_ENCODER, 0.0373, "operations"),
                                    (chip_smoke.SEAMLESS_CROSS, 0.00734, "bytes")):
        _, B, Sq, Sk, H, KVH, D, opts = shape
        ms, by = chip_smoke.attention_bound_ms(B, Sq, Sk, H, KVH, D, opts)
        assert by == want_by and abs(ms - want_ms) < 1e-4


def test_chip_smoke_paths_cut_depth_not_width(chip_smoke):
    """The VLM runs 10 of its 100 layers (2 of 20 five-layer groups: 8 self-
    and 2 cross-attention) and command-r-plus 4 of 64, both at full width;
    every other path runs its whole config. gemma2-9b's agreement prompts
    reach past its local layers' window."""
    for arch, _ in chip_smoke.SERVE_PATHS:
        full, cfg = get_config(arch), chip_smoke.path_config(arch)
        assert cfg.replace(n_layers=full.n_layers) == full
        assert cfg.n_layers == chip_smoke.DEPTH_CUTS.get(arch, full.n_layers)
    (gd,) = transformer.layer_plan(chip_smoke.path_config("llama-3.2-vision-90b"))
    assert gd.repeat == 2 and [b.kind for b in gd.blocks].count("attn") == 4
    assert get_config("llama-3.2-vision-90b").vision.num_patches == \
        chip_smoke.NUM_PATCHES
    _, S = chip_smoke.AGREE_PROMPTS["gemma2-9b"]
    assert S > get_config("gemma2-9b").sliding_window
    assert set(chip_smoke.REPLAY_CALLS) <= {a for a, _ in chip_smoke.SERVE_PATHS}


def test_chip_smoke_new_attention_bounds(chip_smoke):
    """The flash bounds at the new serving shapes, by operations: gemma2's
    global layer 1.37e11 FLOPs = 0.139 ms, its local layer past the window
    (4096 x 4097 / 2 + 2048 x 4096 pairs) 0.278 ms, stablelm's 1.72e11 =
    0.174 ms, the VLM's cross-attention 1.10e12 = 1.11 ms."""
    want = {"gemma2_global": 0.139, "gemma2_local_past_window": 0.278,
            "stablelm_prefill": 0.174, "vlm_cross": 1.112}
    for name, B, Sq, Sk, H, KVH, D, opts in chip_smoke.FAMILY_SHAPES:
        ms, by = chip_smoke.attention_bound_ms(B, Sq, Sk, H, KVH, D, opts)
        assert by == "operations" and abs(ms - want[name]) < 1e-3, name
    assert len(chip_smoke.GRID_WIDE) == 2 * len(chip_smoke.GRID)
    assert {shape[6] for shape in chip_smoke.GRID_WIDE} == {160, 256}


@pytest.mark.parametrize("kw", [{"causal": True}, {"causal": False},
                                {"causal": True, "window": 5,
                                 "logit_softcap": 20.0},
                                {"causal": True, "logit_softcap": 50.0,
                                 "scale": 224 ** -0.5}])
def test_chip_smoke_floor_oracles_take_window_and_softcap(chip_smoke, kw):
    """Both rounding-only oracles of the floor agree with the naive one in
    fp32 (where P's rounding to v's dtype is none) under gemma2's window and
    softcap; the naive one runs a batch row at a time."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, np.float32))
               for sh in ((2, 12, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16)))
    want = ref.mha_naive(q, k, v, **kw)
    for oracle in (chip_smoke.naive_attention, chip_smoke.p_bf16_attention,
                   chip_smoke.plain_attention):
        np.testing.assert_allclose(oracle(q, k, v, **kw).numpy(),
                                   want.numpy(), atol=1e-5, rtol=1e-5)


def test_chip_smoke_window_fault_moves_every_row_past_the_window(chip_smoke):
    """With a window, the injected faults include the window's first tile
    dropped: it moves every row whose window is full, where the last tile's
    faults move only the rows that reach the last tile."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, np.float32))
               for sh in ((1, 400, 2, 16), (1, 400, 2, 16), (1, 400, 2, 16)))
    kw = dict(causal=True, window=128, softcap=0.0, scale=None, q_offset=0,
              kv_valid=None)
    want = chip_smoke.plain_attention(q, k, v, window=128)
    faults = chip_smoke.injected_faults(q, k, v, kw)
    assert list(faults) == ["last_tile_dropped", "last_tile_stale",
                            "window_first_tile_dropped"]
    moved = {name: chip_smoke.moved_rows(out, want)
             for name, out in faults.items()}
    assert moved["last_tile_dropped"] <= chip_smoke.KV_TILE / 400 + 1e-6
    # rows 64.. lose their window's oldest 64 keys
    assert abs(moved["window_first_tile_dropped"] - (400 - 64) / 400) < 0.05
    assert "window_first_tile_dropped" not in chip_smoke.injected_faults(
        q, k, v, {**kw, "window": 0})


def test_chip_smoke_call_check_power_takes_either_limit(chip_smoke):
    """A shape fails when the kernel passes either limit, so a fault shows
    the check's power when it passes one: here the fault moves only the row
    of smallest norm, past the worst-row limit and within the max-abs one."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, np.float32)).bfloat16()
               for sh in ((1, 64, 2, 16), (1, 64, 2, 16), (1, 64, 2, 16)))
    kw = {"causal": True, "scale": 0.25}
    want = chip_smoke.plain_attention(q, k, v, **kw)
    norms = want.float().norm(dim=-1)
    row = np.unravel_index(int(norms.argmin()), tuple(norms.shape))

    def fault(q, k, v, **kw):
        out = chip_smoke.plain_attention(q, k, v, **kw).clone()
        out[row] = (out[row].float() * 1.03).to(out.dtype)
        return out

    with mock.patch.object(chip_smoke, "dropped_tile_attention", fault):
        line, ok, power = chip_smoke.call_check([(q, k, v, kw, want)])
    (held,) = line["shapes"].values()
    assert ok and power and held["fault_exceeds"]
    assert held["fault_max_abs"] <= held["tol_max_abs"]
    assert held["fault_row_rel"] > held["tol_row_rel"]


def test_chip_smoke_call_check_holds_each_shape(chip_smoke):
    """The replay of recorded attention calls, held per shape: on the CPU
    the wrapper is the plain version (no difference), the rounding floor is
    small, and the last-K/V-tile fault exceeds both limits at every shape
    with two keys or more (64 keys, or half of a shorter call's). Over one
    key the floor is 0 and no fault applies."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).bfloat16()

    nc, causal = {"causal": False, "scale": 0.125}, {"causal": True, "scale": 0.125}
    cross = (t(2, 1, 4, 64), t(2, 300, 4, 64), t(2, 300, 4, 64), nc)
    encoder = (t(2, 40, 4, 64), t(2, 40, 4, 64), t(2, 40, 4, 64), nc)
    prefill = (t(1, 17, 4, 64), t(1, 17, 2, 64), t(1, 17, 2, 64), causal)
    one_key = (t(2, 1, 4, 64), t(2, 1, 4, 64), t(2, 1, 4, 64), causal)
    calls = [(q, k, v, kw, chip_smoke.plain_attention(q, k, v, **kw))
             for q, k, v, kw in (cross, encoder, prefill, one_key, cross)]
    line, ok, power = chip_smoke.call_check(calls)
    assert ok and power and line["calls"] == 5
    shapes = line["shapes"]
    assert list(shapes) == [
        "B=2 Sq=1 Sk=300 H=4 KVH=4 D=64 non-causal",
        "B=2 Sq=40 Sk=40 H=4 KVH=4 D=64 non-causal",
        "B=1 Sq=17 Sk=17 H=4 KVH=2 D=64 causal",
        "B=2 Sq=1 Sk=1 H=4 KVH=4 D=64 causal"]
    assert shapes["B=2 Sq=1 Sk=300 H=4 KVH=4 D=64 non-causal"]["calls"] == 2
    for shape in list(shapes)[:3]:
        held = shapes[shape]
        assert held["kernel_max_abs"] == 0.0 and held["fault_exceeds"]
        assert held["fault_row_rel"] > held["tol_row_rel"] > 0
    held = shapes["B=2 Sq=1 Sk=1 H=4 KVH=4 D=64 causal"]
    assert held["tol_max_abs"] == 0.0 and held["fault_exceeds"] is None
    assert "fault_max_abs" not in held
    # a wrong kernel fails the shape it is wrong at
    with mock.patch.object(ops, "flash_attention",
                           lambda q, k, v, **kw: chip_smoke.dropped_tile_attention(
                               q, k, v, causal=kw["causal"], scale=kw["scale"])):
        line, ok, _ = chip_smoke.call_check(calls)
    assert not ok
    assert [held["ok"] for held in line["shapes"].values()] == \
        [False, False, False, True]
