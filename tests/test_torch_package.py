"""Hygiene of the PyTorch/CUDA port: what it imports, where it runs, what
crosses the bridge, and the on-card script's behaviour without a card."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from repro.configs import deepseek_7b as jax_deepseek  # noqa: E402
from repro.configs import deepseek_moe_16b as jax_deepseek_moe  # noqa: E402
from repro.configs import kimi_k2_1t as jax_kimi  # noqa: E402
from repro.configs import mamba2_370m as jax_mamba2  # noqa: E402
from repro.configs import seamless_m4t_large_v2 as jax_seamless  # noqa: E402
from repro.configs import zamba2_7b as jax_zamba2  # noqa: E402
from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro_torch import _bridge  # noqa: E402
from repro_torch.configs import (deepseek_7b, deepseek_moe_16b,  # noqa: E402
                                  kimi_k2_1t, mamba2_370m,
                                  seamless_m4t_large_v2, zamba2_7b)
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
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
    wrappers' autograd rule lives beside them (``kernels/_autograd.py``)."""
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
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JaxModelConfig)]
    for port, ref_mod in ((deepseek_7b, jax_deepseek), (mamba2_370m, jax_mamba2),
                          (zamba2_7b, jax_zamba2),
                          (deepseek_moe_16b, jax_deepseek_moe),
                          (kimi_k2_1t, jax_kimi),
                          (seamless_m4t_large_v2, jax_seamless)):
        for name in ("CONFIG", "REDUCED"):
            assert dataclasses.asdict(getattr(port, name)) == \
                dataclasses.asdict(getattr(ref_mod, name))
    assert ARCH_IDS == ("deepseek-7b", "deepseek-moe-16b", "kimi-k2-1t-a32b",
                        "mamba2-370m", "seamless-m4t-large-v2", "zamba2-7b")
    assert get_config("deepseek-7b").n_layers == 30
    assert get_config("zamba2-7b").n_layers == 81
    assert get_config("deepseek-moe-16b").n_layers == 28
    with pytest.raises(KeyError):
        get_config("gemma2-9b")


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
    for kw in ({}, {"window": 5}, {"q_offset": 9, "kv_valid": 10},
               {"causal": False}):
        Sq, Sk = (1, 16) if "q_offset" in kw else (12, 12)
        kv_len = torch.tensor([kw["kv_valid"]]) if "kv_valid" in kw else None
        mask = ref._mask(torch.arange(Sq)[None] + kw.get("q_offset", 0),
                         torch.arange(Sk)[None], causal=kw.get("causal", True),
                         window=kw.get("window", 0), kv_len=kv_len)
        assert chip_smoke.attended_pairs(Sq, Sk, **kw) == int(mask.sum())
    ms, by = chip_smoke.attention_bound_ms(4, 2048, 2048, 32, 32, 128, {})
    assert by == "operations" and abs(ms - 0.139) < 0.001


def test_chip_smoke_expects_a_launch_per_block(chip_smoke):
    """Per prefill: one flash launch per attention block (the encoder's and
    the cross-attention blocks' too), one SSD launch per SSM layer, three
    grouped-GEMM launches per MoE layer. Per decode step: one flash launch
    per cross-attention block and the grouped GEMMs again."""
    want = {"deepseek-7b": {"flash_attention": 30, "gmm": 0, "ssd_scan": 0},
            "zamba2-7b": {"flash_attention": 13, "gmm": 0, "ssd_scan": 81},
            "mamba2-370m": {"flash_attention": 0, "gmm": 0, "ssd_scan": 48},
            "deepseek-moe-16b": {"flash_attention": 28, "gmm": 81,
                                 "ssd_scan": 0},
            "seamless-m4t-large-v2": {"flash_attention": 72, "gmm": 0,
                                      "ssd_scan": 0}}
    decode = {"deepseek-moe-16b": {"flash_attention": 0, "gmm": 81,
                                   "ssd_scan": 0},
              "seamless-m4t-large-v2": {"flash_attention": 24, "gmm": 0,
                                        "ssd_scan": 0}}
    for arch, count in want.items():
        cfg = get_config(arch)
        assert chip_smoke.expected_launches(cfg) == count
        step = decode.get(arch, dict.fromkeys(count, 0))
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
    assert float(aux) == 0.0


def test_chip_smoke_seamless_attention_bounds(chip_smoke):
    """The flash bounds at seamless-m4t-large-v2's shapes over 1500 frames:
    the encoder's self-attention 3.69e10 FLOPs over 49 MB, by operations;
    a cross-attention step (one query row) 24.6 MB, by bytes."""
    for shape, want_ms, want_by in ((chip_smoke.SEAMLESS_ENCODER, 0.0373, "operations"),
                                    (chip_smoke.SEAMLESS_CROSS, 0.00734, "bytes")):
        _, B, Sq, Sk, H, KVH, D, opts = shape
        ms, by = chip_smoke.attention_bound_ms(B, Sq, Sk, H, KVH, D, opts)
        assert by == want_by and abs(ms - want_ms) < 1e-4


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
