"""The dry-run (``repro_torch.launch.dryrun``), its cost census
(``launch/op_cost.py``) and the kernels' own counts, on the CPU: parity with
the reference's dry-run and cost model, a meta trace against a real CPU run
of the same step, the census's rules one by one, and the guards that keep
the dry-run off the card. The mesh cases are in
``tests/test_torch_dryrun_mesh.py``."""
import json
import os
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SHAPE_CELLS as JAX_SHAPE_CELLS  # noqa: E402
from repro.configs.base import cell_applicable as jax_cell_applicable  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.launch import hlo_cost as jax_hlo_cost  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro_torch import census  # noqa: E402
from repro_torch.configs.base import SHAPE_CELLS, ShapeCell, cell_applicable  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as mg  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.launch import dryrun, op_cost, perf_probe  # noqa: E402
from repro_torch.launch.mesh import production_mesh_shape  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` left as it was:
    the module asks for 512 host devices, which no JAX test this worker
    runs later may inherit."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _kernel_cfg(arch):
    """A reduced config with heads of 64, the smallest the flash kernel
    takes (its meta path checks what the kernel takes)."""
    return get_config(arch, reduced=True).replace(head_dim=64)


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_the_reference(arch):
    ours, ref = build_model(get_config(arch)), jax_build_model(jax_get_config(arch))
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()


def test_shape_cells_and_applicability_match_the_reference():
    assert {k: tuple(v.__dict__.values()) for k, v in SHAPE_CELLS.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in JAX_SHAPE_CELLS.items()}
    for arch in ARCH_IDS:
        for name in SHAPE_CELLS:
            assert cell_applicable(get_config(arch), SHAPE_CELLS[name]) == \
                jax_cell_applicable(jax_get_config(arch), JAX_SHAPE_CELLS[name])


@pytest.mark.parametrize("n", [1, 2, 4, 16, 256, 512])
@pytest.mark.parametrize("op", op_cost.COLLECTIVES)
def test_traffic_factor_matches_the_reference(op, n):
    want = jax_hlo_cost._traffic_factor(op, n)
    assert op_cost._traffic_factor(op, n) == want
    assert _reference_dryrun()._traffic_factor(op, n) == want


# The archs whose attention the reference's ``kernel_io_per_device`` models
# as the flash kernel reads it: q and the output once, K and V once. Where
# the model axis (16) divides kv_heads (deepseek-7b's 32) the two counts are
# equal. gemma2-9b, stablelm-12b, command-r-plus-104b and the VLM (self and
# cross-attention) have 8 kv heads: the rule table leaves them replicated
# over model, and a rank's kernel reads the one kv head its q heads share
# (models/tp.py), where the reference's model charges a device a sixteenth
# of the 8 heads' K and V. So there the port's K/V term is 16 / 8 = 2x the
# reference's, and its q/output term equal.
FLASH_IO_ARCHS = ["deepseek-7b", "gemma2-9b", "stablelm-12b",
                  "command-r-plus-104b", "llama-3.2-vision-90b"]


@pytest.mark.parametrize("arch", FLASH_IO_ARCHS)
def test_flash_io_per_device_matches_the_reference_at_prefill_32k(arch):
    ref = _reference_dryrun()
    cell, jcfg = JAX_SHAPE_CELLS["prefill_32k"], jax_get_config(arch)
    whole = ref.kernel_io_per_device(jcfg, cell, 256)
    q_out = ref.kernel_io_per_device(jcfg.replace(n_kv_heads=0), cell, 256)
    kv_heads = jcfg.n_kv_heads
    scale = 1 if kv_heads % 16 == 0 else 16 / kv_heads
    trace = dryrun.lower_cell(get_config(arch), SHAPE_CELLS["prefill_32k"],
                              production_mesh_shape())
    assert set(trace.census.kernel_calls) == {"flash_attention"}
    assert trace.census.kernel_io == q_out + (whole - q_out) * scale
    if arch == "deepseek-7b":
        assert trace.census.kernel_io == whole


# ---------------------------------------------------------------------------
# The trace follows the real program
# ---------------------------------------------------------------------------


def _run(fn, args, kind):
    return dryrun.trace_step(fn, args, train=kind == "train").census.summary()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "deepseek-moe-16b"])
def test_meta_trace_equals_a_cpu_run(arch, kind):
    """The same local step traced on meta tensors and run on real CPU ones
    (where each kernel call is its plain version, shaped as the card's
    call): FLOPs, materialized bytes, kernel calls and their IO equal."""
    from repro_torch.runtime import serve as serve_rt
    from repro_torch.runtime import train as train_rt
    cfg = _kernel_cfg(arch)
    model = build_model(cfg)
    cell = ShapeCell(kind, 32, 2, kind)
    meta = dryrun.lower_cell(cfg, cell).census.summary()
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    if kind == "train":
        opts = train_rt.TrainOptions(remat_policy="full")
        state = train_rt.init_train_state(model, gen, opts)
        batch = {"tokens": tokens.int(), "labels": tokens.roll(-1, 1).int()}
        real = _run(train_rt.build_train_step(model, opts), (state, batch), kind)
    else:
        opts = serve_rt.ServeOptions()
        params = model.init(gen)
        cache = model.init_cache(2, 32, device="cpu")
        if kind == "prefill":
            real = _run(serve_rt.build_prefill_step(model, opts),
                        (params, {"tokens": tokens}, cache), kind)
        else:
            real = _run(serve_rt.build_decode_step(model, opts),
                        (params, cache, tokens[:, :1], 31), kind)
    for key in ("flops", "op_flops", "materialized_bytes", "kernel_calls",
                "kernel_io", "collectives"):
        assert real[key] == meta[key], key
    assert meta["kernel_calls"] or kind == "decode"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_kernel_calls_are_the_expected_launches(chip_smoke, arch):
    """At full width, a prefill's trace calls each kernel as often as
    ``chip_smoke.py`` requires of the card's launches."""
    cfg = get_config(arch)
    trace = dryrun.lower_cell(cfg, ShapeCell("prefill", 256, 1, "prefill"))
    want = {k: n for k, n in chip_smoke.expected_launches(cfg, "prefill").items()
            if n}
    assert dict(trace.census.kernel_calls) == want


# ---------------------------------------------------------------------------
# The kernels' own counts: PERF.md section 6's bounds
# ---------------------------------------------------------------------------

# (bound function, its arguments, the bound in PERF.md's kernel table, set by)
PERF_BOUNDS = [
    ("attention_bound_ms", (4, 2048, 2048, 32, 32, 128, {}), "0.139", "operations"),
    ("attention_bound_ms", (4, 2048, 2048, 32, 32, 112, {}), "0.122", "operations"),
    ("attention_bound_ms", (4, 2048, 2048, 16, 8, 256, {"softcap": 50.0}), "0.139",
     "operations"),
    ("attention_bound_ms", (1, 6144, 6144, 16, 8, 256, {"window": 4096}), "0.278",
     "operations"),
    ("attention_bound_ms", (4, 2048, 2048, 32, 8, 160, {}), "0.174", "operations"),
    ("attention_bound_ms", (4, 2048, 4096, 64, 8, 128, {"causal": False}), "1.112",
     "operations"),
    ("attention_bound_ms", (4, 2048, 2048, 24, 2, 128, {}), "0.104", "operations"),
    ("attention_bound_ms", (4, 1500, 1500, 16, 16, 64, {"causal": False}), "0.0373",
     "operations"),
    ("attention_bound_ms", (4, 1, 1500, 16, 16, 64, {"causal": False}), "0.0073",
     "bytes"),
    ("attention_bound_ms", (4, 1, 4096, 64, 8, 128, {"causal": False}), "0.0201",
     "bytes"),
    ("attention_bwd_bound_ms", (2, 2048, 2048, 32, 32, 128, {}), "0.174", "operations"),
    ("attention_bwd_bound_ms", (2, 2048, 2048, 16, 16, 128, {}), "0.0869", "operations"),
    ("attention_bwd_bound_ms", (2, 2048, 2048, 32, 32, 112, {}), "0.152", "operations"),
    ("attention_bwd_bound_ms", (2, 2048, 2048, 16, 8, 256, {}), "0.174", "operations"),
    ("attention_bwd_bound_ms", (2, 2048, 2048, 32, 8, 160, {}), "0.217", "operations"),
    ("attention_bwd_bound_ms", (2, 2048, 2048, 8, 2, 160, {}), "0.054", "operations"),
    ("ssd_bound_ms", (4, 2048, 112, 64, 64, 2, 256, "bfloat16"), "0.0747", "bytes"),
    ("ssd_bound_ms", (4, 2048, 32, 64, 128, 1, 256, "bfloat16"), "0.0228", "bytes"),
    ("ssd_bwd_bound_ms", (2, 2048, 112, 64, 64, 2, 256, "bfloat16"), "0.0570",
     "operations"),
    ("ssd_bwd_bound_ms", (2, 2048, 32, 64, 128, 1, 256, "bfloat16"), "0.0282",
     "operations"),
    ("gmm_bound_ms", (64, 968, 2048, 1408, "bfloat16"), "0.361", "operations"),
    ("gmm_bound_ms", (64, 968, 1408, 2048, "bfloat16"), "0.361", "operations"),
    ("gmm_bound_ms", (64, 8, 2048, 1408, "bfloat16"), "0.111", "bytes"),
    ("gmm_bound_ms", (32, 976, 2048, 1408, "bfloat16"), "0.182", "operations"),
    ("gmm_bound_ms", (8, 7744, 2048, 1408, "bfloat16"), "0.361", "operations"),
    ("gmm_bwd_bound_ms", (64, 488, 2048, 1408), "0.364", "operations"),
    ("gmm_bwd_bound_ms", (64, 488, 1408, 2048), "0.364", "operations"),
]


def _digits(s: str) -> int:
    return len(s.replace(".", "").lstrip("0"))


@pytest.mark.parametrize("fn,args,want,by", PERF_BOUNDS,
                         ids=[f"{f}-{i}" for i, (f, *_) in enumerate(PERF_BOUNDS)])
def test_kernel_counts_reproduce_the_perf_bounds(chip_smoke, fn, args, want, by):
    """``chip_smoke.py``'s bounds, which read the kernel modules' counts,
    give PERF.md's kernel table to its digits (three where it gives three)."""
    ms, got_by = getattr(chip_smoke, fn)(*args)
    assert float(f"{ms:.{min(_digits(want), 3)}g}") == float(
        f"{float(want):.{min(_digits(want), 3)}g}")
    assert got_by == by


def test_train_model_flops_counts_the_routed_experts_alone(chip_smoke):
    """Model FLOPs of a train step: the shared experts are always on, the
    routed ones at top_k / E (``active_param_count``)."""
    model = build_model(get_config("deepseek-moe-16b"))
    n = model.active_param_count() - model.specs["embed"].shape[0] * \
        model.specs["embed"].shape[1]
    flops = chip_smoke.train_model_flops(model, 2, 2048)
    attn = 3 * 28 * fa.attention_cost(2, 2048, 2048, 16, 16, 128)[0]
    assert flops == 6 * n * 2 * 2048 + attn


# ---------------------------------------------------------------------------
# The census, rule by rule (tests/test_hlo_cost.py's cases)
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_views_and_in_place_updates_are_free():
    x = _meta(64, 32)
    c = op_cost.OpCensus()
    c.track([x])
    with c:
        y = x.view(32, 64).t()
        x.add_(1)
        y.mul_(2)
        x[:8].zero_()
        assert c.bytes == 0 and c.flops == 0
        z = x + 1                                    # a new buffer, x2
        w = z @ x.t()
    assert c.bytes == 2 * z.nbytes + 2 * w.nbytes
    assert c.flops == 2 * 64 * 32 * 64
    assert c.peak == x.nbytes + z.nbytes + w.nbytes


@pytest.mark.parametrize("op", op_cost.COLLECTIVES)
def test_collective_bytes_scale_by_the_ring_factor_and_the_group(op):
    t = _meta(8, 16)
    c = op_cost.OpCensus()
    with c:
        for n in (1, 4, 16):
            census.collective(op, t, n)
    totals = c.collective_totals()[op]
    assert totals["count"] == 3 and totals["raw_bytes"] == 3 * t.nbytes
    assert totals["bytes"] == sum(t.nbytes * op_cost._traffic_factor(op, n)
                                  for n in (1, 4, 16))
    assert [x["link_bytes"] for x in c.collectives] == \
        [t.nbytes * op_cost._traffic_factor(op, n) for n in (1, 4, 16)]


def test_a_collective_over_several_tensors_sums_them():
    a, b = _meta(8, 16), _meta(3, dtype=torch.float32)
    c = op_cost.OpCensus()
    with c, census.at(("groups", "g0", "attn")):
        census.collective("all-reduce", [a, b], 4)
    (rec,) = c.collectives
    assert rec["bytes"] == a.nbytes + b.nbytes
    assert rec["link_bytes"] == (a.nbytes + b.nbytes) * 2 * 3 / 4
    assert rec["site"] == "groups/g0/attn" and rec["shape"] == [[8, 16], [3]]


def test_the_collectives_record_where_the_port_issues_them():
    """``collectives.py`` reports each collective, its result and group,
    on a fake group; a Function's backward at its forward's site."""
    from repro_torch import collectives
    from repro_torch.runtime.sharding import MeshShape
    with dryrun.fake_mesh(MeshShape(("data", "model"), (2, 4))) as mesh:
        x = _meta(4, 6, dtype=torch.float32).requires_grad_()
        c = op_cost.OpCensus()
        with c:
            with census.at(("groups", "g0", "ffn", "w_down")):
                y = collectives.all_gather(x, mesh, "model", dim=0)
            s = collectives.psum(y, mesh, "data")
            (g,) = torch.autograd.grad(s, x, torch.ones_like(s))
    assert [(r["op"], r["group"], r["shape"], r["site"]) for r in c.collectives] == [
        ("all-gather", 4, [16, 6], "groups/g0/ffn/w_down"),
        ("all-reduce", 2, [16, 6], ""),
        ("all-reduce", 2, [16, 6], ""),
        ("reduce-scatter", 4, [4, 6], "groups/g0/ffn/w_down")]
    assert g.shape == x.shape


def test_the_ops_inside_a_kernel_call_are_not_counted():
    x, q = _meta(16, 16), _meta(1, 128, 2, 64)
    c = op_cost.OpCensus()
    c.track([x, q])
    with c:
        with census.kernel("k", lambda: (10, 20)):
            y = (x @ x) + 1
            with census.kernel("inner", lambda: (1, 1)):     # the outer's
                y = y * 2
        out = fa.flash_attention_cuda(q, q, q)
    assert c.bytes == 0 and c.flops == 0
    assert dict(c.kernel_calls) == {"k": 1, "flash_attention": 1}
    assert c.kernel_flops == 10 + fa.attention_cost(1, 128, 128, 2, 2, 64)[0]
    assert c.kernel_io == 20 + fa.attention_cost(1, 128, 128, 2, 2, 64)[1]
    assert c.peak >= x.nbytes + y.nbytes + out.nbytes    # memory is tracked


def test_decode_attention_is_counted_op_by_op():
    """``decode_attention`` is one call of its kernel: the census counts no
    op of it, and one ``decode_attention_kernel`` call at
    ``decode_attention_cost`` over the visible positions (a window's
    start and ``kv_len`` cut them)."""
    B, H, KVH, D, Sk = 2, 8, 2, 64, 96
    q, k = _meta(B, 1, H, D), _meta(B, Sk, KVH, D)
    c = op_cost.OpCensus()
    with c, torch.inference_mode():
        ops.decode_attention(q, k, k, q_offset=Sk - 1, kv_len=Sk)
        ops.decode_attention(q, k, k, q_offset=70, kv_len=71, window=32)
    assert c.flops == 0 and c.bytes == 0
    assert dict(c.kernel_calls) == {"decode_attention_kernel": 2}
    want = [ops.decode_attention_cost(B, 1, n, H, KVH, D) for n in (Sk, 32)]
    assert c.kernel_flops == sum(f for f, _ in want)
    assert c.kernel_io == sum(b for _, b in want)


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------


def _refuse_build(name):
    raise AssertionError(f"tried to build {name}")


def test_meta_tensors_never_build_a_kernel(monkeypatch):
    """Every wrapper's meta path, forward and backward, builds and loads no
    kernel library and counts no launch."""
    monkeypatch.setattr(_build, "build", _refuse_build)
    monkeypatch.setattr(_build, "load", _refuse_build)
    counters = [fa.flash_attention_cuda, fa.flash_attention_bwd_cuda, mg.gmm_cuda,
                mg.gmm_bwd_cuda, ss.ssd_scan_cuda, ss.ssd_scan_bwd_cuda]
    before = [f.launches for f in counters]
    q = _meta(1, 128, 2, 64).requires_grad_()
    o = fa.flash_attention_cuda(q, q, q)
    torch.autograd.grad(o, q, torch.ones_like(o))
    for dtype in (torch.bfloat16, torch.float32):
        x = _meta(2, 16, 32, dtype=dtype).requires_grad_()
        y = mg.gmm_cuda(x, _meta(2, 32, 8, dtype=dtype))
        torch.autograd.grad(y, x, torch.ones_like(y))
    x = _meta(1, 128, 2, 64).requires_grad_()
    dt = _meta(1, 128, 2, dtype=torch.float32)
    a = _meta(2, dtype=torch.float32)
    b = _meta(1, 128, 1, 64)
    y, state = ss.ssd_scan_cuda(x, dt, a, b, b, a, chunk=64)
    torch.autograd.grad(y, x, torch.ones_like(y))
    assert state.shape == (1, 2, 64, 64) and state.dtype == torch.float32
    assert [f.launches for f in counters] == before


def test_the_dry_run_needs_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(_build, "load", _refuse_build)
    trace = dryrun.lower_cell(_kernel_cfg("zamba2-7b"),
                              ShapeCell("train", 64, 2, "train"))
    assert trace.census.kernel_calls["ssd_scan_bwd"] > 0


def test_the_dry_run_refuses_a_running_group(tmp_path):
    import torch.distributed as dist
    from repro_torch.runtime.sharding import MeshShape
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already up"):
            dryrun.lower_cell(_kernel_cfg("deepseek-7b"),
                              ShapeCell("d", 8, 1, "decode"),
                              MeshShape(("data", "model"), (1, 1)))
    finally:
        dist.destroy_process_group()


def test_main_writes_a_record_per_cell(tmp_path, capsys):
    dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                 "--both-meshes", "--out", str(tmp_path)])
    assert "all requested dry-run cells passed" in capsys.readouterr().out
    for mesh in ("16x16", "2x16x16"):
        rec = json.loads((tmp_path / f"mamba2-370m_long_500k_{mesh}.json").read_text())
        assert rec["ok"] and rec["mesh"] == mesh and rec["fits_80gb"]
    dryrun.main(["--arch", "deepseek-7b", "--shape", "long_500k", "--out",
                 str(tmp_path)])
    rec = json.loads((tmp_path / "deepseek-7b_long_500k_16x16.json").read_text())
    assert rec["skipped"] and not rec["ok"] and "500k" in rec["reason"]


def test_perf_probe_names_the_collectives_and_the_memory(capsys):
    colls, mems = perf_probe.probe("mamba2-370m", "prefill_32k", top=3)
    out = capsys.readouterr().out
    assert "top collectives" in out and "top memory contributors" in out
    assert colls and all(c["link_bytes"] >= d["link_bytes"]
                         for c, d in zip(colls, colls[1:]))
    assert all(re.fullmatch(r"[\w/]*|backward:\w+", m["site"]) for m in mems)
    assert mems and mems[0]["bytes"] >= 1e8
