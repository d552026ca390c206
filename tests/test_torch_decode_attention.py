"""Decode attention's kernel wrapper (``repro_torch.kernels.decode_attention``):
its plain version against the oracle, the split planner, the meta and CPU
paths, the census's count and what the kernel refuses, on the CPU; and the
kernel against its plain version on the card (``cuda``-marked, skipped
here). Imports torch and the port only:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_decode_attention.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.launch import op_cost  # noqa: E402

# the bf16 decode-step tolerance of tests/test_torch_families.py
# (``DECODE_STEP_TOL["bfloat16"]``), absolute and relative
DECODE_STEP_TOL = 6e-2
# the worst (b, h) row's |kernel - plain| / |plain|, 2-norms over D: a limit
# on the output's own scale. Over thousands of positions an output element
# is about sqrt(e / n) (0.018 at 8632), so DECODE_STEP_TOL alone would pass
# an all-zero output; one split of 68 left out moves a row by about 0.1
ROW_RTOL = 1e-2
# (B, KVH, visible lengths) of the serve cells' decode steps: deepseek-7b's
# 32 kv heads at the agent turn (B = 4, prompts 6640-8632, 24 new tokens)
# and at RAG synthesis (B = 32, 1200 in, 200 out)
CELL_SHAPES = {"agent_turn": (4, 32, range(6641, 8656)),
               "rag_synth": (32, 32, range(1201, 1400))}
GROUPS = (1, 2, 4, 8, 12)
KV_LENS = (1, 127, 128, 129, 8632)


def _qkv(seed, B, Sk, H, KVH, D, dtype=torch.bfloat16, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(device, dtype)
                 for shape in ((B, 1, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D)))


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _row_err(got, want) -> float:
    """The worst (b, h) row's |got - want| / |want|, 2-norms over D."""
    d, w = got.float() - want.float(), want.float()
    return (d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max().item()


def _within(got, want):
    return _row_err(got, want) <= ROW_RTOL and np.allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(),
        atol=DECODE_STEP_TOL, rtol=DECODE_STEP_TOL)


def _errors(got, want) -> str:
    return (f"max abs {(got.float() - want.float()).abs().max().item():.3g}, "
            f"worst row {_row_err(got, want):.3g}")


def _refuse_build(name):
    raise AssertionError(f"tried to build {name}")


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("kw", [{}, {"window": 16, "logit_softcap": 30.0},
                                {"scale": 0.07}], ids=["plain", "window_softcap", "scale"])
def test_plain_version_is_the_oracle_over_the_valid_prefix(g, kw):
    """Over a cache longer than ``kv_len`` (its tail is garbage the masks
    must hide), the plain version is ``ref.mha_naive`` on the prefix."""
    B, KVH, D, Sk, idx = 2, 2, 32, 72, 50
    q, k, v = _qkv(1, B, Sk, g * KVH, KVH, D, torch.float32)
    k[:, idx + 1:], v[:, idx + 1:] = 1e4, -1e4
    got = da.decode_attention_plain(q, k, v, q_offset=idx, kv_len=idx + 1, **kw)
    want = ref.mha_naive(q, k[:, :idx + 1], v[:, :idx + 1], q_offset=idx, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cell", sorted(CELL_SHAPES))
def test_split_plan_fills_the_card_at_the_cells(cell):
    """At every decode step of both serve cells the grid is at least one
    wave of the card's SMs, and no run is under ``MIN_RUN`` positions."""
    B, KVH, lengths = CELL_SHAPES[cell]
    for n in lengths:
        splits = da.split_count(B * KVH, n)
        assert B * KVH * splits >= da.SMS
        assert splits == 1 or -(-n // splits) >= da.MIN_RUN
    assert da.split_count(4 * 32, 8640) == 17
    assert da.split_count(32 * 32, 1300) == 3


@pytest.mark.parametrize("window", [0, 100, 4096])
@pytest.mark.parametrize("kv_len", KV_LENS + (6641, 1300))
def test_split_ranges_cover_the_visible_positions_once(kv_len, window):
    lo, hi = da.visible_range(kv_len + 24, kv_len - 1, kv_len, window)
    assert hi == kv_len and lo == (max(0, kv_len - window) if window else 0)
    for pairs, step in ((1, 128), (8, 256), (128, 128), (1024, 32), (1024, 1)):
        splits = da.split_count(pairs, hi - lo)
        ranges = da.split_ranges(lo, hi, splits, step)
        assert len(ranges) == splits
        seen = [p for a, b in ranges for p in range(a, b)]
        assert seen == list(range(lo, hi))
        assert all(a <= b for a, b in ranges)
        assert all((b - a) % step == 0 for a, b in ranges if b < hi)


@pytest.mark.parametrize("D, g, step", [(64, 1, 256), (112, 1, 128), (128, 1, 128),
                                         (128, 2, 128), (160, 4, 32), (256, 2, 64),
                                         (128, 8, 32), (64, 12, 64)])
def test_split_step_is_the_kernels_block_step(D, g, step):
    assert da.split_step(D, g) == step


def test_visible_range_takes_the_tightest_mask():
    assert da.visible_range(100, 40, 80) == (0, 41)         # causal
    assert da.visible_range(100, 90, 60) == (0, 60)         # kv_len
    assert da.visible_range(50, 90, 200) == (0, 50)         # the cache's end
    assert da.visible_range(100, 40, 41, window=8) == (33, 41)


def test_meta_path_gives_the_kernels_output_unlaunched(monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse_build)
    before = da.decode_attention_cuda.launches
    q, k = _meta(3, 1, 24, 128), _meta(3, 40, 2, 128)
    out = ops.decode_attention(q, k, k, q_offset=30, kv_len=31)
    assert out.shape == (3, 1, 24, 128) and out.dtype == torch.bfloat16
    assert out.device.type == "meta"
    assert da.decode_attention_cuda.launches == before


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_a_census_counts_one_kernel_call_at_the_visible_cost(device, monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse_build)
    B, H, KVH, D, Sk = 2, 8, 2, 64, 96
    if device == "meta":
        q, k, v = _meta(B, 1, H, D), _meta(B, Sk, KVH, D), _meta(B, Sk, KVH, D)
    else:
        q, k, v = _qkv(2, B, Sk, H, KVH, D)
    c = op_cost.OpCensus()
    with c, torch.inference_mode():
        out = ops.decode_attention(q, k, v, q_offset=60, kv_len=61, window=20)
    assert out.shape == (B, 1, H, D)
    assert dict(c.kernel_calls) == {da.KERNEL: 1}
    assert (c.kernel_flops, c.kernel_io) == da.decode_attention_cost(B, 1, 20, H, KVH, D)
    assert c.flops == 0


def test_cpu_wrapper_takes_the_plain_version_without_counting(monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse_build)
    before = da.decode_attention_cuda.launches
    q, k, v = _qkv(3, 2, 64, 8, 2, 64)
    got = da.decode_attention_cuda(q, k, v, q_offset=40, kv_len=41)
    want = da.decode_attention_plain(q, k, v, q_offset=40, kv_len=41)
    assert torch.equal(got, want)
    assert da.decode_attention_cuda.launches == before


@pytest.mark.parametrize("case", ["fp32_cache", "two_rows", "tensor_positions",
                                  "fp32_arithmetic", "group_16", "head_dim_96",
                                  "nothing_visible"])
def test_the_kernels_path_raises_on_what_it_does_not_take(case):
    B, H, KVH, D, Sk = 2, 8, 2, 128, 64
    q, k = _meta(B, 1, H, D), _meta(B, Sk, KVH, D)
    kw = dict(q_offset=40, kv_len=41)
    if case == "fp32_cache":
        k = _meta(B, Sk, KVH, D, dtype=torch.float32)
    elif case == "two_rows":
        q = _meta(B, 2, H, D)
    elif case == "tensor_positions":
        kw = dict(q_offset=torch.tensor(40), kv_len=torch.tensor(41))
    elif case == "fp32_arithmetic":
        kw["bf16_kv"] = False
    elif case == "group_16":
        q = _meta(B, 1, 16 * KVH, D)
    elif case == "head_dim_96":
        q, k = _meta(B, 1, H, 96), _meta(B, Sk, KVH, 96)
    elif case == "nothing_visible":
        kw = dict(q_offset=40, kv_len=41, window=0)
        k = _meta(B, 0, KVH, D)
    with pytest.raises(ValueError):
        da.decode_attention_cuda(q, k, k, **kw)


@pytest.mark.parametrize("kv_len", [1300, 8632])
def test_the_limits_see_a_dropped_split_on_random_inputs(kv_len):
    """The limits the kernel is held to on the card have the power to see
    one split's keys left out, or no output at all, on ordinary random
    inputs: the elementwise tolerance alone passes both at 8632 positions,
    the row limit fails both."""
    D, g = 128, 1
    q, k, v = _qkv(8, 1, kv_len, g, 1, D)
    kw = dict(q_offset=kv_len - 1, kv_len=kv_len)
    want = da.decode_attention_plain(q, k, v, **kw)
    splits = da.split_count(1, kv_len)
    ranges = [r for r in da.split_ranges(0, kv_len, splits, da.split_step(D, g))
              if r[1] > r[0]]
    a, b = ranges[len(ranges) // 2]
    kd, vd = (torch.cat([t[:, :a], t[:, b:]], 1) for t in (k, v))
    n = kv_len - (b - a)
    dropped = da.decode_attention_plain(q, kd, vd, q_offset=n - 1, kv_len=n)
    for fault in (dropped, torch.zeros_like(want)):
        assert _row_err(fault, want) > 5 * ROW_RTOL
        assert not _within(fault, want)
    if kv_len == 8632:
        for fault in (dropped, torch.zeros_like(want)):
            assert np.allclose(fault.float().numpy(), want.float().numpy(),
                               atol=DECODE_STEP_TOL, rtol=DECODE_STEP_TOL)
    assert _within(want, want)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_inputs(seed, B, kv_len, g, KVH, D, cuda, tail=5):
    """q, k, v on the card over a cache ``tail`` positions longer than
    ``kv_len``, whose tail holds large values no visible score may read."""
    q, k, v = _qkv(seed, B, kv_len + tail, g * KVH, KVH, D, device=cuda)
    k[:, kv_len:], v[:, kv_len:] = 1e4, -1e4
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", KV_LENS)
@pytest.mark.parametrize("D", da.HEAD_DIMS)
@pytest.mark.parametrize("g", GROUPS)
def test_kernel_vs_plain(cuda, g, D, kv_len):
    q, k, v = _card_inputs(4, 2, kv_len, g, 2, D, cuda)
    before = da.decode_attention_cuda.launches
    got = da.decode_attention_cuda(q, k, v, q_offset=kv_len - 1, kv_len=kv_len)
    torch.cuda.synchronize()
    assert da.decode_attention_cuda.launches == before + 1
    want = da.decode_attention_plain(q, k, v, q_offset=kv_len - 1, kv_len=kv_len)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert _within(got, want), _errors(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", KV_LENS)
@pytest.mark.parametrize("D", da.HEAD_DIMS)
@pytest.mark.parametrize("g", GROUPS)
def test_kernel_vs_plain_with_window_and_softcap(cuda, g, D, kv_len):
    kw = dict(q_offset=kv_len - 1, kv_len=kv_len, window=100, logit_softcap=50.0,
              scale=224 ** -0.5)
    q, k, v = _card_inputs(5, 2, kv_len, g, 2, D, cuda)
    got = da.decode_attention_cuda(q, k, v, **kw)
    want = da.decode_attention_plain(q, k, v, **kw)
    assert _within(got, want), _errors(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len, g", [(8632, 1), (8632, 4), (1300, 12)])
def test_a_dropped_split_exceeds_the_tolerance(cuda, kv_len, g):
    """On ordinary random inputs, the kernel run over the cache without its
    middle split's keys (one split dropped) is outside the limits the
    kernel is held to, and the whole cache inside them."""
    D = 128
    q, k, v = _card_inputs(6, 2, kv_len, g, 2, D, cuda, tail=0)
    kw = dict(q_offset=kv_len - 1, kv_len=kv_len)
    want = da.decode_attention_plain(q, k, v, **kw)
    whole = da.decode_attention_cuda(q, k, v, **kw)
    assert _within(whole, want), _errors(whole, want)
    splits = da.split_count(4, kv_len)
    assert splits > 2
    ranges = [r for r in da.split_ranges(0, kv_len, splits, da.split_step(D, g))
              if r[1] > r[0]]
    a, b = ranges[len(ranges) // 2]
    kd, vd = (torch.cat([t[:, :a], t[:, b:]], 1).contiguous() for t in (k, v))
    n = kv_len - (b - a)
    dropped = da.decode_attention_cuda(q, kd, vd, q_offset=n - 1, kv_len=n)
    assert _row_err(dropped, want) > ROW_RTOL, _errors(dropped, want)
    assert not _within(dropped, want)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 12])
def test_two_runs_agree_bitwise(cuda, g):
    kv_len = 8632
    q, k, v = _card_inputs(7, 2, kv_len, g, 4, 128, cuda)
    kw = dict(q_offset=kv_len - 1, kv_len=kv_len)
    assert da.split_count(8, kv_len) > 1
    first = da.decode_attention_cuda(q, k, v, **kw)
    second = da.decode_attention_cuda(q, k, v, **kw)
    assert torch.equal(first, second)
