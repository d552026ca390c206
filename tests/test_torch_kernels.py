"""Port vs reference: attention, SSD and grouped-matmul oracles, the
flash-attention, SSD-scan and grouped-GEMM modules and the decode steps, on
the same seeded numpy inputs through JAX and torch.

The JAX side runs the Pallas kernel in interpret mode (as tests/test_kernels.py
does) and its pure-jnp oracle; the port's CUDA kernel runs only on a card
(tests/test_torch_cuda.py), and on the CPU its wrapper takes the plain
version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.moe_gmm import gmm_pallas  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as mg  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, Sq, Sk, H, KVH, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Sk, KVH, D), np.float32),
            rng.standard_normal((B, Sk, KVH, D), np.float32))


def _both(arrays, dtype):
    """The same values as JAX and torch arrays of ``dtype``."""
    j = [jnp.asarray(a).astype(JDT[dtype]) for a in arrays]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


GRID = [
    (1, 128, 128, 4, 4, 64),     # MHA
    (2, 128, 128, 4, 2, 64),     # GQA 2:1
    (1, 256, 256, 8, 1, 32),     # MQA
    (1, 100, 100, 4, 2, 64),     # ragged
    (1, 64, 192, 2, 2, 128),     # cross lengths
]


@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_vs_pallas_and_oracle(B, Sq, Sk, H, KVH, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, B, Sq, Sk, H, KVH, D), dtype)
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, interpret=True,
                                    block_q=64, block_k=64)
    oracle = jref.mha_naive(jq, jk, jv, causal=True)
    for got in (ref.mha_naive(tq, tk, tv, causal=True),
                ref.mha_chunked(tq, tk, tv, causal=True, block_k=64),
                ops.flash_attention(tq, tk, tv, causal=True)):
        assert got.dtype == TDT[dtype] and got.shape == (B, Sq, H, D)
        _close(got, pallas, TOL[dtype])
        _close(got, oracle, TOL[dtype])


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_window_softcap_vs_pallas(window, softcap):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 1, 128, 128, 4, 2, 64), "float32")
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                  softcap=softcap, interpret=True,
                                  block_q=64, block_k=64)
    for got in (ref.mha_naive(tq, tk, tv, window=window, logit_softcap=softcap),
                ops.flash_attention(tq, tk, tv, window=window,
                                    logit_softcap=softcap)):
        _close(got, want, 2e-5)


def test_kv_valid_mask_vs_pallas():
    """Decode-style: only the first kv_valid cache entries count."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 1, 1, 256, 4, 2, 64), "float32")
    want = flash_attention_pallas(jq, jk, jv, causal=True, q_offset=99,
                                  kv_valid=100, interpret=True)
    _close(ops.flash_attention(tq, tk, tv, q_offset=99, kv_len=100), want, 2e-5)
    _close(fa.flash_attention_plain(tq, tk, tv, q_offset=99, kv_valid=100),
           want, 2e-5)


@pytest.mark.parametrize("oracle", ["mha_naive", "mha_chunked"])
def test_reference_per_row_kv_len_vs_reference(oracle):
    """The plain oracles take (B,) valid lengths, as the JAX ones do."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 2, 4, 64, 4, 2, 32), "float32")
    lens = np.array([40, 64], np.int32)
    kw = {"block_k": 16} if oracle == "mha_chunked" else {}
    want = getattr(jref, oracle)(jq, jk, jv, causal=False,
                                 kv_len=jnp.asarray(lens), **kw)
    got = getattr(ref, oracle)(tq, tk, tv, causal=False,
                               kv_len=torch.from_numpy(lens), **kw)
    _close(got, want, 2e-5)


def test_chunked_equals_naive():
    _, (tq, tk, tv) = _both(_qkv(3, 2, 96, 96, 4, 2, 32), "float32")
    _close(ref.mha_chunked(tq, tk, tv, block_k=32),
           ref.mha_naive(tq, tk, tv), 1e-5)


@pytest.mark.parametrize("bf16_kv", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_vs_reference(bf16_kv, dtype):
    B, Sk, H, KVH, D, idx = 2, 64, 4, 2, 32, 40
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(5, B, 1, Sk, H, KVH, D), dtype)
    want = jops.decode_attention(jq, jk, jv, q_offset=idx, kv_len=idx + 1,
                                 bf16_kv=bf16_kv)
    got = ops.decode_attention(tq, tk, tv, q_offset=idx, kv_len=idx + 1,
                               bf16_kv=bf16_kv)
    assert got.dtype == TDT[dtype]
    _close(got, want, TOL[dtype])


def test_decode_attention_tensor_positions_vs_reference():
    """Per-row positions and valid lengths given as arrays, as a traced
    decode step passes them."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(9, 3, 1, 48, 4, 2, 32), "float32")
    lens = np.array([10, 48, 30], np.int32)
    want = jops.decode_attention(jq, jk, jv, q_offset=jnp.asarray(lens - 1),
                                 kv_len=jnp.asarray(lens))
    got = ops.decode_attention(tq, tk, tv, q_offset=torch.from_numpy(lens - 1),
                               kv_len=torch.from_numpy(lens))
    _close(got, want, 2e-5)


def test_decode_attention_matches_flash_over_prefix():
    _, (tq, tk, tv) = _both(_qkv(5, 2, 1, 64, 4, 2, 32), "float32")
    got = ops.decode_attention(tq, tk, tv, q_offset=40, kv_len=41)
    want = ref.mha_naive(tq, tk[:, :41], tv[:, :41], q_offset=40)
    _close(got, want, 1e-5)


def test_decode_attention_window_softcap_vs_reference():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(6, 1, 1, 64, 4, 2, 32), "float32")
    kw = dict(window=16, logit_softcap=30.0, q_offset=50, kv_len=51)
    _close(ops.decode_attention(tq, tk, tv, **kw),
           jops.decode_attention(jq, jk, jv, **kw), 2e-5)


def test_cpu_wrapper_takes_plain_version_without_counting(monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse_build)
    before = fa.flash_attention_cuda.launches
    _, (tq, tk, tv) = _both(_qkv(7, 1, 64, 64, 2, 2, 64), "bfloat16")
    got = fa.flash_attention_cuda(tq, tk, tv)
    _close(got, fa.flash_attention_plain(tq, tk, tv), 0.0)
    assert fa.flash_attention_cuda.launches == before


def _refuse_build(name):
    raise AssertionError(f"tried to build {name} on a CPU-only path")


@pytest.mark.parametrize("case", ["dtype", "head_dim", "contiguous", "gqa"])
def test_check_inputs_rejects_what_the_kernel_does_not_take(case):
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    v = k.clone()
    fa.check_inputs(q, k, v)        # the accepted form
    if case == "dtype":
        q = q.float()
    elif case == "head_dim":
        q, k, v = q[..., :32].contiguous(), k[..., :32].contiguous(), \
            v[..., :32].contiguous()
    elif case == "contiguous":
        q = torch.zeros(1, 4, 8, 64, dtype=torch.bfloat16).transpose(1, 2)
    else:
        k = torch.zeros(1, 8, 3, 64, dtype=torch.bfloat16)
        v = k.clone()
    with pytest.raises(ValueError):
        fa.check_inputs(q, k, v)


# (B, S, H, KVH, D, options): the new head dims at small size with the GQA
# groups of their models and gemma2's scale and softcaps
NEW_HEAD_DIM_CASES = [
    (2, 64, 4, 2, 256, {"window": 16, "logit_softcap": 50.0,
                        "scale": 224 ** -0.5}),
    (1, 80, 4, 2, 256, {"logit_softcap": 20.0}),
    (2, 64, 8, 2, 160, {}),
    (1, 70, 4, 1, 160, {"window": 24}),
]


@pytest.mark.parametrize("B,S,H,KVH,D,kw", NEW_HEAD_DIM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_at_new_head_dims_vs_reference(B, S, H, KVH, D, kw,
                                                     dtype):
    """The plain version (the CPU path of the wrapper) at head_dim 256
    (gemma2-9b) and 160 (stablelm-12b) against the reference's naive oracle
    and its Pallas kernel in interpret mode."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(5, B, S, S, H, KVH, D), dtype)
    oracle = jref.mha_naive(jq, jk, jv, **kw)
    pallas = flash_attention_pallas(
        jq, jk, jv, causal=True, window=kw.get("window", 0),
        softcap=kw.get("logit_softcap", 0.0), scale=kw.get("scale"),
        interpret=True, block_q=32, block_k=32)
    got = ops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, D)
    _close(got, oracle, TOL[dtype])
    _close(got, pallas, TOL[dtype])


@pytest.mark.parametrize("D,takes", [(160, True), (256, True), (96, False),
                                     (192, False)])
def test_check_inputs_takes_the_built_head_dims(D, takes):
    """160 and 256 are built; 96 and 192 (160's padded width) are not."""
    q = torch.zeros(1, 8, 4, D, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, D, dtype=torch.bfloat16)
    if takes:
        fa.check_inputs(q, k, k.clone())
    else:
        with pytest.raises(ValueError, match="head_dim"):
            fa.check_inputs(q, k, k.clone())


def test_smem_budget_at_new_head_dims():
    """At 160 and 256 a block is one consumer warpgroup (a 64-row Q tile) and
    a producer warp over two stages of K and V tiles: 96-row tiles at 160 in
    three boxes (run at 192), 64-row tiles at 256 in four."""
    assert fa.smem_bytes(d=160) == (64 + 4 * 96) * 3 * 128 + 1152 == 173184
    assert fa.smem_bytes(d=256) == (64 + 4 * 64) * 4 * 128 + 1152 == 164992
    assert fa.block_q(160) == fa.block_q(256) == 64
    assert fa.block_threads(160) == fa.block_threads(256) == 160
    assert fa.block_q(128) == 128 and fa.block_threads(128) == 384
    # five warps: two a sub-partition at most, so a thread may hold 255
    # registers, where twelve (or nine) warps cap it at 168
    assert all(-(-fa.block_threads(d) // 32) <= 8 for d in (160, 256))
    assert all(fa.smem_bytes(d=d) <= 232448 for d in fa.HEAD_DIMS)


def test_smem_budget():
    """The kernel's shared memory fits a Hopper block at every head dim: a
    128-row Q tile and two stages of 96-row K and V tiles, rows in 64-column
    boxes of 128 bytes, 128 bytes of mbarriers and 1 KB of alignment slack."""
    assert fa.smem_bytes(d=128) == (128 + 4 * 96) * 2 * 128 + 128 + 1024 == 132224
    assert fa.smem_bytes(d=112) == fa.smem_bytes(d=128)   # two boxes, as 128
    assert fa.smem_bytes(d=64) == (128 + 4 * 96) * 128 + 1152 == 66688
    assert all(fa.smem_bytes(d=d) <= 232448 for d in fa.HEAD_DIMS)


@pytest.mark.parametrize("D", sorted(fa.BWD_TILES))
def test_backward_tile_plan_fits_a_hopper_block(D):
    """Each row of the backward's tile plan: dK and dV's column parts cover
    the padded head dim in parts of at most two 64-column boxes (64 fp32
    registers a thread for each of dK and dV), and both kernels' shared
    memory fits the 232 448 bytes of a Hopper block: dkdv's 64-row K and V,
    its stages of Q and dO tiles of a step's rows with their LSE and Delta,
    two buffers of P dy; dq's 64-row Q and dO and its stages of 32-row K
    and V. Two dq blocks share an SM up to head_dim 128."""
    parts, q_step, dkdv_stages, dq_stages = fa.BWD_TILES[D]
    assert sum(parts) == fa.head_dim_boxes(D) and max(parts) <= 2
    assert q_step in (32, 64) and min(dkdv_stages, dq_stages) >= 2
    row = fa.padded_head_dim(D) * 2
    assert fa.bwd_smem_bytes(D, "dq") == (2 * 64 + 2 * dq_stages * 32) * row + 1152
    assert fa.bwd_smem_bytes(D, "dkdv") == \
        (2 * 64 + 2 * dkdv_stages * q_step) * row + \
        (2 * 64 + 2 * dkdv_stages) * q_step * 4 + 1152
    assert max(fa.bwd_smem_bytes(D, k) for k in ("dkdv", "dq")) <= 232448
    assert fa.bwd_blocks_per_sm(D, "dkdv") == 1
    assert fa.bwd_blocks_per_sm(D, "dq") == (2 if D <= 128 else 1)


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_check_bwd_inputs_takes_every_head_dim(D):
    """The backward takes every head dim the forward does (``BWD_HEAD_DIMS``
    is ``HEAD_DIMS``); only a q_offset is refused."""
    assert fa.BWD_HEAD_DIMS == fa.HEAD_DIMS
    q = torch.zeros(1, 8, 4, D, dtype=torch.bfloat16)
    fa.check_bwd_inputs(q)
    with pytest.raises(ValueError, match="q_offset"):
        fa.check_bwd_inputs(q, q_offset=3)


@pytest.mark.parametrize("d,boxes,padded", [(64, 1, 64), (112, 2, 128),
                                            (128, 2, 128), (160, 3, 192),
                                            (256, 4, 256)])
def test_head_dim_box_split(d, boxes, padded):
    """The 128-byte swizzle caps a TMA box row at 64 bf16, so head_dim is
    read in 64-column boxes; 112 takes two (its last 16 columns read past
    the edge as zeros) and the products run at the padded width 128."""
    assert fa.head_dim_boxes(d) == boxes
    assert fa.padded_head_dim(d) == padded == boxes * fa.BOX
    assert fa.BOX * 2 == 128 and padded - d < fa.BOX


def test_library_name_hashes_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared csrc/*.cuh header alone gives a new library name,
    so a stale build is never reused; an unchanged tree keeps its name."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// v1\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    assert first.parent == tmp_path / "build" and first.name.startswith("libk-")
    header.write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)
    assert _build.ptxas_report(first).name == first.name + ".ptxas.txt"


@pytest.mark.parametrize("name", ["flash_attention", "moe_gmm", "ssd_scan"])
def test_nvcc_command_targets_sm90a(name):
    cmd = _build.nvcc_command(name, _build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith(f"csrc/{name}.cu")
    lib = _build.library_path(name)
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

SSD_GRID = [                    # tests/test_kernels.py TestSSDScan
    (1, 64, 2, 16, 16, 1, 16),
    (2, 128, 4, 32, 16, 2, 32),
    (1, 96, 2, 16, 32, 1, 32),
]
SSD_TOL = 1e-4


def _ssd_inputs(seed, B, L, H, P, N, G):
    """x, dt, a_log, b, c, d_skip as the JAX kernel test draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    a_log = np.full(H, 0.5, np.float32)
    b = rng.standard_normal((B, L, G, N)).astype(np.float32) * 0.3
    c = rng.standard_normal((B, L, G, N)).astype(np.float32) * 0.3
    d_skip = rng.standard_normal(H).astype(np.float32)
    return x, dt, a_log, b, c, d_skip


def _ssd_both(seed, *shape):
    arrays = _ssd_inputs(seed, *shape)
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("B,L,H,P,N,G,chunk", SSD_GRID)
def test_ssd_vs_pallas_and_reference(B, L, H, P, N, G, chunk):
    j, t = _ssd_both(0, B, L, H, P, N, G)
    y_p, st_p = ssd_scan_pallas(*j, chunk=chunk, interpret=True)
    y_r, st_r = jref.ssd_chunked(*j, chunk_size=chunk)
    for y, st in (ref.ssd_naive(*t), ref.ssd_chunked(*t, chunk_size=chunk),
                  ops.ssd_scan(*t, chunk=chunk)):
        assert y.shape == (B, L, H, P) and st.shape == (B, H, P, N)
        assert st.dtype == torch.float32
        for want_y, want_st in ((y_p, st_p), (y_r, st_r)):
            _close(y, want_y, SSD_TOL)
            _close(st, want_st, SSD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_and_naive_vs_reference_in_dtype(dtype):
    """x, b, c in the model's dtype: y comes back in it, the state in fp32."""
    arrays = _ssd_inputs(1, 2, 64, 4, 16, 16, 2)
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    for i in (0, 3, 4):
        j[i], t[i] = j[i].astype(JDT[dtype]), t[i].to(TDT[dtype])
    for name, kw in (("ssd_naive", {}), ("ssd_chunked", {"chunk_size": 16})):
        y_w, st_w = getattr(jref, name)(*j, **kw)
        y, st = getattr(ref, name)(*t, **kw)
        assert y.dtype == TDT[dtype] and st.dtype == torch.float32
        _close(y, y_w, TOL[dtype])
        _close(st, st_w, SSD_TOL)


def test_ssd_decode_step_matches_scan():
    """Stepwise recurrent decode == chunked scan on the same sequence, and
    each step == the reference's step."""
    B, L, H, P, N, G = 1, 32, 2, 16, 16, 1
    j, t = _ssd_both(7, B, L, H, P, N, G)
    x, dt, a_log, b, c, d_skip = t
    y_scan, st_scan = ref.ssd_chunked(*t, chunk_size=16)
    state, j_state, ys = torch.zeros(B, H, P, N), jnp.zeros((B, H, P, N)), []
    for i in range(L):
        y_t, state = ops.ssd_decode_step(state, x[:, i], dt[:, i], a_log,
                                         b[:, i], c[:, i], d_skip)
        jy_t, j_state = jref.ssd_decode_step(
            j_state, j[0][:, i], j[1][:, i], j[2], j[3][:, i], j[4][:, i], j[5])
        _close(y_t, jy_t, SSD_TOL)
        ys.append(y_t)
    _close(torch.stack(ys, 1), y_scan, SSD_TOL)
    _close(state, st_scan, SSD_TOL)
    _close(state, j_state, SSD_TOL)


def test_ssd_chunked_requires_whole_chunks():
    _, t = _ssd_both(2, 1, 48, 2, 16, 16, 1)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ref.ssd_chunked(*t, chunk_size=32)


def test_ssd_cpu_wrapper_takes_plain_version_without_counting(monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse_build)
    before = ss.ssd_scan_cuda.launches
    _, t = _ssd_both(3, 1, 64, 2, 16, 16, 1)
    y, st = ss.ssd_scan_cuda(*t, chunk=16)
    y_w, st_w = ss.ssd_scan_plain(*t, chunk=16)
    _close(y, y_w, 0.0)
    _close(st, st_w, 0.0)
    assert ss.ssd_scan_cuda.launches == before


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "dt_dtype", "head_dim",
                                  "d_state", "chunk", "contiguous", "groups"])
def test_ssd_check_inputs_rejects_what_the_kernel_does_not_take(case):
    B, L, H, P, N, G = 1, 64, 4, 32, 16, 2
    x = torch.zeros(B, L, H, P, dtype=torch.bfloat16)
    dt = torch.zeros(B, L, H)
    b = torch.zeros(B, L, G, N, dtype=torch.bfloat16)
    c = b.clone()
    vec = torch.zeros(H)
    chunk = 32
    ss.check_inputs(x, dt, vec, b, c, vec, chunk)    # the accepted form
    if case == "dtype":
        x, b, c = x.half(), b.half(), c.half()
    elif case == "mixed_dtype":
        b = b.float()
    elif case == "dt_dtype":
        dt = dt.bfloat16()
    elif case == "head_dim":
        x = torch.zeros(B, L, H, 24, dtype=torch.bfloat16)
    elif case == "d_state":
        b = c = torch.zeros(B, L, G, 256, dtype=torch.bfloat16)
    elif case == "chunk":
        chunk = 24
    elif case == "contiguous":
        x = torch.zeros(B, H, L, P, dtype=torch.bfloat16).transpose(1, 2)
    else:
        b = c = torch.zeros(B, L, 3, N, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ss.check_inputs(x, dt, vec, b, c, vec, chunk)


def test_ssd_smem_budget():
    """The SSD kernel's shared memory at each state width the models use:
    two blocks of the widest (mamba2-370m, N=128) fit one SM's 228 KB."""
    assert ss.smem_bytes(128) == 112128
    assert ss.smem_bytes(64) == 71168
    assert 2 * (ss.smem_bytes(128) + 1024) <= 233472


def test_ssd_wgmma_smem_budget():
    """The wgmma variant's blocks at each state width the models use:
    chunk_state's 2-stage ring of x and b boxes, and chunk_scan's C tile,
    entering state hi and lo and ring, each with its barriers and 1 KB of
    alignment slack; at N=128 two chunk_scan blocks still fit one SM."""
    assert ss.wgmma_smem_bytes("chunk_state", 64) == 33824
    assert ss.wgmma_smem_bytes("chunk_state", 128) == 50208
    assert ss.wgmma_smem_bytes("chunk_scan", 64) == 58416
    assert ss.wgmma_smem_bytes("chunk_scan", 128) == 99376
    assert 2 * (ss.wgmma_smem_bytes("chunk_scan", 128) + 3072 + 1024) <= 233472


# (x shape, b shape, chunk, dtype, variant): the model shapes (zamba2-7b,
# mamba2-370m, chunk 256 and 128), the reduced configs (P = 16), the
# kernel-test grid and its P = 32 cases, fp32, and the edges of the set
SSD_VARIANT_CASES = [
    ((4, 2048, 112, 64), (4, 2048, 2, 64), 256, "bfloat16", "wgmma"),
    ((4, 2048, 32, 64), (4, 2048, 1, 128), 256, "bfloat16", "wgmma"),
    ((1, 512, 32, 64), (1, 512, 1, 128), 128, "bfloat16", "wgmma"),
    ((2, 64, 4, 64), (2, 64, 1, 64), 256, "bfloat16", "wgmma"),
    ((4, 2048, 112, 64), (4, 2048, 2, 64), 256, "float32", "fma"),
    ((2, 256, 4, 32), (2, 256, 2, 64), 64, "bfloat16", "fma"),
    ((2, 64, 8, 16), (2, 64, 2, 16), 16, "bfloat16", "fma"),
    ((2, 128, 4, 64), (2, 128, 1, 32), 64, "bfloat16", "fma"),
    ((2, 200, 4, 64), (2, 200, 1, 64), 100, "bfloat16", "fma"),
    ((2, 96, 4, 64), (2, 96, 1, 64), 128, "bfloat16", "fma"),
]


@pytest.mark.parametrize("xs,bs,chunk,dtype,variant", SSD_VARIANT_CASES)
def test_ssd_variant_follows_shapes_and_dtype(xs, bs, chunk, dtype, variant):
    """bf16 with P = 64, N = 64 or 128 and an effective chunk (min(chunk,
    L)) that is a multiple of 64 up to 256 takes wgmma; everything else
    fma. The choice reads only shapes and the dtype."""
    x = torch.empty(xs, dtype=TDT[dtype], device="meta")
    b = torch.empty(bs, dtype=TDT[dtype], device="meta")
    assert ss.ssd_variant(x, b, chunk) == variant
    assert variant in ss.VARIANTS


def test_ssd_cpu_wrapper_counts_no_variant(monkeypatch):
    """On the CPU the plain version runs and no variant's count moves."""
    monkeypatch.setattr(_build, "load", _refuse_build)
    before = dict(ss.ssd_scan_cuda.variant_launches)
    _, t = _ssd_both(4, 1, 128, 2, 64, 64, 1)
    ss.ssd_scan_cuda(*t, chunk=64)
    assert ss.ssd_scan_cuda.variant_launches == before
    assert set(before) == set(ss.VARIANTS)


def test_ssd_check_inputs_rejects_unaligned_tma_operands():
    """The wgmma variant reads x, b and c by TMA, which needs 16-byte
    aligned bases: a contiguous view 2 bytes into its storage is refused."""
    B, L, H, P, N, G = 1, 64, 2, 64, 64, 1
    x = torch.zeros(B * L * H * P + 1, dtype=torch.bfloat16)[1:].view(B, L, H, P)
    b = torch.zeros(B, L, G, N, dtype=torch.bfloat16)
    vec = torch.zeros(H)
    assert ss.ssd_variant(x, b, 64) == "wgmma"
    with pytest.raises(ValueError, match="aligned"):
        ss.check_inputs(x, torch.zeros(B, L, H), vec, b, b.clone(), vec, 64)
    ss.check_inputs(x.clone(), torch.zeros(B, L, H), vec, b, b.clone(), vec, 64)


@pytest.mark.parametrize("xs,bs,chunk,dtype,variant", SSD_VARIANT_CASES)
def test_ssd_bwd_variant_follows_the_forwards_rule(xs, bs, chunk, dtype, variant):
    """The backward takes the forward's variant at every shape: a model
    shape is wgmma both ways."""
    x = torch.empty(xs, dtype=TDT[dtype], device="meta")
    b = torch.empty(bs, dtype=TDT[dtype], device="meta")
    assert ss.ssd_bwd_variant(x, b, chunk) == variant == ss.ssd_variant(x, b, chunk)


def test_ssd_bwd_wgmma_smem_budget():
    """The wgmma backward's blocks at each state width the models use
    (zamba2-7b N=64, mamba2-370m N=128), in 8 KB boxes: chunk_state a ring
    of 2 stages (x or dy, and n/64 b or c boxes); rows the t tile's c and
    dy, the entering state's hi and lo and a ring of x and b; cols the s
    tile's b, x and dy, the state gradient's hi and lo and a ring of dy and
    c; 8 bytes a barrier and 1 KB of alignment slack. Each fits one SM's
    227 KB with its static arrays (3 KB: dt, cum and the weights of a
    256-step chunk)."""
    want = {("chunk_state", 64): 33824, ("chunk_state", 128): 50208,
            ("rows", 64): 66608, ("rows", 128): 107568,
            ("cols", 64): 74800, ("cols", 128): 115760}
    for (kernel, n), nbytes in want.items():
        assert kernel in ss.BWD_WGMMA_KERNELS
        assert ss.bwd_wgmma_smem_bytes(kernel, n) == nbytes, (kernel, n)
        assert nbytes + 3 * 1024 <= 232448


def _ssd_bwd_args(dtype=torch.bfloat16, B=1, L=64, H=2, P=64, N=64, G=1):
    x = torch.zeros(B, L, H, P, dtype=dtype)
    b = torch.zeros(B, L, G, N, dtype=dtype)
    vec = torch.zeros(H)
    return x, torch.zeros(B, L, H), vec, b, b.clone(), vec


def test_ssd_bwd_check_inputs_rejects_what_the_variant_does_not_take():
    """The wgmma backward reads dy by TMA: a dy 2 bytes into its storage is
    refused, an aligned copy taken; it refuses fp32 and P = 32, which only
    fma takes; dy must match x, dstate be (B,H,P,N) fp32; no other variant."""
    args = _ssd_bwd_args()
    x = args[0]
    dy = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    with pytest.raises(ValueError, match="aligned"):
        ss.check_bwd_inputs("wgmma", *args, dy, None, 64)
    ss.check_bwd_inputs("wgmma", *args, dy.clone(), None, 64)
    ss.check_bwd_inputs("fma", *args, dy, None, 64)
    f32 = _ssd_bwd_args(torch.float32)
    with pytest.raises(ValueError, match="wgmma backward does not take"):
        ss.check_bwd_inputs("wgmma", *f32, torch.zeros_like(f32[0]), None, 64)
    p32 = _ssd_bwd_args(P=32)
    with pytest.raises(ValueError, match="wgmma backward does not take"):
        ss.check_bwd_inputs("wgmma", *p32, torch.zeros_like(p32[0]), None, 64)
    with pytest.raises(ValueError, match="dy must be"):
        ss.check_bwd_inputs("wgmma", *args, torch.zeros_like(x, dtype=torch.float32),
                            None, 64)
    with pytest.raises(ValueError, match="dstate must be"):
        ss.check_bwd_inputs("wgmma", *args, torch.zeros_like(x),
                            torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16), 64)
    with pytest.raises(ValueError, match="no SSD backward variant"):
        ss.check_bwd_inputs("mma", *args, torch.zeros_like(x), None, 64)


@pytest.mark.parametrize("variant", ["wgmma", "fma"])
def test_ssd_bwd_launch_refuses_cpu_tensors(variant, monkeypatch):
    """Neither backward variant launches on CPU tensors, and nothing is
    built: on the CPU autograd differentiates the plain version."""
    monkeypatch.setattr(_build, "load", _refuse_build)
    args = _ssd_bwd_args()
    with pytest.raises(ValueError, match="no SSD backward kernel"):
        ss._launch_bwd(variant, *args, torch.zeros_like(args[0]), None, 64)
    before = dict(ss.ssd_scan_bwd_cuda.variant_launches)
    with pytest.raises(ValueError, match="autograd differentiates"):
        ss.ssd_scan_bwd_cuda(*args, torch.zeros_like(args[0]), chunk=64)
    assert ss.ssd_scan_bwd_cuda.variant_launches == before
    assert set(before) == set(ss.VARIANTS)


def test_split_bf16_keeps_sixteen_bits():
    """hi is v rounded to bf16, lo the remainder rounded to bf16; hi + lo
    is within 2^-16 of v, relative to |v|."""
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(4096)
                         .astype(np.float32) * 10 ** np.linspace(-6, 6, 4096,
                                                                  dtype=np.float32))
    hi, lo = ss.split_bf16(v)
    assert hi.dtype == lo.dtype == torch.bfloat16
    torch.testing.assert_close(hi, v.to(torch.bfloat16), rtol=0, atol=0)
    err = (hi.float() + lo.float() - v).abs() / v.abs()
    assert err.max().item() <= 2.0 ** -16
    assert (v - hi.float()).abs().max() > 0          # one bf16 alone loses bits


@pytest.mark.parametrize("split", [False, True], ids=["fp32", "split_bf16"])
@pytest.mark.parametrize("B,L,H,P,N,G,chunk", SSD_GRID)
def test_ssd_decomposition_vs_pallas_and_reference(B, L, H, P, N, G, chunk,
                                                   split):
    """The wgmma variant's three stages in plain torch (chunk states, the
    state pass, the chunk scan), composed, in fp32 and with its split
    operands, against the Pallas kernel in interpret mode and the
    reference's ssd_chunked, on the TestSSDScan grid at 1e-4."""
    j, t = _ssd_both(0, B, L, H, P, N, G)
    y_p, st_p = ssd_scan_pallas(*j, chunk=chunk, interpret=True)
    y_r, st_r = jref.ssd_chunked(*j, chunk_size=chunk)
    y, st = ss.ssd_decomposed_plain(*t, chunk=chunk, split=split)
    assert y.shape == (B, L, H, P) and st.shape == (B, H, P, N)
    assert st.dtype == torch.float32
    for want_y, want_st in ((y_p, st_p), (y_r, st_r)):
        _close(y, want_y, SSD_TOL)
        _close(st, want_st, SSD_TOL)
    _close(y, ref.ssd_chunked(*t, chunk_size=chunk)[0], SSD_TOL)


def test_ssd_state_pass_returns_the_entering_states():
    """The state entering chunk c + 1 is e^{tot_c} times the one entering c
    plus chunk c's own; the first is zero and the last step gives the
    final state, equal to the reference's."""
    B, L, H, P, N, G, chunk = 2, 128, 4, 32, 16, 2, 32
    j, t = _ssd_both(6, B, L, H, P, N, G)
    x, dt, a_log, b, c, d_skip = t
    s_loc, tot = ss.chunk_states_plain(x, dt, a_log, b, chunk=chunk)
    s_in, state = ss.state_pass_plain(s_loc, tot)
    assert s_in.shape == (B, L // chunk, H, P, N) and tot.shape == (B, L // chunk, H)
    assert not s_in[:, 0].any()
    for ci in range(L // chunk - 1):
        _close(s_in[:, ci + 1],
               s_in[:, ci] * torch.exp(tot[:, ci])[..., None, None] + s_loc[:, ci],
               0.0)
    _close(state, jref.ssd_chunked(*j, chunk_size=chunk)[1], SSD_TOL)


SSD_STATE_RTOL = 1e-4       # chip_smoke.py: the fp32 state at the model shapes


def _ssd_model_like(seed, B, L, H, P, N, G):
    """Inputs drawn as chip_smoke.ssd_inputs draws them (dt log-uniform in
    [1e-3, 1e-1], A in [1, 16]); x, b and c rounded to bf16 as the model
    hands them over, held in fp32 so that y stays fp32."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float()

    return (bf16(rng.standard_normal((B, L, H, P)) * 0.5),
            torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                                (B, L, H))).astype(np.float32)),
            torch.from_numpy(np.log(rng.uniform(1, 16, H)).astype(np.float32)),
            bf16(rng.standard_normal((B, L, G, N)) * 0.3),
            bf16(rng.standard_normal((B, L, G, N)) * 0.3),
            torch.from_numpy(rng.standard_normal(H).astype(np.float32)))


@pytest.mark.parametrize("B,L,H,P,N,G,chunk", [(2, 512, 4, 64, 64, 2, 256),
                                               (1, 512, 2, 64, 128, 1, 256),
                                               (2, 384, 4, 64, 64, 1, 128)])
def test_ssd_split_operands_keep_a_tenth_of_the_state_limit(B, L, H, P, N, G,
                                                            chunk, monkeypatch):
    """The wgmma variant's two-pass hi + lo operands against the same
    decomposition in fp32: y and the state within SSD_STATE_RTOL / 10 in
    relative norm; one bf16 rounding of those operands instead puts the
    state past the limit itself."""
    def rel(got, want):
        return ((got - want).norm() / want.norm()).item()

    args = _ssd_model_like(9, B, L, H, P, N, G)
    y, st = ss.ssd_decomposed_plain(*args, chunk=chunk, split=True)
    y_w, st_w = ss.ssd_decomposed_plain(*args, chunk=chunk)
    assert rel(y, y_w) <= SSD_STATE_RTOL / 10
    assert rel(st, st_w) <= SSD_STATE_RTOL / 10
    _close(st_w, ref.ssd_chunked(*args, chunk_size=chunk)[1], SSD_TOL)
    monkeypatch.setattr(ss, "_as_operand", lambda v, split: v.bfloat16().float()
                        if split else v)
    _, st_1 = ss.ssd_decomposed_plain(*args, chunk=chunk, split=True)
    assert rel(st_1, st_w) > SSD_STATE_RTOL


# ---------------------------------------------------------------------------
# Grouped (per-expert) matmul
# ---------------------------------------------------------------------------

GMM_GRID = [(2, 16, 32, 64), (8, 64, 128, 64), (4, 8, 256, 128)]   # TestGMM
# ragged C, d and f: the Pallas wrapper pads them to its blocks, the port's
# kernel masks them; the plain version must agree with both
GMM_RAGGED = [(3, 100, 72, 200), (2, 37, 30, 50)]


def _gmm_both(seed, E, C, d, f, dtype):
    rng = np.random.default_rng(seed)
    return _both((rng.standard_normal((E, C, d), np.float32),
                  rng.standard_normal((E, d, f), np.float32)), dtype)


@pytest.mark.parametrize("E,C,d,f", GMM_GRID + GMM_RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_vs_pallas_and_reference(E, C, d, f, dtype):
    """ref.gmm_naive, the plain version and ops.gmm against gmm_pallas in
    interpret mode and the reference's gmm_naive, at TOL * sqrt(d) as
    TestGMM holds the Pallas kernel."""
    (jx, jw), (tx, tw) = _gmm_both(0, E, C, d, f, dtype)
    pallas = gmm_pallas(jx, jw, interpret=True)
    oracle = jref.gmm_naive(jx, jw)
    for got in (ref.gmm_naive(tx, tw), mg.gmm_plain(tx, tw), ops.gmm(tx, tw)):
        assert got.dtype == TDT[dtype] and got.shape == (E, C, f)
        for want in (pallas, oracle):
            np.testing.assert_allclose(_np(got), _np(want),
                                       atol=TOL[dtype] * d ** 0.5,
                                       rtol=TOL[dtype])


def test_gmm_plain_rounds_once_from_fp32_sums():
    """bf16 in, bf16 out: the product of fp32 sums rounded once equals the
    reference's einsum with an fp32 accumulator, bit for bit here."""
    (jx, jw), (tx, tw) = _gmm_both(1, 4, 24, 64, 40, "bfloat16")
    got = mg.gmm_plain(tx, tw)
    want = jref.gmm_naive(jx, jw)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_gmm_cpu_wrapper_takes_plain_version_without_counting(monkeypatch):
    monkeypatch.setattr(_build, "load", _refuse_build)
    before = mg.gmm_cuda.launches
    _, (tx, tw) = _gmm_both(2, 2, 16, 32, 64, "bfloat16")
    _close(mg.gmm_cuda(tx, tw), mg.gmm_plain(tx, tw), 0.0)
    assert mg.gmm_cuda.launches == before


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "rank", "experts",
                                  "depth", "empty", "contiguous"])
def test_gmm_check_inputs_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros(4, 8, 32, dtype=torch.bfloat16)
    w = torch.zeros(4, 32, 16, dtype=torch.bfloat16)
    mg.check_inputs(x, w)           # the accepted form
    mg.check_inputs(x.float(), w.float())
    if case == "dtype":
        x, w = x.half(), w.half()
    elif case == "mixed_dtype":
        w = w.float()
    elif case == "rank":
        x = x[0]
    elif case == "experts":
        w = w[:3]
    elif case == "depth":
        w = torch.zeros(4, 16, 16, dtype=torch.bfloat16)
    elif case == "empty":
        x = torch.zeros(4, 0, 32, dtype=torch.bfloat16)
    else:
        w = torch.zeros(4, 16, 32, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError):
        mg.check_inputs(x, w)


def test_gmm_smem_budget():
    """The mma path: two stages of a (128 x 32) x tile and a (32 x 128) w
    tile in bf16 with 8 elements of row padding, within the 48 KB of static
    shared memory a block may use (the fma path likewise). The wgmma path:
    prefill 3 stages of a (128 x 64) x tile and a (64 x 256) w tile beside
    the (128 x 256) output tile, decode 8 stages of (64 x 64) and (64 x 64)
    beside a (64 x 64) one, each with two mbarriers a stage and 1 KB of
    alignment slack, within the 232 448 bytes of a Hopper block."""
    assert mg.smem_bytes(torch.bfloat16) == 2 * (128 * 40 + 32 * 136) * 2 == 37888
    assert mg.smem_bytes(torch.float32) == 16448
    assert max(mg.smem_bytes(t) for t in mg.DTYPES) <= 48 * 1024
    assert mg.wgmma_smem_bytes(128) == \
        3 * (128 + 256) * 64 * 2 + 128 * 256 * 2 + 48 + 1024 == 214064
    assert mg.wgmma_smem_bytes(64) == \
        8 * (64 + 64) * 64 * 2 + 64 * 64 * 2 + 128 + 1024 == 140416
    assert max(mg.wgmma_smem_bytes(c) for c in mg.WGMMA_TILES) <= 232448


# deepseek-moe-16b's expert products (prefill gate/up and down at capacity
# 968, decode at 8), kimi-k2's (d 7168, f 2048), the TestGMM grid, the two
# ragged shapes, and fp32
GMM_VARIANT_CASES = [
    ((64, 968, 2048), (64, 2048, 1408), "bfloat16", "wgmma"),
    ((64, 968, 1408), (64, 1408, 2048), "bfloat16", "wgmma"),
    ((64, 8, 2048), (64, 2048, 1408), "bfloat16", "wgmma"),
    ((4, 8, 7168), (4, 7168, 2048), "bfloat16", "wgmma"),
    ((2, 16, 32), (2, 32, 64), "bfloat16", "wgmma"),
    ((3, 100, 72), (3, 72, 200), "bfloat16", "wgmma"),
    ((2, 37, 30), (2, 30, 50), "bfloat16", "mma"),
    ((2, 8, 64), (2, 64, 36), "bfloat16", "mma"),
    ((2, 8, 36), (2, 36, 64), "bfloat16", "mma"),
    ((64, 968, 2048), (64, 2048, 1408), "float32", "fma"),
    ((2, 37, 30), (2, 30, 50), "float32", "fma"),
]


@pytest.mark.parametrize("xs,ws,dtype,variant", GMM_VARIANT_CASES)
def test_gmm_variant_follows_shapes_and_dtype(xs, ws, dtype, variant):
    """bf16 whose d and f are multiples of 8 (16-byte TMA strides) takes
    wgmma, other bf16 shapes mma, fp32 fma; the choice reads only shapes and
    the dtype."""
    x = torch.empty(xs, dtype=TDT[dtype], device="meta")
    w = torch.empty(ws, dtype=TDT[dtype], device="meta")
    assert mg.gmm_variant(x, w) == variant
    assert variant in mg.VARIANTS


# deepseek-moe-16b's expert products at the training capacity (488: 2 x
# 2048 tokens, top 6 of 64) and at decode's, kimi-k2's, fp32, and d or f
# not a multiple of 8
GMM_BWD_VARIANT_CASES = [
    ((64, 488, 2048), (64, 2048, 1408), "bfloat16", "wgmma_bwd"),
    ((64, 488, 1408), (64, 1408, 2048), "bfloat16", "wgmma_bwd"),
    ((64, 8, 2048), (64, 2048, 1408), "bfloat16", "wgmma_bwd"),
    ((4, 8, 7168), (4, 7168, 2048), "bfloat16", "wgmma_bwd"),
    ((3, 100, 72), (3, 72, 200), "bfloat16", "wgmma_bwd"),
    ((64, 488, 2048), (64, 2048, 1408), "float32", "fma"),
    ((2, 37, 30), (2, 30, 50), "float32", "fma"),
    ((2, 37, 30), (2, 30, 50), "bfloat16", "mma"),
    ((2, 8, 64), (2, 64, 36), "bfloat16", "mma"),
    ((2, 8, 36), (2, 36, 64), "bfloat16", "mma"),
]


@pytest.mark.parametrize("xs,ws,dtype,variant", GMM_BWD_VARIANT_CASES)
def test_gmm_bwd_variant_follows_shapes_and_dtype(xs, ws, dtype, variant):
    """The backward reads its operands as stored (``wgmma_bwd``) wherever
    the forward takes wgmma, every model shape; fp32 and bf16 shapes TMA
    cannot address keep the transposed copies onto fma and mma."""
    x = torch.empty(xs, dtype=TDT[dtype], device="meta")
    w = torch.empty(ws, dtype=TDT[dtype], device="meta")
    assert mg.gmm_bwd_variant(x, w) == variant
    assert variant in mg.BWD_VARIANTS


@pytest.mark.parametrize("C", [8, 64, 65, 488, 968])
def test_gmm_bwd_tiles_fit_a_hopper_block(C):
    """dx's rows are C, tiled as the forward's; dw's are d, on the 128-row
    tile; each tile the backward launches fits a Hopper block."""
    tiles = mg.wgmma_bwd_tiles(C)
    assert tiles == {"dx": 64 if C <= 64 else 128, "dw": 128}
    assert all(mg.wgmma_smem_bytes(t) <= 232448 for t in tiles.values())


def test_gmm_cpu_wrapper_counts_no_variant(monkeypatch):
    """On the CPU the plain version runs and no variant's count moves."""
    monkeypatch.setattr(_build, "load", _refuse_build)
    before = dict(mg.gmm_cuda.variant_launches)
    _, (tx, tw) = _gmm_both(3, 2, 16, 32, 64, "bfloat16")
    mg.gmm_cuda(tx, tw)
    assert mg.gmm_cuda.variant_launches == before
    assert set(before) == set(mg.VARIANTS)
