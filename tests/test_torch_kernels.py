"""Port vs reference: attention oracles, the flash-attention module and the
decode GEMV, on the same seeded numpy inputs through JAX and torch.

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
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

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


def test_smem_budget():
    """The kernel's shared memory fits a Hopper block at both head dims."""
    assert fa.smem_bytes(d=128) == (64 + 4 * 64) * 136 * 2 == 87040
    assert fa.smem_bytes(d=64) == 46080
    assert all(fa.smem_bytes(d=d) <= 232448 for d in fa.HEAD_DIMS)


def test_nvcc_command_targets_sm90a():
    cmd = _build.nvcc_command("flash_attention", _build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/flash_attention.cu")
    lib = _build.library_path("flash_attention")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
