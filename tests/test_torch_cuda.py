"""The hand-written CUDA kernels on the card, against their plain versions.

Imports torch and the port only, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card every test here skips: a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(seed, B, Sq, Sk, H, KVH, D, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to(device, torch.bfloat16)
                 for shape in ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D)))


@pytest.mark.cuda
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("kw", [{}, {"window": 48, "softcap": 30.0},
                                {"causal": False}],
                         ids=["causal", "window_softcap", "noncausal"])
def test_flash_attention_kernel_vs_plain(cuda, D, kw):
    q, k, v = _qkv(8, 2, 200, 200, 4, 2, D, cuda)
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_fp32(cuda):
    q, k, v = (t.float() for t in _qkv(9, 1, 64, 64, 2, 2, 64, cuda))
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_cuda(q, k, v)
