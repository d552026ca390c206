"""The hand-written CUDA kernels on the card, against their plain versions.

Imports torch and the port only, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card every test here skips: a CUDA kernel has no CPU mode.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as mg  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402


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


# (B, Sq, Sk, H, KVH, options): one query row (decode through the prefill
# kernel; non-causal, the encoder-decoder's cross-attention decode step over
# a ragged encoder length), ragged self- and cross-attention that TMA
# zero-fills past the edges, a window with a softcap over three 128-row
# tiles, and a short q block at the end of a long cache
FLASH_EDGES = [
    (1, 1, 256, 4, 2, {"q_offset": 99, "kv_valid": 100}),
    (1, 1, 300, 2, 1, {"q_offset": 299}),
    (2, 1, 250, 4, 4, {"causal": False}),
    (1, 100, 100, 4, 2, {}),
    (1, 70, 130, 4, 2, {"causal": False}),
    (2, 300, 300, 4, 2, {"window": 48, "softcap": 30.0}),
    (1, 5, 300, 2, 2, {"q_offset": 295}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,kw", FLASH_EDGES)
def test_flash_attention_kernel_edges_vs_plain(cuda, D, B, Sq, Sk, H, KVH, kw):
    """The TMA + wgmma kernel at every head dim (112 read as two 64-column
    boxes) on the shapes whose edges TMA fills with zeros."""
    q, k, v = _qkv(12, B, Sq, Sk, H, KVH, D, cuda)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert got.shape == (B, Sq, H, D)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2, rtol=2e-2)


# (B, S, H, KVH, D, options): the serving options of the head dims and GQA
# groups the new paths bring, at small size: gemma2-9b's global and local
# layers (scale 224^-0.5, softcap 50; a window that binds), stablelm-12b's
# group of 4, the VLM's group of 8 and command-r-plus's of 12
MODEL_OPTION_CASES = [
    (2, 300, 4, 2, 256, {"scale": 224 ** -0.5, "softcap": 50.0}),
    (1, 400, 4, 2, 256, {"scale": 224 ** -0.5, "softcap": 50.0,
                         "window": 128}),
    (2, 300, 8, 2, 160, {}),
    (1, 200, 16, 2, 128, {"causal": False}),
    (1, 200, 24, 2, 128, {}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D,kw", MODEL_OPTION_CASES)
def test_flash_attention_kernel_at_model_options_vs_plain(cuda, B, S, H, KVH,
                                                          D, kw):
    q, k, v = _qkv(13, B, S, S, H, KVH, D, cuda)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2, rtol=2e-2)


def _requires_grad_inputs(kernel, device):
    """Inputs of one small call of ``kernel``, each requiring grad."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, device=device).to(dtype).requires_grad_()

    f32 = torch.float32
    if kernel == "flash_attention":
        return fa.flash_attention_cuda, (t(1, 128, 2, 64), t(1, 128, 2, 64),
                                         t(1, 128, 2, 64)), {}
    if kernel == "gmm":
        return mg.gmm_cuda, (t(2, 64, 64), t(2, 64, 64)), {}
    dt = (0.1 * torch.rand(1, 128, 2, device=device)).requires_grad_()
    return ss.ssd_scan_cuda, (t(1, 128, 2, 64), dt, t(2, dtype=f32),
                              t(1, 128, 1, 64), t(1, 128, 1, 64),
                              t(2, dtype=f32)), {"chunk": 64}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention", "gmm", "ssd_scan"])
def test_kernel_takes_the_gradient_through_its_backward_kernel(cuda, kernel):
    """No kernel drops a gradient: in grad mode with inputs that require
    grad, the output carries a ``grad_fn``, the backward launches its kernel
    once, and the gradients match autograd through the plain version.
    Without grad mode each call launches its kernel, and nothing falls back
    to the plain version."""
    fn, args, kw = _requires_grad_inputs(kernel, cuda)
    before = fn.launches
    bwd = {"flash_attention": fa.flash_attention_bwd_cuda, "gmm": mg.gmm_bwd_cuda,
           "ssd_scan": ss.ssd_scan_bwd_cuda}[kernel]
    plain = {"flash_attention": fa.flash_attention_plain, "gmm": mg.gmm_plain,
             "ssd_scan": ss.ssd_scan_plain}[kernel]
    bwd_before = bwd.launches
    out = fn(*args, **kw)
    y = out[0] if kernel == "ssd_scan" else out
    assert y.grad_fn is not None and fn.launches == before + 1
    dout = torch.randn_like(y)
    got = torch.autograd.grad(y, args, dout)
    torch.cuda.synchronize()
    assert bwd.launches == bwd_before + 1
    leaves = [a.detach().float().requires_grad_() for a in args]
    want_out = plain(*leaves, **kw)
    want = torch.autograd.grad(want_out[0] if kernel == "ssd_scan" else want_out,
                               leaves, dout.float())
    for g, w, a in zip(got, want, args):
        assert g.dtype == a.dtype
        assert float((g.float() - w).norm() / w.norm()) < 1e-2
    before = fn.launches
    with torch.no_grad():
        out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert all(not t.requires_grad for t in (out if isinstance(out, tuple)
                                             else (out,)))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention", "gmm", "ssd_scan"])
def test_meta_path_gives_a_launch_shapes_and_dtypes(cuda, kernel):
    """The wrapper's meta path (the dry-run's) returns what a launch
    returns, forward (the flash forward's log-sum-exp and the SSD's final
    state too) and backward, in shapes and dtypes, and launches nothing."""
    torch.manual_seed(0)
    fn, args, kw = _requires_grad_inputs(kernel, cuda)
    meta = [torch.empty_like(a, device="meta").requires_grad_() for a in args]

    def run(inputs):
        out = fn(*inputs, **kw)
        y = out[0] if kernel == "ssd_scan" else out
        grads = torch.autograd.grad(y, inputs, torch.ones_like(y))
        with torch.no_grad():
            if kernel == "flash_attention":
                extra = fa._forward(*inputs, causal=True, window=0, softcap=0.0,
                                    scale=None, q_offset=0, kv_valid=None,
                                    with_lse=True)
            elif kernel == "ssd_scan":
                extra = fn(*inputs, **kw)
            else:
                extra = (fn(*inputs),)
        return [(tuple(t.shape), t.dtype) for t in (*_tuple(out), *grads, *extra)]

    want = run(args)
    torch.cuda.synchronize()
    counters = (fn, {"flash_attention": fa.flash_attention_bwd_cuda,
                     "gmm": mg.gmm_bwd_cuda, "ssd_scan": ss.ssd_scan_bwd_cuda}[kernel])
    before = [c.launches for c in counters]
    assert run(meta) == want
    assert [c.launches for c in counters] == before


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


# (B, Sq, Sk, H, KVH, options): the backward's grid: causal, non-causal,
# GQA, window, softcap, ragged lengths and a causal Sq < Sk
FLASH_BWD_CASES = [
    (1, 128, 128, 4, 4, {}),
    (2, 200, 200, 4, 2, {}),
    (2, 200, 200, 4, 2, {"causal": False}),
    (1, 70, 130, 4, 2, {"causal": False}),
    (1, 64, 192, 2, 2, {}),
    (2, 300, 300, 4, 2, {"window": 48}),
    (2, 300, 300, 4, 2, {"softcap": 30.0}),
    (2, 300, 300, 8, 2, {"window": 48, "softcap": 30.0, "scale": 0.1}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("D", fa.BWD_HEAD_DIMS)
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,kw", FLASH_BWD_CASES)
def test_flash_attention_backward_vs_plain(cuda, D, B, Sq, Sk, H, KVH, kw):
    """dQ, dK, dV of the backward kernel against autograd through the plain
    version in fp32: 1e-2 in relative norm (P and dS are rounded to bf16 for
    the products, as the forward rounds P); and bitwise repeatable."""
    q, k, v = _qkv(21, B, Sq, Sk, H, KVH, D, cuda)
    do = _qkv(22, B, Sq, Sq, H, H, D, cuda)[0]
    out, lse = fa._forward(q, k, v, q_offset=0, kv_valid=None, with_lse=True,
                           causal=kw.get("causal", True),
                           window=kw.get("window", 0),
                           softcap=kw.get("softcap", 0.0), scale=kw.get("scale"))
    opts = dict(causal=kw.get("causal", True), window=kw.get("window", 0),
                softcap=kw.get("softcap", 0.0), scale=kw.get("scale"))
    got = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, **opts)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, **opts)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, do, **opts)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert _rel(g, w) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("kw", [{}, {"window": 48, "softcap": 30.0},
                                {"causal": False}],
                         ids=["causal", "window_softcap", "noncausal"])
def test_flash_attention_forward_lse_vs_plain(cuda, D, kw):
    """The forward's row log-sum-exp (base 2), at every head dim: one
    consumer warpgroup at 160 and 256 holds the row statistics otherwise."""
    q, k, v = _qkv(23, 2, 300, 300, 4, 2, D, cuda)
    opts = dict(causal=kw.get("causal", True), window=kw.get("window", 0),
                softcap=kw.get("softcap", 0.0), scale=None)
    out, lse = fa._forward(q, k, v, q_offset=0, kv_valid=None, with_lse=True,
                           **opts)
    torch.cuda.synchronize()
    want = fa.attention_lse_plain(q, k, **opts)
    assert float((lse - want).abs().max()) < 1e-4
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v, **opts))


@pytest.mark.cuda
def test_flash_attention_backward_of_a_row_with_no_key_is_zero(cuda):
    q, k, v = _qkv(24, 1, 64, 64, 2, 2, 64, cuda)
    out, lse = fa._forward(q, k, v, causal=False, window=0, softcap=0.0,
                           scale=None, q_offset=0, kv_valid=0, with_lse=True)
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, torch.ones_like(q), lse,
                                        causal=False, kv_valid=0)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(lse).all())
    assert all(bool((g == 0).all()) for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("D,kw", [(160, {"q_offset": 4}), (256, {"q_offset": 4}),
                                  (128, {"q_offset": 4})])
def test_flash_attention_backward_rejects_what_it_does_not_take(cuda, D, kw):
    """Every head dim has a backward; a q_offset (never passed in training)
    is refused before any launch."""
    q, k, v = (t.requires_grad_() for t in _qkv(25, 1, 64, 64, 2, 2, D, cuda))
    before = fa.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_cuda(q, k, v, **kw)
    assert fa.flash_attention_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("E,C,d,f", [(2, 16, 32, 64), (8, 64, 128, 64),
                                     (4, 8, 256, 128), (3, 100, 72, 200),
                                     (2, 37, 30, 50), (4, 488, 256, 128)])
def test_gmm_backward_vs_plain(cuda, dtype, tol, E, C, d, f):
    """dx and dw of the grouped GEMM's backward (two launches of its kernel)
    against the two einsums in fp32, TOL x sqrt(contraction)."""
    rng = np.random.default_rng(26)
    x, w, dy = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(cuda, dtype)
                for s in ((E, C, d), (E, d, f), (E, C, f)))
    before = mg.gmm_bwd_cuda.launches
    dx, dw = mg.gmm_bwd_cuda(x, w, dy)
    torch.cuda.synchronize()
    assert mg.gmm_bwd_cuda.launches == before + 1
    px, pw = mg.gmm_bwd_plain(x, w, dy)
    for got, want, depth in ((dx, px, f), (dw, pw, C)):
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   atol=tol * depth ** 0.5, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,f", [(64, 488, 2048, 1408), (64, 488, 1408, 2048)])
def test_gmm_backward_makes_no_transposed_copy(cuda, E, C, d, f):
    """At deepseek-moe-16b's training shapes the backward takes its
    ``wgmma_bwd`` variant, which reads x, w and dy as stored: the call's
    peak device memory is its inputs and its two outputs (a transposed copy
    of w alone would add 369 MB)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(27)
    x, w, dy = (torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16)
                for s in ((E, C, d), (E, d, f), (E, C, f)))
    assert mg.gmm_bwd_variant(x, w) == "wgmma_bwd"
    before = mg.gmm_bwd_cuda.variant_launches["wgmma_bwd"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dx, dw = mg.gmm_bwd_cuda(x, w, dy)
    torch.cuda.synchronize()
    outputs = dx.untyped_storage().nbytes() + dw.untyped_storage().nbytes()
    assert torch.cuda.max_memory_allocated() - held - outputs < 2 ** 20
    assert mg.gmm_bwd_cuda.variant_launches["wgmma_bwd"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch,remat", [("deepseek-7b", "full"),
                                        ("deepseek-7b", "dots"),
                                        ("deepseek-moe-16b", "full"),
                                        ("mamba2-370m", "full"),
                                        ("zamba2-7b", "full")])
def test_train_step_on_the_card(cuda, arch, remat):
    """One train step at REDUCED with one attention head of 64 (the flash
    kernels' smallest head dim), with remat, on the card and on the CPU
    from the same state: the loss within 2e-2, every grad leaf finite, the
    backward kernels launched; the dense model's grads within 5e-2 in
    relative norm (bf16 rounds on each side in other places), mamba2-370m's,
    run in fp32, within 1e-3. (In bf16 a rounding difference grows by about
    1.5x an SSM layer at the reference's initialisation, so zamba2-7b's 7
    layers, which need bf16 for the flash kernel, are held by the loss.)"""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import train as train_rt
    cfg = get_config(arch, reduced=True)
    if cfg.n_heads:
        cfg = cfg.replace(n_heads=1, n_kv_heads=1)
    if arch == "mamba2-370m":
        cfg = cfg.replace(param_dtype="float32", activ_dtype="float32")
    model = build_model(cfg)
    opts = train_rt.TrainOptions(remat_policy=remat, warmup_steps=1,
                                 total_steps=10)
    params = model.init(torch.Generator().manual_seed(0))
    dc = DataConfig(cfg.vocab_size, 64, 4)
    grads, losses = {}, {}
    before = {f: f.launches for f in (fa.flash_attention_bwd_cuda,
                                      mg.gmm_bwd_cuda, ss.ssd_scan_bwd_cuda)}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        g, m = train_rt.build_grad_fn(model, opts)(
            p, batch_for_step(dc, 0, cfg, device=dev))
        grads[dev], losses[dev] = g, float(m["loss"])
    torch.cuda.synchronize()
    assert abs(losses["cuda"] - losses["cpu"]) <= 2e-2 * abs(losses["cpu"])
    launched = {f for f, n in before.items() if f.launches > n}
    assert (fa.flash_attention_bwd_cuda in launched) == (arch != "mamba2-370m")
    assert (mg.gmm_bwd_cuda in launched) == (arch == "deepseek-moe-16b")
    assert (ss.ssd_scan_bwd_cuda in launched) == (arch in ("mamba2-370m",
                                                           "zamba2-7b"))
    tol = {"deepseek-7b": 5e-2, "mamba2-370m": 1e-3}.get(arch)
    for (path, a), (_, b) in zip(_flat(grads["cuda"]), _flat(grads["cpu"])):
        assert bool(torch.isfinite(a).all()), path
        if tol:
            assert _rel(a.cpu(), b) < tol, path


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_fp32(cuda):
    q, k, v = (t.float() for t in _qkv(9, 1, 64, 64, 2, 2, 64, cuda))
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_cuda(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("L,chunk", [(256, 64), (200, 100), (21, 7)])
def test_ssd_scan_kernel_vs_plain(cuda, dtype, tol, L, chunk):
    rng = np.random.default_rng(10)
    B, H, P, N, G = 2, 4, 32, 64, 2

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(cuda, dt)

    x = t(rng.standard_normal((B, L, H, P)) * 0.5, dtype)
    dt = t(rng.uniform(1e-3, 1e-1, (B, L, H)))
    a_log = t(np.log(rng.uniform(1, 16, H)))
    b, c = (t(rng.standard_normal((B, L, G, N)) * 0.3, dtype) for _ in range(2))
    d_skip = t(rng.standard_normal(H))
    assert ss.ssd_variant(x, b, chunk) == "fma"       # fp32, or P = 32
    before = ss.ssd_scan_cuda.launches
    before_fma = ss.ssd_scan_cuda.variant_launches["fma"]
    y, state = ss.ssd_scan_cuda(x, dt, a_log, b, c, d_skip, chunk=chunk)
    torch.cuda.synchronize()
    assert ss.ssd_scan_cuda.launches == before + 1
    assert ss.ssd_scan_cuda.variant_launches["fma"] == before_fma + 1
    y_p, state_p = ss.ssd_scan_plain(x, dt, a_log, b, c, d_skip, chunk=chunk)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_p.float().cpu().numpy(), atol=tol, rtol=tol)
    np.testing.assert_allclose(state.cpu().numpy(), state_p.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


def _ssd_model_like(seed, B, L, H, P, N, G, device):
    """bf16 x, b, c and fp32 dt, a_log, d_skip drawn as chip_smoke.ssd_inputs
    draws them: dt log-uniform in [1e-3, 1e-1], A in [1, 16]."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    return (t(rng.standard_normal((B, L, H, P)) * 0.5, torch.bfloat16),
            t(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, L, H)))),
            t(np.log(rng.uniform(1, 16, H))),
            t(rng.standard_normal((B, L, G, N)) * 0.3, torch.bfloat16),
            t(rng.standard_normal((B, L, G, N)) * 0.3, torch.bfloat16),
            t(rng.standard_normal(H)))


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("N", [64, 128])
def test_ssd_scan_wgmma_vs_plain(cuda, N, chunk, G):
    """The wgmma variant (chunk_state, state_pass, chunk_scan) over three
    chunks at P = 64, held to the limits chip_smoke.py holds the model
    shapes to: y within 2e-2 elementwise and 1e-3 in relative norm, the
    state within 1e-4 elementwise and in relative norm."""
    B, L, H, P = 2, 3 * chunk, 4, 64
    args = _ssd_model_like(14, B, L, H, P, N, G, cuda)
    assert ss.ssd_variant(args[0], args[3], chunk) == "wgmma"
    before = ss.ssd_scan_cuda.launches
    before_wgmma = ss.ssd_scan_cuda.variant_launches["wgmma"]
    y, state = ss.ssd_scan_cuda(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ss.ssd_scan_cuda.launches == before + 1
    assert ss.ssd_scan_cuda.variant_launches["wgmma"] == before_wgmma + 1
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    y_p, state_p = ss.ssd_scan_plain(*args, chunk=chunk)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_p.float().cpu().numpy(), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(state.cpu().numpy(), state_p.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    assert ((y.float() - y_p.float()).norm() / y_p.float().norm()).item() <= 1e-3
    assert ((state - state_p).norm() / state_p.norm()).item() <= 1e-4


# the SSD backward's limits, by the gradient's dtype: the largest difference
# as a share of the largest |plain| value, and the relative norm; bf16
# gradients are rounded once on each side (one ulp is 2^-8 relative)
SSD_BWD_ELEM = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_BWD_NORM = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


# (L, chunk, P, N, G): several chunks, ragged tiles (chunk 100, 7), P-slices
# of 64, 32 and 16 (P = 48), N up to 128, 1 to 4 groups
SSD_BWD_GRID = [(256, 64, 64, 64, 2), (200, 100, 32, 64, 2), (21, 7, 16, 16, 1),
                (384, 128, 64, 128, 1), (96, 32, 48, 32, 4)]
# every shape behind the fma forward in both dtypes, and the shapes the
# wgmma forward takes (bf16, P = 64, N = 64 or 128, chunk a multiple of 64);
# the backward variant beside it: where the backward's own choice is wgmma,
# fma too, so that it stays covered at the shapes that now take wgmma
_SSD_BWD_FWD = [("fma", dt, shape) for dt in (torch.float32, torch.bfloat16)
                for shape in SSD_BWD_GRID] + \
    [("wgmma", torch.bfloat16, SSD_BWD_GRID[0]), ("wgmma", torch.bfloat16, SSD_BWD_GRID[3])]
SSD_BWD_CASES = [(fwd, bwd, dt, shape) for fwd, dt, shape in _SSD_BWD_FWD
                 for bwd in ("wgmma", "fma")
                 if bwd == "fma" or (dt == torch.bfloat16 and shape in
                                     (SSD_BWD_GRID[0], SSD_BWD_GRID[3]))]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,bwd_variant,dtype,shape", SSD_BWD_CASES)
def test_ssd_scan_backward_vs_plain(cuda, variant, bwd_variant, dtype, shape):
    """The backward kernel of variant ``bwd_variant`` behind each forward
    variant that takes the shape, with a non-zero state cotangent: all six
    gradients against autograd through the plain version in fp32, each
    rounded to its input's dtype, within SSD_BWD_ELEM and SSD_BWD_NORM; the
    backward run twice bitwise equal. The variant ``ssd_bwd_variant`` names
    runs through ``SsdScanFn`` (one backward launch of that variant, as the
    counts show); the other is called through ``_launch_bwd``, which counts
    nothing."""
    (L, chunk, P, N, G), B, H = shape, 2, 8
    args = list(_ssd_model_like(15, B, L, H, P, N, G, cuda))
    for i in (0, 3, 4):
        args[i] = args[i].to(dtype)
    assert variant == "fma" or ss.ssd_variant(args[0], args[3], chunk) == "wgmma"
    rng = np.random.default_rng(16)
    dy = torch.from_numpy(rng.standard_normal((B, L, H, P), np.float32)).to(cuda, dtype)
    ds = torch.from_numpy(rng.standard_normal((B, H, P, N), np.float32)).to(cuda)
    before = ss.ssd_scan_bwd_cuda.launches
    before_variant = dict(ss.ssd_scan_bwd_cuda.variant_launches)
    if bwd_variant == ss.ssd_bwd_variant(args[0], args[3], chunk):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        y, state = ss.SsdScanFn.apply(*leaves, chunk, variant)
        got = torch.autograd.grad((y, state), leaves, (dy, ds))
        again = ss.ssd_scan_bwd_cuda(*args, dy, ds, chunk=chunk)
        calls = 2
    else:
        got = ss._launch_bwd(bwd_variant, *args, dy, ds, chunk)
        again = ss._launch_bwd(bwd_variant, *args, dy, ds, chunk)
        calls = 0
    torch.cuda.synchronize()
    assert ss.ssd_scan_bwd_cuda.launches == before + calls
    assert ss.ssd_scan_bwd_cuda.variant_launches == {
        **before_variant, bwd_variant: before_variant[bwd_variant] + calls}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    f32 = [a.detach().float().requires_grad_() for a in args]
    y_p, state_p = ss.ssd_scan_plain(*f32, chunk=chunk)
    want = torch.autograd.grad((y_p, state_p), f32, (dy.float(), ds))
    for name, g, w, a in zip(("dx", "ddt", "da_log", "db", "dc", "dd_skip"),
                             got, want, args):
        assert g.dtype == a.dtype and g.shape == a.shape, name
        w = w.to(a.dtype).float()
        d = (g.float() - w).abs().max().item()
        assert d <= SSD_BWD_ELEM[a.dtype] * w.abs().max().item(), name
        assert _rel(g, w) <= SSD_BWD_NORM[a.dtype], name


@pytest.mark.cuda
def test_ssd_scan_backward_rejects_unaligned_dy(cuda):
    """The wgmma backward reads dy by TMA: a dy 2 bytes into its storage is
    refused on the card, before any launch."""
    B, L, H, P, N, G = 1, 64, 2, 64, 64, 1
    args = list(_ssd_model_like(17, B, L, H, P, N, G, cuda))
    for i in (0, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    dy = torch.zeros(B * L * H * P + 1, dtype=torch.bfloat16,
                     device=cuda)[1:].view(B, L, H, P)
    before = ss.ssd_scan_bwd_cuda.launches
    with pytest.raises(ValueError, match="aligned"):
        ss.ssd_scan_bwd_cuda(*args, dy, chunk=64)
    assert ss.ssd_scan_bwd_cuda.launches == before


@pytest.mark.cuda
def test_ssd_scan_kernel_rejects_fp16(cuda):
    x = torch.zeros(1, 16, 2, 16, device=cuda, dtype=torch.float16)
    b = torch.zeros(1, 16, 1, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="kernel takes"):
        ss.ssd_scan_cuda(x, torch.zeros(1, 16, 2, device=cuda),
                         torch.zeros(2, device=cuda), b, b,
                         torch.zeros(2, device=cuda), chunk=16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("E,C,d,f", [(2, 16, 32, 64), (8, 64, 128, 64),
                                     (4, 8, 256, 128), (3, 200, 72, 136),
                                     (2, 37, 30, 50)])
def test_gmm_kernel_vs_plain(cuda, dtype, tol, E, C, d, f):
    """TestGMM's grid and a shape ragged in C and f (bf16: the wgmma path,
    zero-filled by TMA), and one that is not a multiple of 8 in d or f (bf16:
    the mma path's element-wise loads); fp32 takes the fma path. At
    TOL * sqrt(d), as TestGMM holds the Pallas kernel."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((E, C, d), np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((E, d, f), np.float32)).to(cuda, dtype)
    before = mg.gmm_cuda.launches
    variant = mg.gmm_variant(x, w)
    before_variant = mg.gmm_cuda.variant_launches[variant]
    got = mg.gmm_cuda(x, w)
    torch.cuda.synchronize()
    assert mg.gmm_cuda.launches == before + 1
    assert mg.gmm_cuda.variant_launches[variant] == before_variant + 1
    assert got.dtype == dtype and got.shape == (E, C, f)
    want = mg.gmm_plain(x, w)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=tol * d ** 0.5, rtol=tol)


def _gmm_ring_edges():
    """(E, C, d, f) at each wgmma tile's ring-depth edges: d one stage deep,
    and one stage more than the ring holds, at prefill's C=968 and decode's
    C=8; and one prefill shape at full depth."""
    cases = []
    for C, block_c in ((968, 128), (8, 64)):
        stages = mg.WGMMA_TILES[block_c][1]
        cases += [(2, C, mg.WGMMA_BLOCK_D, 136),
                  (2, C, (stages + 1) * mg.WGMMA_BLOCK_D, 264)]
    return cases + [(4, 968, 2048, 1408)]


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,f", _gmm_ring_edges())
def test_gmm_wgmma_ring_edges_vs_plain(cuda, E, C, d, f):
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((E, C, d), np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((E, d, f), np.float32)
                         * d ** -0.5).to(cuda, torch.bfloat16)
    assert mg.gmm_variant(x, w) == "wgmma"
    before = mg.gmm_cuda.variant_launches["wgmma"]
    got = mg.gmm_cuda(x, w)
    torch.cuda.synchronize()
    assert mg.gmm_cuda.variant_launches["wgmma"] == before + 1
    want = mg.gmm_plain(x, w)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_gmm_kernel_rejects_fp16(cuda):
    x = torch.zeros(2, 8, 16, device=cuda, dtype=torch.float16)
    w = torch.zeros(2, 16, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="kernel takes"):
        mg.gmm_cuda(x, w)


@pytest.mark.cuda
def test_tensor_parallel_on_four_cards(tmp_path):
    """``tests/_torch_tp_card.py``'s equality part under the torch launcher
    on four cards (NCCL): command-r-plus-104b (4 layers), deepseek-moe-16b
    (8 layers) and zamba2-7b (12 layers) at full width on the (1, 4) and
    (2, 2) meshes, serving tokens equal to one card's and logits, step-1
    loss and gradients within the run's noise floor times FLOOR_MULT."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    out = tmp_path / "tp_card.json"
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4",
         "tests/_torch_tp_card.py", "--part", "equality", "--out", str(out)],
        cwd=root, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    lines = [line for line in json.loads(out.read_text())
             if line.get("part") == "equality"]
    assert len(lines) == 12 and all(line["ok"] for line in lines), lines
