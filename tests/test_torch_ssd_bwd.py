"""The SSD scan's backward in the port against the reference's gradient.

JAX cannot differentiate the Pallas SSD kernel, so the reference's gradient
is ``jax.vjp`` of ``repro.kernels.ref.ssd_chunked``. The port's
``ssd_scan_bwd_plain`` (the backward kernels' decomposition in plain torch:
states, chunks, reduce) is held to it and to autograd through
``ssd_scan_plain`` for all six gradients, on the same seeded numpy inputs.
The kernel itself runs only on a card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

NAMES = ("dx", "ddt", "da_log", "db", "dc", "dd_skip")
# fp32: relative norm 1e-5; ddt and da_log reach the log-decay, whose
# gradient sums the M_ts terms with cancellation, so 1e-4 as the forward's
# state (tests/test_kernels.py TestSSDScan)
FP32_RTOL = {"dx": 1e-5, "ddt": 1e-4, "da_log": 1e-4, "db": 1e-5, "dc": 1e-5,
             "dd_skip": 1e-5}
# bf16 x, b, c (and dy): the port computes in fp32 and rounds dx, db, dc to
# bf16 once; the reference casts x to fp32 twice (u and the skip) and
# repeats b and c per head before casting, so its cotangents are rounded to
# bf16 per use and summed in bf16: up to three roundings of 2^-9 relative
# (measured up to 3.6e-3 in relative norm)
BF16_RTOL = 1e-2

# (B, L, H, P, N, G, chunk): one chunk and several, G = 1 and G > 1
# (including 4 heads a group), P and N at 16 and 32
CASES = [
    (1, 16, 2, 16, 16, 1, 16),
    (1, 64, 2, 16, 16, 1, 16),
    (2, 96, 4, 32, 16, 2, 32),
    (1, 64, 8, 16, 32, 2, 64),
    (2, 48, 4, 16, 16, 4, 16),
]
# the wgmma backward's stages: CASES and one at its own operand widths
# (P = 64, N = 128: two boxes of n) over two 128-step chunks
WGMMA_CASES = CASES + [(1, 256, 2, 64, 128, 1, 128)]


def _inputs(seed, B, L, H, P, N, G, *, state_grad=True, dt_scale=1.0):
    """x, dt, a_log, b, c, d_skip, dy and the final state's cotangent (zero
    without ``state_grad``), as numpy fp32: dt from softplus (times
    ``dt_scale``), A in [1, 4]. The reference exponentiates its decay before
    masking it, so above the diagonal e^{cum_t - cum_s} overflows once a
    chunk's |cum| passes about 88, and its where's gradient turns 0 * inf
    into NaN: dt is drawn small enough (mean about 0.13) that a 64-step
    chunk stays well inside that; a 128-step chunk takes half of it."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.standard_normal((B, L, H, P)) * 0.5).astype(f32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, L, H)) - 2.0)) * dt_scale).astype(f32)
    a_log = np.log(rng.uniform(1.0, 4.0, H)).astype(f32)
    b = (rng.standard_normal((B, L, G, N)) * 0.3).astype(f32)
    c = (rng.standard_normal((B, L, G, N)) * 0.3).astype(f32)
    d_skip = rng.standard_normal(H).astype(f32)
    dy = rng.standard_normal((B, L, H, P)).astype(f32)
    ds = rng.standard_normal((B, H, P, N)).astype(f32) if state_grad \
        else np.zeros((B, H, P, N), f32)
    return [x, dt, a_log, b, c, d_skip], dy, ds


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _jax_grads(arrays, dy, ds, chunk, dtype):
    """jax.vjp of the reference's ssd_chunked, x, b, c and dy in ``dtype``."""
    j = [jnp.asarray(a) for a in arrays]
    for i in (0, 3, 4):
        j[i] = j[i].astype(dtype)
    _, vjp = jax.vjp(lambda *a: jref.ssd_chunked(*a, chunk_size=chunk), *j)
    return vjp((jnp.asarray(dy).astype(dtype), jnp.asarray(ds)))


def _torch_args(arrays, dy, ds, dtype):
    t = [torch.from_numpy(a) for a in arrays]
    for i in (0, 3, 4):
        t[i] = t[i].to(dtype)
    return t, torch.from_numpy(dy).to(dtype), torch.from_numpy(ds)


def _autograd(args, dy, ds, chunk):
    """Autograd through ssd_scan_plain, each gradient in its input's dtype."""
    leaves = [a.clone().requires_grad_() for a in args]
    y, state = ss.ssd_scan_plain(*leaves, chunk=chunk)
    return torch.autograd.grad((y, state), leaves, (dy, ds))


@pytest.mark.parametrize("B,L,H,P,N,G,chunk", CASES)
def test_bwd_plain_vs_jax_vjp_and_autograd_fp32(B, L, H, P, N, G, chunk):
    arrays, dy, ds = _inputs(0, B, L, H, P, N, G)
    args, tdy, tds = _torch_args(arrays, dy, ds, torch.float32)
    got = ss.ssd_scan_bwd_plain(*args, tdy, tds, chunk=chunk)
    want_j = _jax_grads(arrays, dy, ds, chunk, jnp.float32)
    want_t = _autograd(args, tdy, tds, chunk)
    for name, g, wj, wt, a in zip(NAMES, got, want_j, want_t, args):
        assert g.shape == a.shape and g.dtype == a.dtype, name
        assert _rel(_np(g), _np(wj)) <= FP32_RTOL[name], name
        assert _rel(_np(g), _np(wt)) <= FP32_RTOL[name], name


@pytest.mark.parametrize("B,L,H,P,N,G,chunk", [CASES[1], CASES[2], CASES[4]])
def test_bwd_plain_vs_jax_vjp_bf16(B, L, H, P, N, G, chunk):
    """x, b, c and dy in bf16: dx, db and dc come back in bf16, the rest in
    fp32, each within its tolerance of the reference's."""
    arrays, dy, ds = _inputs(1, B, L, H, P, N, G)
    args, tdy, tds = _torch_args(arrays, dy, ds, torch.bfloat16)
    got = ss.ssd_scan_bwd_plain(*args, tdy, tds, chunk=chunk)
    want = _jax_grads(arrays, dy, ds, chunk, jnp.bfloat16)
    for name, g, w, a in zip(NAMES, got, want, args):
        assert g.dtype == a.dtype and str(w.dtype) == str(a.dtype).split(".")[1], name
        tol = BF16_RTOL if a.dtype == torch.bfloat16 else FP32_RTOL[name]
        assert _rel(_np(g), _np(w)) <= tol, name


def test_bwd_plain_without_state_gradient_equals_a_zero_one():
    """``dstate=None`` (training: the final state unused) is a zero
    cotangent."""
    arrays, dy, ds = _inputs(2, 2, 64, 4, 16, 16, 2, state_grad=False)
    args, tdy, tds = _torch_args(arrays, dy, ds, torch.float32)
    for g, w in zip(ss.ssd_scan_bwd_plain(*args, tdy, None, chunk=16),
                    ss.ssd_scan_bwd_plain(*args, tdy, tds, chunk=16)):
        assert torch.equal(g, w)


def test_bwd_states_are_the_forward_states_and_carry_the_cotangent():
    """Stage 1: the state entering each chunk is the forward's (the last
    state carried once more gives the final state), and the last chunk's
    leaving-state gradient is the cotangent itself."""
    arrays, dy, ds = _inputs(3, 1, 96, 2, 16, 16, 1)
    args, tdy, tds = _torch_args(arrays, dy, ds, torch.float32)
    x, dt, a_log, b, c, _ = args
    s_in, g = ss.bwd_states_plain(x, dt, a_log, b, c, tdy, tds, chunk=32)
    assert s_in.shape == g.shape == (1, 3, 2, 16, 16)
    assert torch.equal(s_in[:, 0], torch.zeros_like(s_in[:, 0]))
    assert torch.equal(g[:, -1], tds)
    for ci in range(3):
        _, state = ss.ssd_scan_plain(*(t[:, :32 * ci] for t in (x, dt)), a_log,
                                     *(t[:, :32 * ci] for t in (b, c)), args[5],
                                     chunk=32) if ci else (None, s_in[:, 0])
        torch.testing.assert_close(s_in[:, ci], state, atol=1e-6, rtol=1e-5)


def test_bwd_log_decay_is_a_reverse_scan_within_each_chunk():
    """d la_r = sum over t >= r of d cum_t within r's chunk; ddt = x . du +
    A d la; da_log's partial per (batch, chunk) is A sum_r dt_r d la_r."""
    gen = torch.Generator().manual_seed(7)
    B, L, H, Q = 2, 12, 3, 4
    dt, xdu, dcum = (torch.rand(B, L, H, generator=gen) for _ in range(3))
    a_log = torch.randn(H, generator=gen)
    ddt, da = ss.bwd_log_decay_plain(dt, a_log, xdu, dcum, chunk=Q)
    A = -torch.exp(a_log)
    dla = torch.zeros_like(dcum)
    for r in range(L):
        end = (r // Q + 1) * Q
        dla[:, r] = dcum[:, r:end].sum(1)
    torch.testing.assert_close(ddt, xdu + A * dla)
    torch.testing.assert_close(da, A * (dt * dla).reshape(B, L // Q, Q, H).sum(2))


def test_bwd_reduce_sums_each_groups_heads():
    """Stage 3: db and dc of group g are the sums of its H/G heads', da_log
    and d_skip's the sums of the (batch, chunk) partials."""
    gen = torch.Generator().manual_seed(4)
    B, L, H, N, G, nc = 2, 8, 6, 4, 3, 2
    db_h, dc_h = (torch.randn(B, L, H, N, generator=gen) for _ in range(2))
    da_p, dd_p = (torch.randn(B, nc, H, generator=gen) for _ in range(2))
    db, dc, da, dd = ss.bwd_reduce_plain(db_h, dc_h, da_p, dd_p, G)
    assert db.shape == dc.shape == (B, L, G, N)
    torch.testing.assert_close(db[:, :, 1], db_h[:, :, 2] + db_h[:, :, 3])
    torch.testing.assert_close(dc[:, :, 2], dc_h[:, :, 4] + dc_h[:, :, 5])
    torch.testing.assert_close(da, da_p.sum((0, 1)))
    torch.testing.assert_close(dd, dd_p.sum((0, 1)))


def test_cpu_ssd_scan_differentiates_through_the_plain_version(monkeypatch):
    """On the CPU ``ops.ssd_scan`` with inputs that require grad is the plain
    version under autograd, builds nothing, and gives the plain backward's
    gradients."""
    def refuse(name):
        raise AssertionError(f"tried to build {name} on a CPU-only path")

    monkeypatch.setattr(_build, "load", refuse)
    arrays, dy, ds = _inputs(5, 1, 64, 4, 16, 16, 2)
    args, tdy, tds = _torch_args(arrays, dy, ds, torch.float32)
    before = ss.ssd_scan_bwd_cuda.launches
    leaves = [a.clone().requires_grad_() for a in args]
    y, state = ops.ssd_scan(*leaves, chunk=16)
    got = torch.autograd.grad((y, state), leaves, (tdy, tds))
    for g, w in zip(got, ss.ssd_scan_bwd_plain(*args, tdy, tds, chunk=16)):
        assert _rel(g.numpy(), w.numpy()) <= 1e-4
    assert ss.ssd_scan_bwd_cuda.launches == before


def test_bwd_cuda_wrapper_refuses_cpu_tensors():
    arrays, dy, ds = _inputs(6, 1, 16, 2, 16, 16, 1)
    args, tdy, _ = _torch_args(arrays, dy, ds, torch.float32)
    with pytest.raises(ValueError, match="autograd differentiates"):
        ss.ssd_scan_bwd_cuda(*args, tdy, chunk=16)


@pytest.mark.parametrize("P,ps", [(16, 16), (32, 32), (48, 16), (64, 64),
                                  (96, 32), (128, 64)])
def test_bwd_slice_is_the_widest_that_divides_p(P, ps):
    assert ss.bwd_slice(P) == ps


def test_bwd_smem_budget():
    """The backward's blocks at the widest shape it takes (N=128, a 64-wide
    P-slice) fit one SM's 227 KB with the kernels' static arrays; the model
    shapes' chunks blocks: zamba2-7b (N=64) and mamba2-370m (N=128)."""
    assert ss.bwd_smem_bytes("chunks", 128, 64) == 209920
    assert ss.bwd_smem_bytes("chunks", 64, 64) == 144384
    assert ss.bwd_smem_bytes("states", 128, 64) == 87040
    assert ss.bwd_smem_bytes("chunks", 128, 64) + 32 <= 232448
    assert ss.bwd_smem_bytes("states", 128, 64) + 1056 <= 232448


# ---------------------------------------------------------------------------
# the wgmma backward's stages (local states, state pass, rows, cols)
# ---------------------------------------------------------------------------


def _wgmma_inputs(seed, B, L, H, P, N, G, chunk, dtype):
    arrays, dy, ds = _inputs(seed, B, L, H, P, N, G,
                             dt_scale=0.5 if chunk > 64 else 1.0)
    return arrays, dy, ds, _torch_args(arrays, dy, ds, dtype)


@pytest.mark.parametrize("B,L,H,P,N,G,chunk", WGMMA_CASES)
def test_bwd_wgmma_stages_vs_jax_vjp_fp32(B, L, H, P, N, G, chunk):
    """The wgmma backward's stages at its precision (every fp32 operand of a
    tensor-core product as bf16 hi + lo: about 2^-17 relative) against
    jax.vjp of the reference's ssd_chunked, within FP32_RTOL."""
    arrays, dy, ds, (args, tdy, tds) = _wgmma_inputs(0, B, L, H, P, N, G, chunk,
                                                     torch.float32)
    got = ss.ssd_scan_bwd_wgmma_plain(*args, tdy, tds, chunk=chunk, split=True)
    want = _jax_grads(arrays, dy, ds, chunk, jnp.float32)
    for name, g, w, a in zip(NAMES, got, want, args):
        assert g.shape == a.shape and g.dtype == a.dtype, name
        assert _rel(_np(g), _np(w)) <= FP32_RTOL[name], name


@pytest.mark.parametrize("B,L,H,P,N,G,chunk", WGMMA_CASES)
def test_bwd_wgmma_stages_vs_jax_vjp_bf16(B, L, H, P, N, G, chunk):
    """x, b, c and dy in bf16 (the wgmma variant's inputs): dx, db and dc
    within BF16_RTOL of the reference's bf16 cotangents, ddt, da_log and
    dd_skip within FP32_RTOL, from the stages at the kernel's precision."""
    arrays, dy, ds, (args, tdy, tds) = _wgmma_inputs(1, B, L, H, P, N, G, chunk,
                                                     torch.bfloat16)
    got = ss.ssd_scan_bwd_wgmma_plain(*args, tdy, tds, chunk=chunk, split=True)
    want = _jax_grads(arrays, dy, ds, chunk, jnp.bfloat16)
    for name, g, w, a in zip(NAMES, got, want, args):
        assert g.dtype == a.dtype, name
        tol = BF16_RTOL if a.dtype == torch.bfloat16 else FP32_RTOL[name]
        assert _rel(_np(g), _np(w)) <= tol, name


@pytest.mark.parametrize("B,L,H,P,N,G,chunk", [CASES[2], CASES[4], WGMMA_CASES[-1]])
def test_bwd_wgmma_passes_split_what_bwd_chunks_computes(B, L, H, P, N, G, chunk):
    """Without the split the wgmma stages compute what the fma kernels'
    stages do, in another order (fp32, relative norm 1e-5): the row pass dc
    per head, the column pass dx, x . du and db per head; d cum's row part plus
    its column part, with d tot (the chunk's K sums and e^{tot} <g, s_in>)
    at each chunk's last step, is bwd_chunks_plain's d cum; the dy . x
    partials are its d_skip partials."""
    _, _, _, (args, tdy, tds) = _wgmma_inputs(2, B, L, H, P, N, G, chunk,
                                              torch.float32)
    x, dt, a_log, b, c, d_skip = args
    s_loc, ds_loc, tot = ss.bwd_chunk_states_plain(x, dt, a_log, b, c, tdy, chunk=chunk)
    s_in, g, sg = ss.bwd_state_pass_plain(s_loc, ds_loc, tot, tds)
    want = ss.bwd_chunks_plain(x, dt, a_log, b, c, d_skip, tdy, s_in, g, chunk=chunk)
    w_dx, w_xdu, w_dcum, w_db, w_dc, w_dd = want
    dc_h, row = ss.bwd_rows_plain(x, dt, a_log, b, c, tdy, s_in, chunk=chunk)
    dx, xdu, col, db_h, k_sum, dd = ss.bwd_cols_plain(x, dt, a_log, b, c, d_skip, tdy,
                                                      g, chunk=chunk)
    dcum = (row + col).reshape(B, L // chunk, chunk, H)
    dcum[:, :, -1] += k_sum + sg
    for name, got, w in (("dc", dc_h, w_dc), ("dx", dx, w_dx), ("x.du", xdu, w_xdu),
                         ("db", db_h, w_db), ("dcum", dcum.reshape(B, L, H), w_dcum),
                         ("dd_skip", dd, w_dd)):
        assert got.shape == w.shape, name
        assert _rel(got.numpy(), w.numpy()) <= 1e-5, name


def test_bwd_wgmma_state_pass_carries_the_cotangent_and_zero_first_state():
    """Stage 2: chunk 0 enters with a zero state, the last chunk's leaving
    gradient is the cotangent (zero for None), and d tot's state term is
    e^{tot} <g, s_in>, zero in chunk 0."""
    _, _, _, (args, tdy, tds) = _wgmma_inputs(3, 1, 96, 2, 16, 16, 1, 32,
                                              torch.float32)
    x, dt, a_log, b, c, _ = args
    s_loc, ds_loc, tot = ss.bwd_chunk_states_plain(x, dt, a_log, b, c, tdy, chunk=32)
    s_in, g, sg = ss.bwd_state_pass_plain(s_loc, ds_loc, tot, tds)
    assert s_in.shape == g.shape == (1, 3, 2, 16, 16) and sg.shape == (1, 3, 2)
    assert torch.equal(s_in[:, 0], torch.zeros_like(s_in[:, 0]))
    assert torch.equal(g[:, -1], tds)
    assert torch.equal(sg[:, 0], torch.zeros_like(sg[:, 0]))
    torch.testing.assert_close(sg, torch.exp(tot) * (g * s_in).sum((-1, -2)))
    _, g0, _ = ss.bwd_state_pass_plain(s_loc, ds_loc, tot, None)
    assert torch.equal(g0[:, -1], torch.zeros_like(tds))
