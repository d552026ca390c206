"""Port vs reference: norms, RoPE, the gated FFN and the dense decoder.

The JAX model's parameters cross to the port through ``repro_torch._bridge``;
inputs are seeded numpy. Each variant is checked in fp32 (tolerance 1e-4)
and in bf16 (``DECODE_TOL`` of tests/test_models.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch._bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import common, ffn, transformer  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402

DECODE_TOL = 6e-2
TOL = {"float32": 1e-4, "bfloat16": DECODE_TOL}
B, S = 2, 17

VARIANTS = {
    "mha": {},
    "gqa": {"n_kv_heads": 2},
    "parallel": {"parallel_block": True},
    "local_global": {"alt_local_global": True, "sliding_window": 8,
                     "post_block_norm": True, "embed_scale": True,
                     "attn_logit_softcap": 50.0, "final_logit_softcap": 30.0},
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _pair(variant, dtype):
    """(jax model, jax params, port model, port params) on the same weights."""
    kw = dict(VARIANTS[variant], param_dtype=dtype, activ_dtype=dtype)
    jm = jax_build_model(jax_get_config("deepseek-7b", reduced=True).replace(**kw))
    tm = build_model(get_config("deepseek-7b", reduced=True).replace(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _tokens(seed=1, shape=(B, S), vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


CASES = [(v, d) for v in ("mha", "gqa") for d in ("float32", "bfloat16")] + \
    [("parallel", "float32"), ("local_global", "float32")]


@pytest.mark.parametrize("variant,dtype", CASES)
def test_train_logits_match(variant, dtype):
    jm, jp, tm, tp = _pair(variant, dtype)
    toks = _tokens()
    want, _, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)}, mode="train")
    got, cache, aux = tm.apply(tp, {"tokens": torch.from_numpy(toks)},
                               mode="train")
    assert got.dtype == torch.float32 and cache is None and float(aux) == 0.0
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("variant,dtype", CASES)
def test_prefill_logits_and_cache_match(variant, dtype):
    jm, jp, tm, tp = _pair(variant, dtype)
    toks = _tokens()[:, :S - 1]
    jcache = jm.init_cache(B, S + 2)
    want, jcache = jserve.build_prefill_step(jm, jserve.ServeOptions())(
        jp, {"tokens": jnp.asarray(toks)}, jcache)
    tcache = tm.init_cache(B, S + 2, device="cpu")
    got, tcache = serve.build_prefill_step(tm, serve.ServeOptions())(
        tp, {"tokens": torch.from_numpy(toks)}, tcache)
    _close(got, want, TOL[dtype])
    # both caches hold bf16 whatever the model dtype, so a K/V value that
    # differs in its last fp32 bits may round to a neighbouring bf16 value
    cache_tol = max(TOL[dtype], 2 ** -7)
    for g, blocks in jcache["groups"].items():
        for b, kv in blocks.items():
            for name in ("k", "v"):
                assert tcache["groups"][g][b][name].dtype == torch.bfloat16
                _close(tcache["groups"][g][b][name], kv[name], cache_tol)


@pytest.mark.parametrize("variant,dtype", CASES)
def test_decode_logits_match(variant, dtype):
    jm, jp, tm, tp = _pair(variant, dtype)
    toks = _tokens()
    jcache = jm.init_cache(B, S + 2)
    _, jcache = jserve.build_prefill_step(jm, jserve.ServeOptions())(
        jp, {"tokens": jnp.asarray(toks[:, :S - 1])}, jcache)
    _, want, _ = jserve.build_decode_step(jm, jserve.ServeOptions())(
        jp, jcache, jnp.asarray(toks[:, S - 1:]), jnp.asarray(S - 1, jnp.int32))
    tcache = tm.init_cache(B, S + 2, device="cpu")
    _, tcache = serve.build_prefill_step(tm, serve.ServeOptions())(
        tp, {"tokens": torch.from_numpy(toks[:, :S - 1])}, tcache)
    nxt, got, _ = serve.build_decode_step(tm, serve.ServeOptions())(
        tp, tcache, torch.from_numpy(toks[:, S - 1:]), S - 1)
    assert nxt.shape == (B, 1)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("variant", ["mha", "gqa", "local_global"])
def test_decode_equals_forward(variant):
    """Prefill(S-1) + decode(1) logits == full forward at the last position,
    on the port alone (the counterpart of tests/test_models.py's proof)."""
    tm = build_model(get_config("deepseek-7b", reduced=True).replace(
        **VARIANTS[variant]))
    gen = torch.Generator().manual_seed(0)
    params = tm.init(gen)
    toks = torch.from_numpy(_tokens(seed=2)).long()
    full, _, _ = tm.apply(params, {"tokens": toks}, mode="train")
    cache = tm.init_cache(B, S + 2, device="cpu")
    _, cache = serve.build_prefill_step(tm, serve.ServeOptions())(
        params, {"tokens": toks[:, :S - 1]}, cache)
    _, last, _ = serve.build_decode_step(tm, serve.ServeOptions())(
        params, cache, toks[:, S - 1:], S - 1)
    _close(last, full[:, -1], DECODE_TOL)


@pytest.mark.parametrize("zero_centered", [False, True])
def test_rms_norm_matches(zero_centered):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32) * 3
    s = rng.standard_normal(32).astype(np.float32)
    for dt, tol in ((jnp.float32, 1e-5), (jnp.bfloat16, 1e-2)):
        want = jcommon.rms_norm(jnp.asarray(x).astype(dt), jnp.asarray(s),
                                zero_centered=zero_centered)
        tdt = torch.float32 if dt == jnp.float32 else torch.bfloat16
        got = common.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(s),
                              zero_centered=zero_centered)
        assert got.dtype == tdt
        _close(got, want, tol)


def test_layer_norm_matches():
    rng = np.random.default_rng(1)
    x, s, b = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((2, 8, 32), (32,), (32,)))
    want = jcommon.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = common.layer_norm(*(torch.from_numpy(a) for a in (x, s, b)))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("rope_pct", [1.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches(rope_pct, dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3, 64)).astype(np.float32)
    pos = np.arange(100, 106)[None].repeat(2, 0).astype(np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jcommon.apply_rope(jnp.asarray(x).astype(jdt), jnp.asarray(pos),
                              rope_pct=rope_pct)
    got = common.apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
                            rope_pct=rope_pct)
    assert got.dtype == tdt
    _close(got, want, 1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_ffn_matches(act):
    cfg = get_config("deepseek-7b", reduced=True).replace(mlp_act=act,
                                                          use_bias=True)
    rng = np.random.default_rng(3)
    p = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.2
         for k, s in ffn.ffn_specs(cfg).items()}
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = jffn.apply_ffn({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), cfg=cfg)
    got = ffn.apply_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), cfg=cfg)
    _close(got, want, 1e-5)


def test_param_tree_matches_reference():
    """Same paths, shapes and dtypes as the reference's spec tree."""
    jm, jp, tm, _ = _pair("gqa", "bfloat16")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {tuple(k.key for k in path): (leaf.shape, str(leaf.dtype))
            for path, leaf in flat}
    got = {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for path, t in _leaves(tm.init(torch.Generator().manual_seed(0)))}
    assert got == want
    assert tm.param_count() == jm.param_count()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_init_fan_in_scaling():
    """Fan-in init skips the stacked layers axis, as the reference does."""
    cfg = get_config("deepseek-7b", reduced=True).replace(d_model=256,
                                                          d_ff=512)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    w_up = params["groups"]["g0"]["b1"]["ffn"]["w_up"].float()
    assert w_up.shape == (2, 256, 512)
    assert abs(w_up.std().item() - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert abs(params["embed"].float().std().item() - 0.02) < 0.002


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid", "encdec", "vlm"])
def test_unported_families_name_their_roadmap_item(family):
    cfg = get_config("deepseek-7b", reduced=True).replace(family=family)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A"):
        transformer.layer_plan(cfg)
