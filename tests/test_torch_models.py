"""Port vs reference: norms, RoPE, the gated FFN, the Mamba2 block, the MoE
layer (routing, dispatch, experts), the dense decoder and the MoE, SSM,
hybrid and encoder-decoder models.

The JAX model's parameters cross to the port through ``repro_torch._bridge``;
inputs are seeded numpy. Each variant is checked in fp32 (tolerance 1e-4)
and in bf16 (``DECODE_TOL`` of tests/test_models.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch._bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import common, ffn, moe, ssm, transformer  # noqa: E402
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


# ---------------------------------------------------------------------------
# Mamba2 block, mamba2-370m and zamba2-7b
# ---------------------------------------------------------------------------

SSM_ARCHS = ("mamba2-370m", "zamba2-7b")
SSM_CASES = [(a, d) for a in SSM_ARCHS for d in ("float32", "bfloat16")]


def _ssm_block(dtype, seed=4):
    """zamba2-7b reduced's SSM block (2 groups) with seeded numpy weights."""
    cfg = get_config("zamba2-7b", reduced=True).replace(param_dtype=dtype,
                                                        activ_dtype=dtype)
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.3
         for k, s in ssm.ssm_specs(cfg).items()}
    p["a_log"] = np.log(rng.uniform(1, 4, p["a_log"].shape)).astype(np.float32)
    jp = {k: jnp.asarray(v).astype(jnp.dtype(dtype)) for k, v in p.items()}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tp


@pytest.mark.parametrize("L", [16, 23, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_prefill_and_decode_match(L, dtype):
    """apply_ssm with a state (L a chunk multiple or not), its state handoff,
    then two apply_ssm_decode steps, against repro.models.ssm."""
    cfg, jp, tp = _ssm_block(dtype)
    B, d = 2, cfg.d_model
    x = np.random.default_rng(5).standard_normal((B, L + 2, d)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.dtype(dtype)), torch.from_numpy(x).to(
        TDT[dtype])
    jst = jax.tree.map(lambda a: a[0], jssm.init_ssm_state(cfg, B, 1))
    tst = {k: v[0] for k, v in ssm.init_ssm_state(cfg, B, 1,
                                                  device="cpu").items()}
    want, jst = jssm.apply_ssm(jp, jx[:, :L], cfg=cfg, state=jst)
    got, new = ssm.apply_ssm(tp, tx[:, :L], cfg=cfg, state=tst)
    assert new is tst and got.dtype == TDT[dtype]
    _close(got, want, TOL[dtype])
    for name in ("conv", "ssm"):
        assert tst[name].dtype == torch.float32
        _close(tst[name], jst[name], TOL[dtype])
    for i in range(L, L + 2):
        want, jst = jssm.apply_ssm_decode(jp, jx[:, i:i + 1], jst, cfg=cfg)
        got, _ = ssm.apply_ssm_decode(tp, tx[:, i:i + 1], tst, cfg=cfg)
        _close(got, want, TOL[dtype])
        _close(tst["ssm"], jst["ssm"], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches(dtype):
    rng = np.random.default_rng(6)
    x, w, b = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((2, 9, 12), (4, 12), (12,)))
    jdt = jnp.dtype(dtype)
    want = jssm._causal_conv(*(jnp.asarray(a).astype(jdt) for a in (x, w, b)))
    got = ssm._causal_conv(*(torch.from_numpy(a).to(TDT[dtype])
                             for a in (x, w, b)))
    assert got.dtype == TDT[dtype]
    _close(got, want, 1e-5 if dtype == "float32" else 2e-2)


def _ssm_pair(arch, dtype):
    kw = dict(param_dtype=dtype, activ_dtype=dtype)
    jm = jax_build_model(jax_get_config(arch, reduced=True).replace(**kw))
    tm = build_model(get_config(arch, reduced=True).replace(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SSM_S = 21          # a prompt that is not a multiple of the reduced chunk (16)
# bf16 models: the SSM states are unnormalised sums that carry each layer's
# bf16 rounding differences (XLA fuses elementwise chains in fp32, torch
# rounds per op) into the next layer; over 7 layers a cache leaf moves
# 0.5-7.4% in relative norm while the logits agree within DECODE_TOL
CACHE_RTOL_BF16 = 0.1


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,dtype", SSM_CASES)
def test_ssm_train_logits_match(arch, dtype):
    jm, jp, tm, tp = _ssm_pair(arch, dtype)
    toks = _tokens(shape=(B, SSM_S))
    want, _, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)}, mode="train")
    got, cache, aux = tm.apply(tp, {"tokens": torch.from_numpy(toks)},
                               mode="train")
    assert got.dtype == torch.float32 and cache is None and float(aux) == 0.0
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("arch,dtype", SSM_CASES)
def test_ssm_prefill_logits_cache_and_decode_match(arch, dtype):
    """Prefill logits, every cache leaf (KV cache, conv buffer, SSM state),
    then the decode logits of the next token, against the reference."""
    jm, jp, tm, tp = _ssm_pair(arch, dtype)
    toks = _tokens(shape=(B, SSM_S + 1))
    jcache = jm.init_cache(B, SSM_S + 2)
    want, jcache = jserve.build_prefill_step(jm, jserve.ServeOptions())(
        jp, {"tokens": jnp.asarray(toks[:, :SSM_S])}, jcache)
    tcache = tm.init_cache(B, SSM_S + 2, device="cpu")
    got, tcache = serve.build_prefill_step(tm, serve.ServeOptions())(
        tp, {"tokens": torch.from_numpy(toks[:, :SSM_S])}, tcache)
    _close(got, want, TOL[dtype])
    want_leaves = dict(_flat(jcache))
    got_leaves = dict(_flat(tcache))
    assert set(got_leaves) == set(want_leaves)
    for path, leaf in want_leaves.items():
        got_leaf, want_leaf = _np(got_leaves[path]), _np(leaf)
        assert got_leaf.shape == want_leaf.shape, path
        if dtype == "float32":
            # bf16 K/V may round to a neighbouring value (see the dense test)
            _close(got_leaf, want_leaf, 2 ** -7 if path[-1] in ("k", "v")
                   else TOL[dtype])
        else:
            rel = np.linalg.norm(got_leaf - want_leaf) / np.linalg.norm(want_leaf)
            assert rel <= CACHE_RTOL_BF16, (path, rel)
    _, want, _ = jserve.build_decode_step(jm, jserve.ServeOptions())(
        jp, jcache, jnp.asarray(toks[:, SSM_S:]),
        jnp.asarray(SSM_S, jnp.int32))
    nxt, got, _ = serve.build_decode_step(tm, serve.ServeOptions())(
        tp, tcache, torch.from_numpy(toks[:, SSM_S:]), SSM_S)
    assert nxt.shape == (B, 1)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_decode_equals_forward(arch):
    """Prefill(S-1) + decode(1) logits == full forward at the last position,
    on the port alone, for the SSM state handoff."""
    tm = build_model(get_config(arch, reduced=True))
    params = tm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(seed=2, shape=(B, SSM_S))).long()
    full, _, _ = tm.apply(params, {"tokens": toks}, mode="train")
    cache = tm.init_cache(B, SSM_S + 1, device="cpu")
    _, cache = serve.build_prefill_step(tm, serve.ServeOptions())(
        params, {"tokens": toks[:, :SSM_S - 1]}, cache)
    _, last, _ = serve.build_decode_step(tm, serve.ServeOptions())(
        params, cache, toks[:, SSM_S - 1:], SSM_S - 1)
    _close(last, full[:, -1], DECODE_TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_param_tree_matches_reference(arch):
    jm, jp, tm, _ = _ssm_pair(arch, "bfloat16")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {tuple(k.key for k in path): (leaf.shape, str(leaf.dtype))
            for path, leaf in flat}
    got = {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for path, t in _leaves(tm.init(torch.Generator().manual_seed(0)))}
    assert got == want
    assert tm.param_count() == jm.param_count()


def test_layer_plans_and_caches_of_the_ssm_families():
    """zamba2 reduced: g0 = 3 SSM blocks + the shared block, twice; g1 = one
    SSM block. mamba2 has no attention, so no KV cache."""
    zcfg = get_config("zamba2-7b", reduced=True)
    plan = transformer.layer_plan(zcfg)
    assert [(g.repeat, [b.kind for b in g.blocks]) for g in plan] == \
        [(2, ["ssm", "ssm", "ssm", "shared_attn"]), (1, ["ssm"])]
    cache = build_model(zcfg).init_cache(1, 8, device="cpu")
    assert set(cache["groups"]["g0"]["b3"]) == {"k", "v"}
    assert cache["groups"]["g0"]["b3"]["k"].shape[0] == 2
    assert cache["groups"]["g1"]["b0"]["ssm"].dtype == torch.float32
    mcache = build_model(get_config("mamba2-370m", reduced=True)).init_cache(
        1, 8, device="cpu")
    assert all(set(b) == {"conv", "ssm"}
               for b in mcache["groups"]["g0"].values())


# ---------------------------------------------------------------------------
# MoE: routing, dispatch, the local layer, deepseek-moe-16b and kimi-k2
# ---------------------------------------------------------------------------

MOE_ARCHS = ("deepseek-moe-16b", "kimi-k2-1t-a32b")
MOE_CASES = [(a, d) for a in MOE_ARCHS for d in ("float32", "bfloat16")]
# aux is an fp32 reduction over the router's probabilities: in fp32 the two
# packages differ only in summation order; in bf16 the hidden states that
# feed the routers differ by each layer's rounding
AUX_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _with_capacity(cfg, factor):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def _moe_layer(T, dtype="float32", factor=None, seed=0, arch="deepseek-moe-16b",
               hot_last=False):
    """The reduced config's MoE layer: reference params from its own init
    (fp32 router, experts in ``dtype``), bridged to the port; x seeded.
    ``hot_last``: every token's router prefers the last expert (x[:, 0] = 3
    and router[0, E-1] = 2), so that it overflows its capacity."""
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    if factor is not None:
        jcfg, cfg = _with_capacity(jcfg, factor), _with_capacity(cfg, factor)
    jp = jcommon.init_params(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed),
                             jnp.dtype(dtype))
    if hot_last:
        jp["router"] = jp["router"].at[0, -1].set(2.0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    if hot_last:
        x[:, 0] = 3.0
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    return jcfg, cfg, jp, tp, jx, torch.from_numpy(x).to(TDT[dtype])


def test_moe_specs_keep_the_router_in_fp32():
    cfg = get_config("deepseek-moe-16b", reduced=True)
    params = common.init_params(moe.moe_specs(cfg),
                                torch.Generator().manual_seed(0))
    assert params["router"].dtype == torch.float32
    assert params["w_gate"].dtype == torch.bfloat16
    assert set(params["shared"]) == {"w_gate", "w_up", "w_down"}


@pytest.mark.parametrize("T", [1, 4, 17, 64, 8192])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_matches_reference(T, arch):
    for factor in (None, 1.25):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        if factor is not None:
            jcfg, cfg = _with_capacity(jcfg, factor), _with_capacity(cfg, factor)
        assert moe._capacity(T, cfg) == jmoe._capacity(T, jcfg)
    # deepseek-moe-16b's serving shapes: a prefill of 4 x 2048 tokens, a
    # decode step of 4
    if arch == "deepseek-moe-16b":
        assert moe._capacity(8192, get_config(arch)) == 968
        assert moe._capacity(4, get_config(arch)) == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_reference(dtype):
    """Expert ids exactly, weights in x's dtype, and the aux loss."""
    jcfg, cfg, jp, tp, jx, tx = _moe_layer(64, dtype)
    j_idx, j_w, j_aux = jmoe._route(jx, jp["router"], jcfg)
    idx, w, aux = moe._route(tx, tp["router"], cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert w.dtype == TDT[dtype]
    # fp32: the router's sums in another order move a weight by an ulp
    _close(w, j_w, {"float32": 1e-6, "bfloat16": 2 ** -8}[dtype])
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-6)


def test_route_breaks_ties_as_top_k():
    """Equal probabilities: the lower expert id comes first, as in
    ``jax.lax.top_k``."""
    jcfg, cfg, jp, tp, jx, tx = _moe_layer(16)
    r = np.asarray(jp["router"]).copy()
    r[:, 5] = r[:, 2]               # experts 2 and 5 always tie
    r[:, 7] = r[:, 2] + 1.0         # and 7 is above both
    j_idx, j_w, _ = jmoe._route(jx, jnp.asarray(r), jcfg)
    idx, w, _ = moe._route(tx, torch.from_numpy(r), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    _close(w, j_w, 1e-6)


def _skewed_topk(T, k, E, hot, seed=0):
    """topk ids with distinct experts per token, ``hot`` in every row."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(T):
        rest = [e for e in rng.permutation(E) if e not in hot]
        rows.append(np.array(list(hot) + rest[:k - len(hot)])[rng.permutation(k)])
    return np.stack(rows).astype(np.int32)


DISPATCH_CASES = {
    # name: (T, k, E, C, experts every token picks)
    "no_drops": (64, 2, 8, 40, ()),
    "last_expert_overflows": (64, 2, 8, 24, (7,)),
    "last_expert_exactly_full": (24, 2, 8, 24, (7,)),
    "other_experts_overflow": (64, 2, 8, 24, (0, 3)),
    "full_width_last_expert_overflows": (8192, 6, 64, 968, (63,)),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_indices_equal_reference_exactly(case):
    """Every slot and inverse entry equal, with the reference's scatter
    collision at (E-1, C-1) where expert E-1 overflows."""
    T, k, E, C, hot = DISPATCH_CASES[case]
    topk = _skewed_topk(T, k, E, hot)
    counts = np.bincount(topk.reshape(-1), minlength=E)
    assert (counts[E - 1] > C) == (case.endswith("last_expert_overflows"))
    j_gather, j_inv = jmoe._dispatch_indices(jnp.asarray(topk), E, C)
    gather, inv = moe._dispatch_indices(torch.from_numpy(topk).long(), E, C)
    np.testing.assert_array_equal(gather.numpy(), np.asarray(j_gather))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(j_inv))
    if counts[E - 1] > C:           # the kept assignment in that slot is lost
        assert int(gather[E - 1, C - 1]) == T
        assert int((inv == (E - 1) * C + C - 1).sum()) == 1


@pytest.mark.parametrize("factor", [1.25, 64.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_local_matches_reference(factor, dtype):
    """The local layer at the configs' default capacity factor, with a
    router that overflows the last expert (assignments dropped, and the
    reference's collision at slot (E-1, C-1)), and at the reduced configs'
    drop-free 64."""
    jcfg, cfg, jp, tp, jx, tx = _moe_layer(64, dtype, factor, hot_last=True)
    j_out, j_aux = jmoe._moe_local(jx, jp, jcfg)
    out, aux = moe._moe_local(tx, tp, cfg)
    assert out.dtype == TDT[dtype] and out.shape == tx.shape
    _close(out, j_out, TOL[dtype])
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-6)
    idx, _, _ = moe._route(tx, tp["router"], cfg)
    C = moe._capacity(64, cfg)
    gather, inv = moe._dispatch_indices(idx, cfg.moe.num_experts, C)
    dropped = int((inv == cfg.moe.num_experts * C).sum())
    assert (dropped > 0) == (factor == 1.25)
    # at 1.25 the last expert overflows: the reference's collision at its
    # last slot, which the outputs above held
    overflow = np.bincount(idx.reshape(-1).numpy(),
                           minlength=cfg.moe.num_experts)[-1] > C
    assert overflow == (factor == 1.25)
    assert not overflow or int(gather[-1, -1]) == 64


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_moe_with_shared_experts_matches_reference(act):
    jcfg, cfg, jp, tp, jx, tx = _moe_layer(2 * 9, factor=1.25, seed=3)
    jcfg, cfg = jcfg.replace(mlp_act=act), cfg.replace(mlp_act=act)
    j_out, j_aux = jmoe.apply_moe(jp, jx.reshape(2, 9, -1), cfg=jcfg)
    out, aux = moe.apply_moe(tp, tx.reshape(2, 9, -1), cfg=cfg)
    assert out.shape == (2, 9, cfg.d_model)
    _close(out, j_out, 1e-5)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-6)


_moe_pair = _ssm_pair   # the same pair: reduced config, JAX init, bridged weights


@pytest.mark.parametrize("arch,dtype", MOE_CASES)
def test_moe_train_logits_and_aux_match(arch, dtype):
    jm, jp, tm, tp = _moe_pair(arch, dtype)
    toks = _tokens()
    want, _, j_aux = jm.apply(jp, {"tokens": jnp.asarray(toks)}, mode="train")
    got, cache, aux = tm.apply(tp, {"tokens": torch.from_numpy(toks)},
                               mode="train")
    assert got.dtype == torch.float32 and cache is None
    assert aux.dtype == torch.float32 and float(aux) > 0
    _close(got, want, TOL[dtype])
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=AUX_RTOL[dtype])


@pytest.mark.parametrize("arch,dtype", MOE_CASES)
def test_moe_prefill_cache_and_decode_match(arch, dtype):
    """Prefill logits, the KV cache, then the next token's decode logits,
    against the reference."""
    jm, jp, tm, tp = _moe_pair(arch, dtype)
    toks = _tokens()
    jcache = jm.init_cache(B, S + 2)
    want, jcache = jserve.build_prefill_step(jm, jserve.ServeOptions())(
        jp, {"tokens": jnp.asarray(toks[:, :S - 1])}, jcache)
    tcache = tm.init_cache(B, S + 2, device="cpu")
    got, tcache = serve.build_prefill_step(tm, serve.ServeOptions())(
        tp, {"tokens": torch.from_numpy(toks[:, :S - 1])}, tcache)
    _close(got, want, TOL[dtype])
    want_leaves, got_leaves = dict(_flat(jcache)), dict(_flat(tcache))
    assert set(got_leaves) == set(want_leaves)
    for path, leaf in want_leaves.items():
        assert got_leaves[path].dtype == torch.bfloat16, path
        _close(got_leaves[path], leaf, max(TOL[dtype], 2 ** -7))
    _, want, _ = jserve.build_decode_step(jm, jserve.ServeOptions())(
        jp, jcache, jnp.asarray(toks[:, S - 1:]), jnp.asarray(S - 1, jnp.int32))
    nxt, got, _ = serve.build_decode_step(tm, serve.ServeOptions())(
        tp, tcache, torch.from_numpy(toks[:, S - 1:]), S - 1)
    assert nxt.shape == (B, 1)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_equals_forward(arch):
    """Prefill(S-1) + decode(1) == full forward at the last position, on the
    port alone (the reduced configs' capacity drops nothing)."""
    tm = build_model(get_config(arch, reduced=True))
    params = tm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(seed=2)).long()
    full, _, _ = tm.apply(params, {"tokens": toks}, mode="train")
    cache = tm.init_cache(B, S + 1, device="cpu")
    _, cache = serve.build_prefill_step(tm, serve.ServeOptions())(
        params, {"tokens": toks[:, :S - 1]}, cache)
    _, last, _ = serve.build_decode_step(tm, serve.ServeOptions())(
        params, cache, toks[:, S - 1:], S - 1)
    _close(last, full[:, -1], DECODE_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_param_tree_matches_reference(arch):
    """Same paths, shapes and dtypes (the router in fp32) as the reference."""
    jm, jp, tm, _ = _moe_pair(arch, "bfloat16")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {tuple(k.key for k in path): (leaf.shape, str(leaf.dtype))
            for path, leaf in flat}
    got = {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for path, t in _leaves(tm.init(torch.Generator().manual_seed(0)))}
    assert got == want
    assert got[("groups", "g1", "b1", "moe", "router")][1] == "float32"
    assert tm.param_count() == jm.param_count()


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_moe_layer_plan_matches_reference(arch, reduced):
    """first_k_dense groups of (attn, ffn at d_ff_dense), then (attn, moe)."""
    def plan(mod, cfg):
        return [(g.repeat, [(b.kind, b.window, b.d_ff, b.causal)
                            for b in g.blocks]) for g in mod.layer_plan(cfg)]

    want = plan(jtransformer, jax_get_config(arch, reduced=reduced))
    assert plan(transformer, get_config(arch, reduced=reduced)) == want
    assert [kinds[-1][0] for _, kinds in want] == ["ffn", "moe"]


# ---------------------------------------------------------------------------
# Encoder-decoder: seamless-m4t-large-v2
# ---------------------------------------------------------------------------

SEAMLESS = "seamless-m4t-large-v2"
ENC_S = 23          # frames: another length than the prompt, not a block multiple


def _frames(seed=7, shape=(B, ENC_S, 64)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _inputs(toks, frames):
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_train_logits_match(dtype):
    jm, jp, tm, tp = _ssm_pair(SEAMLESS, dtype)
    j_in, t_in = _inputs(_tokens(), _frames())
    want, _, _ = jm.apply(jp, j_in, mode="train")
    got, cache, aux = tm.apply(tp, t_in, mode="train")
    assert got.dtype == torch.float32 and cache is None and float(aux) == 0.0
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("enc_len", [S - 1, ENC_S])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_prefill_cache_and_decode_match(dtype, enc_len):
    """Prefill logits, every cache leaf (the self-attention K/V and the
    encoder's K/V in ck/cv), then the next token's decode logits. The
    reference's cache made for ``enc_len`` cross entries (the prompt's
    length, as its generate sizes it, or the frames') holds the frames'
    length after its prefill, the port's is made for the frames' length."""
    jm, jp, tm, tp = _ssm_pair(SEAMLESS, dtype)
    toks, frames = _tokens(), _frames()
    j_in, t_in = _inputs(toks[:, :S - 1], frames)
    jcache = jm.init_cache(B, S + 2, enc_len=enc_len)
    want, jcache = jserve.build_prefill_step(jm, jserve.ServeOptions())(
        jp, j_in, jcache)
    tcache = tm.init_cache(B, S + 2, enc_len=ENC_S, device="cpu")
    got, tcache = serve.build_prefill_step(tm, serve.ServeOptions())(
        tp, t_in, tcache)
    _close(got, want, TOL[dtype])
    want_leaves, got_leaves = dict(_flat(jcache)), dict(_flat(tcache))
    assert set(got_leaves) == set(want_leaves)
    for path, leaf in want_leaves.items():
        assert tuple(got_leaves[path].shape) == leaf.shape, path
        assert got_leaves[path].dtype == torch.bfloat16, path
        _close(got_leaves[path], leaf, max(TOL[dtype], 2 ** -7))
    assert got_leaves[("groups", "g0", "b1", "ck")].shape[2] == ENC_S
    _, want, _ = jserve.build_decode_step(jm, jserve.ServeOptions())(
        jp, jcache, jnp.asarray(toks[:, S - 1:]), jnp.asarray(S - 1, jnp.int32))
    nxt, got, _ = serve.build_decode_step(tm, serve.ServeOptions())(
        tp, tcache, torch.from_numpy(toks[:, S - 1:]), S - 1)
    assert nxt.shape == (B, 1)
    _close(got, want, TOL[dtype])


def test_encdec_decode_equals_forward():
    """Prefill(S-1) + decode(1) logits == full forward at the last position,
    on the port alone: decode reads the encoder's K/V from the cache."""
    tm = build_model(get_config(SEAMLESS, reduced=True))
    params = tm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(seed=2)).long()
    frames = torch.from_numpy(_frames(seed=3))
    full, _, _ = tm.apply(params, {"tokens": toks, "frames": frames},
                          mode="train")
    cache = tm.init_cache(B, S + 1, enc_len=ENC_S, device="cpu")
    _, cache = serve.build_prefill_step(tm, serve.ServeOptions())(
        params, {"tokens": toks[:, :S - 1], "frames": frames}, cache)
    _, last, _ = serve.build_decode_step(tm, serve.ServeOptions())(
        params, cache, toks[:, S - 1:], S - 1)
    _close(last, full[:, -1], DECODE_TOL)


@pytest.mark.parametrize("enc_len", [1, ENC_S + 1])
def test_encdec_prefill_rejects_a_cross_cache_of_another_length(enc_len):
    """A cross cache not made for the frames' length is refused, not
    broadcast into (a 1-row frame set into a longer cache) or cut."""
    tm = build_model(get_config(SEAMLESS, reduced=True))
    params = tm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(seed=2)).long()
    frames = torch.from_numpy(_frames(seed=3))
    cache = tm.init_cache(B, S, enc_len=enc_len, device="cpu")
    with pytest.raises(ValueError, match="cross cache"):
        serve.build_prefill_step(tm, serve.ServeOptions())(
            params, {"tokens": toks, "frames": frames}, cache)


def test_encdec_param_tree_matches_reference():
    """Same paths, shapes and dtypes as the reference, the ``encoder`` and
    the ``cross_kv`` subtrees included."""
    jm, jp, tm, _ = _ssm_pair(SEAMLESS, "bfloat16")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {tuple(k.key for k in path): (leaf.shape, str(leaf.dtype))
            for path, leaf in flat}
    got = {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for path, t in _leaves(tm.init(torch.Generator().manual_seed(0)))}
    assert got == want
    assert ("encoder", "in_proj") in got
    assert ("groups", "g0", "b1", "cross_kv", "wk") in got
    assert tm.param_count() == jm.param_count()


@pytest.mark.parametrize("reduced", [True, False])
def test_encdec_layer_plans_match_reference(reduced):
    """Decoder (attn, cross_attn, ffn) x n_layers; encoder (non-causal attn,
    ffn) x n_encoder_layers."""
    def plan(fn, cfg):
        return [(g.repeat, [(b.kind, b.window, b.d_ff, b.causal)
                            for b in g.blocks]) for g in fn(cfg)]

    jcfg, cfg = jax_get_config(SEAMLESS, reduced=reduced), \
        get_config(SEAMLESS, reduced=reduced)
    assert plan(transformer.layer_plan, cfg) == plan(jtransformer.layer_plan, jcfg)
    assert plan(transformer.encoder_plan, cfg) == \
        plan(jtransformer.encoder_plan, jcfg)
    assert plan(transformer.encoder_plan, cfg)[0][1][0] == ("attn", 0, 0, False)


def test_encoder_states_match_reference():
    """The encoder alone (in_proj, the non-causal stack, final_norm) in fp32
    against the reference's forward, whose cross-attention K/V in the cache
    are these states projected."""
    jm, jp, tm, tp = _ssm_pair(SEAMLESS, "float32")
    frames = _frames()
    got = transformer.encode(tp, torch.from_numpy(frames), cfg=tm.cfg)
    assert got.shape == (B, ENC_S, tm.cfg.d_model) and got.dtype == torch.float32
    enc = jp["encoder"]
    h = jnp.einsum("bse,ed->bsd", jnp.asarray(frames), enc["in_proj"])
    gd, = jtransformer.encoder_plan(jm.cfg)
    h, _, _ = jtransformer._apply_group(
        enc["groups"]["g0"], h, gd, cfg=jm.cfg, dist=jmoe.LOCAL, mode="train",
        cache=None, cache_index=None, cross_states=None, shared_params=None,
        positions=jnp.arange(ENC_S)[None, :])
    want = jcommon.apply_norm(enc["final_norm"], h, jm.cfg)
    _close(got, want, TOL["float32"])
