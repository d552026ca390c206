"""Port vs reference: gemma2-9b, stablelm-12b, command-r-plus-104b and
llama-3.2-vision-90b at their ``REDUCED`` configs.

gemma2-9b: alternating local/global windows, attention and final softcaps,
post-block norms, ``embed_scale`` and the zero-centered RMSNorm;
stablelm-12b: partial RoPE and per-head qk-norm; command-r-plus-104b: the
parallel block and LayerNorm; llama-3.2-vision-90b: the ``vlm`` plan, a
cross-attention block every fifth layer over seeded random patches through
``vision_proj``. The JAX model's parameters cross to the port through
``repro_torch._bridge``; inputs are seeded numpy. Each arch is checked in
fp32 (tolerance 1e-4) and in bf16 (``DECODE_TOL`` of tests/test_models.py),
as the other families' tests are.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch._bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import common, transformer  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402

DECODE_TOL = 6e-2
TOL = {"float32": 1e-4, "bfloat16": DECODE_TOL}
# Decode rounds P to bf16 before the PV product in both packages, fp32
# models too; a probability that differs in its last fp32 bit may round to
# the neighbouring bf16 value. At gemma2 reduced one such flip moves the
# fp32 logits by 1.1e-4 (P's rounding as a whole by 1.2e-3).
DECODE_STEP_TOL = {"float32": 5e-4, "bfloat16": DECODE_TOL}
B, S = 2, 17
ARCHS = ("gemma2-9b", "stablelm-12b", "command-r-plus-104b",
         "llama-3.2-vision-90b")
VLM = "llama-3.2-vision-90b"
CASES = [(a, d) for a in ARCHS for d in ("float32", "bfloat16")]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _pair(arch, dtype):
    """(jax model, jax params, port model, port params) on the same weights."""
    kw = dict(param_dtype=dtype, activ_dtype=dtype)
    jm = jax_build_model(jax_get_config(arch, reduced=True).replace(**kw))
    tm = build_model(get_config(arch, reduced=True).replace(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _patches(cfg, seed=7):
    """Seeded random patch embeddings (zeros would make the cross-attention
    K/V zero, and its check empty)."""
    v = cfg.vision
    return np.random.default_rng(seed).standard_normal(
        (B, v.num_patches, v.d_vision)).astype(np.float32)


def _inputs(cfg, toks):
    """The same prefill inputs for both packages: tokens, and for the VLM its
    patches."""
    j, t = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        p = _patches(cfg)
        j["patches"], t["patches"] = jnp.asarray(p), torch.from_numpy(p)
    return j, t


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _caches(jm, tm):
    enc = jm.enc_len_for(S)
    assert tm.enc_len_for(S) == enc
    return jm.init_cache(B, S + 2, enc_len=enc), \
        tm.init_cache(B, S + 2, enc_len=enc, device="cpu")


@pytest.mark.parametrize("arch,dtype", CASES)
def test_train_logits_match(arch, dtype):
    jm, jp, tm, tp = _pair(arch, dtype)
    j_in, t_in = _inputs(tm.cfg, _tokens())
    want, _, _ = jm.apply(jp, j_in, mode="train")
    got, cache, aux = tm.apply(tp, t_in, mode="train")
    assert got.dtype == torch.float32 and cache is None and float(aux) == 0.0
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_logits_and_cache_match(arch, dtype):
    """Prefill logits and every cache leaf (self-attention K/V; the VLM's
    cross-attention K/V of the projected patches in ck/cv)."""
    jm, jp, tm, tp = _pair(arch, dtype)
    j_in, t_in = _inputs(tm.cfg, _tokens()[:, :S - 1])
    jcache, tcache = _caches(jm, tm)
    want, jcache = jserve.build_prefill_step(jm, jserve.ServeOptions())(
        jp, j_in, jcache)
    got, tcache = serve.build_prefill_step(tm, serve.ServeOptions())(
        tp, t_in, tcache)
    _close(got, want, TOL[dtype])
    want_leaves, got_leaves = dict(_flat(jcache)), dict(_flat(tcache))
    assert set(got_leaves) == set(want_leaves)
    for path, leaf in want_leaves.items():
        assert tuple(got_leaves[path].shape) == leaf.shape, path
        assert got_leaves[path].dtype == torch.bfloat16, path
        # both caches hold bf16, so a value that differs in its last fp32
        # bits may round to a neighbouring bf16 value
        _close(got_leaves[path], leaf, max(TOL[dtype], 2 ** -7))


@pytest.mark.parametrize("arch,dtype", CASES)
def test_decode_logits_match(arch, dtype):
    """The next token's decode logits from each package's own prefill."""
    jm, jp, tm, tp = _pair(arch, dtype)
    toks = _tokens()
    j_in, t_in = _inputs(tm.cfg, toks[:, :S - 1])
    jcache, tcache = _caches(jm, tm)
    _, jcache = jserve.build_prefill_step(jm, jserve.ServeOptions())(
        jp, j_in, jcache)
    _, want, _ = jserve.build_decode_step(jm, jserve.ServeOptions())(
        jp, jcache, jnp.asarray(toks[:, S - 1:]), jnp.asarray(S - 1, jnp.int32))
    _, tcache = serve.build_prefill_step(tm, serve.ServeOptions())(
        tp, t_in, tcache)
    nxt, got, _ = serve.build_decode_step(tm, serve.ServeOptions())(
        tp, tcache, torch.from_numpy(toks[:, S - 1:]), S - 1)
    assert nxt.shape == (B, 1)
    _close(got, want, DECODE_STEP_TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward(arch):
    """Prefill(S-1) + decode(1) logits == full forward at the last position,
    on the port alone (gemma2's local layers mask the decode window too)."""
    tm = build_model(get_config(arch, reduced=True))
    params = tm.init(torch.Generator().manual_seed(0))
    toks = _tokens(seed=2)
    _, full_in = _inputs(tm.cfg, toks)
    full, _, _ = tm.apply(params, full_in, mode="train")
    _, pre_in = _inputs(tm.cfg, toks[:, :S - 1])
    cache = tm.init_cache(B, S + 1, enc_len=tm.enc_len_for(S), device="cpu")
    _, cache = serve.build_prefill_step(tm, serve.ServeOptions())(
        params, pre_in, cache)
    _, last, _ = serve.build_decode_step(tm, serve.ServeOptions())(
        params, cache, torch.from_numpy(toks[:, S - 1:]), S - 1)
    _close(last, full[:, -1], DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """Same paths, shapes and dtypes as the reference's spec tree (the VLM's
    ``vision_proj`` and cross-attention ``cross_kv`` included)."""
    jm, jp, tm, _ = _pair(arch, "bfloat16")
    want = {tuple(k.key for k in path): (leaf.shape, str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for path, t in _flat(tm.init(torch.Generator().manual_seed(0)))}
    assert got == want
    assert tm.param_count() == jm.param_count()
    if arch == VLM:
        assert ("vision_proj",) in got
        assert ("groups", "g0", "b8", "cross_kv", "wk") in got


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_layer_plan_matches_reference(arch, reduced):
    def plan(mod, cfg):
        return [(g.repeat, [(b.kind, b.window, b.d_ff, b.causal)
                            for b in g.blocks]) for g in mod.layer_plan(cfg)]

    want = plan(jtransformer, jax_get_config(arch, reduced=reduced))
    assert plan(transformer, get_config(arch, reduced=reduced)) == want


def test_vlm_plan_is_four_self_attention_layers_then_a_cross_attention_one():
    """``cross_every`` 5: [attn, ffn] x 4 + (cross_attn, ffn), 20 groups at
    full depth."""
    (gd,) = transformer.layer_plan(get_config(VLM))
    assert gd.repeat == 20
    assert [b.kind for b in gd.blocks] == ["attn", "ffn"] * 4 + ["cross_attn",
                                                                 "ffn"]


def test_vlm_cross_cache_is_sized_by_the_patches():
    """``generate`` makes the cross cache for the patches' length, whatever
    the prompt's, as the reference's ``enc_len_for`` does; a prefill with
    patches of another length than the cache is refused."""
    jm, jp, tm, tp = _pair(VLM, "float32")
    n = tm.cfg.vision.num_patches
    assert tm.enc_len_for(3) == jm.enc_len_for(3) == n
    _, t_in = _inputs(tm.cfg, _tokens(shape=(B, 3)))
    got = serve.ServeSession(tm, tp, device="cpu").generate(
        t_in["tokens"], max_new_tokens=4, extras={"patches": t_in["patches"]})
    assert tuple(got.shape) == (B, 4)
    cache = tm.init_cache(B, 8, enc_len=n - 1, device="cpu")
    with pytest.raises(ValueError, match="cross cache"):
        serve.build_prefill_step(tm, serve.ServeOptions())(tp, t_in, cache)
    cache = tm.init_cache(B, 8, enc_len=n, device="cpu")
    serve.build_prefill_step(tm, serve.ServeOptions())(tp, t_in, cache)
    ck = cache["groups"]["g0"]["b8"]["ck"]
    assert tuple(ck.shape) == (1, B, n, tm.cfg.n_kv_heads, tm.cfg.head_dim_)
    assert not bool(ck.eq(0).all())


def test_vlm_patches_reach_the_logits():
    """The cross-attention sees the patches: random patches give other
    logits than the reference's zero stub patches."""
    tm = build_model(get_config(VLM, reduced=True))
    params = tm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens())
    rand = tm.apply(params, {"tokens": toks,
                             "patches": torch.from_numpy(_patches(tm.cfg))})[0]
    zero = tm.apply(params, {"tokens": toks,
                             **tm.extra_inputs(B, S, device="cpu")})[0]
    assert float((rand - zero).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma2_zero_centered_norm_with_nonzero_scales(dtype):
    """gemma2's RMSNorm multiplies by (1 + scale), its scales drawn as zeros.
    At zero init ``1 + scale`` and ``scale = 1`` agree, so the norm is held
    with non-zero scales, against the reference's ``apply_norm`` at the
    gemma2-9b REDUCED config."""
    jcfg, cfg = jax_get_config("gemma2-9b", reduced=True), \
        get_config("gemma2-9b", reduced=True)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32) * 3
    scale = rng.standard_normal(cfg.d_model).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jcommon.apply_norm({"scale": jnp.asarray(scale)},
                              jnp.asarray(x).astype(jdt), jcfg)
    got = common.apply_norm({"scale": torch.from_numpy(scale)},
                            torch.from_numpy(x).to(tdt), cfg)
    assert got.dtype == tdt
    _close(got, want, 1e-5 if dtype == "float32" else 1e-2)
    plain = common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    assert float((got.float() - plain).abs().max()) > 0.1


@pytest.mark.parametrize("arch,low,high,head_dim", [
    ("gemma2-9b", 9.1e9, 9.3e9, 256), ("stablelm-12b", 12.0e9, 12.2e9, 160),
    ("command-r-plus-104b", 1.03e11, 1.05e11, 128),
    ("llama-3.2-vision-90b", 8.7e10, 8.9e10, 128)])
def test_full_width_sizes(arch, low, high, head_dim):
    """Parameters at full width and the head dim the flash kernel must take:
    gemma2-9b ~9.2e9 (18.5 GB in bf16) and stablelm-12b ~12.1e9 (24.3 GB)
    fit one 80 GB card; command-r-plus-104b ~1.04e11 and
    llama-3.2-vision-90b ~8.8e10 do not."""
    cfg = get_config(arch)
    assert low < build_model(cfg).param_count() < high
    assert cfg.head_dim_ == head_dim


@pytest.mark.parametrize("arch,layers,low,high", [
    ("llama-3.2-vision-90b", 10, 10.6e9, 10.8e9),
    ("command-r-plus-104b", 4, 9.3e9, 9.5e9)])
def test_depth_cut_sizes(arch, layers, low, high):
    """The depth cuts the card runs at full width: the VLM at 10 of 100
    layers (2 of its 20 five-layer groups) ~10.7e9 parameters, command-r-plus
    at 4 of 64 ~9.4e9."""
    cfg = get_config(arch).replace(n_layers=layers)
    assert low < build_model(cfg).param_count() < high
