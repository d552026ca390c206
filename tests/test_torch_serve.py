"""Port vs reference: ``ServeSession.generate`` and the serving launcher.

Greedy tokens must equal the JAX session's wherever the reference's top-2
logit margin exceeds the tolerance: a bf16 near-tie may flip an argmax, and
after a flip the two sequences rightly go apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch._bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 6e-2}
B, S, N = 2, 8, 8


def _pair(dtype, arch="deepseek-7b", **overrides):
    kw = dict(overrides, param_dtype=dtype, activ_dtype=dtype)
    jm = jax_build_model(jax_get_config(arch, reduced=True).replace(**kw))
    tm = build_model(get_config(arch, reduced=True).replace(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _prompts(seed=4, vocab=256, length=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, length)).astype(np.int32)


def _assert_tokens_match(jm, jp, prompts, got, want, tol, extras=None):
    """Equal tokens up to the first step whose reference top-2 margin is
    within ``tol`` (a near-tie may flip there, and the paths go apart)."""
    assert got.shape == want.shape == (B, N)
    # the reference's logits at each step of its own greedy path
    seq = np.concatenate([prompts, want[:, :-1]], axis=1)
    logits, _, _ = jm.apply(jp, {"tokens": jnp.asarray(seq), **(extras or {})},
                            mode="train")
    P = prompts.shape[1]
    top2 = np.sort(np.asarray(logits[:, P - 1:], np.float32), axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    for b in range(B):
        for i in range(N):
            if got[b, i] != want[b, i]:
                assert margin[b, i] <= tol, (b, i, margin[b, i])
                break


def _generate_both(dtype, arch="deepseek-7b", opts=None, **overrides):
    jm, jp, tm, tp = _pair(dtype, arch, **overrides)
    prompts = _prompts()
    want = np.asarray(jserve.ServeSession(
        jm, jp, opts=jserve.ServeOptions(**(opts or {}))).generate(
            jnp.asarray(prompts), max_new_tokens=N))
    got = serve.ServeSession(tm, tp, serve.ServeOptions(**(opts or {})),
                             device="cpu").generate(
        torch.from_numpy(prompts), max_new_tokens=N).numpy()
    _assert_tokens_match(jm, jp, prompts, got, want, TOL[dtype])
    return got, want


@pytest.mark.parametrize("dtype,overrides", [
    ("bfloat16", {}), ("bfloat16", {"n_kv_heads": 2}), ("float32", {})])
def test_generate_matches_reference(dtype, overrides):
    _generate_both(dtype, **overrides)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssm_generate_matches_reference(arch, dtype):
    _generate_both(dtype, arch)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_generate_matches_reference(arch, dtype):
    _generate_both(dtype, arch)


@pytest.mark.parametrize("arch", ["gemma2-9b", "stablelm-12b",
                                  "command-r-plus-104b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_family_generate_matches_reference(arch, dtype):
    """gemma2-9b (local/global windows, softcaps), stablelm-12b (partial
    RoPE, qk-norm) and command-r-plus-104b (parallel block, LayerNorm)."""
    _generate_both(dtype, arch)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_vlm_generate_with_patches_matches_reference(dtype):
    """llama-3.2-vision-90b with seeded random ``patches``: both packages
    size the cross cache by the patches (``enc_len_for``)."""
    jm, jp, tm, tp = _pair(dtype, "llama-3.2-vision-90b")
    prompts = _prompts()
    v = tm.cfg.vision
    patches = np.random.default_rng(6).standard_normal(
        (B, v.num_patches, v.d_vision)).astype(np.float32)
    jpatches = jnp.asarray(patches).astype(jnp.bfloat16)
    want = np.asarray(jserve.ServeSession(jm, jp).generate(
        jnp.asarray(prompts), max_new_tokens=N, extras={"patches": jpatches}))
    got = serve.ServeSession(tm, tp, device="cpu").generate(
        torch.from_numpy(prompts), max_new_tokens=N,
        extras={"patches": torch.from_numpy(patches).bfloat16()}).numpy()
    _assert_tokens_match(jm, jp, prompts, got, want, TOL[dtype],
                         extras={"patches": jpatches})


@pytest.mark.parametrize("prompt_len,enc_len", [(1, 24), (S, S)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_encdec_generate_with_frames_matches_reference(dtype, prompt_len,
                                                       enc_len):
    """seamless-m4t-large-v2 with ``extras={"frames": ...}``: a 1-token
    prompt over 24 frames (the executor's shape: the reference sizes the
    cross cache by the prompt and replaces it in the prefill, the port sizes
    it by the frames) and a prompt as long as its frames."""
    jm, jp, tm, tp = _pair(dtype, "seamless-m4t-large-v2")
    prompts = _prompts(length=prompt_len)
    frames = np.random.default_rng(5).standard_normal(
        (B, enc_len, tm.cfg.d_model)).astype(np.float32)
    jframes = jnp.asarray(frames).astype(jnp.bfloat16)
    want = np.asarray(jserve.ServeSession(jm, jp).generate(
        jnp.asarray(prompts), max_new_tokens=N, extras={"frames": jframes}))
    got = serve.ServeSession(tm, tp, device="cpu").generate(
        torch.from_numpy(prompts), max_new_tokens=N,
        extras={"frames": torch.from_numpy(frames).bfloat16()}).numpy()
    _assert_tokens_match(jm, jp, prompts, got, want, TOL[dtype],
                         extras={"frames": jframes})


def test_encdec_cache_after_prefill_has_the_reference_shapes():
    """The cache as each package's ``generate`` makes it (the reference's
    cross entries sized by the prompt, ``enc_len_for(S)``, the port's by the
    frames), after a prefill of a 1-token prompt over 24 frames: every leaf
    has the reference's shape, ck/cv the frames' length."""
    jm, jp, tm, tp = _pair("bfloat16", "seamless-m4t-large-v2")
    prompts = _prompts(length=1)
    frames = np.zeros((B, 24, tm.cfg.d_model), np.float32)
    assert tm.enc_len_for(1) == jm.enc_len_for(1) == 1
    jcache = jm.init_cache(B, 1 + N, enc_len=jm.enc_len_for(1))
    _, jcache = jserve.build_prefill_step(jm, jserve.ServeOptions())(
        jp, {"tokens": jnp.asarray(prompts), "frames": jnp.asarray(frames)},
        jcache)
    tcache = tm.init_cache(B, 1 + N, enc_len=frames.shape[1], device="cpu")
    _, tcache = serve.build_prefill_step(tm, serve.ServeOptions())(
        tp, {"tokens": torch.from_numpy(prompts),
             "frames": torch.from_numpy(frames)}, tcache)
    want = {path: leaf.shape for path, leaf in
            ((tuple(k.key for k in p), leaf) for p, leaf in
             jax.tree_util.tree_flatten_with_path(jcache)[0])}
    got = {}
    for g, blocks in tcache["groups"].items():
        for b, leaves in blocks.items():
            for name, t in leaves.items():
                got[("groups", g, b, name)] = tuple(t.shape)
    assert got == want
    assert got[("groups", "g0", "b1", "ck")] == (2, B, 24, 4, 16)


def test_extra_inputs_match_reference():
    jm, _, tm, _ = _pair("bfloat16", "seamless-m4t-large-v2")
    want = jm.extra_inputs(3, 5)["frames"]
    got = tm.extra_inputs(3, 5, device="cpu")["frames"]
    assert tuple(got.shape) == want.shape and got.dtype == torch.bfloat16
    assert not bool(got.ne(0).any())
    assert build_model(get_config("deepseek-7b")).extra_inputs(3, 5) == {}


def test_vlm_extra_inputs_match_reference():
    """The VLM's stub frontend: zero bf16 patches of ``num_patches``, whatever
    the prompt's length, and the cross length ``generate`` sizes by."""
    jm, _, tm, _ = _pair("bfloat16", "llama-3.2-vision-90b")
    want = jm.extra_inputs(3, 5)
    got = tm.extra_inputs(3, 5, device="cpu")
    assert list(got) == list(want) == ["patches"]
    assert tuple(got["patches"].shape) == want["patches"].shape == (3, 16, 32)
    assert got["patches"].dtype == torch.bfloat16
    assert not bool(got["patches"].ne(0).any())
    assert serve.cross_len(got) == tm.enc_len_for(5) == 16


@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-7b"])
def test_generate_ignores_temperature_as_the_reference_does(arch):
    """The reference's generate decodes greedily whatever the temperature
    (it gives its decode step no key); the port's session does the same."""
    got, want = _generate_both("float32", arch, opts={"temperature": 0.7})
    greedy, _ = _generate_both("float32", arch)
    assert np.array_equal(got, greedy)


def test_sampling_is_seeded_and_in_range():
    """The decode step samples when given a generator and temperature > 0
    (as the reference's samples when given a key)."""
    _, _, tm, tp = _pair("float32")
    prompts = torch.from_numpy(_prompts()).long()
    cache = tm.init_cache(B, S + 1, device="cpu")
    last, cache = serve.build_prefill_step(tm, serve.ServeOptions())(
        tp, {"tokens": prompts}, cache)
    decode = serve.build_decode_step(tm, serve.ServeOptions(temperature=1.0))
    tok = last.argmax(-1)[:, None]

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return torch.cat([decode(tp, cache, tok, S, gen)[0]
                          for _ in range(N)], dim=1)

    a, b, c = draw(3), draw(3), draw(4)
    assert a.shape == (B, N)
    assert bool(((a >= 0) & (a < tm.cfg.vocab_size)).all())
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_greedy_next_token_takes_the_first_maximum():
    last = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]])
    assert serve._next_token(last, serve.ServeOptions()).tolist() == [[1], [0]]


def test_prefill_and_decode_steps_shapes():
    _, _, tm, tp = _pair("float32")
    prompts = torch.from_numpy(_prompts()).long()
    cache = tm.init_cache(B, S + 1, device="cpu")
    last, cache = serve.build_prefill_step(tm, serve.ServeOptions())(
        tp, {"tokens": prompts}, cache)
    assert last.shape == (B, tm.cfg.vocab_size) and last.dtype == torch.float32
    k = cache["groups"]["g0"]["b0"]["k"]
    assert k.shape == (tm.cfg.n_layers, B, S + 1, tm.cfg.n_kv_heads,
                       tm.cfg.head_dim_)
    assert bool(k[:, :, S:].eq(0).all()) and not bool(k[:, :, :S].eq(0).all())
    nxt, last, cache = serve.build_decode_step(tm, serve.ServeOptions())(
        tp, cache, last.argmax(-1)[:, None], S)
    assert nxt.shape == (B, 1) and not bool(k[:, :, S].eq(0).all())


@pytest.mark.parametrize("arch", ["deepseek-7b", "deepseek-moe-16b",
                                  "kimi-k2-1t-a32b", "mamba2-370m",
                                  "seamless-m4t-large-v2", "zamba2-7b",
                                  "gemma2-9b", "stablelm-12b",
                                  "command-r-plus-104b",
                                  "llama-3.2-vision-90b"])
def test_launcher_runs_reduced_on_cpu(arch, capsys):
    out = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--requests", "3", "--batch", "2",
                             "--prompt-len", "8", "--max-new", "4"])
    assert out["batches"] == 2 and out["tok_per_s"] > 0
    assert f"[serve] {arch} on cpu" in capsys.readouterr().out


def test_launcher_defaults_to_full_width(monkeypatch):
    """--reduced is off unless asked for (the JAX launcher cannot turn it off)."""
    seen = {}

    def fake_config(arch, reduced=False):
        seen["reduced"] = reduced
        raise SystemExit(0)

    monkeypatch.setattr(launch_serve, "get_config", fake_config)
    with pytest.raises(SystemExit):
        launch_serve.main(["--device", "cpu"])
    assert seen == {"reduced": False}
