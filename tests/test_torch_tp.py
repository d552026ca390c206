"""Port vs reference and local path: tensor parallelism over the model axis.

On four gloo ranks (``tests/_torch_mesh_ranks.py``, the run shared with
``tests/test_torch_mesh.py`` through ``tests/_torch_mesh_runs.py``), on the
(data 1, model 4) and (2, 2) meshes, REDUCED in fp32 from the same weights
as the reference's run on four host devices: deepseek-7b, command-r-plus-104b
(kv_heads 2: its cache sequence-parallel at model 4, head-parallel at 2),
gemma2-9b (softcaps, sliding window, tied vocabulary; sequence-parallel at
4), seamless-m4t-large-v2 (encoder, cross cache), deepseek-moe-16b (shared
experts beside the expert-parallel ones, remat) and zamba2-7b (shared
attention, its SSM blocks gathered whole), and deepseek-7b with a 258-word
vocabulary (replicated at model 4). Held: the serve steps' tokens equal the
local path's and the reference's ``jit_prefill_step`` / ``jit_decode_step``
on the same mesh, their logits within a relative 1e-5 of the local path's
and within TOL of the reference's; the train step's gradients, loss, grad
norm and step-1 params within 1e-5 of the local step's (and within
GRAD_TOL of the reference's ``jit_train_step``); the blocks a rank computes
with; no dense weight gathered over model; the attention cache on
``cache_shardings``.

On one process: the sequence-split decode attention over four simulated
ranks (threads) against ``decode_attention``; the vocab-parallel
cross-entropy and embedding lookup against the whole-vocabulary ones; a
one-rank group's steps bitwise the local ones.
"""
import datetime
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as rank_side  # noqa: E402
from _torch_mesh_runs import RANKS, mesh_runs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import tp as tp_mod  # noqa: E402
from repro_torch.runtime import train as train_rt  # noqa: E402

# serving, fp32 with an fp32 cache: logits against the local path's
# (another summation order), relative norm; against the reference's,
# elementwise (tests/test_torch_mesh.py's TOL)
SERVE_LOGIT_RTOL = 1e-5
TOL = 1e-4
# training, fp32: each leaf (gradient, params after step 1), loss and grad
# norm against the local step, relative (tests/test_torch_mesh.py's TRAIN_RTOL);
# against the reference, tests/test_torch_train.py's fp32 GRAD_TOL. The
# params after step 2 are not held: AdamW divides each element by its own
# gradient's magnitude, so an element whose gradient is small moves by a
# full step whatever the rounding of its sums (seamless's zero-initialised
# bk, 6e-5 of its norm apart after two steps, with gradients 1e-6 apart)
TRAIN_RTOL = 1e-5
GRAD_TOL = 1e-4
CASES = [(case, rank_side.tp_mesh_name(m)) for case in rank_side.TP_CASES
         for m in rank_side.TP_MESHES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _model_size(mesh: str) -> int:
    return int(mesh.split("x")[1])


@pytest.mark.parametrize("case,mesh", CASES)
def test_tp_serve_gives_the_local_and_the_reference_tokens(runs, case, mesh):
    """Prefill and greedy decode steps: every rank returns the whole batch's
    tokens, equal to the local path's and to the reference's on the same
    mesh; the logits within SERVE_LOGIT_RTOL of the local path's (every
    rank's alike) and within TOL of the reference's."""
    r0, ref = runs["ranks"][0], runs["ref"]
    key = f"tp/{case}/serve"
    want = r0[f"{key}/local/tokens"]
    assert want.shape == (rank_side.TP_BATCH, rank_side.TP_NEW)
    for r in RANKS:
        np.testing.assert_array_equal(runs["ranks"][r][f"{key}/{mesh}/tokens"], want)
        np.testing.assert_array_equal(runs["ranks"][r][f"{key}/{mesh}/logits"],
                                      r0[f"{key}/{mesh}/logits"])
    np.testing.assert_array_equal(ref[f"{key}/{mesh}/tokens"], want)
    got = r0[f"{key}/{mesh}/logits"]
    assert _rel(got, r0[f"{key}/local/logits"]) <= SERVE_LOGIT_RTOL
    np.testing.assert_allclose(got, ref[f"{key}/{mesh}/logits"], atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("case,mesh", CASES)
def test_tp_train_step_matches_local(runs, case, mesh):
    """The mesh step from the reference's weights against the local step on
    the full batch: every leaf's step-1 gradient and params after step 1,
    and both steps' loss and grad norm, within TRAIN_RTOL."""
    r0 = runs["ranks"][0]
    key = f"tp/{case}/train"
    for i in range(rank_side.TRAIN_STEPS):
        for k in ("loss", "grad_norm"):
            got = float(r0[f"{key}/{mesh}/{k}/{i}"])
            want = float(r0[f"{key}/local/{k}/{i}"])
            assert abs(got - want) <= TRAIN_RTOL * abs(want), (k, i, got, want)
    for what in ("grads", "params_step1"):
        leaves = [k.split(f"/{what}/", 1)[1] for k in r0.files
                  if k.startswith(f"{key}/local/{what}/")]
        assert leaves
        for leaf in leaves:
            gap = _rel(r0[f"{key}/{mesh}/{what}/{leaf}"],
                       r0[f"{key}/local/{what}/{leaf}"])
            assert gap <= TRAIN_RTOL, (what, leaf, gap)


@pytest.mark.parametrize("case", rank_side.TP_CASES)
def test_tp_train_step_matches_reference(runs, case):
    """The port's mesh step against the reference's ``jit_train_step`` on
    the case's TP_REF_TRAIN_MESH: both steps' loss and grad norm, and every
    leaf of the params after step 1, within GRAD_TOL."""
    r0, ref = runs["ranks"][0], runs["ref"]
    mesh = rank_side.tp_mesh_name(rank_side.TP_REF_TRAIN_MESH[case])
    key = f"tp/{case}/train/{mesh}"
    for i in range(rank_side.TRAIN_STEPS):
        for k in ("loss", "grad_norm"):
            got, want = float(r0[f"{key}/{k}/{i}"]), float(ref[f"{key}/{k}/{i}"])
            assert abs(got - want) <= GRAD_TOL * abs(want), (k, i, got, want)
    leaves = [k for k in ref.files if k.startswith(f"{key}/params_step1/")]
    assert leaves
    for k in leaves:
        assert _rel(r0[k], ref[k]) <= GRAD_TOL, (k, _rel(r0[k], ref[k]))


def _mlp_widths(cfg) -> set:
    widths = {cfg.d_ff}
    if cfg.moe.num_experts:
        widths |= {cfg.moe.d_ff_dense, cfg.moe.num_shared * cfg.moe.d_ff_expert}
    return widths


@pytest.mark.parametrize("case,mesh", CASES)
def test_tp_ranks_compute_with_their_blocks(runs, case, mesh):
    """What the prefill's projections receive on each rank: ``wq`` (and
    every q/k/v projection) at the rank's heads, never all of them; each
    ``w_gate`` at its share of the MLP columns; the embedding table at the
    rank's share of the vocabulary where model divides it (258 words at
    model 4: whole)."""
    cfg = rank_side.tp_config(case)
    m = _model_size(mesh)
    d, H, hd, V = cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.vocab_size
    for r in RANKS:
        out = runs["ranks"][r]
        key = f"tp/{case}/serve/{mesh}/computes_with"
        heads = {tuple(s) for s in out[f"{key}/heads"]}
        assert (d, H // m, hd) in heads and (d, H, hd) not in heads, heads
        gate = {tuple(s) for s in out[f"{key}/gate"]}
        assert gate and all(s[0] == d and s[1] * m in _mlp_widths(cfg)
                            for s in gate), gate
        embed = {tuple(s) for s in out[f"{key}/embed"]}
        assert embed == {(V // m, d) if V % m == 0 else (V, d)}, embed


@pytest.mark.parametrize("case,mesh", CASES)
def test_tp_no_dense_weight_is_gathered_over_model(runs, case, mesh):
    """A mesh train step gathers over model only the weights the use specs
    take whole there: the SSM blocks' (zamba2-7b), none of the attention,
    MLP or vocabulary weights; and it makes exactly that many model-axis
    all-gathers."""
    out = runs["ranks"][0]
    key = f"tp/{case}/train/{mesh}"
    gathered = [g for g in out[f"{key}/gathered_over_model"] if g]
    assert all("/ssm/" in g for g in gathered), gathered
    assert bool(gathered) == case.startswith("zamba2")
    assert int(out[f"{key}/model_gathers"]) == len(gathered)


@pytest.mark.parametrize("case,mesh", CASES)
def test_tp_attention_cache_is_on_cache_shardings(runs, case, mesh):
    """``mesh_cache``'s k/v (and ck/cv) leaves are placed as
    ``cache_shardings`` says: head-parallel where model divides kv_heads,
    else sequence-parallel (the cache's 32 positions divide)."""
    cfg = rank_side.tp_config(case)
    m = _model_size(mesh)
    want = "heads" if cfg.n_kv_heads % m == 0 else "seq"
    for r in RANKS:
        key = f"tp/{case}/serve/{mesh}"
        out = runs["ranks"][r]
        assert bool(out[f"{key}/attention_cache_as_cache_shardings"])
        layouts = {str(x).split(":")[1] for x in out[f"{key}/cache_layouts"]}
        assert layouts == {want}, layouts


def test_tp_cases_cover_both_cache_layouts_and_the_vocab_fallback(runs):
    """command-r-plus-104b's cache is sequence-parallel at model 4 and
    head-parallel at 2; the 258-word vocabulary is replicated at model 4
    and split at 2."""
    out = runs["ranks"][0]
    layouts = {m: {str(x) for x in out[f"tp/command-r-plus-104b/serve/{m}/cache_layouts"]}
               for m in ("1x4", "2x2")}
    assert layouts == {"1x4": {"k:seq", "v:seq"}, "2x2": {"k:heads", "v:heads"}}
    embed = {m: [tuple(s) for s in out[f"tp/deepseek-7b:v258/serve/{m}/computes_with/embed"]]
             for m in ("1x4", "2x2")}
    assert embed == {"1x4": [(258, 64)], "2x2": [(129, 64)]}


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------


class _Ranks:
    """``n`` ranks simulated by threads: ``reduce`` meets the others and
    returns ``op`` of every rank's tensor, stacked in rank order."""

    def __init__(self, n: int):
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n, timeout=30)

    def reduce(self, rank, x, op):
        self.slots[rank] = x
        self.barrier.wait()
        out = op(torch.stack(self.slots))
        self.barrier.wait()
        return out

    def run(self, fn):
        with ThreadPoolExecutor(self.n) as pool:
            return list(pool.map(fn, range(self.n)))


class _SimTP:
    """A ``models/tp.py`` view of one simulated rank whose every weight is
    split over model."""

    def __init__(self, ranks: _Ranks, rank: int):
        self.ranks, self.rank, self.size = ranks, rank, ranks.n

    def split(self, leaf, dim):
        return True

    def psum(self, x):
        return self.ranks.reduce(self.rank, x, lambda s: s.sum(0))

    def pmax(self, x):
        return self.ranks.reduce(self.rank, x, lambda s: s.amax(0))


DECODE_CASES = [(dt, window, cap) for dt in ("float32", "bfloat16")
                for window, cap in ((0, 0.0), (8, 0.0), (0, 30.0), (8, 30.0))]


@pytest.mark.parametrize("dtype,window,softcap", DECODE_CASES)
def test_decode_attention_split_matches_decode_attention(dtype, window, softcap):
    """A 32-position cache split into 4 slices of 8 (one rank's slice past
    ``kv_len``, masked whole), GQA 8 over 2: the split form against
    ``decode_attention`` on the whole cache. fp32 within the rounding of
    another summation order; bf16 within one bf16 rounding of the output
    (P is rounded to bf16 from the global max and sum, as the local path
    rounds it)."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(3)
    B, H, KVH, D, S, n = 2, 8, 2, 16, 32, 4
    q = torch.randn(B, 1, H, D, generator=g).to(dt)
    k = torch.randn(B, S, KVH, D, generator=g).to(dt)
    v = torch.randn(B, S, KVH, D, generator=g).to(dt)
    kw = dict(window=window, logit_softcap=softcap, scale=D ** -0.5,
              q_offset=21, kv_len=22)
    want = ops.decode_attention(q, k, v, **kw)
    ranks = _Ranks(n)
    Sl = S // n

    def one(r):
        tp = _SimTP(ranks, r)
        return ops.decode_attention_split(
            q, k[:, r * Sl:(r + 1) * Sl], v[:, r * Sl:(r + 1) * Sl],
            k_start=r * Sl, pmax=tp.pmax, psum=tp.psum, **kw)

    got = ranks.run(one)
    for o in got:
        torch.testing.assert_close(o, got[0], rtol=0, atol=0)
    if dtype == "float32":
        torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-6)
    else:
        torch.testing.assert_close(got[0], want, rtol=2 ** -7, atol=2 ** -9)


def test_vocab_parallel_cross_entropy_and_lookup_match_the_whole():
    """A 4-way vocabulary split of 64 words: ``tp.embed_lookup`` on each
    rank's block gives the whole table's rows bitwise (one rank holds each
    row; the others add zeros), and ``train.cross_entropy`` over each rank's
    logits block the whole-vocabulary loss within fp32 rounding."""
    g = torch.Generator().manual_seed(5)
    V, d, n = 64, 8, 4
    table = torch.randn(V, d, generator=g)
    tokens = torch.randint(0, V, (3, 7), generator=g)
    logits = torch.randn(3, 7, V, generator=g) * 4
    labels = torch.randint(0, V, (3, 7), generator=g)
    want_rows = table[tokens]
    want_ce = train_rt.cross_entropy(logits, labels)
    ranks = _Ranks(n)
    Vl = V // n

    def one(r):
        tp = _SimTP(ranks, r)
        rows = tp_mod.embed_lookup(table[r * Vl:(r + 1) * Vl], tokens, tp)
        ce = train_rt.cross_entropy(logits[..., r * Vl:(r + 1) * Vl], labels, tp)
        return rows, ce

    for rows, ce in ranks.run(one):
        assert torch.equal(rows, want_rows)
        torch.testing.assert_close(ce, want_ce, rtol=1e-6, atol=0)


def test_one_rank_group_steps_are_the_local_steps_bitwise(tmp_path):
    """On a (1, 1) mesh of a one-rank gloo group nothing is split: REDUCED
    deepseek-7b (bf16) through ``jit_prefill_step``, ``jit_decode_step``
    and ``jit_train_step`` gives the local steps' logits, tokens, loss and
    params bitwise."""
    import copy

    import torch.distributed as dist
    from repro_torch.data import pipeline
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import serve

    model = build_model(get_config("deepseek-7b", reduced=True))
    params = model.init(torch.Generator().manual_seed(0))
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        opts = serve.ServeOptions()
        B, P, N = 2, 8, 4
        prompts = torch.randint(0, 256, (B, P), generator=torch.Generator().manual_seed(1))
        prefill, _ = serve.jit_prefill_step(model, opts, mesh, B, P)
        decode, _ = serve.jit_decode_step(model, opts, mesh, B, P + N)
        runs = {
            "mesh": (prefill, decode, serve.shard_params(params, model, mesh),
                     serve.mesh_cache(model, opts, mesh, B, P + N, device="cpu")),
            "local": (serve.build_prefill_step(model, opts),
                      serve.build_decode_step(model, opts), params,
                      model.init_cache(B, P + N, device="cpu"))}
        got = {}
        with torch.inference_mode():
            for name, (pre, dec, p, cache) in runs.items():
                last, cache = pre(p, {"tokens": prompts}, cache)
                tok, seen = torch.argmax(last, -1)[:, None], [last]
                for idx in range(P, P + N - 1):
                    tok, last, cache = dec(p, cache, tok, idx)
                    seen.append(last)
                got[name] = torch.stack(seen)
        assert torch.equal(got["mesh"], got["local"])

        topts = train_rt.TrainOptions(remat_policy=None, warmup_steps=1,
                                      total_steps=10)
        state = train_rt.init_train_state(model, torch.Generator().manual_seed(0),
                                          topts)
        local = copy.deepcopy(state)
        dc = pipeline.DataConfig(256, 16, 4)
        batch = pipeline.batch_for_step(dc, 0, model.cfg, device="cpu")
        b_abs = {k: torch.empty(v.shape, device="meta") for k, v in batch.items()}
        mstate = train_rt.distribute_train_state(state, model, mesh, topts)
        mstate, mmet = train_rt.jit_train_step(model, topts, mesh, b_abs)(mstate, batch)
        local, lmet = train_rt.build_train_step(model, topts)(local, batch)
        assert torch.equal(mmet["loss"], lmet["loss"])
        from repro_torch.tree import leaves
        from repro_torch.runtime import sharding as shd
        for a, b in zip(leaves(shd.local_tree(mstate["params"])),
                        leaves(local["params"])):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
