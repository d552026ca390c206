"""Port vs reference: the real executor on the video workflow.

The four checks of tests/test_executor_real.py, run on the port's
``RealExecutor`` with the same fixtures: the reference's media (carried
across as numpy), the reference's MIN_COST and baseline plans (the port
duck-types them), the reference's reduced models (weights bridged) and its
detector projections. Then the port's outputs are held to the JAX
executor's on those fixtures.

The reduced models are bf16, so a greedy step whose reference top-2 margin
is within bf16's tolerance may flip (tests/test_torch_serve.py's rule);
object ids may flip only where the reference's top-2 cosines are within
fp32 rounding. ``test_outputs_match_the_jax_executor`` prints which
held: on these fixtures the transcripts are equal token for token, and the
summaries are equal except one scene from the step where the reference's
top two logits tie exactly in bf16.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.configs.workflow_video import (PAPER_VIDEOS,  # noqa: E402
                                          make_baseline_workflow,
                                          make_declarative_job)
from repro.core import MIN_COST, Murakkab  # noqa: E402
from repro.core import executor as jexecutor  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro_torch._bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import Media, RealExecutor, seeded_sessions  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.runtime.serve import ServeSession  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 6e-2           # bf16 logits (tests/test_models.py's DECODE_TOL)
COS_TOL = 1e-5       # fp32 cosines: a 3072-long sum in another order


@pytest.fixture(scope="module")
def jax_media():
    return [jexecutor.Media.synthesize(v.name, scenes=2, fps=4, seed=i)
            for i, v in enumerate(PAPER_VIDEOS[:1])]


@pytest.fixture(scope="module")
def media(jax_media):
    return [Media(m.name, torch.from_numpy(np.array(m.frames)),
                  torch.from_numpy(np.array(m.audio))) for m in jax_media]


@pytest.fixture(scope="module")
def sessions():
    """arch -> a port session on the reference executor's weights (its
    reduced config, ``init(PRNGKey(seed))`` with seed 0), built once."""
    built = {}

    def make(arch):
        if arch not in built:
            jm = jax_build_model(jax_get_config(arch, reduced=True))
            params = params_from_numpy(
                jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))), "cpu")
            built[arch] = ServeSession(build_model(get_config(arch, reduced=True)),
                                       params, device="cpu")
        return built[arch]

    return make


@pytest.fixture(scope="module")
def projections():
    """The reference detector's projections, drawn as it draws them."""
    k_img, k_txt = jax.random.split(jax.random.PRNGKey(0 + 1))
    img = jax.random.normal(k_img, (32 * 32 * 3, 64)) / 55.4
    txt = jax.random.normal(k_txt, (len(jexecutor._LABELS), 64))
    return torch.from_numpy(np.array(img)), torch.from_numpy(np.array(txt))


@pytest.fixture(scope="module")
def executor(sessions, projections):
    def make(library):
        return RealExecutor(library, sessions, projections=projections,
                            device="cpu")
    return make


def _min_cost():
    system = Murakkab.paper_cluster()
    return (system, *system.plan(make_declarative_job(MIN_COST)))


@pytest.fixture(scope="module")
def outputs(media, executor):
    system, dag, plan = _min_cost()
    return executor(system.library).run(dag, plan, media), dag


def _by(out, part):
    return [v for k, v in out.items() if part in k][0]


def test_shapes_and_dataflow(outputs, media):
    out, dag = outputs
    scenes = media[0].frames.shape[0]
    assert _by(out, "frame_extract").shape[0] == scenes
    assert _by(out, "speech").shape == (scenes, 8)
    assert _by(out, "object").shape[:1] == (scenes,)
    assert _by(out, "summar").shape == (scenes, 8)
    assert _by(out, "embed").shape[0] == scenes


def test_deterministic(media, executor):
    system, dag, plan = _min_cost()
    o1 = executor(system.library).run(dag, plan, media)
    o2 = executor(system.library).run(dag, plan, media)
    for k in o1:
        if k != "_timings":
            assert torch.equal(o1[k], o2[k]), k


def test_same_outputs_across_plans(media, executor):
    """Baseline plan and MIN_COST plan compute identical summaries when the
    underlying impls match (the paper's quality-preservation claim)."""
    system_a, dag_a, plan_a = _min_cost()
    out_a = executor(system_a.library).run(dag_a, plan_a, media)
    sys_b = Murakkab.paper_cluster()
    dag_b, plan_b = sys_b.lower_imperative(make_baseline_workflow(),
                                           PAPER_VIDEOS[:1])
    out_b = executor(sys_b.library).run(dag_b, plan_b, media)
    assert torch.equal(_by(out_a, "summar"), _by(out_b, "summar"))


def test_qa_agent(media, executor):
    system, dag, plan = _min_cost()
    ex = executor(system.library)
    ex.run(dag, plan, media)
    ans = ex.qa(None, "what objects appear?", None)
    assert ans.shape == (1, 8)


def _margins(sess, inputs, want):
    """The reference's top-2 logit margin at each step of its own greedy
    path (B, steps)."""
    P = inputs["tokens"].shape[1]
    seq = jnp.concatenate([inputs["tokens"], jnp.asarray(want[:, :-1])], 1)
    logits, _, _ = sess.model.apply(sess.params, {**inputs, "tokens": seq},
                                    mode="train")
    top2 = np.sort(np.asarray(logits[:, P - 1:], np.float32), -1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _first_flips(got, want, margin, tol):
    """Per row, the first step where the tokens differ (None: equal), each
    at a step whose reference margin is within ``tol``."""
    flips = []
    for b in range(want.shape[0]):
        diff = np.flatnonzero(got[b] != want[b])
        if diff.size:
            assert margin[b, diff[0]] <= tol, (b, diff[0], margin[b, diff[0]])
        flips.append(int(diff[0]) if diff.size else None)
    return flips


def test_outputs_match_the_jax_executor(jax_media, outputs):
    """Frames equal; object ids equal where the reference's cosines decide;
    transcript and summary ids equal up to the first step that the
    reference decides within bf16's tolerance; embed vectors as the
    reference's embed computes them from the port's summaries.

    Which held is printed per scene (the first step where the ids differ,
    None where they are equal; ``pytest -rA`` shows it). When written:
    transcripts equal in both scenes; summaries equal in scene 1 and
    differing in scene 0 from step 4, where the reference's top two logits
    tie exactly in bf16 (it takes the lower id, the port the one its own
    rounding puts first)."""
    out, _ = outputs
    system, dag, plan = _min_cost()
    jex = jexecutor.RealExecutor(system.library)
    jout = jex.run(dag, plan, jax_media)
    want = {k: np.asarray(v) for k, v in jout.items() if k != "_timings"}
    got = {k: (v.float() if v.is_floating_point() else v).numpy()
           for k, v in out.items() if k != "_timings"}
    assert set(got) == set(want)
    np.testing.assert_array_equal(_by(got, "frame_extract"),
                                  _by(want, "frame_extract"))

    # object ids: the reference's cosines, top two apart by more than COS_TOL
    frames = _by(want, "frame_extract")
    k_img, k_txt = jax.random.split(jax.random.PRNGKey(1))
    img = frames.reshape(*frames.shape[:2], -1) @ np.asarray(
        jax.random.normal(k_img, (3072, 64)) / 55.4)
    txt = np.asarray(jax.random.normal(k_txt, (16, 64)))
    cos = np.einsum("sfd,ld->sfl", img / np.linalg.norm(img, axis=-1, keepdims=True),
                    txt / np.linalg.norm(txt, axis=-1, keepdims=True))
    top2 = np.sort(cos, -1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > COS_TOL
    assert decided.all()
    np.testing.assert_array_equal(_by(got, "object")[decided],
                                  _by(want, "object")[decided])

    # transcripts: the enc-dec over the tiled audio frames
    stt = jex._sessions["seamless-m4t-large-v2"]
    audio = np.concatenate([np.asarray(m.audio) for m in jax_media], 0)
    reps = -(-stt.model.cfg.d_model // audio.shape[-1])
    jframes = jnp.tile(jnp.asarray(audio), (1, 1, reps))[
        ..., :stt.model.cfg.d_model].astype(jnp.bfloat16)
    bos = jnp.zeros((audio.shape[0], 1), jnp.int32)
    t_got, t_want = _by(got, "speech"), _by(want, "speech")
    flips = _first_flips(t_got, t_want, _margins(
        stt, {"tokens": bos, "frames": jframes}, t_want), TOL)
    print(f"transcripts: first differing step per scene {flips}")

    # summaries: the same prompt where the transcripts and objects agree
    lm = jex._sessions["deepseek-7b"]
    V = lm.model.cfg.vocab_size
    mean = frames.reshape(frames.shape[0], -1).mean(-1) * 1000
    assert (np.abs(mean - np.round(mean)) > 1e-3).all()   # int() decided
    ctx = np.concatenate([_by(want, "object")[:, :8] % V, t_want[:, :8] % V,
                          mean.astype(np.int32)[:, None] % V], 1)
    s_got, s_want = _by(got, "summar"), _by(want, "summar")
    margin = _margins(lm, {"tokens": jnp.asarray(ctx, jnp.int32)}, s_want)
    flips = _first_flips(s_got, s_want, margin, TOL)
    print(f"summaries: first differing step per scene {flips}")

    # embed: the reference's mean of bf16 rows, on the port's summary ids
    emb = lm.params["embed"]
    ref_vecs = np.asarray(jnp.take(emb, jnp.asarray(s_got) % emb.shape[0],
                                   axis=0).mean(1), np.float32)
    np.testing.assert_allclose(_by(got, "embed").astype(np.float32), ref_vecs,
                               atol=2 ** -8, rtol=2 ** -8)


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


def _plan_rows(dag, plan, library):
    return [(tid, dag.nodes[tid].agent, dag.nodes[tid].args, plan[tid].impl,
             library.impls[plan[tid].impl].arch,
             library.interfaces[dag.nodes[tid].agent].produces)
            for tid in dag.topo_order]


def test_chip_smoke_video_workflow_is_the_reference_plan(chip_smoke, media,
                                                         executor, outputs):
    """The video workflow that chip_smoke.py writes out (it may not import
    repro) equals the reference's MIN_COST and baseline plans, and the port
    runs it to the same outputs."""
    system, dag, plan = _min_cost()
    sys_b = Murakkab.paper_cluster()
    dag_b, plan_b = sys_b.lower_imperative(make_baseline_workflow(),
                                           PAPER_VIDEOS[:1])
    for name, want in (("min_cost", (dag, plan, system.library)),
                       ("baseline", (dag_b, plan_b, sys_b.library))):
        assert _plan_rows(*chip_smoke.video_workflow(name)) == _plan_rows(*want)
    hand_dag, hand_plan, hand_library = chip_smoke.video_workflow("min_cost")
    got = executor(hand_library).run(hand_dag, hand_plan, media)
    want, _ = outputs
    for k in want:
        if k != "_timings":
            assert torch.equal(got[k], want[k]), k


def test_seeded_sessions_are_reduced_on_the_cpu():
    """By default the executor's sessions take the reduced configs on the
    CPU (full width is the default on the card, where the reduced head_dim
    16 is below the flash kernel's smallest)."""
    sess = seeded_sessions(0, device="cpu")("deepseek-7b")
    assert sess.model.cfg == get_config("deepseek-7b", reduced=True)
    assert sess.params["embed"].device.type == "cpu"

