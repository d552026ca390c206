"""Port vs reference: the mesh path on several processes.

The reference runs on four host devices in one subprocess
(``tests/_torch_mesh_ref.py``, ``XLA_FLAGS`` set there), the port as four
ranks of a gloo group on a (data 2, model 2) ``DeviceMesh`` in another
(``tests/_torch_mesh_ranks.py``, a ``FileStore`` under the test's temporary
directory, so no port is opened). Both start from the same inputs and run
at the same time, once per session for this file and
``tests/test_torch_tp.py`` (``tests/_torch_mesh_runs.py``); every group and
join has a timeout, so a hang fails the tests instead of the suite.

Held: ``compressed_psum`` against the reference's inside ``shard_map``; the
expert-parallel ``apply_moe`` (reduced deepseek-moe-16b, capacity factor
1.25 with a hot last expert, so that tokens drop per shard; fp32 and bf16;
the default, ``fsdp_experts`` and ``expert_tp`` variants) against the
reference's EP path, forward and gradients; the sharded train step against
the port's local one on the full batch; the sharded serve steps against the
local tokens; a sharded state's checkpoint against the local state's.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ref as ref_side  # noqa: E402
import _torch_mesh_ranks as rank_side  # noqa: E402
from _torch_mesh_runs import RANKS, mesh_runs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

# the MoE layer's tolerance of tests/test_torch_models.py (bf16: its
# DECODE_TOL), elementwise, for outputs and fp32 gradients; bf16 gradients
# by relative norm at the train step tests' GRAD_TOL (tests/test_torch_train.py:
# torch rounds per op, XLA in fused fp32, so a near-zero element of a bf16
# gradient may differ by a few ulps)
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
AUX_RTOL = 1e-6
# the mesh train step against the local one, fp32, relative (loss, grad
# norm, each updated leaf)
TRAIN_RTOL = 1e-5
# with the MoE's aux loss, EP and local differ by design (the EP aux is the
# mean of per-shard values): each leaf is held to the reference's own
# EP-to-local gap on the same state and batches, times this, plus 1e-6
GAP_MULT = 1.05
# serving: fp32 logits of a rank's rows against the whole batch's (another
# summation order; a router near-tie may flip one expert), relative norm
SERVE_LOGIT_RTOL = 1e-3
DATA_ROWS = (0, 2)          # ranks (data 0, model 0) and (data 1, model 0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_compressed_psum_matches_reference(runs):
    """The mean over the group bitwise; the residual g - q*scale within the
    rounding of one product, which the reference's XLA fuses into an FMA."""
    ref = runs["ref"]
    total = np.stack([runs["ranks"][r]["psum/total"] for r in RANKS])
    new_err = np.stack([runs["ranks"][r]["psum/new_err"] for r in RANKS])
    np.testing.assert_array_equal(total, ref["psum/total"])
    g = runs["inputs"]["psum/g"] + runs["inputs"]["psum/err"]
    scale = np.abs(g).max() / 127.0
    np.testing.assert_allclose(new_err, ref["psum/new_err"], rtol=0,
                               atol=2.0 ** -17 * scale)


MOE_CASES = [(d, v) for d in ("float32", "bfloat16") for v in ref_side.MOE_VARIANTS]


def test_moe_shards_drop_tokens(runs):
    """At capacity factor 1.25 with the hot last expert, each data shard's
    32 tokens overflow its capacity, so the EP result is not the local one
    (the reference's own two paths differ the same way)."""
    cfg = ref_side_config()
    x = torch.from_numpy(runs["inputs"]["moe/float32/x"])
    router = torch.from_numpy(runs["inputs"]["moe/float32/params/router"])
    for shard in x.chunk(2):
        idx, _, _ = moe._route(shard, router, cfg)
        C = moe._capacity(shard.shape[0], cfg)
        assert np.bincount(idx.reshape(-1).numpy(),
                           minlength=cfg.moe.num_experts).max() > C
    ref = runs["ref"]
    assert _rel(ref["moe/float32/default/out"], ref["moe/float32/local/out"]) > 1e-3


def ref_side_config():
    cfg = get_config("deepseek-moe-16b", reduced=True)
    return cfg.replace(moe=cfg.moe.__class__(**{**cfg.moe.__dict__,
                                                 "capacity_factor": 1.25}))


def _hold(got, want, dtype, grad=False, what=""):
    if grad and dtype == "bfloat16":
        assert _rel(got, want) <= GRAD_TOL[dtype], (what, _rel(got, want))
    else:
        np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype],
                                   err_msg=what)


@pytest.mark.parametrize("dtype,variant", MOE_CASES)
def test_moe_ep_matches_reference(runs, dtype, variant):
    """Outputs, aux and every gradient of the EP layer against the
    reference's EP path on four host devices; each rank of the model axis
    returns its data shard's rows alike; no gradient is ep x the
    reference's."""
    ref, ranks = runs["ref"], runs["ranks"]
    key = f"moe/{dtype}/{variant}"
    for name in ("out", "grad_x"):
        got = np.concatenate([ranks[r][f"{key}/{name}"] for r in DATA_ROWS])
        _hold(got, ref[f"{key}/{name}"], dtype, grad=name != "out")
        for r in RANKS:           # the model axis' copies agree
            np.testing.assert_array_equal(ranks[r][f"{key}/{name}"],
                                          ranks[r - r % 2][f"{key}/{name}"])
    for r in RANKS:
        np.testing.assert_allclose(float(ranks[r][f"{key}/aux"]),
                                   float(ref[f"{key}/aux"]), rtol=AUX_RTOL)
    grads = [k for k in ref.files if k.startswith(f"{key}/grad/")]
    assert len(grads) == 7
    for k in grads:
        for r in RANKS:           # every rank holds the whole gradient
            _hold(ranks[r][k], ref[k], dtype, grad=True, what=k)
        ratio = np.linalg.norm(ranks[0][k]) / np.linalg.norm(ref[k])
        assert abs(ratio - 1) < 1e-2, (k, ratio)


def _train(runs, case):
    r0 = runs["ranks"][0]
    for r in RANKS:
        assert bool(runs["ranks"][r][f"train/{case}/placed_as_state_shardings"])
        assert int(runs["ranks"][r][f"train/{case}/mesh/step"]) == \
            rank_side.TRAIN_STEPS
    leaves = sorted(k.split("/mesh/params/")[1] for k in r0.files
                    if k.startswith(f"train/{case}/mesh/params/"))
    assert leaves
    return r0, leaves


@pytest.mark.parametrize("case", [c for c in rank_side.TRAIN_ARCHS
                                  if c not in ("deepseek-moe-16b", "deepseek-7b:int8")])
def test_mesh_train_step_matches_local(runs, case):
    """Two sharded steps on the (2, 2) mesh against two local steps on the
    full batch: loss, grad norm and every updated leaf within TRAIN_RTOL;
    deepseek-7b also with two microbatches and int8 moments (their scales
    the whole leaf's absmax). deepseek-moe-16b is held here without its aux
    loss (and with remat), the only term where EP and local differ by
    design (next test); its experts take the EP path, its router its
    gradient through the top-k weights."""
    r0, leaves = _train(runs, case)
    for i in range(rank_side.TRAIN_STEPS):
        for k in ("loss", "grad_norm"):
            got = float(r0[f"train/{case}/mesh/{k}/{i}"])
            want = float(r0[f"train/{case}/local/{k}/{i}"])
            assert abs(got - want) <= TRAIN_RTOL * abs(want), (k, i, got, want)
    for leaf in leaves:
        gap = _rel(r0[f"train/{case}/mesh/params/{leaf}"],
                   r0[f"train/{case}/local/params/{leaf}"])
        assert gap <= TRAIN_RTOL, (leaf, gap)


def test_mesh_train_step_int8_moments_take_the_whole_leafs_scale(runs):
    """int8 moments on the mesh: each leaf's scales are the whole leaf's
    absmax (a shard's own would differ by far more than rounding) and the
    q values the local step's but for ``tests/test_torch_train.py``'s int8
    allowance (off by at most 1 in at most 1e-4 of the elements); loss and
    grad norm at both steps and the params after step 1 within TRAIN_RTOL.
    After step 2 the params are not held: an update reads the moments back
    from int8, where a one-level flip moves an element by a quantization
    step of its moment."""
    case = "deepseek-7b:int8"
    r0, leaves = _train(runs, case)
    for i in range(rank_side.TRAIN_STEPS):
        for k in ("loss", "grad_norm"):
            got = float(r0[f"train/{case}/mesh/{k}/{i}"])
            want = float(r0[f"train/{case}/local/{k}/{i}"])
            assert abs(got - want) <= TRAIN_RTOL * abs(want), (k, i, got, want)
    for leaf in leaves:
        assert _rel(r0[f"train/{case}/mesh/params_step1/{leaf}"],
                    r0[f"train/{case}/local/params_step1/{leaf}"]) <= TRAIN_RTOL, leaf
    n = flips = 0
    for key in [k for k in r0.files if k.startswith(f"train/{case}/mesh/opt/")]:
        got, want = r0[key], r0[key.replace("/mesh/", "/local/")]
        if key.endswith("/scale"):
            assert abs(float(got) - float(want)) <= TRAIN_RTOL * float(want), key
        elif key.endswith("/q"):
            assert np.abs(got - want).max() <= 1, key
            n, flips = n + got.size, flips + int((got != want).sum())
    assert n > 0 and flips <= 1e-4 * n, (flips, n)


def test_mesh_train_step_moe_within_the_reference_gap(runs):
    """deepseek-moe-16b with its aux loss, from the reference's state: the
    EP aux is the mean of per-shard values, so every leaf its gradient
    reaches (the router, and through x every leaf upstream) moves from the
    local step's. Each leaf's gap and the aux's are held to the reference's
    own EP-to-local gap on the same state and batches."""
    case = "deepseek-moe-16b"
    r0, leaves = _train(runs, case)
    ref = runs["ref"]
    for i in range(rank_side.TRAIN_STEPS):
        port_gap = float(r0[f"train/{case}/mesh/aux_loss/{i}"]) - \
            float(r0[f"train/{case}/local/aux_loss/{i}"])
        ref_gap = float(ref[f"train/mesh/aux_loss/{i}"]) - \
            float(ref[f"train/local/aux_loss/{i}"])
        assert ref_gap > 0 and abs(port_gap - ref_gap) <= 1e-4 * ref_gap
        for k in ("loss", "grad_norm"):
            port = abs(float(r0[f"train/{case}/mesh/{k}/{i}"]) -
                       float(r0[f"train/{case}/local/{k}/{i}"]))
            refg = abs(float(ref[f"train/mesh/{k}/{i}"]) -
                       float(ref[f"train/local/{k}/{i}"]))
            want = abs(float(ref[f"train/local/{k}/{i}"]))
            assert port <= GAP_MULT * refg + TRAIN_RTOL * want, (k, i, port, refg)
    gaps = {}
    for leaf in leaves:
        port = _rel(r0[f"train/{case}/mesh/params/{leaf}"],
                    r0[f"train/{case}/local/params/{leaf}"])
        refg = _rel(ref[f"train/mesh/params/{leaf}"],
                    ref[f"train/local/params/{leaf}"])
        gaps[leaf] = (port, refg)
        assert port <= GAP_MULT * refg + 1e-6, (leaf, port, refg)
    # the router moves most, as in the reference
    assert max(gaps, key=lambda k: gaps[k][0]) == "groups/g1/b1/moe/router"


def test_sharded_checkpoint_is_the_local_format(runs):
    """The sharded state's checkpoint (full tensors, written by one rank)
    equals the unsharded state's file for file, byte for byte; a sharded
    checkpoint restores into the mesh's shards bitwise."""
    mesh_dir = runs["ckpt"] / "mesh" / "step_00000000"
    local_dir = runs["ckpt"] / "local" / "step_00000000"
    names = sorted(p.name for p in local_dir.iterdir())
    assert names == sorted(p.name for p in mesh_dir.iterdir())
    assert "manifest.json" in names
    for name in names:
        assert (mesh_dir / name).read_bytes() == (local_dir / name).read_bytes(), name
    leaves = json.loads((local_dir / "manifest.json").read_text())["leaves"]
    assert "state/opt/count" in leaves and "state/params/embed" in leaves
    for r in RANKS:
        assert bool(runs["ranks"][r]["ckpt/restored_bitwise"])


@pytest.mark.parametrize("arch", rank_side.SERVE_ARCHS)
def test_mesh_serve_gives_the_local_tokens(runs, arch):
    """A sharded prefill and four decode steps (params on SERVING_RULES,
    batch over data, deepseek-moe-16b's experts EP over model): every rank
    returns the whole batch's tokens, equal to the local path's."""
    r0 = runs["ranks"][0]
    want = r0[f"serve/{arch}/local/tokens"]
    assert want.shape == (rank_side.SERVE_BATCH, rank_side.SERVE_NEW)
    for r in RANKS:
        np.testing.assert_array_equal(runs["ranks"][r][f"serve/{arch}/mesh/tokens"],
                                      want)
    assert _rel(r0[f"serve/{arch}/mesh/logits"],
                r0[f"serve/{arch}/local/logits"]) <= SERVE_LOGIT_RTOL
