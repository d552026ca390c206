"""Port vs reference: the mesh path on a multi-pod mesh, (pod 2, data 2,
model 2), where the batch is split jointly over (pod, data), pod-major.

The reference runs on eight host devices in one subprocess
(``tests/_torch_pod_ref.py``), the port as eight ranks of a gloo group in
another (``tests/_torch_pod_ranks.py``, a ``FileStore`` under the test's
temporary directory), from the same inputs, once per session
(``tests/_torch_mesh_runs.py``); every group and join has a timeout.

Held against the reference on the same mesh: the expert-parallel
``apply_moe`` over ``data_axes=("pod", "data")`` (three variants, two
dtypes; the expert weights' use blocks split jointly over (pod, data) where
the store splits ``expert_mlp`` over ``data`` alone); two ``jit_train_step``
steps of reduced deepseek-moe-16b and deepseek-7b (a leaf the pod axis
replicates takes its gradient summed over pod); where each rank stores its
block of every param; the sharded checkpoint; the serve steps' tokens.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_pod_ranks as rank_side  # noqa: E402
from _torch_mesh_runs import POD_RANKS, pod_runs  # noqa: E402
from test_torch_mesh import (GAP_MULT, MOE_CASES, TRAIN_RTOL, _hold,  # noqa: E402
                             _rel, AUX_RTOL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return pod_runs(tmp_path_factory)


def _coord(runs, r) -> tuple:
    return tuple(int(c) for c in runs["ranks"][r]["coordinate"])


def _batch_rows(runs) -> list:
    """The ranks of model coordinate 0, in the batch's (pod, data) order."""
    return sorted((r for r in POD_RANKS if _coord(runs, r)[2] == 0),
                  key=lambda r: _coord(runs, r))


def test_the_mesh_is_pod_major(runs):
    """Rank r sits at (pod, data, model) = r's digits in base 2, as the
    reference's devices do on its mesh."""
    assert [_coord(runs, r) for r in POD_RANKS] == \
        [tuple(int(b) for b in f"{r:03b}") for r in POD_RANKS]


@pytest.mark.parametrize("dtype,variant", MOE_CASES)
def test_pod_moe_matches_reference(runs, dtype, variant):
    """Outputs, aux and every gradient of the EP layer with its batch over
    (pod, data) against the reference's on eight host devices, at the
    limits of ``test_torch_mesh.py::test_moe_ep_matches_reference``; each
    batch shard overflows its capacity, so EP is not the local path."""
    ref, ranks = runs["ref"], runs["ranks"]
    key = f"moe/{dtype}/{variant}"
    rows = _batch_rows(runs)
    for name in ("out", "grad_x"):
        got = np.concatenate([ranks[r][f"{key}/{name}"] for r in rows])
        _hold(got, ref[f"{key}/{name}"], dtype, grad=name != "out")
        for r in POD_RANKS:        # the model axis' copies agree
            np.testing.assert_array_equal(ranks[r][f"{key}/{name}"],
                                          ranks[r - r % 2][f"{key}/{name}"])
    for r in POD_RANKS:
        np.testing.assert_allclose(float(ranks[r][f"{key}/aux"]),
                                   float(ref[f"{key}/aux"]), rtol=AUX_RTOL)
    grads = [k for k in ref.files if k.startswith(f"{key}/grad/")]
    assert len(grads) == 7
    for k in grads:
        for r in POD_RANKS:       # every rank holds the whole gradient
            _hold(ranks[r][k], ref[k], dtype, grad=True, what=k)
    local = f"moe/{dtype}/local/out"
    assert _rel(ref[f"{key}/out"], ref[local]) > 1e-3


@pytest.mark.parametrize("case", rank_side.TRAIN_CASES)
def test_pod_train_steps_match_reference(runs, case):
    """Two mesh steps from one state against the reference's
    ``jit_train_step`` on the same mesh: loss, grad norm, aux and every
    leaf after each step within TRAIN_RTOL; and the port's own mesh-to-local
    gap within the reference's, at the limits of
    ``test_torch_mesh.py::test_mesh_train_step_moe_within_the_reference_gap``
    (with the MoE's aux loss the EP aux is the mean of per-shard values)."""
    ref, r0 = runs["ref"], runs["ranks"][0]
    for i in range(rank_side.TRAIN_STEPS):
        for k in ("loss", "grad_norm", "aux_loss"):
            got = float(r0[f"{case}/mesh/{k}/{i}"])
            want = float(ref[f"{case}/mesh/{k}/{i}"])
            assert abs(got - want) <= TRAIN_RTOL * abs(want), (k, i, got, want)
            port = abs(got - float(r0[f"{case}/local/{k}/{i}"]))
            refg = abs(want - float(ref[f"{case}/local/{k}/{i}"]))
            assert port <= GAP_MULT * refg + TRAIN_RTOL * abs(want), (k, i)
        leaves = [k.split(f"/mesh/params/{i}/")[1] for k in r0.files
                  if k.startswith(f"{case}/mesh/params/{i}/")]
        assert len(leaves) == len([k for k in ref.files
                                   if k.startswith(f"{case}/mesh/params/{i}/")])
        for leaf in leaves:
            got = r0[f"{case}/mesh/params/{i}/{leaf}"]
            want = ref[f"{case}/mesh/params/{i}/{leaf}"]
            assert _rel(got, want) <= TRAIN_RTOL, (i, leaf, _rel(got, want))
            port = _rel(got, r0[f"{case}/local/params/{i}/{leaf}"])
            refg = _rel(want, ref[f"{case}/local/params/{i}/{leaf}"])
            assert port <= GAP_MULT * refg + 1e-6, (i, leaf, port, refg)
    if case == "deepseek-moe-16b":        # the EP aux differs from the local
        gap = float(ref[f"{case}/mesh/aux_loss/0"]) - \
            float(ref[f"{case}/local/aux_loss/0"])
        assert gap > 0


@pytest.mark.parametrize("case", rank_side.TRAIN_CASES)
def test_pod_stored_shards_are_the_references_blocks(runs, case):
    """Each rank stores, as ``state_shardings`` places it, the block of
    every param that the reference's sharding gives the device at the
    rank's mesh coordinate (a dim split over (pod, data) read pod-major)."""
    inputs = runs["inputs"]
    prefix = f"{case}/params/"
    leaves = [k[len(prefix):] for k in inputs.files if k.startswith(prefix)]
    assert leaves
    split = 0
    for r in POD_RANKS:
        ranks = runs["ranks"][r]
        assert bool(ranks[f"{case}/placed_as_state_shardings"])
        coord = "_".join(map(str, _coord(runs, r)))
        for leaf in leaves:
            bounds = runs["ref"][f"{case}/blocks/{leaf}/{coord}"]
            full = inputs[prefix + leaf]
            block = full[tuple(slice(a, b) for a, b in bounds)]
            np.testing.assert_array_equal(ranks[f"{case}/stored/{leaf}"], block,
                                          err_msg=f"{leaf} at {coord}")
            split += block.size < full.size
    assert split


def test_pod_sharded_checkpoint_is_the_local_format(runs):
    """The eight ranks' checkpoint of deepseek-moe-16b's sharded state
    equals the unsharded state's file for file, byte for byte; a sharded
    checkpoint restores into the mesh's shards bitwise, placed as saved."""
    mesh_dir = runs["ckpt"] / "mesh" / "step_00000000"
    local_dir = runs["ckpt"] / "local" / "step_00000000"
    names = sorted(p.name for p in local_dir.iterdir())
    assert names == sorted(p.name for p in mesh_dir.iterdir())
    assert "manifest.json" in names
    for name in names:
        assert (mesh_dir / name).read_bytes() == (local_dir / name).read_bytes(), name
    leaves = json.loads((local_dir / "manifest.json").read_text())["leaves"]
    assert "state/params/groups/g1/b1/moe/w_gate" in leaves
    for r in POD_RANKS:
        assert bool(runs["ranks"][r]["ckpt/restored_bitwise"])
        assert bool(runs["ranks"][r]["ckpt/restored_placed"])


def test_pod_serve_tokens_match_reference_and_local(runs):
    """``jit_prefill_step`` and four greedy ``jit_decode_step`` steps of
    reduced deepseek-moe-16b with the serving rules (experts EP over model,
    gathered over data; the batch over (pod, data)): every rank's tokens
    equal the local path's and the reference's jit steps' on the mesh."""
    want = runs["ref"]["serve/mesh/tokens"]
    assert want.shape == (rank_side.SERVE_BATCH, rank_side.SERVE_NEW)
    np.testing.assert_array_equal(runs["ranks"][0]["serve/local/tokens"], want)
    for r in POD_RANKS:
        np.testing.assert_array_equal(runs["ranks"][r]["serve/mesh/tokens"], want)
