"""Port vs reference: the mesh path's rules and plans, with no process.

The rule tables; every parameter and cache leaf's mesh assignment for the
ten architectures at their published widths, under both rule tables, on the
production meshes and three small ones (the reference's ``spec_for_axes``
takes a stand-in mesh: only its axis names and device-array shape are
read); ``abstract_params``; the DTensor placements of an assignment;
``plan_remesh``; the int8 compression's functions; ``make_dist`` and the
options dataclasses.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro.runtime.fault_tolerance import plan_remesh as jplan_remesh  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.runtime import serve, train  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime.fault_tolerance import plan_remesh  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
# the decode cache the assignments are read on: a serving batch, a context
# the sequence axis splits, and the encoder-decoder's frames of that length
CACHE_BATCH, CACHE_LEN = 32, 4096


def _meshes(name):
    shape, names = MESHES[name]
    return (shd.MeshShape(names, shape),
            SimpleNamespace(axis_names=names, devices=np.empty(shape, object)))


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(a, (str, type(None))) for a in x))
    return {tuple(k.key for k in path): leaf for path, leaf in flat}


def _port_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, prefix + (k,)))
        return out
    return {prefix: tree}


def test_rule_tables_are_the_references():
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert shd.SERVING_RULES == jshd.SERVING_RULES
    assert shd.PRIORITY == jshd.PRIORITY


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_is_assigned_as_the_reference_assigns_it(arch, mesh):
    """Every parameter leaf (``abstract()`` / ``axes()``) and every decode
    cache leaf, under DEFAULT_RULES and SERVING_RULES: the same assignment
    per dimension, including the divisibility fallback and no mesh axis
    claimed twice."""
    jm, tm = jax_build_model(jax_get_config(arch)), build_model(get_config(arch))
    port_mesh, ref_mesh = _meshes(mesh)
    j_axes, t_axes = _jax_leaves(jm.axes()), _port_leaves(tm.axes())
    j_abs, t_abs = _port_leaves(jm.abstract()), _port_leaves(tm.abstract())
    assert set(j_axes) == set(t_axes) == set(t_abs)
    enc_len = tm.enc_len_for(CACHE_LEN)
    j_cache = jserve.abstract_cache(jm, CACHE_BATCH, CACHE_LEN, enc_len=enc_len)
    t_cache = serve.abstract_cache(tm, CACHE_BATCH, CACHE_LEN, enc_len)
    j_cax = _jax_leaves(jshd.cache_logical_axes(j_cache))
    t_cax = _port_leaves(shd.cache_logical_axes(t_cache))
    assert j_cax == t_cax
    t_cabs = _port_leaves(t_cache)
    for rules in (None, shd.SERVING_RULES):
        got = _port_leaves(shd.tree_shardings(tm.axes(), tm.abstract(),
                                              port_mesh, rules))
        for path, axes in t_axes.items():
            assert axes == j_axes[path], path
            want = tuple(jshd.spec_for_axes(axes, j_abs[path].shape, ref_mesh,
                                            rules))
            assert got[path] == want, (path, got[path], want)
        got = _port_leaves(serve.cache_shardings(tm, t_cache, port_mesh, rules))
        for path, axes in t_cax.items():
            want = tuple(jshd.spec_for_axes(axes, t_cabs[path].shape, ref_mesh,
                                            rules))
            assert got[path] == want, (path, got[path], want)
        assert tuple(shd.data_spec((CACHE_BATCH, 16), port_mesh)) == \
            tuple(jshd.data_spec((CACHE_BATCH, 16), ref_mesh))
    assert shd.batch_axes(port_mesh) == jshd.batch_axes(ref_mesh)
    assert shd.mesh_axis_size(port_mesh, "model") == \
        jshd.mesh_axis_size(ref_mesh, "model")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_are_the_references(arch):
    """Meta tensors of the reference's shapes and dtypes; nothing is
    allocated."""
    j_abs = _port_leaves(jax_build_model(jax_get_config(arch)).abstract())
    t_abs = _port_leaves(build_model(get_config(arch)).abstract())
    assert set(j_abs) == set(t_abs)
    for path, t in t_abs.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j_abs[path].shape), path
        assert str(t.dtype).removeprefix("torch.") == str(j_abs[path].dtype), path


def test_abstract_train_state_is_the_references():
    model = build_model(get_config("deepseek-moe-16b"))
    jm = jax_build_model(jax_get_config("deepseek-moe-16b"))
    for moments in ("float32", "int8"):
        opts = train.TrainOptions(opt=train.adamw.AdamWConfig(moment_dtype=moments))
        jopts = jtrain.TrainOptions(opt=jtrain.adamw.AdamWConfig(moment_dtype=moments))
        got = _port_leaves(train.abstract_train_state(model, opts))
        want = _port_leaves(jtrain.abstract_train_state(jm, jopts))
        assert set(got) == set(want)
        for path, t in got.items():
            assert tuple(t.shape) == tuple(want[path].shape), path
            assert str(t.dtype).removeprefix("torch.") == str(want[path].dtype), path


def test_state_shardings_are_the_references():
    """Moments inherit their params' assignments; int8 scales, ``count`` and
    ``step`` are replicated."""
    port_mesh, ref_mesh = _meshes("2x4")
    model = build_model(get_config("deepseek-moe-16b"))
    axes = _port_leaves(model.axes())
    for moments in ("bfloat16", "int8"):
        opts = train.TrainOptions(opt=train.adamw.AdamWConfig(moment_dtype=moments))
        got = _port_leaves(train.state_shardings(model, port_mesh, opts))
        for path, spec in got.items():
            kind, leaf = path[0], path[-1]
            if kind == "step" or leaf in ("count", "scale"):
                assert spec == (), path
                continue
            core = path[1:] if kind == "params" else \
                path[2:-1] if moments == "int8" else path[2:]
            shape = _port_leaves(model.abstract())[core].shape
            assert spec == tuple(jshd.spec_for_axes(axes[core], shape, ref_mesh)), path


def test_placements_of_an_assignment():
    from torch.distributed.tensor import Replicate, Shard
    mesh = shd.MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert shd.placements((("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert shd.placements((None, "data"), mesh) == \
        [Replicate(), Shard(1), Replicate()]
    assert shd.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="axis order"):
        shd.placements((("data", "pod"),), mesh)


def test_production_mesh_shapes_are_the_references():
    assert launch_mesh.production_mesh_shape() == \
        shd.MeshShape(("data", "model"), (16, 16))
    assert launch_mesh.production_mesh_shape(multi_pod=True) == \
        shd.MeshShape(("pod", "data", "model"), (2, 16, 16))


REMESH_GRID = [((2, 16, 16), ("pod", "data", "model")),
               ((1, 2, 16), ("pod", "data", "model")),
               ((16, 16), ("data", "model")),
               ((4, 2), ("data", "model")),
               ((8,), ("model",))]


@pytest.mark.parametrize("shape,names", REMESH_GRID)
def test_plan_remesh_is_the_references(shape, names):
    """Every count of devices left, from one to all of them (the reference
    test's property over (2, 16, 16), exhaustively), with its min_model."""
    total = int(np.prod(shape))
    for avail in range(1, total + 1):
        for min_model in (1, 4):
            got = plan_remesh(shape, names, avail, min_model=min_model)
            want = jplan_remesh(shape, names, avail, min_model=min_model)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), avail
    plan = plan_remesh((2, 16, 16), ("pod", "data", "model"), 256)
    assert plan.new_shape == (1, 16, 16) and plan.resharded_axes == ("pod",)


@pytest.mark.parametrize("shape,scale", [((257,), 1.0), ((16, 33), 1e-3),
                                         ((4, 8, 8), 50.0), ((3,), 0.0)])
def test_compression_is_bitwise_the_references(shape, scale):
    rng = np.random.default_rng(sum(shape))
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    err = (rng.standard_normal(shape) * 1e-3 * scale).astype(np.float32)
    q, s, new_err = compression.compress(torch.from_numpy(g), torch.from_numpy(err))
    jq, js, jnew = jcompression.compress(jnp.asarray(g), jnp.asarray(err))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(jnew))
    np.testing.assert_array_equal(compression.decompress(q, s).numpy(),
                                  np.asarray(jcompression.decompress(jq, js)))
    tree = {"a": torch.from_numpy(g), "b": {"c": torch.zeros(5)}}
    jtree = {"a": jnp.asarray(g), "b": {"c": jnp.zeros(5)}}
    assert compression.compression_ratio(tree) == \
        jcompression.compression_ratio(jtree)
    errs = compression.init_error_state(tree)
    assert errs["b"]["c"].dtype == torch.float32 and errs["a"].shape == shape


def _fields(dc) -> dict:
    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)
            if f.name != "mesh"}


def test_make_dist_is_the_references():
    port_mesh, ref_mesh = _meshes("2x16x16")
    got = train.make_dist(port_mesh, train.TrainOptions())
    want = jtrain.make_dist(ref_mesh, jtrain.TrainOptions())
    assert got.mesh is port_mesh and want.mesh is ref_mesh
    assert _fields(got) == _fields(want)
    so = dict(expert_tp=True, moe_capacity_cap=8)
    assert _fields(serve.make_dist(port_mesh, serve.ServeOptions(**so))) == \
        _fields(jserve.make_dist(ref_mesh, jserve.ServeOptions(**so)))
    assert train.make_dist(None, train.TrainOptions()).mesh is None


def test_serve_options_are_the_references():
    got = {f.name: f.default for f in dataclasses.fields(serve.ServeOptions)}
    want = {f.name: f.default for f in dataclasses.fields(jserve.ServeOptions)}
    assert got == want
