"""The reference's side of ``tests/test_torch_mesh.py``: the JAX package's
mesh path on four host devices, written to one ``.npz`` for the tests to
compare with the port's ranks (``tests/_torch_mesh_ranks.py``), which start
from the same INPUTS (``make_inputs``).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_torch_mesh_ref.py INPUTS.npz OUT.npz

- ``compressed_psum`` inside ``shard_map`` over a 4-device ``data`` axis;
- ``apply_moe`` on a (data 2, model 2) mesh, reduced deepseek-moe-16b at
  capacity factor 1.25 with a hot last expert (tokens dropped per shard),
  in fp32 and bf16, on the default, ``fsdp_experts`` and ``expert_tp``
  variants: outputs, aux and ``jax.grad`` of a seeded linear loss, and the
  local path's on the same inputs (the reference's own EP-to-local gap);
- two reference train steps of reduced deepseek-moe-16b in fp32 at its
  drop-free capacity, on that mesh and on one device, from the state INPUTS
  holds: the EP-to-local gap of every leaf and of the aux loss.

Every array is stored under a ``/``-joined key; bf16 goes as fp32 (exact).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro.configs.registry import get_config
from repro.data import pipeline
from repro.launch.mesh import make_mesh
from repro.models import common, moe
from repro.models.model_zoo import build_model
from repro.optim import adamw, compression
from repro.runtime import train

MOE_T = 64                    # tokens of the MoE layer test: 32 per data shard
MOE_VARIANTS = {"default": {}, "fsdp_experts": {"fsdp_experts": True},
                "expert_tp": {"expert_tp": True}}
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 2, 4, 16


def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join([prefix, *(p.key for p in path)])
        out[key] = np.asarray(jnp.asarray(leaf, jnp.float32))
    return out


def moe_config():
    cfg = get_config("deepseek-moe-16b", reduced=True)
    return cfg.replace(moe=cfg.moe.__class__(**{**cfg.moe.__dict__,
                                                 "capacity_factor": 1.25}))


def train_config():
    return get_config("deepseek-moe-16b", reduced=True).replace(
        param_dtype="float32", activ_dtype="float32")


def make_inputs() -> dict:
    """What both sides start from: per dtype the MoE layer's params (fp32
    router, experts in the dtype, the router's last expert hot), x (T, d)
    with x[:, 0] = 3, and the loss's cotangent; the rows of the compressed
    all-reduce; the train state's params."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        p = common.init_params(moe.moe_specs(moe_config()),
                               jax.random.PRNGKey(0), jnp.dtype(dtype))
        p["router"] = p["router"].at[0, -1].set(2.0)
        out.update(flat(p, f"moe/{dtype}/params"))
        rng = np.random.default_rng(1)
        x = rng.standard_normal((MOE_T, moe_config().d_model)).astype(np.float32)
        x[:, 0] = 3.0
        out[f"moe/{dtype}/x"] = x
        out[f"moe/{dtype}/cot"] = rng.standard_normal(x.shape).astype(np.float32)
    rng = np.random.default_rng(2)
    out["psum/g"] = rng.standard_normal((4, 257)).astype(np.float32) * \
        np.array([1, 3, 0.5, 7], np.float32)[:, None]
    out["psum/err"] = rng.standard_normal((4, 257)).astype(np.float32) * 1e-3
    model = build_model(train_config())
    out.update(flat(model.init(jax.random.PRNGKey(0)), "train/init"))
    return out


def tree_from(inputs, prefix, dtype=None):
    """The nested dict of INPUTS' arrays under ``prefix`` (experts cast to
    ``dtype``; the router stays fp32)."""
    tree = {}
    for key in inputs.files:
        if key.startswith(prefix + "/"):
            node, path = tree, key[len(prefix) + 1:].split("/")
            for k in path[:-1]:
                node = node.setdefault(k, {})
            a = jnp.asarray(inputs[key])
            node[path[-1]] = a if dtype is None or path[-1] == "router" \
                else a.astype(dtype)
    return tree


def moe_case(mesh, inputs, dtype, variant, out):
    cfg = moe_config()
    dt = jnp.dtype(dtype)
    p = tree_from(inputs, f"moe/{dtype}/params", dt)
    cot = inputs[f"moe/{dtype}/cot"]
    xs = jnp.asarray(inputs[f"moe/{dtype}/x"]).astype(dt)[None]

    def run(dist):
        def loss(p, xs):
            y, aux = moe.apply_moe(p, xs, cfg=cfg, dist=dist)
            return jnp.sum(y.astype(jnp.float32)[0] * cot) + aux, (y, aux)
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, xs)
        return y, aux, gp, gx

    dist = moe.DistContext(mesh=mesh, data_axes=("data",), model_axis="model",
                           **MOE_VARIANTS[variant])
    for name, d in (("ep", dist), ("local", moe.LOCAL)):
        if name == "local" and variant != "default":
            continue
        y, aux, gp, gx = run(d)
        key = f"moe/{dtype}/{variant if name == 'ep' else 'local'}"
        out[f"{key}/out"] = np.asarray(y.astype(jnp.float32))[0]
        out[f"{key}/aux"] = np.asarray(aux, np.float32)
        out[f"{key}/grad_x"] = np.asarray(gx.astype(jnp.float32))[0]
        out.update(flat(gp, f"{key}/grad"))


def train_gap(mesh, inputs, out):
    """Two steps of the reference's train step on the mesh and on one
    device, from INPUTS' state: every leaf's and the aux loss's gap."""
    cfg = train_config()
    model = build_model(cfg)
    opts = train.TrainOptions(remat_policy=None, warmup_steps=1, total_steps=10)
    params = tree_from(inputs, "train/init")
    state = {"params": params, "opt": adamw.init_opt_state(params, opts.opt),
             "step": jnp.zeros((), jnp.int32)}
    dc = pipeline.DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    batches = [pipeline.batch_for_step(dc, i, cfg) for i in range(TRAIN_STEPS)]
    b_abs = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                         batches[0])
    with (jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh):
        mesh_step = train.jit_train_step(model, opts, mesh, b_abs)
        st_sh = train.state_shardings(model, mesh, opts)
        # the local run first: the mesh step donates its state
        runs = {"local": (jax.jit(train.build_train_step(model, opts)),
                          lambda: state),
                "mesh": (mesh_step, lambda: jax.device_put(state, st_sh))}
        for name, (step, init) in runs.items():
            st = init()
            for i, b in enumerate(batches):
                if name == "mesh":
                    b = jax.device_put(b, train.batch_shardings(b_abs, mesh))
                st, met = step(st, b)
                for k in ("loss", "grad_norm", "aux_loss"):
                    out[f"train/{name}/{k}/{i}"] = np.asarray(met[k])
            out.update(flat(st["params"], f"train/{name}/params"))


def psum_case(inputs, out):
    mesh = make_mesh((4,), ("data",))
    g, err = inputs["psum/g"], inputs["psum/err"]
    fn = moe._shard_map(
        lambda g, e: compression.compressed_psum(g[0], e[0], "data"),
        mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")))
    # shard_map's body sees (1, 257) per shard and returns (257,) pieces,
    # concatenated along the data axis
    total, new_err = jax.jit(fn)(jnp.asarray(g), jnp.asarray(err))
    out["psum/total"] = np.asarray(total).reshape(4, 257)
    out["psum/new_err"] = np.asarray(new_err).reshape(4, 257)


def main(inputs_path, path):
    assert jax.device_count() == 4, jax.devices()
    inputs = np.load(inputs_path)
    out = {}
    psum_case(inputs, out)
    mesh = make_mesh((2, 2), ("data", "model"))
    for dtype in ("float32", "bfloat16"):
        for variant in MOE_VARIANTS:
            moe_case(mesh, inputs, dtype, variant, out)
    train_gap(mesh, inputs, out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
