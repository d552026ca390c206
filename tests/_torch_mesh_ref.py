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
  holds: the EP-to-local gap of every leaf and of the aux loss;
- tensor parallelism (``tests/test_torch_tp.py``): for each of
  ``_torch_mesh_ranks.TP_CASES`` on the (1, 4) and (2, 2) meshes, the
  reference's ``jit_prefill_step`` and greedy ``jit_decode_step`` steps
  (tokens and logits; the cache's conv leaves after each), and two ``jit_train_step`` steps (loss, grad norm,
  the params after step 1) on the case's ``TP_REF_TRAIN_MESH``, from the
  weights, prompts and frames INPUTS holds.

Every array is stored under a ``/``-joined key; bf16 goes as fp32 (exact).
"""
import sys

import _torch_mesh_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro.configs.registry import get_config
from repro.data import pipeline
from repro.launch.mesh import make_mesh
from repro.models import common, moe, transformer
from repro.models.model_zoo import build_model
from repro.optim import adamw, compression
from repro.runtime import serve, train

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


def _torch_flat(tree, prefix):
    from repro_torch.tree import leaves_with_path
    for path, leaf in leaves_with_path(tree):
        yield "/".join([prefix, *path]), leaf


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
    import torch
    from repro_torch.models.model_zoo import build_model as torch_model
    for i, case in enumerate(ranks.TP_CASES):
        # drawn by the port's init (the reference's kinds and scales; one
        # jax.random init a case costs seconds of compiles)
        cfg = ranks.tp_config(case)
        params = torch_model(cfg).init(torch.Generator().manual_seed(10 + i))
        out.update({k: v.numpy() for k, v in _torch_flat(params,
                                                         f"tp/{case}/params")})
        rng = np.random.default_rng(10 + i)
        out[f"tp/{case}/prompts"] = rng.integers(
            0, cfg.vocab_size, (ranks.TP_BATCH, ranks.TP_PROMPT)).astype(np.int32)
        if cfg.family == "encdec":
            out[f"tp/{case}/frames"] = rng.standard_normal(
                (ranks.TP_BATCH, ranks.TP_PROMPT, cfg.d_model)).astype(np.float32)
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


def params_from(model, inputs, prefix):
    """The model's params tree (a block without weights an empty dict)
    from INPUTS' arrays under ``prefix``."""
    def fill(meta, path):
        if isinstance(meta, dict):
            return {k: fill(v, path + (k,)) for k, v in meta.items()}
        return jnp.asarray(inputs["/".join((prefix,) + path)])
    return fill(model.abstract(), ())


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


def tp_serve(mesh, name, inputs, case, out):
    """The reference's prefill and greedy decode steps on ``mesh``."""
    cfg = ranks.tp_config_of(get_config, case)
    model = build_model(cfg)
    params = params_from(model, inputs, f"tp/{case}/params")
    prompts = jnp.asarray(inputs[f"tp/{case}/prompts"])
    extras = {k: jnp.asarray(inputs[f"tp/{case}/{k}"])
              for k in ("frames",) if f"tp/{case}/{k}" in inputs.files}
    B, P = prompts.shape
    max_len = P + ranks.TP_NEW
    opts = serve.ServeOptions()
    prefill, _ = serve.jit_prefill_step(model, opts, mesh, B, P)
    decode, _ = serve.jit_decode_step(model, opts, mesh, B, max_len,
                                      enc_len=model.enc_len_for(P))
    cache = transformer.init_cache(cfg, B, max_len,
                                   enc_len=model.enc_len_for(P),
                                   kv_dtype=jnp.dtype(ranks.TP_KV_DTYPE))
    cache = jax.device_put(cache, serve.cache_shardings(
        model, jax.eval_shape(lambda: cache), mesh))
    key = f"tp/{case}/serve/{name}"
    last, cache = prefill(params, {"tokens": prompts, **extras}, cache)
    conv_leaves(cache, out, f"{key}/conv/0")
    tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
    toks, logits = [tok], [last]
    for i, idx in enumerate(range(P, P + ranks.TP_NEW - 1)):
        tok, last, cache = decode(params, cache, tok, jnp.int32(idx))
        toks.append(tok)
        logits.append(last)
        conv_leaves(cache, out, f"{key}/conv/{i + 1}")
    out[f"{key}/tokens"] = np.asarray(jnp.concatenate(toks, 1))
    out[f"{key}/logits"] = np.asarray(jnp.stack(logits), np.float32)


def conv_leaves(cache, out, prefix):
    """The cache's conv leaves (the Mamba2 blocks' windows), whole."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        if path[-1].key == "conv":
            key = "/".join([prefix, *(p.key for p in path)])
            out[key] = np.asarray(jnp.asarray(leaf, jnp.float32))


def tp_train(mesh, name, inputs, case, out):
    """Two of the reference's train steps on ``mesh`` from INPUTS' weights."""
    cfg = ranks.tp_config_of(get_config, case)
    model = build_model(cfg)
    opts = train.TrainOptions(
        remat_policy="full" if case in ranks.TP_REMAT else None,
        warmup_steps=1, total_steps=10)
    params = params_from(model, inputs, f"tp/{case}/params")
    state = {"params": params, "opt": adamw.init_opt_state(params, opts.opt),
             "step": jnp.zeros((), jnp.int32)}
    dc = pipeline.DataConfig(cfg.vocab_size, ranks.TRAIN_SEQ, ranks.TRAIN_BATCH)
    batches = [pipeline.batch_for_step(dc, i, cfg)
               for i in range(ranks.TRAIN_STEPS)]
    b_abs = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                         batches[0])
    key = f"tp/{case}/train/{name}"
    step = train.jit_train_step(model, opts, mesh, b_abs)
    st = jax.device_put(state, train.state_shardings(model, mesh, opts))
    for i, b in enumerate(batches):
        st, met = step(st, jax.device_put(b, train.batch_shardings(b_abs, mesh)))
        if i == 0:
            out.update(flat(st["params"], f"{key}/params_step1"))
        for k in ("loss", "grad_norm"):
            out[f"{key}/{k}/{i}"] = np.asarray(met[k])


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
    for shape in ranks.TP_MESHES:
        tp_mesh = make_mesh(shape, ("data", "model"))
        name = ranks.tp_mesh_name(shape)
        with (jax.set_mesh(tp_mesh) if hasattr(jax, "set_mesh") else tp_mesh):
            for case in ranks.TP_CASES:
                tp_serve(tp_mesh, name, inputs, case, out)
                if ranks.TP_REF_TRAIN_MESH[case] == shape:
                    tp_train(tp_mesh, name, inputs, case, out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
