"""The reference's side of ``tests/test_torch_pod.py``: the JAX package's
mesh path on eight host devices, a (pod 2, data 2, model 2) mesh, written
to one ``.npz`` for the tests to compare with the port's eight ranks
(``tests/_torch_pod_ranks.py``), which start from the same INPUTS
(``make_inputs``).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_torch_pod_ref.py INPUTS.npz OUT.npz

- ``apply_moe`` with ``data_axes=("pod", "data")``, reduced deepseek-moe-16b
  at capacity factor 1.25 with a hot last expert, in fp32 and bf16, on the
  default, ``fsdp_experts`` and ``expert_tp`` variants: outputs, aux and
  ``jax.grad`` of a seeded linear loss, and the local path's (the
  reference's own EP-to-local gap);
- two ``jit_train_step`` steps of reduced deepseek-moe-16b (drop-free
  capacity, ``fsdp_experts``) and of reduced deepseek-7b, in fp32, on the
  mesh and on one device, from the weights INPUTS holds: loss, grad norm,
  aux, the params after each step; and where ``state_shardings`` puts each
  param's block, by mesh coordinate;
- ``jit_prefill_step`` and greedy ``jit_decode_step`` steps of reduced
  deepseek-moe-16b in fp32 (the train case's weights) on the mesh with the
  serving rules: the tokens.

Every array is stored under a ``/``-joined key; bf16 goes as fp32 (exact).
"""
import sys

import _torch_mesh_ref as mesh_ref
import _torch_pod_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import get_config
from repro.data import pipeline
from repro.launch.mesh import make_mesh
from repro.models import transformer
from repro.models.model_zoo import build_model
from repro.optim import adamw
from repro.runtime import serve, train
from repro.runtime import sharding as shd


def make_inputs() -> dict:
    """What both sides start from: the MoE layer's cases (as the (2, 2)
    mesh's), and per train or serve case the weights, drawn by the port's
    init from a seed (the reference's kinds and scales)."""
    import torch
    from repro_torch.models.model_zoo import build_model as torch_model
    out = _moe_inputs()
    for i, case in enumerate(ranks.TRAIN_CASES):
        params = torch_model(ranks.case_config(case)).init(
            torch.Generator().manual_seed(20 + i))
        out.update({k: v.numpy() for k, v in
                    mesh_ref._torch_flat(params, f"{case}/params")})
    rng = np.random.default_rng(3)
    out["serve/prompts"] = rng.integers(
        0, ranks.case_config(ranks.SERVE_CASE).vocab_size,
        (ranks.SERVE_BATCH, ranks.SERVE_PROMPT)).astype(np.int32)
    return out


def _moe_inputs() -> dict:
    from repro.models import common, moe
    out = {}
    for dtype in ("float32", "bfloat16"):
        p = common.init_params(moe.moe_specs(mesh_ref.moe_config()),
                               jax.random.PRNGKey(0), jnp.dtype(dtype))
        p["router"] = p["router"].at[0, -1].set(2.0)
        out.update(mesh_ref.flat(p, f"moe/{dtype}/params"))
        rng = np.random.default_rng(1)
        x = rng.standard_normal(
            (ranks.MOE_T, mesh_ref.moe_config().d_model)).astype(np.float32)
        x[:, 0] = 3.0
        out[f"moe/{dtype}/x"] = x
        out[f"moe/{dtype}/cot"] = rng.standard_normal(x.shape).astype(np.float32)
    return out


def coordinates(mesh):
    """(device, its coordinate on the mesh's axes) of every device."""
    for idx in np.ndindex(mesh.devices.shape):
        yield mesh.devices[idx], idx


def blocks(sharding_tree, abstract, mesh, prefix, out):
    """Where each leaf's block lies at each mesh coordinate: (ndim, 2)
    start and stop per dim, under ``prefix``/<leaf>/<p>_<d>_<m>."""
    for (path, sh), (_, aval) in zip(
            jax.tree_util.tree_flatten_with_path(sharding_tree)[0],
            jax.tree_util.tree_flatten_with_path(abstract)[0]):
        index = sh.devices_indices_map(aval.shape)
        key = "/".join([prefix, *(p.key for p in path)])
        for dev, coord in coordinates(mesh):
            sl = index[dev]
            out[f"{key}/{'_'.join(map(str, coord))}"] = np.asarray(
                [s.indices(n)[:2] for s, n in zip(sl, aval.shape)],
                np.int64).reshape(len(aval.shape), 2)


def train_case(mesh, inputs, case, out):
    """Two of the reference's train steps on the mesh and on one device."""
    cfg = ranks.case_config(case, get_config)
    model = build_model(cfg)
    opts = train.TrainOptions(remat_policy=None, warmup_steps=1, total_steps=10)
    params = mesh_ref.params_from(model, inputs, f"{case}/params")
    state = {"params": params, "opt": adamw.init_opt_state(params, opts.opt),
             "step": jnp.zeros((), jnp.int32)}
    dc = pipeline.DataConfig(cfg.vocab_size, ranks.TRAIN_SEQ, ranks.TRAIN_BATCH)
    batches = [pipeline.batch_for_step(dc, i, cfg)
               for i in range(ranks.TRAIN_STEPS)]
    b_abs = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                         batches[0])
    st_sh = train.state_shardings(model, mesh, opts)
    blocks(st_sh["params"], model.abstract(), mesh, f"{case}/blocks", out)
    runs = {"local": (jax.jit(train.build_train_step(model, opts)),
                      lambda: state),
            "mesh": (train.jit_train_step(model, opts, mesh, b_abs),
                     lambda: jax.device_put(state, st_sh))}
    for name, (step, init) in runs.items():   # local first: mesh donates
        st = init()
        for i, b in enumerate(batches):
            if name == "mesh":
                b = jax.device_put(b, train.batch_shardings(b_abs, mesh))
            st, met = step(st, b)
            for k in ("loss", "grad_norm", "aux_loss"):
                out[f"{case}/{name}/{k}/{i}"] = np.asarray(met[k])
            out.update(mesh_ref.flat(st["params"], f"{case}/{name}/params/{i}"))


def serve_case(mesh, inputs, out):
    """The reference's prefill and greedy decode steps on the mesh, with
    the serving rules."""
    cfg = ranks.case_config(ranks.SERVE_CASE, get_config)
    model = build_model(cfg)
    params = mesh_ref.params_from(model, inputs, f"{ranks.SERVE_CASE}/params")
    prompts = jnp.asarray(inputs["serve/prompts"])
    B, P = prompts.shape
    max_len = P + ranks.SERVE_NEW
    opts = serve.ServeOptions(kv_dtype=ranks.SERVE_KV_DTYPE)
    rules = shd.SERVING_RULES
    prefill, _ = serve.jit_prefill_step(model, opts, mesh, B, P, rules=rules)
    decode, _ = serve.jit_decode_step(model, opts, mesh, B, max_len, rules=rules)
    cache = transformer.init_cache(cfg, B, max_len,
                                   kv_dtype=jnp.dtype(ranks.SERVE_KV_DTYPE))
    cache = jax.device_put(cache, serve.cache_shardings(
        model, jax.eval_shape(lambda: cache), mesh, rules))
    params = jax.device_put(params, shd.tree_shardings(
        model.axes(), model.abstract(), mesh, rules))
    last, cache = prefill(params, {"tokens": prompts}, cache)
    tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
    toks = [tok]
    for idx in range(P, P + ranks.SERVE_NEW - 1):
        tok, last, cache = decode(params, cache, tok, jnp.int32(idx))
        toks.append(tok)
    out["serve/mesh/tokens"] = np.asarray(jnp.concatenate(toks, 1))


def main(inputs_path, path):
    assert jax.device_count() == 8, jax.devices()
    inputs = np.load(inputs_path)
    out = {}
    mesh = make_mesh(ranks.MESH, ranks.AXES)
    with (jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh):
        for dtype in ("float32", "bfloat16"):
            for variant in ranks.MOE_VARIANTS:
                mesh_ref.moe_case(mesh, inputs, dtype, variant, out,
                                  data_axes=ranks.DATA_AXES)
        for case in ranks.TRAIN_CASES:
            train_case(mesh, inputs, case, out)
        serve_case(mesh, inputs, out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
