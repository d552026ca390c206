"""The port's side of ``tests/test_torch_mesh.py``: four ranks of a gloo
group on a (data 2, model 2) ``DeviceMesh``, each writing what it computed
to ``OUT_DIR/rank<r>.npz`` for the tests to compare.

    PYTHONPATH=src python tests/_torch_mesh_ranks.py INPUTS.npz OUT_DIR

The group meets through a ``FileStore`` in OUT_DIR (no port is opened), with
a timeout on the group and on every rank's join, so a hang fails the run.

- ``compressed_psum`` over the four ranks on INPUTS' ``psum/*`` rows;
- ``apply_moe`` on the mesh, from INPUTS' ``moe/<dtype>/*`` (the
  reference's layer, its tokens and the loss's cotangent), in the default,
  ``fsdp_experts`` and ``expert_tp`` variants: outputs, aux and gradients;
- the mesh train step, two steps against the local step on the full batch
  (rank 0 runs it): deepseek-7b (also with two microbatches and int8
  moments) and mamba2-370m reduced in fp32 from the port's seeded init,
  deepseek-moe-16b from INPUTS' state (the reference's), also without its
  aux loss and with remat;
  each rank's stored shards against ``state_shardings``; the mesh state's
  checkpoint, written and restored;
- the mesh prefill and four greedy decode steps, against the local ones
  (deepseek-7b, deepseek-moe-16b, mamba2-370m);
- tensor parallelism (``tests/test_torch_tp.py``): on the (1, 4) and (2, 2)
  meshes, from INPUTS' ``tp/<case>/*`` (the reference's weights, prompts
  and frames), a prefill and greedy decode steps through
  ``jit_prefill_step`` / ``jit_decode_step`` and two fp32 train steps
  through ``jit_train_step``, against the local path (rank 0); the blocks
  the forward computes with (the weights ``_heads``, ``apply_ffn`` and the
  embedding lookup receive), the model-axis all-gathers of a train step,
  and the cache's placements.
"""
import datetime
import os
import sys
import traceback

import numpy as np

TIMEOUT_S = 60
JOIN_S = 600
MESH = (2, 2)
# arch[:flag+flag]: no_aux (router_aux_coef 0), remat (policy "full"),
# mb2 (two microbatches), int8 (int8 moments)
TRAIN_ARCHS = ("deepseek-7b", "deepseek-7b:mb2", "deepseek-7b:int8",
               "mamba2-370m", "deepseek-moe-16b", "deepseek-moe-16b:no_aux+remat")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 2, 4, 16
SERVE_ARCHS = ("deepseek-7b", "deepseek-moe-16b", "mamba2-370m")
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 8, 5
MOE_VARIANTS = {"default": {}, "fsdp_experts": {"fsdp_experts": True},
                "expert_tp": {"expert_tp": True}}
# tensor parallelism: arch[:flag] on each (data, model) mesh, REDUCED in
# fp32; v258 replaces the vocabulary by 258 (replicated at model 4, split at
# 2); deepseek-moe-16b without its aux loss (where EP and local differ by
# design) and with remat
TP_MESHES = ((1, 4), (2, 2))
TP_CASES = ("deepseek-7b", "command-r-plus-104b", "gemma2-9b",
            "seamless-m4t-large-v2", "deepseek-moe-16b", "zamba2-7b",
            "deepseek-7b:v258")
# a prompt past gemma2 REDUCED's 16-token window, a cache of 32 positions
# (split 4 ways by position where model does not divide kv_heads)
TP_BATCH, TP_PROMPT, TP_NEW = 4, 20, 12
TP_REMAT = ("deepseek-moe-16b",)
# the mesh each case's train step is held against the reference's on (the
# reference's train compiles dominate the run): both meshes, half the
# cases each
TP_REF_TRAIN_MESH = {"deepseek-7b": (1, 4), "command-r-plus-104b": (2, 2),
                     "gemma2-9b": (1, 4), "seamless-m4t-large-v2": (2, 2),
                     "deepseek-moe-16b": (1, 4), "zamba2-7b": (2, 2),
                     "deepseek-7b:v258": (1, 4)}
# an fp32 cache: a bf16 one rounds K/V that the rank's narrower products
# sum in another order, which moves logits by more than the sums do
TP_KV_DTYPE = "float32"


def tp_config(case):
    """The REDUCED fp32 config of a tensor-parallel case (torch's or the
    reference's ``get_config``)."""
    from repro_torch.configs.registry import get_config
    return tp_config_of(get_config, case)


def tp_config_of(get_config, case):
    arch, _, flag = case.partition(":")
    cfg = get_config(arch, reduced=True).replace(param_dtype="float32",
                                                 activ_dtype="float32")
    if flag == "v258":
        cfg = cfg.replace(vocab_size=258)
    if cfg.moe.num_experts:
        cfg = cfg.replace(moe=cfg.moe.__class__(**{**cfg.moe.__dict__,
                                                    "router_aux_coef": 0.0}))
    return cfg


def tp_mesh_name(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _np(t):
    """A copy: the train step updates its tensors in place."""
    return t.detach().float().cpu().numpy().copy()


def _flat(tree, prefix, out):
    from repro_torch.tree import leaves_with_path
    for path, leaf in leaves_with_path(tree):
        out["/".join([prefix, *path])] = _np(leaf)


def psum_case(rank, inputs, out):
    import torch
    from repro_torch.optim import compression
    g = torch.from_numpy(inputs["psum/g"][rank])
    err = torch.from_numpy(inputs["psum/err"][rank])
    total, new_err = compression.compressed_psum(g, err)
    out["psum/total"], out["psum/new_err"] = _np(total), _np(new_err)


def moe_case(mesh, inputs, dtype, variant, out):
    import torch
    from repro_torch import collectives
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    from repro_torch.runtime import sharding as shd
    from repro_torch.tree import leaves_with_path, unflatten

    cfg = get_config("deepseek-moe-16b", reduced=True)
    cfg = cfg.replace(moe=cfg.moe.__class__(**{**cfg.moe.__dict__,
                                                "capacity_factor": 1.25}))
    dt = getattr(torch, dtype)
    full = _tree(inputs, f"moe/{dtype}/params")
    full = {k: v if k == "router" else
            ({n: w.to(dt) for n, w in v.items()} if isinstance(v, dict) else v.to(dt))
            for k, v in full.items()}
    dist = moe.DistContext(mesh=mesh, data_axes=("data",), model_axis="model",
                           **MOE_VARIANTS[variant])
    ep = moe.expert_specs(dist)
    use = {"w_gate": ep["w"], "w_up": ep["w"], "w_down": ep["wd"]}
    ps = [t.requires_grad_(True) for _, t in leaves_with_path(full)]
    # the layer's routed experts (top-level leaves) to their EP blocks; the
    # router and the shared experts whole
    p = unflatten(full, iter([
        collectives.to_use(t, (), use.get(path[0], ()) if len(path) == 1 else (),
                           mesh)
        for (path, _), t in zip(leaves_with_path(full), ps)]))
    x_all = torch.from_numpy(inputs[f"moe/{dtype}/x"]).to(dt)
    cot_all = torch.from_numpy(inputs[f"moe/{dtype}/cot"])
    spec = shd.data_spec(x_all.shape, mesh)
    x = shd.local_part(x_all, spec, mesh).clone().requires_grad_(True)
    cot = shd.local_part(cot_all, spec, mesh)
    xs = collectives.to_use(x, spec, spec, mesh)     # the model axis' copies
    y, aux = moe.apply_moe(p, xs[None], cfg=cfg, dist=dist)
    ep_size = collectives.axis_size(mesh, "model")
    # the global loss sum(out * cot) + aux, as each rank's share: its rows
    # are held by ep ranks, aux by all of them
    loss = (y.float()[0] * cot).sum() / ep_size + aux / mesh.size()
    grads = torch.autograd.grad(loss, ps + [x])
    key = f"moe/{dtype}/{variant}"
    out[f"{key}/out"], out[f"{key}/aux"] = _np(y[0]), _np(aux)
    out[f"{key}/grad_x"] = _np(grads[-1])
    _flat(unflatten(full, iter(grads[:-1])), f"{key}/grad", out)


def _params(model, inputs, prefix):
    """The model's params tree (a block without weights an empty dict) from
    INPUTS' arrays under ``prefix``."""
    import torch

    def fill(meta, path):
        if isinstance(meta, dict):
            return {k: fill(v, path + (k,)) for k, v in meta.items()}
        return torch.from_numpy(inputs["/".join((prefix,) + path)])

    return fill(model.abstract(), ())


def _tree(inputs, prefix):
    import torch
    tree = {}
    for key in inputs.files:
        if key.startswith(prefix + "/"):
            node, path = tree, key[len(prefix) + 1:].split("/")
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.from_numpy(inputs[key])
    return tree


def train_case(rank, mesh, inputs, arch_case, out, ckpt_dir):
    import copy

    import torch
    from repro_torch.checkpointing.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.data import pipeline
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import train

    arch, _, flags = arch_case.partition(":")
    flags = set(flags.split("+")) - {""}
    cfg = get_config(arch, reduced=True).replace(param_dtype="float32",
                                                 activ_dtype="float32")
    if "no_aux" in flags:
        cfg = cfg.replace(moe=cfg.moe.__class__(**{**cfg.moe.__dict__,
                                                    "router_aux_coef": 0.0}))
    model = build_model(cfg)
    opts = train.TrainOptions(
        remat_policy="full" if "remat" in flags else None,
        microbatches=2 if "mb2" in flags else 1, warmup_steps=1, total_steps=10,
        opt=train.adamw.AdamWConfig(moment_dtype="int8" if "int8" in flags
                                    else "float32"))
    if arch == "deepseek-moe-16b":
        from repro_torch.optim import adamw
        params = _tree(inputs, "train/init")
        state = {"params": params, "opt": adamw.init_opt_state(params, opts.opt),
                 "step": torch.zeros((), dtype=torch.int32)}
    else:
        state = train.init_train_state(model, torch.Generator().manual_seed(0),
                                       opts)
    local_state = copy.deepcopy(state) if rank == 0 else None
    dc = pipeline.DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    batches = [pipeline.batch_for_step(dc, i, cfg, device="cpu")
               for i in range(TRAIN_STEPS)]
    b_abs = {k: torch.empty(v.shape, device="meta") for k, v in batches[0].items()}
    mstate = train.distribute_train_state(state, model, mesh, opts)
    if arch_case == "deepseek-moe-16b":     # the files of the sharded state
        CheckpointManager(os.path.join(ckpt_dir, "mesh"),
                          async_save=False).save(0, {"state": mstate})
        if rank == 0:
            CheckpointManager(os.path.join(ckpt_dir, "local"),
                              async_save=False).save(0, {"state": state})
    del state
    want = train.state_shardings(model, mesh, opts)
    out[f"train/{arch_case}/placed_as_state_shardings"] = np.asarray(
        shd.spec_tree_of(mstate) == want)
    step = train.jit_train_step(model, opts, mesh, b_abs)
    for i, b in enumerate(batches):
        mstate, met = step(mstate, b)
        for k in ("loss", "grad_norm", "aux_loss"):
            out[f"train/{arch_case}/mesh/{k}/{i}"] = _np(met[k])
        if i == 0 and "int8" in flags:   # before a moment is read back from int8
            first = shd.gather_full(mstate["params"])
            if rank == 0:
                _flat(first, f"train/{arch_case}/mesh/params_step1", out)
    out[f"train/{arch_case}/mesh/step"] = np.asarray(int(mstate["step"].to_local()))
    full = shd.gather_full(mstate)
    if arch_case == "deepseek-moe-16b":     # written and restored, re-sharded
        mgr = CheckpointManager(os.path.join(ckpt_dir, "mesh"), async_save=False)
        mgr.save(TRAIN_STEPS, {"state": mstate})
        back, at = mgr.restore({"state": mstate})
        same = all(torch.equal(a, b) for a, b in zip(
            _leaves(shd.gather_full(back["state"])), _leaves(full)))
        out["ckpt/restored_bitwise"] = np.asarray(same and at == TRAIN_STEPS)
    if rank == 0:
        _flat(full["params"], f"train/{arch_case}/mesh/params", out)
        lstep = train.build_train_step(model, opts)
        for i, b in enumerate(batches):
            local_state, met = lstep(local_state, b)
            for k in ("loss", "grad_norm", "aux_loss"):
                out[f"train/{arch_case}/local/{k}/{i}"] = _np(met[k])
            if i == 0 and "int8" in flags:
                _flat(local_state["params"], f"train/{arch_case}/local/params_step1",
                      out)
        _flat(local_state["params"], f"train/{arch_case}/local/params", out)
        if "int8" in flags:          # the moments: q and the whole-leaf scale
            _flat(full["opt"], f"train/{arch_case}/mesh/opt", out)
            _flat(local_state["opt"], f"train/{arch_case}/local/opt", out)


def _leaves(tree):
    from repro_torch.tree import leaves
    return list(leaves(tree))


def serve_case(rank, mesh, arch, out):
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import serve

    cfg = get_config(arch, reduced=True).replace(param_dtype="float32",
                                                 activ_dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen)
    opts = serve.ServeOptions()
    max_len = SERVE_PROMPT + SERVE_NEW
    prefill, _ = serve.jit_prefill_step(model, opts, mesh, SERVE_BATCH, SERVE_PROMPT)
    decode, _ = serve.jit_decode_step(model, opts, mesh, SERVE_BATCH, max_len)
    runs = {"mesh": (prefill, decode, serve.shard_params(params, model, mesh),
                     lambda: serve.mesh_cache(model, opts, mesh, SERVE_BATCH,
                                              max_len, device="cpu"))}
    if rank == 0:
        runs["local"] = (serve.build_prefill_step(model, opts),
                         serve.build_decode_step(model, opts), params,
                         lambda: model.init_cache(SERVE_BATCH, max_len,
                                                  device="cpu"))
    with torch.inference_mode():
        for name, (pre, dec, p, cache_fn) in runs.items():
            last, cache = pre(p, {"tokens": prompts}, cache_fn())
            tok = torch.argmax(last, -1)[:, None]
            toks, logits = [tok], [last]
            for idx in range(SERVE_PROMPT, SERVE_PROMPT + SERVE_NEW - 1):
                tok, last, cache = dec(p, cache, tok, idx)
                toks.append(tok)
                logits.append(last)
            out[f"serve/{arch}/{name}/tokens"] = torch.cat(toks, 1).numpy()
            out[f"serve/{arch}/{name}/logits"] = _np(torch.stack(logits))


class _Record:
    """What the forward computes with, by patching the port's modules: the
    weights ``attention._heads`` projects with, the ``w_gate`` of each
    ``apply_ffn``, the tables of ``embed_lookup``; and the all-gathers
    over the model axis (``collectives._AllGather``)."""

    def __init__(self, mesh):
        from repro_torch import collectives
        from repro_torch.models import attention, moe, transformer
        self.model_pg = mesh.get_group("model")
        self.heads, self.gate, self.embed, self.model_gathers = (
            set(), set(), set(), [])
        heads, gather = attention._heads, collectives._AllGather.apply
        ffn_t, ffn_m, lookup = transformer.apply_ffn, moe.apply_ffn, \
            transformer.embed_lookup

        def rec_heads(x, w):
            self.heads.add(tuple(w.shape))
            return heads(x, w)

        def rec_ffn(fn):
            def run(p, x, **kw):
                self.gate.add(tuple(p["w_gate"].shape))
                return fn(p, x, **kw)
            return run

        def rec_lookup(table, tokens, tp):
            self.embed.add(tuple(table.shape))
            return lookup(table, tokens, tp)

        def rec_gather(x, dim, pg):
            if pg is self.model_pg:
                self.model_gathers.append(tuple(x.shape))
            return gather(x, dim, pg)

        self._undo = [(attention, "_heads", heads),
                      (transformer, "apply_ffn", ffn_t),
                      (moe, "apply_ffn", ffn_m),
                      (transformer, "embed_lookup", lookup)]
        attention._heads = rec_heads
        collectives._AllGather.apply = rec_gather
        transformer.apply_ffn, moe.apply_ffn = rec_ffn(ffn_t), rec_ffn(ffn_m)
        transformer.embed_lookup = rec_lookup

    def close(self):
        from repro_torch import collectives
        for obj, name, fn in self._undo:
            setattr(obj, name, fn)
        del collectives._AllGather.apply     # Function's own, inherited

    @staticmethod
    def shapes(s):
        return np.asarray(sorted(s), np.int64)


def _cache_layout(spec) -> str:
    """Where an attention cache leaf (layers, batch, kv_seq, kv_heads, hd)
    puts the model axis."""
    spec = tuple(spec) + (None,) * (5 - len(spec))
    for dim, name in ((2, "seq"), (3, "heads")):
        entry = spec[dim]
        if entry == "model" or (isinstance(entry, tuple) and "model" in entry):
            return name
    return "whole"


def tp_serve_case(rank, meshes, inputs, case, out):
    """Prefill and TP_NEW - 1 greedy decode steps on each mesh (and locally
    on rank 0): tokens and each step's logits; on each mesh what the
    prefill computes with and the cache's placements."""
    import torch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import serve
    from repro_torch.runtime import sharding as shd

    cfg = tp_config(case)
    model = build_model(cfg)
    params = _params(model, inputs, f"tp/{case}/params")
    prompts = torch.from_numpy(inputs[f"tp/{case}/prompts"]).long()
    extras = {k: torch.from_numpy(inputs[f"tp/{case}/{k}"])
              for k in ("frames",) if f"tp/{case}/{k}" in inputs.files}
    enc_len = serve.cross_len(extras)
    opts = serve.ServeOptions(kv_dtype=TP_KV_DTYPE)
    B, P = prompts.shape
    max_len = P + TP_NEW
    runs = {}
    for shape, mesh in meshes.items():
        prefill, _ = serve.jit_prefill_step(model, opts, mesh, B, P)
        decode, (_, cache_abs) = serve.jit_decode_step(model, opts, mesh, B,
                                                       max_len, enc_len)
        runs[tp_mesh_name(shape)] = (
            prefill, decode, serve.shard_params(params, model, mesh),
            lambda mesh=mesh: serve.mesh_cache(model, opts, mesh, B, max_len,
                                               enc_len, device="cpu"),
            mesh, cache_abs)
    if rank == 0:
        runs["local"] = (serve.build_prefill_step(model, opts),
                         serve.build_decode_step(model, opts), params,
                         lambda: model.init_cache(
                             B, max_len, enc_len=enc_len, device="cpu",
                             kv_dtype=getattr(torch, TP_KV_DTYPE)), None, None)
    with torch.inference_mode():
        for name, (pre, dec, p, cache_fn, mesh, cache_abs) in runs.items():
            key = f"tp/{case}/serve/{name}"
            cache = cache_fn()
            rec = _Record(mesh) if mesh is not None else None
            try:
                last, cache = pre(p, {"tokens": prompts, **extras}, cache)
            finally:
                if rec is not None:
                    rec.close()
            if mesh is not None:
                for what in ("heads", "gate", "embed"):
                    out[f"{key}/computes_with/{what}"] = rec.shapes(
                        getattr(rec, what))
                want = serve.cache_shardings(model, cache_abs, mesh)
                got = shd.spec_tree_of(cache)
                attn = [(path, spec) for path, spec in _spec_leaves(got)
                        if path[-1] in serve.ATTENTION_CACHE]
                out[f"{key}/attention_cache_as_cache_shardings"] = np.asarray(
                    all(spec == shd.tree_at(want, path) for path, spec in attn))
                out[f"{key}/cache_layouts"] = np.asarray(
                    sorted({f"{path[-1]}:{_cache_layout(spec)}"
                            for path, spec in attn}))
            tok = torch.argmax(last, -1)[:, None]
            toks, logits = [tok], [last]
            for idx in range(P, P + TP_NEW - 1):
                tok, last, cache = dec(p, cache, tok, idx)
                toks.append(tok)
                logits.append(last)
            out[f"{key}/tokens"] = torch.cat(toks, 1).numpy()
            out[f"{key}/logits"] = _np(torch.stack(logits))


def _spec_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tp_train_case(rank, meshes, inputs, case, out):
    """From the reference's weights, on each mesh (and locally on rank 0):
    the step-1 gradients, and two fp32 train steps' loss and grad norm and
    the params after step 1; the model-axis all-gathers of a mesh step and
    the leaves the use specs gather over model."""
    import copy

    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.data import pipeline
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import train
    from repro_torch.tree import leaves_with_path

    cfg = tp_config(case)
    model = build_model(cfg)
    opts = train.TrainOptions(
        remat_policy="full" if case in TP_REMAT else None, warmup_steps=1,
        total_steps=10)
    params = _params(model, inputs, f"tp/{case}/params")
    state = {"params": params, "opt": adamw.init_opt_state(params, opts.opt),
             "step": torch.zeros((), dtype=torch.int32)}
    dc = pipeline.DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    batches = [pipeline.batch_for_step(dc, i, cfg, device="cpu")
               for i in range(TRAIN_STEPS)]
    b_abs = {k: torch.empty(v.shape, device="meta") for k, v in batches[0].items()}
    for shape, mesh in meshes.items():
        key = f"tp/{case}/train/{tp_mesh_name(shape)}"
        mstate = train.distribute_train_state(copy.deepcopy(state), model,
                                              mesh, opts)
        stored = shd.spec_tree_of(mstate["params"])
        grads, _ = train.build_grad_fn(model, opts, mesh)(
            shd.local_tree(mstate["params"]), batches[0], stored)
        for path, g in leaves_with_path(grads):
            full = DTensor.from_local(
                g, mesh, shd.placements(shd.tree_at(stored, path), mesh),
                run_check=False).full_tensor()
            if rank == 0:
                out["/".join((key, "grads", *path))] = _np(full)
        del grads
        # the leaves a rank gathers over model on use: stored split there,
        # used whole
        use = train.use_specs(model, train.make_dist(mesh, opts))
        gathered = [
            "/".join(path) for path, spec in _spec_leaves(stored)
            if "model" in {a for e in spec for a in shd.spec_axes(e)} and
            "model" not in {a for e in shd.tree_at(use, path)
                            for a in shd.spec_axes(e)}]
        out[f"{key}/gathered_over_model"] = np.asarray(sorted(gathered) or [""])
        step = train.jit_train_step(model, opts, mesh, b_abs)
        for i, b in enumerate(batches):
            rec = _Record(mesh) if i == 0 else None
            try:
                mstate, met = step(mstate, b)
            finally:
                if rec is not None:
                    rec.close()
            if rec is not None:
                out[f"{key}/model_gathers"] = np.asarray(len(rec.model_gathers))
                full = shd.gather_full(mstate["params"])
                if rank == 0:
                    _flat(full, f"{key}/params_step1", out)
            for k in ("loss", "grad_norm"):
                out[f"{key}/{k}/{i}"] = _np(met[k])
    if rank == 0:
        key = f"tp/{case}/train/local"
        grads, _ = train.build_grad_fn(model, opts)(params, batches[0])
        _flat(grads, f"{key}/grads", out)
        lstate = copy.deepcopy(state)
        lstep = train.build_train_step(model, opts)
        for i, b in enumerate(batches):
            lstate, met = lstep(lstate, b)
            if i == 0:
                _flat(lstate["params"], f"{key}/params_step1", out)
            for k in ("loss", "grad_norm"):
                out[f"{key}/{k}/{i}"] = _np(met[k])


def rank_main(rank, inputs_path, out_dir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = {}
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), 4),
            rank=rank, world_size=4,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(MESH, ("data", "model"), device_type="cpu")
        inputs = np.load(inputs_path)
        psum_case(rank, inputs, out)
        for dtype in ("float32", "bfloat16"):
            for variant in MOE_VARIANTS:
                moe_case(mesh, inputs, dtype, variant, out)
        for arch in TRAIN_ARCHS:
            train_case(rank, mesh, inputs, arch, out, os.path.join(out_dir, "ckpt"))
        for arch in SERVE_ARCHS:
            serve_case(rank, mesh, arch, out)
        tp_meshes = {s: make_mesh(s, ("data", "model"), device_type="cpu")
                     for s in TP_MESHES}
        for case in TP_CASES:
            tp_serve_case(rank, tp_meshes, inputs, case, out)
            tp_train_case(rank, tp_meshes, inputs, case, out)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def main(inputs_path, out_dir):
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, inputs_path, out_dir))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if codes != [0] * 4:
        sys.exit(f"ranks ended with {codes}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
