"""Four gloo ranks that run the port's mesh steps for real on the CPU under
the dry-run's census (``tests/test_torch_dryrun_mesh.py`` holds rank 0's
census against the dry-run's trace on a fake group of the same mesh), move
a weight between a (data) store and a (pod, data) use, and take a train
step's gradients with each layer's weights gathered when it runs and with
each group's gathered whole first.

    python tests/_torch_dryrun_ranks.py OUT_DIR

The group meets through a ``FileStore`` in OUT_DIR (no port is opened).
Each rank writes ``rank<r>.json``.
"""
import datetime
import json
import os
import sys
import traceback

import numpy as np

MESH = (2, 2)                     # (data, model)
JOINT_MESH = (2, 2, 1)            # (pod, data, model)
TIMEOUT_S = 300
JOIN_S = 600
# name -> (arch, kind, global batch, sequence); reduced configs with heads
# of 64, the smallest the flash kernel takes (the meta path checks it)
CASES = {"dense_train": ("deepseek-7b", "train", 4, 64),
         "moe_train": ("deepseek-moe-16b", "train", 4, 64),
         "dense_decode": ("deepseek-7b", "decode", 4, 64),
         "moe_decode": ("deepseek-moe-16b", "decode", 4, 64)}


def case_config(name):
    from repro_torch.configs.base import ShapeCell
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import serving_options
    arch, kind, B, S = CASES[name]
    cell = ShapeCell(name, S, B, kind)
    rules, opts_over = serving_options(cell) if kind == "decode" else (None, None)
    return get_config(arch, reduced=True).replace(head_dim=64), cell, rules, \
        opts_over or {}


def census_of(trace) -> dict:
    return {**trace.census.summary(),
            "collective_list": trace.census.collectives}


def run_case(mesh, name) -> dict:
    """The case's mesh step on real CPU tensors under the census, as
    ``dryrun.lower_cell`` runs it on meta ones."""
    import torch
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import serve as serve_rt
    from repro_torch.runtime import train as train_rt
    cfg, cell, rules, opts_over = case_config(name)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        opts = train_rt.TrainOptions(**{"remat_policy": "full",
                                        "microbatches": 1, **opts_over})
        state = train_rt.distribute_train_state(
            train_rt.init_train_state(model, gen, opts), model, mesh, opts, rules)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               dtype=torch.int32)
        batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
        step = train_rt.jit_train_step(model, opts, mesh, batch, rules)
        return census_of(trace_step(step, (state, batch), train=True))
    opts = serve_rt.ServeOptions(**opts_over)
    params = serve_rt.shard_params(model.init(gen), model, mesh, rules)
    cache = serve_rt.mesh_cache(model, opts, mesh, B, S, device="cpu")
    fn, _ = serve_rt.jit_decode_step(model, opts, mesh, B, S, rules=rules)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
    return census_of(trace_step(fn, (params, cache, tokens, S - 1), train=False))


def joint_case(rank) -> dict:
    """A weight stored split over data, used split jointly over (pod, data)
    (pod-major): the rank's block, and the gradient of its stored shard when
    each rank back-propagates its own loss, against numpy."""
    import torch
    from repro_torch import collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import sharding as shd
    mesh = make_mesh(JOINT_MESH, ("pod", "data", "model"), device_type="cpu")
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 3))
    cot = rng.standard_normal((4, 2, 3))          # each rank's cotangent
    stored, use = ("data",), (("pod", "data"),)
    x = torch.from_numpy(shd.local_part(torch.from_numpy(w), stored, mesh)
                         .numpy().copy()).requires_grad_()
    y = collectives.to_use(x, stored, use, mesh)
    coord = mesh.get_coordinate()
    block = 2 * coord[0] + coord[1]               # pod-major
    (g,) = torch.autograd.grad(y, x, torch.from_numpy(cot[block]))
    d = coord[1]
    return {"block_ok": bool(np.array_equal(y.detach().numpy(),
                                            w[2 * block:2 * block + 2])),
            "grad_ok": bool(np.allclose(g.numpy(),
                                        cot.reshape(8, 3)[4 * d:4 * d + 4]))}


# the per-layer gather's gradients against the whole group's, REDUCED in
# fp32: arch -> remat policy
LAYER_GATHER_CASES = {"deepseek-7b": "full", "deepseek-moe-16b": None,
                      "zamba2-7b": "full", "seamless-m4t-large-v2": None}


def _whole_group_layers(self, n):
    """``GroupOnUse.layers`` as the port moved a group before it gathered
    one layer at a time: every leaf moved whole by ``collectives.to_use``,
    then cut into its layers."""
    import torch
    from repro_torch import collectives
    from repro_torch.runtime import sharding as shd
    from repro_torch.tree import with_empty
    moved = {}
    for path, t in shd._leaf_paths(self._tree):
        with shd.census.at(self._path + path):
            moved[path] = torch.unbind(collectives.to_use(
                t, *self._specs(self._path + path)), 0)

    def layer(i):
        out: dict = {}
        for path, layers in moved.items():
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = layers[i]
        return with_empty(self._tree, out)

    return [lambda i=i: layer(i) for i in range(n)]


def layer_gather_case(mesh, arch) -> dict:
    """One mesh step's gradients with each layer gathered when it runs,
    and with each group gathered whole first: the worst leaf's relative
    gap, and whether every leaf is bitwise equal."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data import pipeline
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import train as train_rt
    from repro_torch.tree import leaves
    cfg = get_config(arch, reduced=True).replace(param_dtype="float32",
                                                 activ_dtype="float32")
    model = build_model(cfg)
    opts = train_rt.TrainOptions(remat_policy=LAYER_GATHER_CASES[arch])
    state = train_rt.distribute_train_state(
        train_rt.init_train_state(model, torch.Generator().manual_seed(0),
                                  opts), model, mesh, opts)
    stored = shd.spec_tree_of(state["params"])
    params = shd.local_tree(state["params"])
    batch = pipeline.batch_for_step(pipeline.DataConfig(cfg.vocab_size, 16, 4),
                                    0, cfg, device="cpu")
    grad_fn = train_rt.build_grad_fn(model, opts, mesh)
    per_layer, _ = grad_fn(params, batch, stored)
    saved = shd.GroupOnUse.layers
    shd.GroupOnUse.layers = _whole_group_layers
    try:
        whole, _ = grad_fn(params, batch, stored)
    finally:
        shd.GroupOnUse.layers = saved
    gaps = [float((a - b).norm() / max(float(b.norm()), 1e-30))
            for a, b in zip(leaves(per_layer), leaves(whole))]
    return {"worst": max(gaps),
            "bitwise": all(torch.equal(a, b) for a, b in
                           zip(leaves(per_layer), leaves(whole)))}


def rank_main(rank, out_dir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), 4),
            rank=rank, world_size=4,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(MESH, ("data", "model"), device_type="cpu")
        out = {name: run_case(mesh, name) for name in CASES}
        out["joint"] = joint_case(rank)
        out["layer_gather"] = {arch: layer_gather_case(mesh, arch)
                               for arch in LAYER_GATHER_CASES}
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main(out_dir):
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, out_dir)) for r in range(4)]
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
    main(sys.argv[1])
