"""The port's side of ``tests/test_torch_pod.py``: eight ranks of a gloo
group on a (pod 2, data 2, model 2) ``DeviceMesh``, each writing what it
computed to ``OUT_DIR/rank<r>.npz`` for the tests to compare with the
reference on eight host devices (``tests/_torch_pod_ref.py``).

    PYTHONPATH=src python tests/_torch_pod_ranks.py INPUTS.npz OUT_DIR

The group meets through a ``FileStore`` in OUT_DIR (no port is opened), with
a timeout on the group and on every rank's join, so a hang fails the run.
The batch is split jointly over (pod, data), pod-major.

- ``apply_moe`` with ``data_axes=("pod", "data")``, from INPUTS' MoE cases,
  in the default, ``fsdp_experts`` and ``expert_tp`` variants: outputs, aux
  and gradients (``_torch_mesh_ranks.moe_case``);
- two ``jit_train_step`` steps of reduced deepseek-moe-16b (``fsdp_experts``,
  drop-free capacity) and of reduced deepseek-7b in fp32 from INPUTS'
  weights, and on rank 0 the local step on the full batch: loss, grad norm,
  aux and the params after each step; each rank's mesh coordinate and its
  stored block of every param; the mesh state's checkpoint (deepseek-moe-16b)
  written, restored, and beside it the local state's;
- ``jit_prefill_step`` and greedy ``jit_decode_step`` steps of reduced
  deepseek-moe-16b in fp32 with the serving rules, and the local ones on
  rank 0: the tokens.
"""
import datetime
import os
import sys
import traceback

import numpy as np

import _torch_mesh_ranks as mesh_ranks

TIMEOUT_S = 60
JOIN_S = 600
MESH, AXES = (2, 2, 2), ("pod", "data", "model")
DATA_AXES = ("pod", "data")
MOE_VARIANTS = mesh_ranks.MOE_VARIANTS
MOE_T = 64                      # tokens of the MoE layer: 16 per batch shard
TRAIN_CASES = ("deepseek-moe-16b", "deepseek-7b")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 2, 8, 16
SERVE_CASE = "deepseek-moe-16b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 8, 5
# an fp32 cache, as the tensor-parallel cases' (_torch_mesh_ranks.TP_KV_DTYPE)
SERVE_KV_DTYPE = "float32"
_np, _flat, _params = mesh_ranks._np, mesh_ranks._flat, mesh_ranks._params


def case_config(case, get_config=None):
    """The REDUCED fp32 config of a case (torch's or the reference's
    ``get_config``)."""
    if get_config is None:
        from repro_torch.configs.registry import get_config
    return get_config(case, reduced=True).replace(param_dtype="float32",
                                                  activ_dtype="float32")


def train_case(rank, mesh, inputs, case, out, ckpt_dir):
    import copy

    import torch
    from repro_torch.checkpointing.manager import CheckpointManager
    from repro_torch.data import pipeline
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import train

    cfg = case_config(case)
    model = build_model(cfg)
    opts = train.TrainOptions(remat_policy=None, warmup_steps=1, total_steps=10)
    params = _params(model, inputs, f"{case}/params")
    state = {"params": params, "opt": adamw.init_opt_state(params, opts.opt),
             "step": torch.zeros((), dtype=torch.int32)}
    dc = pipeline.DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    batches = [pipeline.batch_for_step(dc, i, cfg, device="cpu")
               for i in range(TRAIN_STEPS)]
    b_abs = {k: torch.empty(v.shape, device="meta") for k, v in batches[0].items()}
    mstate = train.distribute_train_state(copy.deepcopy(state), model, mesh, opts)
    out[f"{case}/placed_as_state_shardings"] = np.asarray(
        shd.spec_tree_of(mstate) == train.state_shardings(model, mesh, opts))
    _flat(shd.local_tree(mstate["params"]), f"{case}/stored", out)
    if case == "deepseek-moe-16b":        # the files of the sharded state
        CheckpointManager(os.path.join(ckpt_dir, "mesh"),
                          async_save=False).save(0, {"state": mstate})
        if rank == 0:
            CheckpointManager(os.path.join(ckpt_dir, "local"),
                              async_save=False).save(0, {"state": state})
    step = train.jit_train_step(model, opts, mesh, b_abs)
    for i, b in enumerate(batches):
        mstate, met = step(mstate, b)
        for k in ("loss", "grad_norm", "aux_loss"):
            out[f"{case}/mesh/{k}/{i}"] = _np(met[k])
        full = shd.gather_full(mstate["params"])
        if rank == 0:
            _flat(full, f"{case}/mesh/params/{i}", out)
    if case == "deepseek-moe-16b":        # written and restored, re-sharded
        mgr = CheckpointManager(os.path.join(ckpt_dir, "mesh"), async_save=False)
        mgr.save(TRAIN_STEPS, {"state": mstate})
        back, at = mgr.restore({"state": mstate})
        want = shd.gather_full(mstate)
        same = all(torch.equal(a, b) for a, b in zip(
            mesh_ranks._leaves(shd.gather_full(back["state"])),
            mesh_ranks._leaves(want)))
        out["ckpt/restored_bitwise"] = np.asarray(same and at == TRAIN_STEPS)
        out["ckpt/restored_placed"] = np.asarray(
            shd.spec_tree_of(back["state"]) == shd.spec_tree_of(mstate))
    if rank == 0:
        lstep = train.build_train_step(model, opts)
        for i, b in enumerate(batches):
            state, met = lstep(state, b)
            for k in ("loss", "grad_norm", "aux_loss"):
                out[f"{case}/local/{k}/{i}"] = _np(met[k])
            _flat(state["params"], f"{case}/local/params/{i}", out)


def serve_case(rank, mesh, inputs, out):
    import torch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import serve

    model = build_model(case_config(SERVE_CASE))
    params = _params(model, inputs, f"{SERVE_CASE}/params")
    prompts = torch.from_numpy(inputs["serve/prompts"]).long()
    B, P = prompts.shape
    max_len = P + SERVE_NEW
    opts = serve.ServeOptions(kv_dtype=SERVE_KV_DTYPE)
    prefill, _ = serve.jit_prefill_step(model, opts, mesh, B, P)
    decode, _ = serve.jit_decode_step(model, opts, mesh, B, max_len)
    runs = {"mesh": (prefill, decode, serve.shard_params(params, model, mesh),
                     lambda: serve.mesh_cache(model, opts, mesh, B, max_len,
                                              device="cpu"))}
    if rank == 0:
        runs["local"] = (serve.build_prefill_step(model, opts),
                         serve.build_decode_step(model, opts), params,
                         lambda: model.init_cache(
                             B, max_len, device="cpu",
                             kv_dtype=getattr(torch, SERVE_KV_DTYPE)))
    with torch.inference_mode():
        for name, (pre, dec, p, cache_fn) in runs.items():
            last, cache = pre(p, {"tokens": prompts}, cache_fn())
            tok = torch.argmax(last, -1)[:, None]
            toks = [tok]
            for idx in range(P, P + SERVE_NEW - 1):
                tok, last, cache = dec(p, cache, tok, idx)
                toks.append(tok)
            out[f"serve/{name}/tokens"] = torch.cat(toks, 1).numpy()


def rank_main(rank, inputs_path, out_dir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    world = int(np.prod(MESH))
    out = {}
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(MESH, AXES, device_type="cpu")
        out["coordinate"] = np.asarray(mesh.get_coordinate(), np.int64)
        inputs = np.load(inputs_path)
        for dtype in ("float32", "bfloat16"):
            for variant in MOE_VARIANTS:
                mesh_ranks.moe_case(mesh, inputs, dtype, variant, out,
                                    data_axes=DATA_AXES)
        for case in TRAIN_CASES:
            train_case(rank, mesh, inputs, case, out,
                       os.path.join(out_dir, "ckpt"))
        serve_case(rank, mesh, inputs, out)
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
    world = int(np.prod(MESH))
    procs = [ctx.Process(target=rank_main, args=(r, inputs_path, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if codes != [0] * world:
        sys.exit(f"ranks ended with {codes}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
