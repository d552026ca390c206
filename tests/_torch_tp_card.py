"""Tensor parallelism on four H100s: one process per card, NCCL.

    python -m torch.distributed.run --nproc-per-node 4 tests/_torch_tp_card.py \\
        [--part equality|full|all] [--out tp_card.json]
    PYTHONPATH=src python tests/_torch_tp_card.py --part predict [--out ...]

(``torchrun --nproc-per-node 4 ...`` is the same launcher.) Imports torch,
the port and ``chip_smoke.py``'s checking helpers; no JAX.

(a) ``equality``: command-r-plus-104b at 4 of 64 layers, deepseek-moe-16b
at 8 of 28 and zamba2-7b at 12 of 81 (two shared attention blocks; its
Mamba2 blocks split by heads over model), full width, bf16, on the (data 1,
model 4) and (2, 2) meshes,
against the one-card local path on the same weights (every rank draws them
from one seed and runs the local path on its own card). Serving: a
4 x 2048 prefill and 8 decode steps fed the local run's greedy tokens; the
mesh run's tokens must equal the local ones and its logits stay within
``chip_smoke.FLOOR_MULT`` x the noise floor of the same run (the largest
difference from the local logits of runs that differ from it only in
rounding: the attention by the naive fp32 oracle with the grouped matmul
summed in two halves of d, and the attention with P rounded to bf16; the
products tensor parallelism splits by rows as four partial sums). The
step-1 loss and every leaf's gradient (B = 2 x 1024, remat full) the same
way. The MoE's routing is the local run's, replayed (each rank its rows),
as chip_smoke's phases hold it: tensor parallelism sums in another order,
and a router near-tie may flip an expert.

(b) ``full``, for the record, on (1, 4): serving command-r-plus-104b at 64 of
64 layers, llama-3.2-vision-90b at 100 of 100 and zamba2-7b at 81 + 13
(4 x 2048-token prompts, 48 new tokens; prefill ms, decode ms a token);
training gemma2-9b (42 layers), stablelm-12b (40), deepseek-moe-16b (28)
and zamba2-7b (81 + 13) at B = 2 x 2048, remat
full, bf16 moments (step s). Each with every rank's peak memory and the
share of the device time in NCCL kernels (torch.profiler over one prefill
or one step). No card holds these models whole to shard them, so each rank
draws its own block of every weight (``draw_block_params``: each block from
a generator seeded by the leaf and the block's index, so a replicated leaf
is the same on every rank); no equality is claimed at full depth.

(c) ``predict``, one process on the CPU, no card and no group: the dry-run
(``repro_torch.launch.dryrun``, meta tensors, rank 0 of a fake group of 4)
of (b)'s paths on (1, 4): one prefill (its cache of the prompt's 2048
positions; (b)'s holds 2096) and one train step, each with its peak live
bytes a rank, its collectives' on-link bytes a rank by op, and its FLOPs.

Rank 0 prints one JSON object a line and writes them all to ``--out``.
"""
import argparse
import contextlib
import datetime
import gc
import json
import math
import os
import statistics
import sys
import time
import zlib
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

EQ_PATHS = (("command-r-plus-104b", 4), ("deepseek-moe-16b", 8),
            ("zamba2-7b", 12))
EQ_MESHES = ((1, 4), (2, 2))
EQ_BATCH, EQ_PROMPT, EQ_DECODE = 4, 2048, 8
EQ_TRAIN_BATCH, EQ_TRAIN_SEQ = 2, 1024
FULL_SERVE = ("command-r-plus-104b", "llama-3.2-vision-90b", "zamba2-7b")
FULL_TRAIN = ("gemma2-9b", "stablelm-12b", "deepseek-moe-16b", "zamba2-7b")
FULL_MESH = (1, 4)
FULL_BATCH, FULL_PROMPT, FULL_NEW = 4, 2048, 48
FULL_TRAIN_BATCH, FULL_TRAIN_SEQ, FULL_TRAIN_STEPS = 2, 2048, 3
PEAK_LIMIT = 80e9
KERNELS = ("flash_attention", "flash_attention_bwd", "moe_gmm", "ssd_scan",
           "ssd_scan_bwd")


class Dev:
    """Where the run is: four cards on NCCL, or (``--rehearse``) four CPU
    processes on gloo at REDUCED width and small shapes, which finds a
    wrong path before a four-card call; it measures nothing."""

    def __init__(self, rehearse: bool = False):
        self.rehearse = rehearse
        self.device = "cpu" if rehearse else "cuda"
        if rehearse:
            global EQ_BATCH, EQ_PROMPT, EQ_DECODE, EQ_TRAIN_SEQ
            global FULL_BATCH, FULL_PROMPT, FULL_NEW, FULL_TRAIN_SEQ
            EQ_BATCH, EQ_PROMPT, EQ_DECODE, EQ_TRAIN_SEQ = 4, 16, 4, 16
            FULL_BATCH, FULL_PROMPT, FULL_NEW, FULL_TRAIN_SEQ = 4, 16, 4, 16

    def config(self, arch):
        from repro_torch.configs.registry import get_config
        return get_config(arch, reduced=self.rehearse)

    def sync(self):
        import torch
        if not self.rehearse:
            torch.cuda.synchronize()

    def free(self):
        import torch
        gc.collect()
        if not self.rehearse:
            torch.cuda.empty_cache()

    def reset_peak(self):
        import torch
        if not self.rehearse:
            torch.cuda.reset_peak_memory_stats()


DEV = Dev()


class Out:
    """Rank 0's lines: printed and kept for ``--out``."""

    def __init__(self, rank, path):
        self.rank, self.path, self.lines = rank, path, []

    def emit(self, obj):
        if self.rank == 0:
            self.lines.append(obj)
            print(json.dumps(obj), flush=True)

    def close(self):
        if self.rank == 0 and self.path:
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
            Path(self.path).write_text(json.dumps(self.lines, indent=1))


def _sync_s(fn):
    DEV.sync()
    t0 = time.perf_counter()
    out = fn()
    DEV.sync()
    return out, time.perf_counter() - t0


def _peaks() -> list:
    """Every rank's peak allocated bytes since the last reset (0 when
    rehearsing)."""
    import torch
    import torch.distributed as dist
    peak = 0.0 if DEV.rehearse else float(torch.cuda.max_memory_allocated())
    mine = torch.tensor([peak], device=DEV.device)
    out = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return [float(t.item()) for t in out]


def _nccl_share(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its wall time, the kernels'
    summed device time, the share of that in NCCL kernels, and the idle
    share of the wall time (kernels of both streams summed, so an overlap
    of a collective with compute counts twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    if DEV.rehearse:
        fn()
        return {}
    DEV.sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        DEV.sync()
        wall = time.perf_counter() - t0
    total = nccl = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = cs._self_device_us(ev)
        total += us
        if "nccl" in ev.key.lower():
            nccl += us
    return {"wall_ms": 1e3 * wall, "device_ms": total / 1e3,
            "nccl_ms": nccl / 1e3, "nccl_share": nccl / total if total else None,
            "idle_share": max(0.0, 1 - total / 1e6 / wall)}


# ---------------------------------------------------------------------------
# (a) equality
# ---------------------------------------------------------------------------


def _shards(model, meshes) -> list:
    """The data-axis sizes whose local baseline differs: the MoE's capacity
    is a data shard's (the EP body routes each shard's tokens with its own
    capacity, as the reference's does), so on a mesh with data d its
    baseline is the local path run on each of the d shards' rows; a dense
    model's one baseline serves every mesh."""
    if model.cfg.family != "moe":
        return [1]
    return sorted({shape[0] for shape in meshes})


def _norm(g, w=None) -> float:
    """The 2-norm of ``g`` (of ``g - w``; either anywhere), in fp32 over
    1e8 values at a time: the embedding's gradient alone is 12 GB in
    fp32 at command-r's width."""
    import torch
    gf, step, total = g.reshape(-1), int(1e8), 0.0
    wf = None if w is None else w.reshape(-1)
    for i in range(0, gf.numel(), step):
        d = gf[i:i + step].to(DEV.device).float()
        if wf is not None:
            d -= wf[i:i + step].to(DEV.device).float()
        total += float(torch.dot(d, d))
    return math.sqrt(total)


def _diff(got, want) -> tuple:
    d = (got.float() - want.float())
    return d.abs().max().item(), (d.norm() / want.float().norm().clamp_min(1e-30)).item()


def _eq_model(arch, layers):
    import torch
    import chip_smoke as cs
    from repro_torch.models.model_zoo import build_model
    model = build_model(DEV.config(arch).replace(
        n_layers=min(layers, DEV.config(arch).n_layers)))
    gen = torch.Generator(device=DEV.device)
    gen.manual_seed(0)
    params = model.init(gen)
    cs.scale_routed_experts(model, params)
    return model, params


def _variants():
    """The rounding-only floor runs of the local path: (name, context).
    chip_smoke's two (the attention by the naive fp32 oracle with the
    grouped matmul summed in two halves of d; the attention with P rounded
    to bf16), and the products that tensor parallelism splits by rows
    summed as four partial products, each rounded to the activation dtype
    (the rounding a psum of bf16 partial sums adds, on one card), the
    Mamba2 blocks' ``out_proj`` too."""
    import chip_smoke as cs
    return [("naive_split_d", lambda: _ops(cs.naive_attention, cs.split_d_gmm)),
            ("p_bf16", lambda: _ops(cs.p_bf16_attention, cs.plain_gmm)),
            ("rows_in_4_partial_sums", lambda: _row_partials(4))]


@contextlib.contextmanager
def _ops(attention=None, gmm=None):
    from repro_torch.kernels import ops
    with mock.patch.object(ops, "flash_attention", attention or ops.flash_attention), \
            mock.patch.object(ops, "gmm", gmm or ops.gmm):
        yield


@contextlib.contextmanager
def _row_partials(m: int):
    """Attention's ``wo``, the MLP's ``w_down`` (the shared experts' too)
    and the Mamba2 blocks' ``out_proj`` products as ``m`` partial products
    over blocks of the contracted dim, each in the activation dtype, summed
    in order."""
    import torch.nn.functional as F
    from repro_torch.models import attention, ffn, moe, ssm, transformer
    from repro_torch.models.common import rms_norm

    def mm(x, w):
        k = w.shape[0] // m
        out = x[..., :k] @ w[:k]
        for i in range(1, m):
            out = out + x[..., i * k:(i + 1) * k] @ w[i * k:(i + 1) * k]
        return out

    def out_proj(p, o, cfg, tp=None):
        B, S = o.shape[:2]
        out = mm(o.reshape(B, S, -1), p["wo"].reshape(-1, p["wo"].shape[-1]))
        return out + p["bo"] if cfg.use_bias else out

    def mlp(p, x, *, cfg, tp=None):
        g, u = x @ p["w_gate"], x @ p["w_up"]
        if cfg.use_bias:
            g, u = g + p["b_gate"], u + p["b_up"]
        out = mm(ffn._act(cfg.mlp_act)(g) * u, p["w_down"])
        return out + p["b_down"] if cfg.use_bias else out

    def gated_out(p, y, z, tp, d_inner):
        g = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"])
        return mm(g, p["out_proj"])

    with mock.patch.object(attention, "_out", out_proj), \
            mock.patch.object(transformer, "apply_ffn", mlp), \
            mock.patch.object(moe, "apply_ffn", mlp), \
            mock.patch.object(ssm, "_gated_out", gated_out):
        yield


def eq_serve(out, arch, layers, meshes):
    """Tokens and logits of the mesh serve steps against the local ones,
    each mesh's within FLOOR_MULT x the floor runs' differences."""
    import torch
    import chip_smoke as cs
    from repro_torch.runtime import serve

    model, params = _eq_model(arch, layers)
    moe = model.cfg.family == "moe"
    gen = torch.Generator(device=DEV.device)
    gen.manual_seed(1)
    prompts = torch.randint(0, model.cfg.vocab_size, (EQ_BATCH, EQ_PROMPT),
                            generator=gen, device=DEV.device)
    opts = serve.ServeOptions()
    max_len = EQ_PROMPT + EQ_DECODE

    def run(prefill, decode, p, cache, rows, tokens=None):
        """Last logits of the prefill of ``prompts[rows]`` and of each
        decode step fed ``tokens`` (the greedy ones of this run when None),
        and the greedy tokens."""
        logits, toks = [], []
        with torch.inference_mode():
            last, cache = prefill(p, {"tokens": prompts[rows]}, cache)
            for i in range(EQ_DECODE + 1):
                logits.append(last.float().clone())
                toks.append(torch.argmax(last, -1)[:, None])
                if i == EQ_DECODE:
                    break
                feed = toks[-1] if tokens is None else tokens[:, i:i + 1]
                _, last, cache = decode(p, cache, feed, EQ_PROMPT + i)
        DEV.sync()
        return torch.stack(logits), torch.cat(toks, 1)

    local = (serve.build_prefill_step(model, opts),
             serve.build_decode_step(model, opts))

    def by_shards(d, replays, context=contextlib.nullcontext, tokens=None):
        """The local run on each of d row shards, joined along the batch;
        each shard's routing recorded into (or replayed from) ``replays``."""
        n = EQ_BATCH // d
        parts = []
        for i in range(d):
            rows = slice(i * n, (i + 1) * n)
            cache = model.init_cache(n, max_len, device=DEV.device)
            with context(), (replays[i].patch() if moe else contextlib.nullcontext()):
                parts.append(run(*local, params, cache, rows,
                                 None if tokens is None else tokens[rows]))
        return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts])

    base = {}
    for d in _shards(model, meshes):
        replays = [cs.RoutingReplay() if moe else None for _ in range(d)]
        want, want_tok = by_shards(d, replays)
        floors = {name: _diff(by_shards(d, replays, variant, want_tok)[0], want)
                  for name, variant in _variants()}
        base[d] = (want, want_tok, replays, floors)
    for shape in meshes:
        mesh = meshes[shape]
        want, want_tok, replays, floors = base[shape[0] if moe else 1]
        floor_abs = max(f[0] for f in floors.values())
        floor_rel = max(f[1] for f in floors.values())
        prefill, _ = serve.jit_prefill_step(model, opts, mesh, EQ_BATCH, EQ_PROMPT)
        decode, _ = serve.jit_decode_step(model, opts, mesh, EQ_BATCH, max_len)
        sharded = serve.shard_params(params, model, mesh)
        cache = serve.mesh_cache(model, opts, mesh, EQ_BATCH, max_len, device=DEV.device)
        # a rank routes its data shard's tokens: that shard's recording
        replay = replays[mesh.get_coordinate()[0]] if moe else None
        cs.reset_launches()
        with (replay.patch() if moe else contextlib.nullcontext()):
            (got, tok), s = _sync_s(lambda: run(prefill, decode, sharded, cache,
                                                slice(None), want_tok))
        launches = cs.read_launches()
        d_abs, d_rel = _diff(got, want)
        # chip_smoke phase 4's rule: the argmax equal wherever the local
        # run's top-2 margin exceeds the logit limit (random weights over a
        # 256 000-word vocabulary leave near-ties the rounding may flip)
        top2 = want.topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > cs.FLOOR_MULT * floor_abs
        same = got.argmax(-1) == want.argmax(-1)
        tokens_equal = torch.equal(tok, want_tok)
        ok = bool(same[decided].all()) and d_abs <= cs.FLOOR_MULT * floor_abs \
            and d_rel <= cs.FLOOR_MULT * floor_rel and (
                DEV.rehearse or launches["flash_attention"] > 0)
        ok = _all_ranks(ok)
        out.emit({"part": "equality", "what": "serve", "arch": arch,
                  "n_layers": model.cfg.n_layers,
                  "mesh": {"data": shape[0], "model": shape[1]},
                  "batch": EQ_BATCH, "prompt_len": EQ_PROMPT,
                  "decode_steps": EQ_DECODE,
                  "local_run_on_row_shards": shape[0] if moe else 1,
                  "tokens_equal": tokens_equal,
                  "argmax_decided": int(decided.sum()),
                  "argmax_equal_where_decided": int(same[decided].sum()),
                  "argmax_equal_all": int(same.sum()), "argmax_all": same.numel(),
                  "within_chip_smoke_floors": d_abs <= cs.FLOOR_MULT * max(
                      floors["naive_split_d"][0], floors["p_bf16"][0]) and
                  d_rel <= cs.FLOOR_MULT * max(floors["naive_split_d"][1],
                                               floors["p_bf16"][1]),
                  "logits_max_abs_diff": d_abs, "logits_rel_diff": d_rel,
                  "floor_abs": floor_abs, "floor_rel": floor_rel,
                  "floor_runs": floors, "floor_mult": cs.FLOOR_MULT,
                  "mesh_run_s": s,
                  "launches": {k: launches[k] for k in
                               ("flash_attention", "gmm", "ssd_scan")},
                  "ok": ok})
        if not ok:
            raise AssertionError(f"{arch} serve on {shape}: not within the floor")
        del sharded, cache, got
        DEV.free()


def _all_ranks(ok: bool) -> bool:
    import torch
    import torch.distributed as dist
    t = torch.tensor([0.0 if ok else 1.0], device=DEV.device)
    dist.all_reduce(t)
    return t.item() == 0.0


def eq_train(out, arch, layers, meshes):
    """Step 1's loss and every leaf's gradient of the mesh grad step against
    the local one, each within FLOOR_MULT x its floor."""
    import torch
    from torch.distributed.tensor import DTensor
    import chip_smoke as cs
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import train as train_rt
    from repro_torch.tree import leaves_with_path

    model, params = _eq_model(arch, layers)
    moe = model.cfg.family == "moe"
    opts = train_rt.TrainOptions(remat_policy="full",
                                 opt=adamw.AdamWConfig(moment_dtype="bfloat16"))
    batch = batch_for_step(DataConfig(model.cfg.vocab_size, EQ_TRAIN_SEQ,
                                      EQ_TRAIN_BATCH), 0, model.cfg, device=DEV.device)
    local_fn = train_rt.build_grad_fn(model, opts)

    def local_grads(d, replays, context=contextlib.nullcontext):
        """The mean over d row shards of the local step-1 gradients (by
        leaf path) and losses; every shard's gradients but the last wait in
        host memory."""
        n = EQ_TRAIN_BATCH // d
        acc, loss = {}, 0.0
        for i in range(d):
            rows = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            with context(), (replays[i].patch() if moe else contextlib.nullcontext()):
                grads, m = local_fn(params, rows)
            loss += float(m["loss"]) / d
            for p, g in leaves_with_path(grads):
                k = "/".join(p)
                if k in acc:
                    g.add_(acc[k].to(g.device))
                acc[k] = g if i == d - 1 else g.to("cpu")
            del grads
            DEV.free()
        return {k: g.div_(d) for k, g in acc.items()}, loss

    base = {}
    for d in _shards(model, meshes):
        replays = [cs.RoutingReplay() if moe else None for _ in range(d)]
        want, want_loss = local_grads(d, replays)
        norms = {k: _norm(g) for k, g in want.items()}
        # the local gradients wait in host memory (19 GB at command-r's 4
        # layers: beside the params and a floor run's gradients they would
        # not fit a card), each leaf's chunks brought back to be compared
        want = {k: g.to("cpu") for k, g in want.items()}
        DEV.free()
        loss_floor, leaf_floor = 0.0, dict.fromkeys(want, 0.0)
        for name, variant in _variants():
            if name == "rows_in_4_partial_sums":   # chip_smoke's floors alone
                cs_floors = (loss_floor, dict(leaf_floor))
            grads, loss = local_grads(d, replays, variant)
            loss_floor = max(loss_floor, abs(loss - want_loss))
            for k, g in grads.items():
                leaf_floor[k] = max(leaf_floor[k],
                                    _norm(g, want[k]) / max(norms[k], 1e-30))
            del grads
            DEV.free()
        base[d] = (want, want_loss, norms, replays, loss_floor, leaf_floor,
                   cs_floors)
    for shape in meshes:
        mesh = meshes[shape]
        want, want_loss, norms, replays, loss_floor, leaf_floor, cs_floors = \
            base[shape[0] if moe else 1]
        sharded = shd.distribute(params, train_rt.state_shardings(
            model, mesh, opts)["params"], mesh)
        stored = shd.spec_tree_of(sharded)
        fn = train_rt.build_grad_fn(model, opts, mesh)
        replay = replays[mesh.get_coordinate()[0]] if moe else None
        cs.reset_launches()
        with (replay.patch() if moe else contextlib.nullcontext()):
            (grads, m), s = _sync_s(lambda: fn(shd.local_tree(sharded), batch, stored))
        launches = cs.read_launches()
        loss_diff = abs(float(m["loss"]) - want_loss)
        worst, ratios = ("", 0.0), []
        for p, g in leaves_with_path(grads):
            k = "/".join(p)
            full = DTensor.from_local(g, mesh, shd.placements(
                shd.tree_at(stored, p), mesh), run_check=False).full_tensor()
            r = _norm(full, want[k]) / max(norms[k], 1e-30) / \
                max(cs.FLOOR_MULT * leaf_floor[k], 1e-30)
            ratios.append(r)
            if r > worst[1]:
                worst = (k, r)
            del full
        ok = loss_diff <= cs.FLOOR_MULT * loss_floor and max(ratios) <= 1.0 and \
            (DEV.rehearse or launches["flash_attention_bwd"] > 0)
        within_cs = loss_diff <= cs.FLOOR_MULT * cs_floors[0] and all(
            r * leaf_floor[k] <= cs_floors[1][k] for k, r in zip(want, ratios))
        ok = _all_ranks(ok)
        out.emit({"part": "equality", "what": "train_step1", "arch": arch,
                  "n_layers": model.cfg.n_layers,
                  "mesh": {"data": shape[0], "model": shape[1]},
                  "batch": EQ_TRAIN_BATCH, "seq": EQ_TRAIN_SEQ,
                  "local_run_on_row_shards": shape[0] if moe else 1,
                  "loss": float(m["loss"]), "local_loss": want_loss,
                  "loss_diff": loss_diff, "loss_floor": loss_floor,
                  "within_chip_smoke_floors": within_cs,
                  "worst_leaf": worst[0],
                  "worst_leaf_over_limit": worst[1], "leaves": len(ratios),
                  "floor_mult": cs.FLOOR_MULT, "grad_s": s,
                  "launches": {k: launches[k] for k in
                               ("flash_attention", "flash_attention_bwd", "gmm",
                                "gmm_bwd", "ssd_scan", "ssd_scan_bwd")},
                  "ok": ok})
        if not ok:
            raise AssertionError(f"{arch} train on {shape}: not within the floor")
        del sharded, grads
        DEV.free()


# ---------------------------------------------------------------------------
# (b) full depth
# ---------------------------------------------------------------------------


def draw_block_params(model, mesh, rules, seed: int = 0):
    """The rank's block of every weight, placed by ``rules``, as DTensors:
    drawn as ``init_params`` draws the whole weight (its kind, and the
    whole weight's fan-in for the scale), from a generator seeded by the
    leaf's path and the block's index on the dims' mesh axes."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.models.common import _fan_in, dtype_of
    from repro_torch.runtime import sharding as shd
    from repro_torch.tree import leaves_with_path, with_empty

    specs = shd.tree_shardings(model.axes(), model.abstract(), mesh, rules)
    sizes = shd.mesh_sizes(mesh)
    coord = dict(zip(shd.axis_names(mesh), mesh.get_coordinate()))
    out = {}
    gen = torch.Generator(device=DEV.device)
    for path, s in leaves_with_path(model.specs):
        spec = shd.tree_at(specs, path)
        shape, block = list(s.shape), []
        for dim, entry in enumerate(spec):
            n, idx = 1, 0
            for a in shd.spec_axes(entry):
                n, idx = n * sizes[a], idx * sizes[a] + coord[a]
            shape[dim] //= n
            block.append(idx)
        dt = s.dtype or dtype_of(model.cfg.param_dtype)
        if s.init == "zeros":
            t = torch.zeros(shape, dtype=dt, device=DEV.device)
        elif s.init == "ones":
            t = torch.ones(shape, dtype=dt, device=DEV.device)
        else:
            std = (s.scale or 1.0) if s.init == "embed" else \
                (s.scale or 1.0 / math.sqrt(_fan_in(s.shape, s.axes)))
            gen.manual_seed(zlib.crc32(f"{seed}/{'/'.join(path)}/{block}".encode()))
            # drawn in fp32 about 1e8 values at a time along dim 0:
            # command-r's stacked w_up block alone is 27 GB in fp32
            t = torch.empty(shape, dtype=dt, device=DEV.device)
            rows = max(1, int(1e8) // max(1, math.prod(shape[1:])))
            for part in t.split(rows) if shape else [t]:
                part.copy_(torch.randn(part.shape, generator=gen,
                                       device=DEV.device).mul_(std))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = DTensor.from_local(t, mesh, shd.placements(spec, mesh),
                                            run_check=False)
    return with_empty(model.specs, out)


def _scale_experts(model, params):
    """chip_smoke's routed-expert scale, on each rank's blocks."""
    import torch
    if model.cfg.family != "moe":
        return
    scale = math.sqrt(model.cfg.moe.num_experts)
    with torch.no_grad():
        for group in params["groups"].values():
            for block in group.values():
                if "moe" in block:
                    for name in ("w_gate", "w_up", "w_down"):
                        block["moe"][name].to_local().mul_(scale)


def full_serve(out, arch, mesh):
    import torch
    import chip_smoke as cs
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import serve
    from repro_torch.runtime import sharding as shd

    cfg = DEV.config(arch)
    model = build_model(cfg)
    DEV.reset_peak()
    params = draw_block_params(model, mesh, shd.SERVING_RULES)
    gen = torch.Generator(device=DEV.device)
    gen.manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (FULL_BATCH, FULL_PROMPT),
                            generator=gen, device=DEV.device)
    extras = model.extra_inputs(FULL_BATCH, FULL_PROMPT, device="cpu") \
        if DEV.rehearse else cs.path_extras(cfg, FULL_BATCH, gen)
    enc_len = serve.cross_len(extras)
    opts = serve.ServeOptions()
    max_len = FULL_PROMPT + FULL_NEW
    prefill, _ = serve.jit_prefill_step(model, opts, mesh, FULL_BATCH, FULL_PROMPT)
    decode, _ = serve.jit_decode_step(model, opts, mesh, FULL_BATCH, max_len, enc_len)
    inputs = {"tokens": prompts, **extras}

    def generate():
        cache = serve.mesh_cache(model, opts, mesh, FULL_BATCH, max_len, enc_len,
                                 device=DEV.device)
        with torch.inference_mode():
            last, cache = prefill(params, inputs, cache)
            tok = torch.argmax(last, -1)[:, None]
            toks = [tok]
            for idx in range(FULL_PROMPT, max_len - 1):
                tok, last, cache = decode(params, cache, tok, idx)
                toks.append(tok)
        return torch.cat(toks, 1)

    def prefill_once():
        cache = serve.mesh_cache(model, opts, mesh, FULL_BATCH, max_len, enc_len,
                                 device=DEV.device)
        with torch.inference_mode():
            return prefill(params, inputs, cache)

    _sync_s(prefill_once)                         # first use: kernel loads
    pre_s = [_sync_s(prefill_once)[1] for _ in range(2)]
    toks, gen_s = _sync_s(generate)
    prefill_ms = 1e3 * statistics.median(pre_s)
    decode_ms = (1e3 * gen_s - prefill_ms) / (FULL_NEW - 1)
    share = _nccl_share(prefill_once)
    peaks = _peaks()
    ok = toks.shape == (FULL_BATCH, FULL_NEW) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all()) and max(peaks) < PEAK_LIMIT
    ok = _all_ranks(ok)
    out.emit({"part": "full", "what": "serve", "arch": arch,
              "n_layers": cfg.n_layers, "params": model.param_count(),
              "mesh": {"data": 1, "model": 4}, "batch": FULL_BATCH,
              "prompt_len": FULL_PROMPT, "enc_len": enc_len or None,
              "max_new": FULL_NEW, "prefill_ms": prefill_ms,
              "prefill_ms_runs": [1e3 * s for s in pre_s],
              "decode_ms_per_token": decode_ms, "generate_s": gen_s,
              "peak_bytes_by_rank": peaks, "prefill_profile": share, "ok": ok})
    if not ok:
        raise AssertionError(f"{arch} full-depth serve failed")
    del params
    DEV.free()


def full_train(out, arch, mesh):
    import torch
    from torch.distributed.tensor import DTensor
    import chip_smoke as cs
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import train as train_rt
    from repro_torch.tree import unflatten, leaves

    cfg = DEV.config(arch)
    model = build_model(cfg)
    opts = train_rt.TrainOptions(
        remat_policy="full", warmup_steps=cs.TRAIN_WARMUP,
        total_steps=FULL_TRAIN_STEPS,
        opt=adamw.AdamWConfig(lr=cs.TRAIN_LR, moment_dtype="bfloat16"))
    DEV.reset_peak()
    params = draw_block_params(model, mesh, None)
    _scale_experts(model, params)
    want = train_rt.state_shardings(model, mesh, opts)

    def placed(tree, specs):
        return unflatten(tree, (DTensor.from_local(t, mesh, shd.placements(s, mesh),
                                                   run_check=False)
                                for t, s in zip(leaves(tree), leaves(
                                    specs, is_leaf=lambda x: isinstance(x, tuple)))))

    opt = adamw.init_opt_state(shd.local_tree(params), opts.opt)
    state = {"params": params,
             "opt": {"m": placed(opt["m"], want["opt"]["m"]),
                     "v": placed(opt["v"], want["opt"]["v"]),
                     "count": DTensor.from_local(opt["count"], mesh,
                                                 shd.placements((), mesh),
                                                 run_check=False)},
             "step": DTensor.from_local(torch.zeros((), dtype=torch.int32,
                                                    device=DEV.device), mesh,
                                        shd.placements((), mesh), run_check=False)}
    dc = DataConfig(cfg.vocab_size, FULL_TRAIN_SEQ, FULL_TRAIN_BATCH)
    batches = [batch_for_step(dc, i, cfg, device=DEV.device)
               for i in range(FULL_TRAIN_STEPS + 1)]
    b_abs = {k: torch.empty(v.shape, device="meta") for k, v in batches[0].items()}
    step = train_rt.jit_train_step(model, opts, mesh, b_abs)
    losses, step_s = [], []
    for b in batches[:FULL_TRAIN_STEPS]:
        (state, met), s = _sync_s(lambda: step(state, b))
        losses.append(float(met["loss"]))
        step_s.append(s)
    holder = {}

    def one_step():
        holder["state"], holder["met"] = step(state, batches[-1])

    share = _nccl_share(one_step)
    peaks = _peaks()
    ok = all(math.isfinite(v) for v in losses) and max(peaks) < PEAK_LIMIT
    ok = _all_ranks(ok)
    out.emit({"part": "full", "what": "train", "arch": arch,
              "n_layers": cfg.n_layers, "params": model.param_count(),
              "mesh": {"data": 1, "model": 4}, "batch": FULL_TRAIN_BATCH,
              "seq": FULL_TRAIN_SEQ, "remat": "full", "moments": "bfloat16",
              "losses": losses, "step_s": step_s,
              "step_s_median_after_first": statistics.median(step_s[1:]),
              "peak_bytes_by_rank": peaks, "step_profile": share, "ok": ok})
    if not ok:
        raise AssertionError(f"{arch} full-depth train failed")
    del state, params, holder
    DEV.free()


def predict(out_path: str) -> None:
    """Part (c): the dry-run of the full-depth paths on (1, 4)."""
    import chip_smoke as cs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    mesh = shd.MeshShape(("data", "model"), FULL_MESH)
    out = Out(0, out_path)
    train_opts = dict(remat_policy="full", warmup_steps=cs.TRAIN_WARMUP,
                      total_steps=FULL_TRAIN_STEPS,
                      opt=adamw.AdamWConfig(lr=cs.TRAIN_LR, moment_dtype="bfloat16"))
    paths = [(a, ShapeCell("prefill", FULL_PROMPT, FULL_BATCH, "prefill"),
              shd.SERVING_RULES, None) for a in FULL_SERVE] + \
        [(a, ShapeCell("train", FULL_TRAIN_SEQ, FULL_TRAIN_BATCH, "train"),
          None, train_opts) for a in FULL_TRAIN]
    try:
        for arch, cell, rules, opts_over in paths:
            trace = dryrun.lower_cell(get_config(arch), cell, mesh, rules=rules,
                                      opts_over=opts_over)
            rec = dryrun.record(trace)
            out.emit({"part": "predict", "what": cell.kind, "arch": arch,
                      "mesh": {"data": 1, "model": 4},
                      "batch": cell.global_batch, "seq": cell.seq_len,
                      "peak_bytes": rec["peak_bytes_per_device"],
                      "collective_bytes": rec["collective_bytes_per_device"],
                      "collectives": {op: c for op, c in rec["collectives"].items()
                                      if c["count"]},
                      "flops": rec["flops_per_device"],
                      "kernel_calls": rec["kernel_calls"],
                      "trace_s": rec["lower_s"]})
    finally:
        out.close()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--part", choices=("equality", "full", "all", "predict"),
                        default="all")
    parser.add_argument("--out", default="")
    parser.add_argument("--rehearse", action="store_true",
                        help="four CPU processes on gloo, REDUCED, small shapes")
    args = parser.parse_args()
    if args.part == "predict":
        return predict(args.out)
    import torch
    import torch.distributed as dist
    global DEV
    DEV = Dev(args.rehearse)
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    timeout = datetime.timedelta(seconds=600)
    if DEV.rehearse:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", timeout=timeout)
    else:
        torch.cuda.set_device(local)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("nccl", device_id=torch.device("cuda", local),
                                timeout=timeout)
    out = Out(rank, args.out)
    try:
        if dist.get_world_size() != 4:
            raise SystemExit("needs four processes, one a card")
        from repro_torch.kernels import _build
        from repro_torch.launch.mesh import make_mesh
        if local == 0 and not DEV.rehearse:   # each library once, in parallel
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(len(KERNELS)) as pool:
                list(pool.map(_build.build, KERNELS))
        dist.barrier()
        import chip_smoke as cs
        if not DEV.rehearse:
            out.emit({"card": cs.card_line(), "cards": torch.cuda.device_count(),
                      "kind": torch.cuda.get_device_name(0)})
        meshes = {s: make_mesh(s, ("data", "model"), device_type=DEV.device)
                  for s in EQ_MESHES}
        if args.part in ("equality", "all"):
            for arch, layers in EQ_PATHS:
                eq_serve(out, arch, layers, meshes)
                eq_train(out, arch, layers, meshes)
        if args.part in ("full", "all"):
            mesh = meshes[FULL_MESH]
            for arch in FULL_SERVE:
                full_serve(out, arch, mesh)
            for arch in FULL_TRAIN:
                full_train(out, arch, mesh)
        out.emit({"ok": True})
    finally:
        out.close()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
