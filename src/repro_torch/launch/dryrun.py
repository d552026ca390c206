"""Dry-run: trace every (arch x shape x mesh) cell on meta tensors and count
what one step costs a device, with no device at all.

Counterpart of ``src/repro/launch/dryrun.py``. The reference lowers and
compiles each cell's step on 256 or 512 placeholder host devices and reads
``compiled.memory_analysis()``, ``cost_analysis()`` and the optimized HLO.
The port compiles nothing; it runs its own mesh step once, eagerly, as rank
0 of a fake process group (``torch.testing``'s ``fake`` backend) of the
mesh's size, on ``meta`` tensors placed as the production rules place them,
under ``launch/op_cost.py``'s census:

    with fake group of 16 x 16 (or 2 x 16 x 16) ranks:
        state = DTensors of meta shards (state_shardings / SERVING_RULES /
                mesh_cache_specs)
        with OpCensus() as census:
            jit_train_step(...)(state, batch)    # or the prefill / decode step
        census.summary()    # FLOPs, bytes, collectives, kernel calls, peak

Every kernel wrapper takes its kernel's path on meta tensors (outputs of the
kernel's shapes, its cost from the kernel's own counts), never its plain
version. The eager trace runs every layer, so the reference's
``depth_variants`` and ``_extrapolate`` (XLA counts a while-loop body once)
have no counterpart, nor has its HLO parser: the collectives are counted
where ``collectives.py`` issues them, each with the block that issued it.

Per cell it writes a JSON record (``results/dryrun_torch/``) with the
reference's keys where their meaning carries over (``flops_per_device``,
``hbm_bytes_per_device``, ``collective_bytes_per_device``, ``collectives``,
``memory``, ...), and ``kernel_calls``, ``kernel_io``,
``peak_bytes_per_device`` and ``fits_80gb``; ``lower_s`` is the trace's
time.

Usage (on the CPU; the trace touches no card):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k [--multi-pod] [--serving-rules]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from ..configs.base import SHAPE_CELLS, ShapeCell, cell_applicable
from ..configs.registry import ARCH_IDS, get_config
from ..models.model_zoo import build_model
from ..runtime import serve as serve_rt
from ..runtime import sharding as shd
from ..runtime import train as train_rt
from .mesh import production_mesh_shape
from .op_cost import COLLECTIVES, OpCensus

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
DEVICE_BYTES = 80e9          # one H100's memory, as chip_smoke.py holds a step to it


def mesh_name(mesh) -> str:
    return "local" if mesh is None else "x".join(map(str, mesh.shape))


def _inputs(model, cell: ShapeCell) -> dict:
    B, S = cell.global_batch, cell.seq_len

    def tok(b, s, dtype):
        return torch.empty((b, s), dtype=dtype, device="meta")

    if cell.kind == "train":   # int32, as the data pipeline's batches
        return {"tokens": tok(B, S, torch.int32), "labels": tok(B, S, torch.int32),
                **model.extra_inputs(B, S, device="meta")}
    if cell.kind == "prefill":
        return {"tokens": tok(B, S, torch.int64),
                **model.extra_inputs(B, S, device="meta")}
    return {"tokens": tok(B, 1, torch.int64)}  # one new token over S cached


def input_specs(arch: str, shape: str, cfg=None) -> dict:
    """A cell's global inputs as meta tensors: never allocates."""
    cfg = cfg or get_config(arch)
    return _inputs(build_model(cfg), SHAPE_CELLS[shape])


@contextlib.contextmanager
def fake_mesh(mesh):
    """A ``DeviceMesh`` of ``mesh`` (a ``MeshShape``) over a fake process
    group of its size, as rank 0; destroyed on exit. ``None``: no mesh (the
    local path). Refuses to run where a process group is already up."""
    if mesh is None:
        yield None
        return
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from .mesh import make_mesh
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; the dry-run makes "
                           "its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh.shape))
    try:
        yield make_mesh(mesh.shape, mesh.axis_names, device_type="cpu")
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class Trace:
    """One step traced under the census: the census, the memory facts of
    the step's arguments and outputs, and the trace's seconds."""

    census: OpCensus
    memory: dict
    trace_s: float


def _local(tree):
    """The plain tensors a rank holds for a tree of DTensors and tensors."""
    if isinstance(tree, (list, tuple)):
        return [_local(t) for t in tree]
    return shd.local_tree(tree)


def _storage_bytes(tensors) -> dict:
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tensors}


def _step_and_args(model, cell: ShapeCell, mesh, rules, opts_over):
    """The cell's step function and its rank-0 arguments (meta)."""
    B, S = cell.global_batch, cell.seq_len
    inputs = _inputs(model, cell)
    if cell.kind == "train":
        opts = train_rt.TrainOptions(**{"remat_policy": "full",
                                        "microbatches": 1, **opts_over})
        state = train_rt.abstract_train_state(model, opts)
        if mesh is None:
            return train_rt.build_train_step(model, opts), (state, inputs)
        state = shd.distribute(state, train_rt.state_shardings(
            model, mesh, opts, rules), mesh)
        return train_rt.jit_train_step(model, opts, mesh, inputs, rules), \
            (state, inputs)
    opts = serve_rt.ServeOptions(**opts_over)
    enc_len = model.enc_len_for(S)
    if mesh is None:
        params = model.abstract()
        cache = model.init_cache(B, S, enc_len=enc_len, device="meta")
        if cell.kind == "prefill":
            return serve_rt.build_prefill_step(model, opts), \
                (params, inputs, cache)
        decode = serve_rt.build_decode_step(model, opts)
        return decode, (params, cache, inputs["tokens"], S - 1)
    params = serve_rt.shard_params(model.abstract(), model, mesh, rules)
    cache = serve_rt.mesh_cache(model, opts, mesh, B, S, enc_len,
                                device="meta")
    if cell.kind == "prefill":
        fn, _ = serve_rt.jit_prefill_step(model, opts, mesh, B, S, rules=rules)
        return fn, (params, inputs, cache)
    fn, _ = serve_rt.jit_decode_step(model, opts, mesh, B, S, enc_len=enc_len,
                                     rules=rules)
    return fn, (params, cache, inputs["tokens"], S - 1)


def lower_cell(cfg, cell: ShapeCell, mesh=None, *, rules=None,
               opts_over=None) -> Trace:
    """Trace one step of ``cfg`` at ``cell`` on ``mesh`` (a ``MeshShape``,
    rank 0 of a fake group of its size; None: the local path) under the
    census. ``rules`` the rule table (None: the default one), ``opts_over``
    the step's options over the defaults (train: remat "full", one
    microbatch). A serve step's cache holds the cell's sequence; decode
    adds one token at its last position."""
    model = build_model(cfg)
    with fake_mesh(mesh) as dmesh:
        fn, args = _step_and_args(model, cell, dmesh, rules, opts_over or {})
        return trace_step(fn, args, train=cell.kind == "train")


def trace_step(fn, args, *, train: bool) -> Trace:
    """``fn(*args)`` once under a census that counts ``args`` (trees of
    tensors and DTensors) live from the start; a serve step (not ``train``)
    in inference mode, as ``ServeSession`` runs it."""
    census = OpCensus()
    arg_storages = _storage_bytes(_flat(_local(args)))
    census.track(_flat(_local(args)))
    grad = contextlib.nullcontext() if train else torch.inference_mode()
    t0 = time.perf_counter()
    with census, grad:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    outs = _storage_bytes(_flat(_local(out)))
    del out
    arguments = sum(arg_storages.values())
    memory = {"argument_bytes": arguments,
              "output_bytes": sum(outs.values()),
              "temp_bytes": census.peak - arguments,
              "alias_bytes": sum(b for k, b in outs.items() if k in arg_storages)}
    return Trace(census, memory, trace_s)


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def serving_options(cell: ShapeCell, rules=None, opts_over=None):
    """What ``--serving-rules`` sets for a serve cell, as the reference's
    ``run_cell``: ``SERVING_RULES``, ``expert_tp`` and, for decode, a MoE
    capacity cap of 4. A train cell keeps its rules and options."""
    if cell.kind == "train":
        return rules, opts_over
    rules = dict(shd.SERVING_RULES, **(rules or {}))
    opts_over = dict(opts_over or {}, expert_tp=True)
    if cell.kind == "decode":
        opts_over["moe_capacity_cap"] = 4
    return rules, opts_over


def record(trace: Trace) -> dict:
    """The record's cost and memory keys from one trace."""
    s = trace.census.summary()
    coll = s["collectives"]
    peak = trace.census.peak
    return {"lower_s": round(trace.trace_s, 2),
            "flops_per_device": s["flops"],
            "hbm_bytes_per_device": s["bytes"],
            "collective_bytes_per_device": coll["total_bytes"],
            "collectives": {op: coll[op] for op in COLLECTIVES},
            "kernel_io": s["kernel_io"], "kernel_calls": s["kernel_calls"],
            "peak_bytes_per_device": peak, "fits_80gb": peak < DEVICE_BYTES,
            "memory": trace.memory}


def run_cell(arch: str, shape: str, *, multi_pod: bool, rules=None,
             opts_over=None, verbose: bool = True,
             serving_rules: bool = False) -> dict:
    cfg = get_config(arch)
    cell = SHAPE_CELLS[shape]
    mesh = production_mesh_shape(multi_pod=multi_pod)
    if serving_rules:
        rules, opts_over = serving_options(cell, rules, opts_over)
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name(mesh),
                 "kind": cell.kind, "ok": False, "serving_rules": serving_rules}
    if not cell_applicable(cfg, cell):
        rec.update(skipped=True,
                   reason="full-attention arch at 500k ctx (DESIGN.md §4)")
        return rec
    trace = lower_cell(cfg, cell, mesh, rules=rules, opts_over=opts_over)
    model = build_model(cfg)
    rec.update(ok=True, **record(trace),
               params_total=model.param_count(),
               params_active=model.active_param_count(),
               global_batch=cell.global_batch, seq_len=cell.seq_len)
    if verbose:
        print(f"[dryrun] {arch} {shape} {rec['mesh']}: "
              f"trace={rec['lower_s']:.1f}s "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"bytes/dev={rec['hbm_bytes_per_device']:.3e} "
              f"coll/dev={rec['collective_bytes_per_device']:.3e}B "
              f"peak/dev={rec['peak_bytes_per_device']:.3e}B", flush=True)
    return rec


def save_record(rec: dict, out_dir=RESULTS_DIR):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = "_opt" if rec.get("serving_rules") else ""
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{suffix}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=1))


# the table's figures: (column, record key, scale, format)
TABLE_COLUMNS = (("peak GB (of 80)", "peak_bytes_per_device", 1e9, ".1f"),
                 ("TFLOP", "flops_per_device", 1e12, ".4g"),
                 ("HBM GB", "hbm_bytes_per_device", 1e9, ".4g"),
                 ("collective GB", "collective_bytes_per_device", 1e9, ".4g"),
                 ("trace s", "lower_s", 1, ".1f"))


def table(records) -> str:
    """A markdown table of ``records``, a row per (arch, cell), each
    figure per device, per mesh in the records' order ("a / b")."""
    rows: dict = {}
    for r in records:
        rows.setdefault((r["arch"], r["shape"]), []).append(r)
    out = ["| arch | cell | mesh | " + " | ".join(c[0] for c in TABLE_COLUMNS)
           + " |", "|---" * (3 + len(TABLE_COLUMNS)) + "|"]
    for (arch, shape), recs in rows.items():
        meshes = " / ".join(r["mesh"] for r in recs)
        if not all(r.get("ok") for r in recs):
            bad = next(r for r in recs if not r.get("ok"))
            why = f"skipped: {bad['reason']}" if bad.get("skipped") else \
                f"failed: {bad.get('error', '')}"
            out.append(f"| {arch} | {shape} | {meshes} | {why} |"
                       + " |" * (len(TABLE_COLUMNS) - 1))
            continue
        cols = [" / ".join(format(r[key] / scale, fmt) for r in recs)
                for _, key, scale, fmt in TABLE_COLUMNS]
        out.append(f"| {arch} | {shape} | {meshes} | " + " | ".join(cols) + " |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPE_CELLS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--serving-rules", action="store_true",
                    help="the serve-time rule table and expert TP")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = ([(a, s) for a in ARCH_IDS for s in SHAPE_CELLS]
             if args.all else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures, records = [], []
    t0 = time.perf_counter()
    for arch, shape in cells:
        for mp in meshes:
            try:
                rec = run_cell(arch, shape, multi_pod=mp,
                               serving_rules=args.serving_rules)
            except Exception as e:
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape,
                       "mesh": mesh_name(production_mesh_shape(multi_pod=mp)),
                       "ok": False, "error": f"{type(e).__name__}: {e}"}
                failures.append(rec)
            save_record(rec, args.out)
            records.append(rec)
    print(f"\n{len(records)} cells in {time.perf_counter() - t0:.1f} s\n")
    print(table(records))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f["arch"], f["shape"], f["mesh"], "->", f["error"])
        raise SystemExit(1)
    print("all requested dry-run cells passed")


if __name__ == "__main__":
    main()
