"""Run one cell of ``BENCHMARK.json`` once and make its result line.

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its mix in ``traffic/<mix>.json``, the limits of
its check in ``limits/<cell>.json``, each per-layer metric's reader in
``metrics/<metric>.py``, and the configuration's family (its plain
reference and its work formulas) in ``reference/<family>.py``. The mix's
``kind`` picks the runner (``serve.py`` or ``train.py``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import trace, traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(name: str, bench: dict | None = None) -> dict:
    bench = bench or manifest()
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def family(conf: dict):
    """The module ``reference/<family>.py`` that a configuration names by
    its ``reference`` key; ``decoder`` (the dense and MoE decoders) where
    it names none."""
    return importlib.import_module(f".reference.{conf.get('reference', 'decoder')}",
                                   __package__)


def limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    """The module ``metrics/<name>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Context:
    """What a runner gets: the cell's data, the seed and the clocks."""

    cell: dict
    conf: dict
    mix: dict
    seed: int
    seconds: float
    tracer: trace.Tracer
    device: torch.device
    started: float
    fault: object = None          # a test's fault (faults.py), planted by the runner
    setup_s: float = 0.0

    @property
    def model(self) -> dict:
        return self.conf["model"]

    @property
    def family(self):
        return family(self.conf)

    @property
    def param_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.model.get("param_dtype", "bfloat16")]

    def program_config(self):
        from repro_torch.configs.base import ModelConfig, MoEConfig
        fields = dict(self.model)
        moe = fields.pop("moe", None)
        return ModelConfig(**fields, moe=MoEConfig(**moe) if moe else MoEConfig())

    def plant(self, obj):
        """The program's session or step, with ``fault`` planted if any."""
        return self.fault(obj) if self.fault else obj

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def mark_setup(self):
        self.setup_s = time.perf_counter() - self.started

    def reset_peak(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.device.type == "cuda" else 0

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def drive(name: str, seed: int, seconds: float, trace_on: bool, *,
          started: float, device="cuda", fault=None, conf=None, mix=None):
    """Set up cell ``name``, run its window and its check: (context, the
    runner's numbers)."""
    cell = cell_of(name)
    mix = mix or traffic.load(cell["traffic"])
    ctx = Context(cell, conf or config(cell["config"]), mix, seed, seconds,
                  trace.Tracer(trace_on), torch.device(device), started, fault)
    from . import serve, train
    runner = serve if mix["kind"] == "serve" else train
    return ctx, runner.run(ctx)


def run_cell(name: str, seed: int, seconds: float, trace_on: bool, *,
             started: float, device="cuda", fault=None, conf=None,
             mix=None) -> dict:
    """One run of cell ``name``; returns the result line's object."""
    bench = manifest()
    ctx, got = drive(name, seed, seconds, trace_on, started=started,
                     device=device, fault=fault, conf=conf, mix=mix)
    limit = limits(name)
    checks = {k: {"value": v, "limit": limit[k]} for k, v in got["checks"].items()
              if k in limit}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": got["attempted"],
              "failed": got["failed"]}
    if trace_on:
        metrics = per_layer(bench, ctx, got)
    else:
        values = {**got["end_to_end"], "setup_s": ctx.setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if reports(m, name)}
    result["metrics"] = metrics
    result["device"] = device_info(ctx, got, trace_on)
    if trace_on:
        t = ctx.tracer.trace
        result["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
    result["checks"] = checks
    return result


def per_layer(bench: dict, ctx: Context, got: dict) -> dict:
    out = {}
    for m in bench["per_layer"]:
        if not reports(m, ctx.cell["name"]):
            continue
        value = reader(m["name"]).read(ctx, got, ctx.tracer.trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(ctx: Context, got: dict, trace_on: bool) -> dict:
    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": got["run"].peak_bytes}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": got["run"].peak_bytes}
    if trace_on:
        info["busy_s"] = ctx.tracer.trace.busy_s()
        info["window_s"] = ctx.tracer.trace.window_s
    return info
