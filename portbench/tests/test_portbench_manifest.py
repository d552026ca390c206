"""BENCHMARK.json against the contract's rules of form, and every name in
it found as a file of its own."""
import ast
import json
import re
from pathlib import Path

import pytest

from portbench import harness, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/")


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_each_configuration_has_a_cell_and_a_file():
    used = {c["config"] for c in BENCH["workloads"]}
    for conf in BENCH["configs"]:
        assert conf["name"] in used
        path = ROOT / conf["file"]
        assert path.is_file() and conf["file"].startswith("portbench/")
        assert json.loads(path.read_text())["name"] == conf["name"]
        assert json.loads(path.read_text())["reduced"] == conf["reduced"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_and_metrics(cell):
    assert cell["chips"] == 1
    assert traffic.load(cell["traffic"])["kind"] in ("serve", "train")
    assert harness.limits(cell["name"])
    e2e = [m for m in BENCH["end_to_end"] if harness.reports(m, cell["name"])]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    layers = [m for m in BENCH["per_layer"] if harness.reports(m, cell["name"])]
    assert layers
    for m in layers:       # every layer metric's cells report what it moves
        assert m["moves"] in [e["name"] for e in e2e]


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in METRICS:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_reader_declares_what_the_manifest_says(metric):
    mod = harness.reader(metric["name"])
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (metric["layer"], metric["unit"],
                                                 metric["moves"])
    tree = ast.parse((ROOT / "portbench" / "metrics" / f"{metric['name']}.py").read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body)
    if metric["name"].endswith("_roofline"):
        assert mod.KERNELS and metric["unit"] == "%"
