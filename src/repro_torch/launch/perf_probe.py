"""Perf probe: the collectives and memory contributors of one cell's step.

    PYTHONPATH=src python -m repro_torch.launch.perf_probe --arch X --shape Y

Counterpart of ``src/repro/launch/perf_probe.py``, which reads the
production lowering's HLO and lists its top collectives (on-link bytes,
op, group, trip scale, shape, op name) and top memory contributors. This
one reads ``dryrun.lower_cell``'s trace of the same cell (rank 0 of the
production mesh, on meta tensors): the collectives by on-link bytes per
device, each kind (op, group, shape, issuing site) with its count, the
site being the layer group, block or weight that issued it
(``groups/g0/b0/attn/wo``) where the reference names XLA's op; and the
allocations of at least 1e8 bytes (x2, as the memory traffic counts them)
by op, shape and site. It times nothing.
"""
from __future__ import annotations

import argparse
import collections

from ..configs.base import SHAPE_CELLS
from ..configs.registry import ARCH_IDS, get_config
from .dryrun import lower_cell, serving_options
from .mesh import production_mesh_shape


def probe(arch: str, shape: str, multi_pod: bool = False, top: int = 12,
          rules=None, opts_over=None, serving_rules: bool = False):
    """Print and return (collectives, memory contributors), each a list of
    dicts sorted by bytes, largest first."""
    cell = SHAPE_CELLS[shape]
    if serving_rules:
        rules, opts_over = serving_options(cell, rules, opts_over)
    trace = lower_cell(get_config(arch), cell,
                       production_mesh_shape(multi_pod=multi_pod),
                       rules=rules, opts_over=opts_over)
    census = trace.census

    colls = collections.defaultdict(lambda: {"count": 0, "link_bytes": 0.0})
    for c in census.collectives:
        key = (c["op"], c["group"], str(c["shape"]), c["dtype"], c["site"])
        colls[key]["count"] += 1
        colls[key]["link_bytes"] += c["link_bytes"]
    colls = sorted(({"op": k[0], "group": k[1], "shape": k[2], "dtype": k[3],
                     "site": k[4], **v} for k, v in colls.items()),
                   key=lambda c: -c["link_bytes"])
    mems = collections.defaultdict(lambda: {"count": 0, "bytes": 0})
    for a in census.allocs:
        key = (a["op"], str(a["shape"]), a["site"])
        mems[key]["count"] += 1
        mems[key]["bytes"] += a["bytes"]
    mems = sorted(({"op": k[0], "shape": k[1], "site": k[2], **v}
                   for k, v in mems.items()), key=lambda m: -m["bytes"])

    print(f"== {arch} {shape} — top collectives (on-link B/dev) ==")
    for c in colls[:top]:
        print(f"  {c['link_bytes']:10.3e} {c['op']:14s} g{c['group']:<4d} "
              f"x{c['count']:<5d} {c['dtype']}{c['shape']:<30s} {c['site']}")
    print(f"  TOTAL {sum(c['link_bytes'] for c in colls):.3e} B/dev")
    print("== top memory contributors (allocations >= 1e8 B, x2) ==")
    for m in mems[:top]:
        print(f"  {m['bytes']:10.3e} x{m['count']:<5d} {m['op']:<32s} "
              f"{m['shape']:<30s} {m['site']}")
    print(f"  TOTAL {sum(m['bytes'] for m in mems):.3e} B/dev; peak live "
          f"{census.peak:.3e} B/dev")
    return colls, mems


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=tuple(SHAPE_CELLS), required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--serving-rules", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    probe(args.arch, args.shape, args.multi_pod, args.top,
          serving_rules=args.serving_rules)


if __name__ == "__main__":
    main()
