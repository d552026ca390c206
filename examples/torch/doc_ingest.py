"""Batch document ingest on the port's declarative API: parse -> digest ->
index.

    PYTHONPATH=src python examples/torch/doc_ingest.py

The twin of ``examples/doc_ingest.py`` on ``repro_torch.core`` (it loads
neither ``jax`` nor ``repro``), printing what the reference script prints,
byte for byte; no card is needed. The digest stage fans out over 72
chunks; LLM decode streams the weights once per step regardless of batch
size (the batch roofline, DESIGN.md §7), so below the compute knee batching
is nearly free and constraint choice mostly moves the parse/digest *tiers*
(pypdf vs OCR, 7B vs 104B) while the scheduler co-schedules chunks
aggressively under every objective.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core import MAX_QUALITY, MIN_COST, MIN_LATENCY, Murakkab
from repro_torch.configs.workflow_docingest import make_docingest_job

if __name__ == "__main__":
    for tag, c in [("MIN_COST", MIN_COST), ("MIN_LATENCY", MIN_LATENCY),
                   ("MAX_QUALITY", MAX_QUALITY)]:
        system = Murakkab.paper_cluster()
        result = make_docingest_job(c).execute(system)
        print(f"\n== {tag} ==")
        for tid, cfg in result.plan.configs.items():
            node = result.dag.nodes[tid]
            print(f"  {node.agent:<10s} items={node.work_items:<3d} -> "
                  f"{cfg.impl:<26s} {cfg.pool:<4s} "
                  f"x{cfg.n_devices * cfg.n_instances:<3d} "
                  f"batch={cfg.batch}")
        print(f"  makespan={result.makespan_s:.1f}s "
              f"energy={result.energy_wh:.1f}Wh cost=${result.usd:.4f} "
              f"quality={result.quality:.3f}")
        print(result.trace_str())
