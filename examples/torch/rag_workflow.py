"""Agentic RAG on the port's declarative API: retrieval routing by
constraint.

    PYTHONPATH=src python examples/torch/rag_workflow.py

The twin of ``examples/rag_workflow.py`` on ``repro_torch.core`` (it loads
neither ``jax`` nor ``repro``), printing what the reference script prints,
byte for byte; no card is needed. The same four-stage workflow (retrieve ->
rerank -> synthesize -> index) executes three ways without changing its
definition: MIN_COST routes retrieval to lexical BM25 on CPU cores,
MAX_QUALITY pays for hybrid retrieval and an LLM reranker, and a
Deadline(30s)+MinEnergy ordering finds the lowest-energy plan that meets
the SLO.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core import (Deadline, Lexicographic, MAX_QUALITY, MIN_COST,
                              MinEnergy, Murakkab)
from repro_torch.configs.workflow_rag import make_rag_job


def run(tag, constraints):
    system = Murakkab.paper_cluster()
    result = make_rag_job(constraints).execute(system)
    print(f"\n== {tag} ==")
    for tid, cfg in result.plan.configs.items():
        agent = result.dag.nodes[tid].agent
        print(f"  {agent:<12s} -> {cfg.impl:<22s} {cfg.pool:<4s} "
              f"x{cfg.n_devices * cfg.n_instances:<3d} batch={cfg.batch}")
    print(f"  makespan={result.makespan_s:.1f}s "
          f"energy={result.energy_wh:.1f}Wh cost=${result.usd:.4f} "
          f"quality={result.quality:.3f}")
    return result


if __name__ == "__main__":
    cheap = run("MIN_COST (keyword route)", MIN_COST)
    best = run("MAX_QUALITY (hybrid route)", MAX_QUALITY)
    slo = run("Deadline(30s) then MinEnergy",
              Lexicographic(Deadline(s=30.0), MinEnergy()))
    print(f"\nrouting lever: quality {cheap.quality:.3f} -> "
          f"{best.quality:.3f} for {best.usd / max(cheap.usd, 1e-9):.1f}x "
          f"the cost; SLO plan meets {slo.makespan_s:.1f}s <= 30s-ish "
          f"while spending {slo.energy_wh:.1f}Wh")
