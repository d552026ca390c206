"""Document-ingest workflow: parse -> digest (batch summarize) -> index.

The second scenario built purely on the declarative API: documents are
parsed into chunks (cardinality: pages), every chunk gets an LLM digest
(cardinality: chunks — the batchable bulk stage), and the digests are
indexed. The digest stage is where the scheduler's batching lever pays:
LLM decode streams the weights once per step regardless of batch size
(the batch roofline, DESIGN.md §7), so below the compute knee MIN_ENERGY/
MIN_COST plans co-schedule chunks aggressively.
"""
from __future__ import annotations

from ..core.spec import SCENARIOS, Scenario
from ..core.workflow import DocumentInput

# the default ingest batch: two quarterly filings
PAPER_DOCS = (
    DocumentInput("10k_2024.pdf", pages=12, chunks_per_page=3),
    DocumentInput("10k_2023.pdf", pages=12, chunks_per_page=3),
)


# representative decode-bound stage for the batch-roofline knee sweep
# (benchmarks/planner_bench.py): the digest interface's token footprint —
# the batchable bulk stage this scenario exists to exercise. The same knee
# seeds the joint (count x batch) search's candidate grid
# (energy.knee_batch_grid, DESIGN.md §7.2): 72 chunks don't divide the
# 64-item max batch, so the remainder-aware grid is what finds the
# zero-remainder divisor schedules here.
BATCH_KNEE_REFERENCE = ("gemma2-9b-digest", 700, 90)


def _first_doc(job) -> DocumentInput:
    docs = [d for d in job.inputs if isinstance(d, DocumentInput)]
    return docs[0] if docs else DocumentInput("input")


DOCINGEST_SCENARIO = SCENARIOS.register(Scenario(
    name="doc_ingest",
    input_artifacts=("document",),
    default_tasks=(
        "Parse and split each document into text chunks",
        "Write a digest of every text chunk",
    ),
    aggregate_tasks=(
        "Index the digests into the vector database",
    ),
    arg_builders={
        "parse_doc": lambda job: {"file": _first_doc(job).name,
                                  "chunk_tokens": 512},
        "digest": lambda job: {"chunks": "$text_chunks", "max_tokens": 90},
        "embed": lambda job: {"texts": "$chunk_summaries"},
    }))


def make_docingest_job(constraints=None, documents=PAPER_DOCS):
    """Declarative batch document-ingest job."""
    from ..core.workflow import MIN_COST, Job
    return Job(
        description="Ingest the quarterly filings and index their digests",
        inputs=documents,
        constraints=MIN_COST if constraints is None else constraints,
        quality_floor={"parse_doc": 0.85, "digest": 0.85, "embed": 0.85})


# -- open-loop serving preset (core/arrivals.py) ------------------------------
# Document ingest is throughput-oriented batch work (unloaded ~21 s): a
# moderate share with a looser SLO than RAG — ingest can queue.
from ..core.arrivals import ServingPreset, register_preset  # noqa: E402

SERVING_PRESET = register_preset(ServingPreset(
    scenario="docingest", make_job=make_docingest_job, weight=0.25,
    base_slo_s=120.0))
