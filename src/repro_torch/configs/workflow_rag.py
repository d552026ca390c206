"""Agentic-RAG workflow: retrieve -> rerank -> synthesize -> index.

Built purely on the declarative API (DESIGN.md §2): the scenario registers
its default decomposition and toolcall-arg builders; cardinality and token
models come from the producing interfaces. Nothing in core knows RAG exists.

The headline lever is *retrieval routing* (beyond-vector-search): the
``retrieve`` interface has a keyword (BM25), a dense (vector) and a hybrid
implementation on the same quality ladder, so constraint choice routes the
query — ``MIN_COST`` runs lexical retrieval on CPU cores, ``MAX_QUALITY``
pays for hybrid retrieval — with no change to the workflow definition.
"""
from __future__ import annotations

from ..core.spec import SCENARIOS, Scenario
from ..core.workflow import QueryInput

# a small analyst query mix over an indexed filings corpus
RAG_QUERIES = (
    QueryInput("What supply-chain risks does the 2024 10-K disclose?",
               top_k=5, candidates=20),
    QueryInput("Summarize the segment revenue trends year over year",
               top_k=5, candidates=20),
    QueryInput("Which acquisitions closed during the fiscal year?",
               top_k=5, candidates=20),
    QueryInput("What litigation contingencies are reserved for?",
               top_k=5, candidates=20),
)

# the learned-routing evaluation mix (DESIGN.md §11; benchmarks/
# routing_bench.py): half *lookup-shaped* queries — document ids, fiscal
# years, tickers, form numbers, where exact lexical (BM25) match wins —
# and half *semantic* prose needing embedding recall. The featurizer
# (core.telemetry.featurize) separates the two by digit/ID density; the
# router learns to send each bucket to its cheapest adequate arm.
ROUTED_QUERIES = (
    # lookup-shaped: id/digit-dense, short
    QueryInput("10-K 2024 item 1A", top_k=5, candidates=20),
    QueryInput("FY2024 Q3 8-K filing AMZN", top_k=5, candidates=20),
    QueryInput("CIK 0000320193 10-Q 2025", top_k=5, candidates=20),
    QueryInput("NVDA 10-K exhibit 21.1 subsidiaries", top_k=5,
               candidates=20),
    # semantic: clean prose, no identifiers
    QueryInput("How does management describe competitive pressure on "
               "margins?", top_k=5, candidates=20),
    QueryInput("Summarize the segment revenue trends year over year",
               top_k=5, candidates=20),
    QueryInput("What strategic rationale is given for the recent "
               "acquisitions?", top_k=5, candidates=20),
    QueryInput("Describe the liquidity outlook under the disclosed risk "
               "factors", top_k=5, candidates=20),
)


# representative decode-bound stage for the batch-roofline knee sweep
# (benchmarks/planner_bench.py): the synthesize interface's token footprint.
# The same knee seeds the joint (count x batch) search's candidate grid
# (energy.knee_batch_grid, DESIGN.md §7.2).
BATCH_KNEE_REFERENCE = ("gemma2-9b-synth", 1200, 200)


def _first_query(job) -> QueryInput:
    qs = [q for q in job.inputs if isinstance(q, QueryInput)]
    return qs[0] if qs else QueryInput("input")


RAG_SCENARIO = SCENARIOS.register(Scenario(
    name="agentic_rag",
    input_artifacts=("query",),
    default_tasks=(
        "Retrieve candidate passages from the corpus for the query",
        "Rerank the retrieved passages by relevance",
        "Synthesize a grounded answer from the top passages",
    ),
    aggregate_tasks=(
        "Index the answer embedding into the semantic cache",
    ),
    arg_builders={
        "retrieve": lambda job: {"query": _first_query(job).text,
                                 "k": _first_query(job).candidates},
        "rerank": lambda job: {"passages": "$passages",
                               "top_k": _first_query(job).top_k},
        "synthesize": lambda job: {"query": _first_query(job).text,
                                   "max_tokens": 200},
        "embed": lambda job: {"texts": "$grounded_answer"},
    }))


def make_rag_job(constraints=None, queries=RAG_QUERIES, *,
                 quality_floor=None):
    """Declarative agentic-RAG job over the default query mix.

    ``quality_floor`` overrides individual per-interface floors (merged
    over the defaults below) — the routing bench raises the retrieve
    floor to force the dense route (the static quality-safe baseline) and
    the synthesize floor to exercise quality-aware model selection.
    """
    from ..core.workflow import MIN_COST, Job
    # floors admit the keyword route (0.82) but gate junk impls; raise
    # the retrieve floor to force the dense/hybrid route.
    floor = {"retrieve": 0.8, "rerank": 0.85, "synthesize": 0.85,
             "embed": 0.85}
    if quality_floor:
        floor.update(quality_floor)
    return Job(
        description="Answer analyst questions over the filings corpus",
        inputs=queries,
        constraints=MIN_COST if constraints is None else constraints,
        quality_floor=floor)


# -- open-loop serving preset (core/arrivals.py) ------------------------------
# RAG is the interactive majority of the serving mix: short spans (unloaded
# ~21 s), tight SLO, highest arrival share.
from ..core.arrivals import ServingPreset, register_preset  # noqa: E402

SERVING_PRESET = register_preset(ServingPreset(
    scenario="rag", make_job=make_rag_job, weight=0.60, base_slo_s=90.0))
