"""Per-task telemetry: the route -> log -> evaluate -> update feedback loop.

DESIGN.md §11. The simulator logs one :class:`TaskRecord` per completed task
attempt — the query features the router saw, the implementation that ran,
and the latency/energy/$/quality outcome — into an append-only
:class:`TelemetryStore`. The offline evaluator (``core/router.py``) replays
the store between runs to update routing weights and to calibrate measured
quality back into the :class:`~repro_torch.core.profiles.ProfileStore`; nothing
learns *inside* a simulation step, so traces stay seeded-replayable.

Attained quality defaults to the planned (declared) quality; a
``quality_model`` callable — ``(features, impl_name, declared) -> float`` —
stands in for a ground-truth grader (an LLM judge, labeled evals) in
benchmarks and tests. Everything here is a pure function of its inputs:
the same run produces byte-identical records.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Callable

# -- query featurization ------------------------------------------------------

#: ~200 highest-frequency English words; tokens outside this set count as
#: *rare* (entity names, tickers, jargon) — the signal that lexical (BM25)
#: retrieval tends to score exactly (beyond-vector-search's observation).
_COMMON_WORDS = frozenset("""
the be to of and a in that have i it for not on with he as you do at this
but his by from they we say her she or an will my one all would there their
what so up out if about who get which go me when make can like time no just
him know take people into year your good some could them see other than then
now look only come its over think also back after use two how our work first
well way even new want because any these give day most us is are was were
been has had did does having may might must shall should state question
summarize summary describe during between under against within without
where why whose whom while which report filing fiscal revenue risk results
company year years quarter annual disclose trends segment acquisitions
litigation supply chain closed reserved what's
""".split())


@dataclass(frozen=True)
class QueryFeatures:
    """Deterministic features of one routed query/task input.

    The router's decision basis and the telemetry record's context — both
    sides compute them through :func:`featurize`, so the offline evaluator
    replays exactly what the router saw.
    """

    length: int            # characters in the text
    n_tokens: int          # whitespace tokens
    digit_density: float   # fraction of characters that are digits
    id_density: float      # fraction of tokens carrying digits/ID shapes
    rarity: float          # fraction of tokens outside the common-word set

    def bucket(self) -> str:
        """Coarse feature bucket the bandit keys its weights on.

        Two axes: *lookup-shaped* (digit/ID-dense — document ids, fiscal
        years, tickers — where exact lexical match wins) vs *semantic*
        (clean prose needing embedding recall), crossed with short vs long.
        """
        lookup = self.id_density >= 0.2 or self.digit_density >= 0.08
        size = "short" if self.n_tokens <= 10 else "long"
        return f"{'lookup' if lookup else 'semantic'}:{size}"


def featurize(text: str) -> QueryFeatures:
    """Featurize one query string (pure, deterministic).

    ``id_density`` counts tokens that look like identifiers: containing a
    digit, or ALL-CAPS acronyms of length >= 2 ("10-K", "FY2024", "SEC").
    ``rarity`` is corpus-frequency-model rarity against the built-in
    common-word table — a stand-in for token IDF that needs no corpus.
    """
    text = text or ""
    toks = text.split()
    n = len(toks)
    digits = sum(c.isdigit() for c in text)
    ids = sum(1 for t in toks
              if any(c.isdigit() for c in t)
              or (len(t) >= 2 and t.isupper()))
    rare = sum(1 for t in toks
               if t.strip(".,?!:;()'\"").lower() not in _COMMON_WORDS)
    return QueryFeatures(
        length=len(text), n_tokens=n,
        digit_density=digits / max(len(text), 1),
        id_density=ids / max(n, 1),
        rarity=rare / max(n, 1))


#: toolcall-arg keys scanned, in order, for the routable text of a task
_TEXT_ARGS = ("query", "question", "message", "text")


def featurize_node(node) -> QueryFeatures:
    """Features for a task node: its text-bearing toolcall arg, else the
    NL description. One shared entry point for the router's decision and
    the telemetry log, so replayed records match routed features exactly."""
    for key in _TEXT_ARGS:
        v = node.args.get(key)
        if isinstance(v, str) and v:
            return featurize(v)
    return featurize(node.description)


# -- the telemetry record + store ---------------------------------------------


@dataclass(frozen=True)
class TaskRecord:
    """One completed task attempt: decision context + measured outcome."""

    t: float               # simulation completion time
    workflow: str
    task: str
    interface: str         # agent interface the task bound to
    impl: str              # implementation that actually ran (the "arm")
    pool: str
    features: QueryFeatures
    latency_s: float       # measured wall time of the run
    energy_j: float        # marginal (above idle) energy of the run
    usd: float
    quality: float         # attained quality (model-graded or declared)
    routed: bool = False   # True when a learned router chose ``impl``

    def to_json(self) -> dict:
        """Round-trippable plain-dict form (JSONL row)."""
        return asdict(self)

    @staticmethod
    def from_json(row: dict) -> "TaskRecord":
        """Inverse of :meth:`to_json` (exact round-trip)."""
        row = dict(row)
        row["features"] = QueryFeatures(**row["features"])
        return TaskRecord(**row)


QualityModel = Callable[[QueryFeatures, str, float], float]


class TelemetryStore:
    """Append-only per-task outcome log feeding the offline evaluator.

    ``quality_model`` — ``(features, impl, declared_quality) -> float`` —
    grades attained quality; ``None`` records the planned quality (every
    run then trivially attains its estimate). The store never influences
    the run that fills it: the simulator writes records after each task's
    accounting settles, so ``telemetry=None`` and an attached store
    produce byte-identical traces (the inertness tests pin this).
    """

    def __init__(self, quality_model: QualityModel | None = None):
        self.records: list[TaskRecord] = []
        self.quality_model = quality_model

    def __len__(self) -> int:
        return len(self.records)

    # -- writing --------------------------------------------------------------
    def observe(self, *, t: float, workflow: str, task: str, node,
                interface: str, impl: str, pool: str, latency_s: float,
                energy_j: float, usd: float, declared_quality: float,
                routed: bool = False) -> TaskRecord:
        """Grade and append one completed task attempt."""
        feats = featurize_node(node)
        q = (self.quality_model(feats, impl, declared_quality)
             if self.quality_model is not None else declared_quality)
        rec = TaskRecord(t=t, workflow=workflow, task=task,
                         interface=interface, impl=impl, pool=pool,
                         features=feats, latency_s=latency_s,
                         energy_j=energy_j, usd=usd, quality=q,
                         routed=routed)
        self.records.append(rec)
        return rec

    def log(self, rec: TaskRecord):
        """Append a pre-built record (trace replay, tests)."""
        self.records.append(rec)

    # -- reading --------------------------------------------------------------
    def by_interface(self, interface: str) -> list[TaskRecord]:
        """Records of one agent interface, in completion order."""
        return [r for r in self.records if r.interface == interface]

    def attainment(self, interface: str, target: float) -> float:
        """Fraction of the interface's records attaining ``target`` quality
        (1.0 on an empty slice — no evidence of a miss)."""
        rows = self.by_interface(interface)
        if not rows:
            return 1.0
        return sum(r.quality >= target for r in rows) / len(rows)

    def mean_quality(self, min_count: int = 1) -> dict[str, float]:
        """Measured mean attained quality per implementation.

        Only impls with at least ``min_count`` records appear — the
        calibration path refuses to overwrite a declared quality on one
        noisy sample. Pure function of the log.
        """
        acc: dict[str, list[float]] = {}
        for r in self.records:
            acc.setdefault(r.impl, []).append(r.quality)
        return {impl: math.fsum(qs) / len(qs)
                for impl, qs in sorted(acc.items())
                if len(qs) >= min_count}

    # -- persistence ----------------------------------------------------------
    def to_jsonl(self) -> str:
        """Serialize every record, one JSON object per line."""
        return "\n".join(json.dumps(r.to_json(), sort_keys=True)
                         for r in self.records) + ("\n" if self.records
                                                   else "")

    @classmethod
    def from_jsonl(cls, text: str,
                   quality_model: QualityModel | None = None) \
            -> "TelemetryStore":
        """Exact inverse of :meth:`to_jsonl`."""
        store = cls(quality_model=quality_model)
        for line in text.splitlines():
            line = line.strip()
            if line:
                store.records.append(TaskRecord.from_json(json.loads(line)))
        return store
