"""Typed dataflow specs: the scenario-agnostic workflow vocabulary.

The seed hardwired the video workload into the core (``_VIDEO_TASKS`` in the
planner, ``scenes * fps if iface == "summarize"`` cardinality heuristics in
three modules, ``VideoInput`` isinstance checks in the lowering paths). This
module is the replacement vocabulary (DESIGN.md §2):

- ``Artifact`` / ``ArtifactRegistry`` — the dataflow *types* that flow along
  DAG edges ("frames", "passages", "chunk_summaries"). Interfaces declare
  what they produce/consume in these types; the registry makes typos a
  registration-time error instead of a silently-missing edge.
- ``InputSet`` — the protocol job inputs satisfy: an ``artifact`` type plus
  a ``units()`` breakdown ("scenes": 8, "frames": 80). Videos, documents and
  queries are just instances; the core never names any of them.
- ``CardinalityModel`` / ``TokenModel`` — declared *by the agent interface*:
  how many work-items one task invocation fans out to (in input units) and
  its per-item LLM token footprint. Planners read these instead of carrying
  per-interface constants.
- ``TaskSpec`` + ``build_node`` — the typed intermediate between NL task
  text and the scheduling IR; the single shared lowering step for the rule
  planner, the LLM planner and the imperative baseline.
- ``Scenario`` / ``ScenarioRegistry`` — a workload registered *onto* the
  API: default NL decomposition, deliverable (aggregation) stages, and
  toolcall-arg builders, keyed by the input artifact types that trigger it.
  The video pipeline is one registered scenario among peers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Protocol, Sequence, \
    runtime_checkable

from .dag import TaskNode


# ---------------------------------------------------------------------------
# Artifacts: the dataflow type system
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Artifact:
    """One dataflow type that can flow along a DAG edge."""

    name: str
    description: str = ""


class ArtifactRegistry:
    """Known dataflow types; interface registration validates against it."""

    def __init__(self):
        self._types: dict[str, Artifact] = {}

    def define(self, name: str, description: str = "") -> Artifact:
        """Register (or redefine) a dataflow type."""
        art = Artifact(name, description)
        self._types[name] = art
        return art

    def __contains__(self, name: str) -> bool:
        return name in self._types

    def __getitem__(self, name: str) -> Artifact:
        if name not in self._types:
            raise KeyError(
                f"unknown artifact type {name!r}; known: {self.names()}. "
                f"Define it first via ARTIFACTS.define({name!r}, ...)")
        return self._types[name]

    def names(self) -> list[str]:
        """All registered artifact type names."""
        return sorted(self._types)


#: The default registry. Library interfaces and scenarios share it.
ARTIFACTS = ArtifactRegistry()

for _name, _desc in [
    ("video", "raw input video file"),
    ("frames", "sampled video frames"),
    ("transcript", "speech-to-text output"),
    ("objects", "detected/classified objects"),
    ("summary", "scene/frame summaries"),
    ("vectors", "embeddings resident in a vector index"),
    ("answer", "final QA answer"),
    ("query", "user retrieval query"),
    ("passages", "retrieved candidate passages"),
    ("ranked_passages", "reranked passages (relevance order)"),
    ("grounded_answer", "answer synthesized from retrieved context"),
    ("document", "raw input document (pdf/scan)"),
    ("text_chunks", "parsed+chunked document text"),
    ("chunk_summaries", "per-chunk digests"),
    ("chat_turn", "one user turn of an ongoing chat session"),
    ("chat_reply", "assistant reply for a chat turn"),
]:
    ARTIFACTS.define(_name, _desc)


# ---------------------------------------------------------------------------
# Input sets
# ---------------------------------------------------------------------------


@runtime_checkable
class InputSet(Protocol):
    """What a job input must provide: its artifact type and unit counts."""

    artifact: str

    def units(self) -> dict[str, int]:
        """Work-unit breakdown, e.g. ``{"scenes": 4, "frames": 40}``."""
        ...


def input_units(inputs: Sequence[Any]) -> dict[str, int]:
    """Merged unit counts over a job's inputs (summed per unit key).

    Non-``InputSet`` inputs contribute nothing — a job may carry opaque
    payloads alongside typed ones.
    """
    units: dict[str, int] = {}
    for x in inputs:
        if not isinstance(x, InputSet):
            continue
        for k, v in x.units().items():
            units[k] = units.get(k, 0) + int(v)
    return units


def input_artifacts(inputs: Sequence[Any]) -> set[str]:
    """The artifact types present across a job's input sets."""
    return {x.artifact for x in inputs if isinstance(x, InputSet)}


# ---------------------------------------------------------------------------
# Interface-declared workload models
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CardinalityModel:
    """Work-items of one invocation, in terms of the job's input units.

    ``units`` is tried in order; the first key present in the job's merged
    input units wins. An empty tuple (or no key present) yields ``default``
    — one indivisible invocation.
    """

    units: tuple[str, ...] = ()
    default: int = 1

    def items(self, available: Mapping[str, int]) -> int:
        """Work-item count for a job's merged input units."""
        for u in self.units:
            if u in available:
                return max(int(available[u]), 1)
        return self.default


@dataclass(frozen=True)
class TokenModel:
    """Per-work-item LLM token footprint of an interface.

    ``tokens_in``/``tokens_out`` are the fixed per-item footprint.
    ``in_units`` optionally names an input-unit key whose count is *added*
    to ``tokens_in`` (e.g. ``history_tokens`` — conversation history grows
    the prompt per turn); ``prefix_units`` names the unit key counted as
    the session-shared *prefix* span of the prompt, the part a resident KV
    cache can serve (DESIGN.md §9). Both default to empty, making the model
    byte-compatible with the fixed-footprint era.
    """

    tokens_in: int = 0
    tokens_out: int = 0
    in_units: str = ""
    prefix_units: str = ""

    def footprint(self, available: Mapping[str, int]) \
            -> tuple[int, int, int]:
        """``(tokens_in, tokens_out, prefix_tokens)`` for a job's units."""
        tin = self.tokens_in
        if self.in_units:
            tin += int(available.get(self.in_units, 0))
        prefix = int(available.get(self.prefix_units, 0)) \
            if self.prefix_units else 0
        return tin, self.tokens_out, min(prefix, tin)


# ---------------------------------------------------------------------------
# TaskSpec: the typed pre-IR and the shared lowering step
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TaskSpec:
    """One task bound to an interface, before dataflow wiring."""

    description: str
    interface: str
    args: dict = field(default_factory=dict)


def build_node(tid: str, description: str, iface, deps: tuple[str, ...],
               args: dict, units: Mapping[str, int],
               chunkable: bool = True) -> TaskNode:
    """The one place a TaskNode is derived from an interface's models."""
    tin, tout, prefix = iface.tokens.footprint(units)
    return TaskNode(
        id=tid, description=description, agent=iface.name, deps=deps,
        args=args, work_items=iface.cardinality.items(units),
        chunkable=chunkable, tokens_in=tin, tokens_out=tout,
        prefix_tokens=prefix)


# ---------------------------------------------------------------------------
# Scenarios: workloads registered onto the API
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Scenario:
    """A registered workflow shape: decomposition defaults + arg builders."""

    name: str
    input_artifacts: tuple[str, ...]
    default_tasks: tuple[str, ...]
    aggregate_tasks: tuple[str, ...] = ()
    # interface name -> Callable[[Job], dict] producing toolcall args
    arg_builders: Mapping[str, Callable[[Any], dict]] = \
        field(default_factory=dict)

    def args_for(self, interface: str, job) -> dict:
        """Toolcall args the scenario builds for one interface."""
        builder = self.arg_builders.get(interface)
        return builder(job) if builder is not None else {}


class ScenarioRegistry:
    """Registered workflow shapes, matched by input artifact types."""

    def __init__(self):
        self._scenarios: dict[str, Scenario] = {}

    def register(self, scenario: Scenario) -> Scenario:
        """Add a scenario; its input artifact types must be registered."""
        for art in scenario.input_artifacts:
            ARTIFACTS[art]            # raises on unknown artifact types
        self._scenarios[scenario.name] = scenario
        return scenario

    def __getitem__(self, name: str) -> Scenario:
        self._ensure_builtin()
        return self._scenarios[name]

    def names(self) -> list[str]:
        """All registered scenario names (built-ins loaded lazily)."""
        self._ensure_builtin()
        return sorted(self._scenarios)

    def match(self, inputs: Sequence[Any]) -> Scenario | None:
        """Scenario with the largest input-artifact overlap (ties: first
        registered). ``None`` when no registered scenario applies."""
        self._ensure_builtin()
        arts = input_artifacts(inputs)
        best, best_overlap = None, 0
        for sc in self._scenarios.values():
            overlap = len(arts & set(sc.input_artifacts))
            if overlap > best_overlap:
                best, best_overlap = sc, overlap
        return best

    @staticmethod
    def _ensure_builtin():
        """Import the built-in scenario configs (idempotent, lazy to avoid
        an import cycle: configs modules import core)."""
        from ..configs import (workflow_docingest, workflow_rag,  # noqa: F401
                               workflow_video)


#: The default scenario registry; configs modules register onto it.
SCENARIOS = ScenarioRegistry()
