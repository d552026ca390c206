"""Workflow programming models: declarative (Murakkab) and imperative (baseline).

Paper Listing 2 (declarative)::

    result = Job(description="List objects shown/mentioned in the videos",
                 inputs=videos, tasks=[t1, t2, t3],
                 constraints=MIN_COST).execute(system)

Paper Listing 1 (imperative, today's systems)::

    frame_ext = Tool(name="OpenCV", params={"sampling_rate": 15},
                     resources={"CPUs": 1})
    stt       = MLModel(name="Whisper", resources={"GPUs": 1})
    ...
    result = Workflow(frame_ext >> stt >> obj_det >> summarize)\
                 .execute(system, inputs=videos)

The imperative path pins model/hardware per component and runs sequentially —
it exists so the baseline of the paper's evaluation is a first-class citizen
(the system prompt requires implementing the baseline too).

Inputs are ``InputSet`` instances (DESIGN.md §2): each carries a dataflow
``artifact`` type and a ``units()`` breakdown that interface-declared
cardinality models consume. ``VideoInput``, ``DocumentInput`` and
``QueryInput`` below are peers — the core special-cases none of them.
Constraints accept the seed enum *or* the composable DSL from
``core.constraints`` (``Deadline``, ``Budget``, ``Weighted``, orderings).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

from .constraints import (MAX_QUALITY, MIN_COST, MIN_ENERGY,  # noqa: F401
                          MIN_LATENCY, Constraint, ConstraintSpec, as_enum,
                          as_spec)


@dataclass(frozen=True)
class VideoInput:
    """Synthetic stand-in for an input video file."""

    name: str
    duration_s: float = 480.0
    scenes: int = 4                  # OmAgent-style scene segmentation
    frames_per_scene: int = 10

    artifact = "video"

    def units(self) -> dict[str, int]:
        """Unit breakdown driving interface cardinality models."""
        return {"videos": 1, "scenes": self.scenes,
                "frames": self.scenes * self.frames_per_scene}


@dataclass(frozen=True)
class DocumentInput:
    """An input document to parse, digest and index."""

    name: str
    pages: int = 12
    chunks_per_page: int = 3

    artifact = "document"

    def units(self) -> dict[str, int]:
        """Unit breakdown driving interface cardinality models."""
        return {"documents": 1, "pages": self.pages,
                "chunks": self.pages * self.chunks_per_page}


@dataclass(frozen=True)
class QueryInput:
    """A retrieval query over an indexed corpus."""

    text: str
    top_k: int = 5                   # passages handed to synthesis
    candidates: int = 20             # retrieval pool size to rerank

    artifact = "query"

    def units(self) -> dict[str, int]:
        """Unit breakdown driving interface cardinality models."""
        return {"queries": 1, "passages": self.candidates}


@dataclass(frozen=True)
class Job:
    """Declarative job spec (paper Listing 2)."""

    description: str
    inputs: Sequence[Any] = ()
    tasks: Sequence[str] = ()        # optional NL sub-task hints
    constraints: Any = Constraint.MIN_COST
    # min acceptable impl quality: one float, or per-interface dict
    quality_floor: float | dict = 0.85
    # multi-tenant class: "priority" | "standard" | "harvest"
    # (core/admission.py). Harvest-class allocations are preemptible; a
    # preempted task's completed batch steps are checkpointed and the
    # requeue resumes from the residual work-items (DESIGN.md §6.4), so
    # harvest jobs lose at most one in-flight step per preemption.
    tenant_class: str = "standard"
    # serving-session identity (multi-turn chat/agent loops): tasks of
    # jobs sharing a session share prompt prefixes, so the planner and
    # engine use it for KV-affinity placement and hit-rate-dependent
    # prefill pricing (DESIGN.md §9). Empty = stateless (the default).
    session: str = ""

    def __post_init__(self):
        from .admission import validate_tenant
        validate_tenant(self.tenant_class)

    @property
    def constraint_spec(self) -> ConstraintSpec:
        """The job's constraints normalized into a ``ConstraintSpec``."""
        return as_spec(self.constraints)

    @property
    def constraint_order(self) -> tuple:
        """Seed-compatible accessor: atomic objectives come back as the
        ``Constraint`` enum members the seed returned (so identity and
        membership checks keep working); composite DSL terms pass through."""
        return tuple(as_enum(o) for o in self.constraint_spec.objectives)

    def execute(self, system, **kw):
        """Lower -> schedule -> run on the given Murakkab system."""
        return system.execute(self, **kw)


# ---------------------------------------------------------------------------
# Imperative API (Listing 1) — the baseline programming model
# ---------------------------------------------------------------------------


@dataclass
class Component:
    """A pinned model/tool with explicit resources (today's style)."""

    name: str
    kind: str                        # tool | mlmodel | llm
    params: dict = field(default_factory=dict)
    resources: dict = field(default_factory=dict)   # {"GPUs": 1} / {"CPUs": 2}
    key: str = ""                    # provider credential (unused, fidelity)
    system_prompt: str = ""
    user_prompt: str = ""
    _next: "Component | None" = None

    def __rshift__(self, other: "Component") -> "Component":
        """``a >> b`` chains dataflow (stands in for the paper's ``->``)."""
        tail = self
        while tail._next is not None:
            tail = tail._next
        tail._next = other
        return self

    def chain(self) -> list["Component"]:
        """The linked components in dataflow order."""
        out, cur = [], self
        while cur is not None:
            out.append(cur)
            cur = cur._next
        return out


def Tool(name: str, **kw) -> Component:
    """A pinned non-model tool component (Listing 1)."""
    return Component(name=name, kind="tool", **kw)


def MLModel(name: str, **kw) -> Component:
    """A pinned (non-LLM) model component (Listing 1)."""
    return Component(name=name, kind="mlmodel", **kw)


def LLM(name: str, **kw) -> Component:
    """A pinned LLM component with prompts (Listing 1)."""
    return Component(name=name, kind="llm", **kw)


# component name -> agent (interface, impl) in the default library
COMPONENT_ALIASES: dict[str, tuple[str, str]] = {
    "opencv": ("frame_extract", "opencv"),
    "whisper": ("speech_to_text", "whisper-large"),
    "clip": ("object_detect", "clip"),
    "llama": ("summarize", "nvlm-72b"),     # paper eval runs NVLM here
    "nvlm": ("summarize", "nvlm-72b"),
    "nvlm-embed": ("embed", "nvlm-embed"),
    "bm25": ("retrieve", "bm25-keyword"),
    "faiss": ("retrieve", "dense-retrieval"),
    "pypdf": ("parse_doc", "pypdf-parse"),
}


@dataclass
class ImperativeWorkflow:
    """Fixed execution: pinned impls/resources, sequential flow."""

    flow: Component

    def components(self) -> list[Component]:
        """The pinned components in execution order."""
        return self.flow.chain()

    def execute(self, system, inputs: Sequence[Any] = (), **kw):
        """Run the pinned sequential flow on the given system."""
        return system.execute_imperative(self, inputs=inputs, **kw)


def Workflow(flow: Component) -> ImperativeWorkflow:
    """Wrap a ``>>``-chained component flow (paper Listing 1)."""
    return ImperativeWorkflow(flow)
