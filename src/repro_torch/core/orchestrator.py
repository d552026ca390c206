"""Job decomposition + task->agent mapping (paper §3.2).

Two planners behind one interface:

- ``RulePlanner`` — deterministic: keyword/schema matching over the agent
  library, dataflow edges derived from interface produces/consumes artifact
  types. This is the offline stand-in for the paper's orchestrator LLM
  (DESIGN.md §5.3 records the substitution; the paper itself measures DAG
  creation at <1% of workflow time, so the swap does not distort the
  evaluation).
- ``LLMPlanner`` — the paper's NVLM/ReAct protocol: agent library via system
  prompt, task descriptions via user prompt, JSON DAG back. Takes any
  ``llm_fn(system, user) -> str`` (tests inject a fake; production would bind
  a served model from the zoo).

Both are scenario-agnostic: work-item cardinality and token footprints come
from the producing interface's declared ``CardinalityModel``/``TokenModel``,
default decompositions and toolcall args from the matched registered
``Scenario`` (DESIGN.md §2). Both emit toolcalls in the paper's format, e.g.
``FrameExtractor(end_time=60, file='cats.mov', num_frames=10, start_time=0)``.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Callable

from .agents import AgentLibrary
from .dag import DAG, TaskNode
from .spec import SCENARIOS, TaskSpec, build_node, input_units
from .workflow import Job


class RulePlanner:
    """Deterministic job -> DAG lowering via the agent library."""

    def __init__(self, library: AgentLibrary):
        self.library = library

    def decompose(self, job: Job) -> list[TaskSpec]:
        """Job description -> typed task specs (hints kept if sufficient)."""
        scenario = SCENARIOS.match(job.inputs)
        if scenario is not None:
            unknown = set(scenario.arg_builders) - set(self.library.interfaces)
            if unknown:
                raise ValueError(
                    f"scenario {scenario.name!r} has arg_builders for "
                    f"interfaces unknown to this library: {sorted(unknown)}")
        texts = list(job.tasks)
        if not texts:
            if scenario is None:
                raise ValueError(
                    "job has no sub-task hints and no registered scenario "
                    f"matches its inputs; scenarios: {SCENARIOS.names()}")
            texts = list(scenario.default_tasks)
        # ensure the job's deliverable is produced: aggregation stages
        mapped = {self.library.match_interface(t) for t in texts}
        for extra in (scenario.aggregate_tasks if scenario else ()):
            m = self.library.match_interface(extra)
            if m not in mapped:
                texts.append(extra)
                mapped.add(m)
        specs: list[TaskSpec] = []
        for text in texts:
            iface_name = self.library.match_interface(text)
            if iface_name is None:
                raise ValueError(
                    f"no agent in the library matches task {text!r}")
            args = scenario.args_for(iface_name, job) if scenario else {}
            specs.append(TaskSpec(description=text, interface=iface_name,
                                  args=args))
        return specs

    def lower(self, job: Job) -> DAG:
        """Decompose the job and wire tasks by artifact dataflow."""
        specs = self.decompose(job)
        units = input_units(job.inputs)
        nodes: list[TaskNode] = []
        produced: dict[str, str] = {}         # artifact type -> producer id
        for i, ts in enumerate(specs):
            iface = self.library.interfaces[ts.interface]
            deps = tuple(produced[c] for c in iface.consumes if c in produced)
            tid = f"t{i}_{iface.name}"
            nodes.append(build_node(tid, ts.description, iface, deps,
                                    ts.args, units))
            produced[iface.produces] = tid
        return DAG(nodes)

    def toolcalls(self, dag: DAG) -> dict[str, str]:
        """Rendered executable toolcall per task (paper §3.2 example)."""
        return {tid: self.library.toolcall(dag.nodes[tid].agent,
                                           dag.nodes[tid].args)
                for tid in dag.topo_order}


# ---------------------------------------------------------------------------
# LLM planner (the paper's protocol, pluggable model)
# ---------------------------------------------------------------------------

_SYSTEM_TMPL = """You are a workflow orchestrator (ReAct). Available agents:
{agents}
Decompose the user's job into tasks, one agent each. Respond with JSON:
{{"tasks": [{{"id": str, "agent": str, "description": str,
             "deps": [str], "args": {{...}}}}]}}"""


@dataclass
class LLMPlanner:
    """ReAct-style decomposition through an LLM (paper §3.2).

    ``llm_fn(system_prompt, user_prompt) -> str`` is any text-completion
    callable — a zoo model served by the runtime, or a test fake. Falls back
    to ``RulePlanner`` output validation: whatever the LLM returns must parse
    into a valid DAG over known agents.
    """

    library: AgentLibrary
    llm_fn: Callable[[str, str], str]

    def system_prompt(self) -> str:
        """The ReAct system prompt listing every library interface."""
        lines = [f"- {i.name}({', '.join(i.schema)}): {i.description} "
                 f"[consumes: {','.join(i.consumes) or '-'}; "
                 f"produces: {i.produces}]"
                 for i in self.library.interfaces.values()]
        return _SYSTEM_TMPL.format(agents="\n".join(lines))

    def lower(self, job: Job) -> DAG:
        """Ask the LLM for a task decomposition and validate it."""
        user = job.description
        if job.tasks:
            user += "\nSub-tasks: " + "; ".join(job.tasks)
        raw = self.llm_fn(self.system_prompt(), user)
        spec = json.loads(raw)
        units = input_units(job.inputs)
        nodes = []
        for t in spec["tasks"]:
            if t["agent"] not in self.library.interfaces:
                raise ValueError(f"LLM mapped to unknown agent {t['agent']!r}")
            iface = self.library.interfaces[t["agent"]]
            nodes.append(build_node(
                t["id"], t.get("description", ""), iface,
                tuple(t.get("deps", ())), t.get("args", {}), units))
        return DAG(nodes)


def dag_creation_overhead(dag: DAG, makespan_s: float,
                          llm_latency_s: float = 0.15) -> float:
    """Fraction of workflow time spent on DAG creation (paper §3.3b: <1%).

    One short-in/short-out LLM query per task node.
    """
    if makespan_s <= 0:
        return math.inf
    return len(dag) * llm_latency_s / makespan_s
