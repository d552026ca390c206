"""Task-DAG intermediate representation.

The orchestrator lowers a declarative ``Job`` into this IR: nodes are agent
invocations, edges are dataflow (paper §3.2 "Job Decomposition"). The IR is
pure metadata — scheduling and execution layers consume it.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Iterable


@dataclass(frozen=True)
class TaskNode:
    """One agent invocation in a workflow DAG."""

    id: str
    description: str                 # NL task text (paper Listing 2)
    agent: str                       # agent *interface* name (library key)
    deps: tuple[str, ...] = ()       # dataflow predecessors
    args: dict = field(default_factory=dict)   # toolcall arguments
    # workload descriptors the profile model consumes:
    work_items: int = 1              # chunkable units (scenes, frames, ...)
    chunkable: bool = False          # may be split across instances
    tokens_in: int = 0               # LLM-agent input size
    tokens_out: int = 0              # LLM-agent output size
    # leading tokens_in span shared with the task's serving session (system
    # prompt + prior turns): the part a resident KV prefix can serve
    prefix_tokens: int = 0

    def with_(self, **kw) -> "TaskNode":
        """Functional update (the dataclass is frozen)."""
        return replace(self, **kw)


class DAG:
    """Validated directed acyclic task graph."""

    def __init__(self, nodes: Iterable[TaskNode]):
        self.nodes: dict[str, TaskNode] = {}
        for n in nodes:
            if n.id in self.nodes:
                raise ValueError(f"duplicate task id {n.id!r}")
            self.nodes[n.id] = n
        for n in self.nodes.values():
            for d in n.deps:
                if d not in self.nodes:
                    raise ValueError(f"{n.id!r} depends on unknown {d!r}")
        self._topo = self._toposort()
        self._sig: tuple | None = None
        # successor adjacency + topo rank, precomputed once: the event
        # engine's indexed ready-set walks successors on every finish and
        # orders candidates by topo rank — both must be O(1) lookups, not
        # per-call scans over all nodes
        self._succ: dict[str, tuple[str, ...]] = {i: () for i in self.nodes}
        succ_acc: dict[str, list[str]] = {i: [] for i in self.nodes}
        for n in self.nodes.values():
            for d in n.deps:
                succ_acc[d].append(n.id)
        self._succ = {i: tuple(v) for i, v in succ_acc.items()}
        self._topo_idx: dict[str, int] = {
            tid: k for k, tid in enumerate(self._topo)}

    # -- structure -----------------------------------------------------------
    def _toposort(self) -> tuple[str, ...]:
        indeg = {i: len(n.deps) for i, n in self.nodes.items()}
        out: dict[str, list[str]] = {i: [] for i in self.nodes}
        for n in self.nodes.values():
            for d in n.deps:
                out[d].append(n.id)
        ready = sorted(i for i, k in indeg.items() if k == 0)
        order: list[str] = []
        while ready:
            i = ready.pop(0)
            order.append(i)
            for j in sorted(out[i]):
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
        if len(order) != len(self.nodes):
            cyc = set(self.nodes) - set(order)
            raise ValueError(f"cycle involving {sorted(cyc)}")
        return tuple(order)

    @property
    def topo_order(self) -> tuple[str, ...]:
        """Deterministic topological order of task ids."""
        return self._topo

    def signature(self) -> tuple:
        """Hashable structural identity: everything the scheduler reads.

        Two DAGs with equal signatures produce identical plans against the
        same cluster state — the admission-time plan cache's key
        (DESIGN.md §7). Covers ids, interfaces, edges and the workload
        descriptors (work_items, chunkable, token footprint); toolcall args
        and NL descriptions are excluded (the scheduler never reads them).
        """
        if self._sig is None:
            self._sig = tuple(
                (n.id, n.agent, n.deps, n.work_items, n.chunkable,
                 n.tokens_in, n.tokens_out, n.prefix_tokens)
                for n in (self.nodes[i] for i in self._topo))
        return self._sig

    def successors(self, node_id: str) -> list[str]:
        """Tasks that directly depend on ``node_id`` (precomputed)."""
        return list(self._succ[node_id])

    def succ(self, node_id: str) -> tuple[str, ...]:
        """:meth:`successors` without the defensive copy (hot path)."""
        return self._succ[node_id]

    def topo_index(self, node_id: str) -> int:
        """Rank of ``node_id`` in :attr:`topo_order` (O(1))."""
        return self._topo_idx[node_id]

    def roots(self) -> list[str]:
        """Tasks with no dependencies (ready at arrival)."""
        return [i for i, n in self.nodes.items() if not n.deps]

    def leaves(self) -> list[str]:
        """Tasks nothing depends on (the deliverable stages)."""
        succ_of = {d for n in self.nodes.values() for d in n.deps}
        return [i for i in self.nodes if i not in succ_of]

    # -- analysis -------------------------------------------------------------
    def critical_path(self, durations: dict[str, float]) \
            -> tuple[float, tuple[str, ...]]:
        """Longest path under per-node ``durations`` (lower bound on makespan
        with infinite resources)."""
        finish: dict[str, float] = {}
        best_pred: dict[str, str | None] = {}
        for i in self._topo:
            n = self.nodes[i]
            start, pred = 0.0, None
            for d in n.deps:
                if finish[d] > start:
                    start, pred = finish[d], d
            finish[i] = start + durations.get(i, 0.0)
            best_pred[i] = pred
        end = max(finish, key=finish.get)  # type: ignore[arg-type]
        path = [end]
        while best_pred[path[-1]] is not None:
            path.append(best_pred[path[-1]])  # type: ignore[arg-type]
        return finish[end], tuple(reversed(path))

    def levels(self) -> list[list[str]]:
        """Antichains of tasks that may run concurrently (fan-out view)."""
        depth: dict[str, int] = {}
        for i in self._topo:
            n = self.nodes[i]
            depth[i] = 1 + max((depth[d] for d in n.deps), default=-1)
        out: dict[int, list[str]] = {}
        for i, d in depth.items():
            out.setdefault(d, []).append(i)
        return [sorted(out[d]) for d in sorted(out)]

    def __len__(self) -> int:
        return len(self.nodes)

    def __iter__(self):
        return iter(self._topo)

    def to_json(self) -> list[dict[str, Any]]:
        """Serializable node rows in topological order."""
        return [{"id": n.id, "agent": n.agent, "deps": list(n.deps),
                 "description": n.description, "work_items": n.work_items}
                for n in (self.nodes[i] for i in self._topo)]
