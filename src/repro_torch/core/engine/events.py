"""Event layer: heap, clock, and the same-timestamp drain loops.

The engine is a single event heap of ``(t, counter, kind, payload)``
tuples. Both run modes drain every event sharing a timestamp before
dispatching once for that timestamp:

- ``loop_closed`` (``Simulator.run``): all submissions are queued up
  front, so each drain pops the full same-``t`` batch before handling it.
  Simultaneous arrivals are all admitted (and planned) before any of them
  starts work, so admission-policy order holds for same-time tenants and
  identical tenants admitted into the same cluster state share one plan
  via the plan cache.
- ``loop_open`` (``Simulator.run_open_loop``): arrivals are pulled lazily
  (one look-ahead submission in the heap at a time) and handlers may chain
  new same-``t`` events (zero-lag scale applies, same-``t`` arrivals), so
  the drain re-checks the heap head after each handler. Same-``t`` events
  pop in push-counter order, so handling them as they pop matches handling
  them as a batch.

Finish coalescing (DESIGN.md §12): a contiguous same-``t`` run of
``finish`` events is handed to ``on_finish_batch`` as one group, which
amortizes the per-finish epoch bumps (one per touched pool) and the
rebalance scan (one per group) across same-step completions. Only
*contiguous* finish runs coalesce: any interleaved non-finish event
(arrival, scale, fault) flushes the group first, so a same-``t`` arrival
that re-raises demand an earlier finish just zeroed still observes exactly
the cluster state the uncoalesced engine would have shown it. Finish
handlers push no events, so the run collected from the heap head is
exactly the run the uncoalesced loop would have popped one-by-one.

The state records (``TraceEntry``, ``Submission``, ``_WfState``,
``_Running``) live here: they are what events carry and what the drain
mutates.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable

from ..admission import Admission
from ..cluster import Instance, Lease
from ..dag import DAG
from ..scheduler import ExecutionPlan, TaskConfig


@dataclass(frozen=True)
class TraceEntry:
    """One task execution interval in the Fig-3-style trace."""

    workflow: str
    task: str
    impl: str
    pool: str
    devices: int              # total devices (n_devices * n_instances)
    start: float
    end: float
    note: str = ""


@dataclass(slots=True)
class Submission:
    """One tenant's workflow submission to the multi-tenant engine.

    ``plan`` may be ``None`` with a ``plan_fn`` instead: the engine calls it
    when the workflow is admitted (its arrival event fires), so scheduling
    sees the live cluster state. ``slo_s``/``scenario`` feed the open-loop
    SLO-attainment metrics and are ignored by the closed-loop ``run``.
    """

    dag: DAG
    plan: ExecutionPlan | None
    arrival: float
    tenant: str = "standard"
    plan_fn: "Callable[[], ExecutionPlan] | None" = None
    slo_s: float | None = None
    scenario: str = ""
    session: str = ""            # serving-session identity (KV affinity)


@dataclass(slots=True)
class _WfState:
    dag: DAG
    plan: ExecutionPlan | None
    arrival: float
    tenant: str = "standard"
    plan_fn: "Callable[[], ExecutionPlan] | None" = None
    done: set[str] = field(default_factory=set)
    started: set[str] = field(default_factory=set)
    finish: float = 0.0
    attempt: dict[str, int] = field(default_factory=dict)
    # work-items checkpointed per task: survived preemption, never re-run
    items_done: dict[str, int] = field(default_factory=dict)
    slo_s: float | None = None
    scenario: str = ""
    session: str = ""
    # indexed ready set: (topo_rank, task_id), kept sorted by insort
    ready: list = field(default_factory=list)
    adm: Admission | None = None
    sort_key: tuple | None = None     # static-policy dispatch key
    # fault machinery (inert when faults=None)
    dead: bool = False                # dead-lettered: retries exhausted
    fails: dict[str, int] = field(default_factory=dict)   # fault count/task


@dataclass(slots=True)
class _Running:
    """Book-keeping for an in-flight task (needed to preempt it)."""

    cfg: TaskConfig
    leases: list[Lease]
    insts: list[Instance]
    start: float
    end: float
    compute_begin: float      # start + weights-load wall time
    ndev: int
    dev_s: float
    pf: float
    note: str
    n_inst: int               # instances actually acquired (may be < plan)
    batch: int                # effective batch (CPU pools force 1)
    items_done0: int          # items already checkpointed before this run
    items_per_inst: int       # the split _duration charged (refund inverts it)
    resumable: bool           # chunkable: completed steps survive preempt
    session: str = ""         # serving session the run belongs to
    cache_frac: float = 0.0   # prefix-cache hit fraction priced into dur
    slow: float = 1.0         # straggler multiplier on the compute window


class EventLoopMixin:
    """The two drain loops over the engine's event heap.

    Mixed into ``Engine`` alongside the dispatch/ledger/recovery layers;
    relies on their handlers (``admit``/``on_finish``/``on_finish_batch``/
    ``on_fault_event``/``dispatch``).
    """

    def loop_closed(self):
        """Drain the heap for ``Simulator.run`` (all arrivals pre-queued)."""
        events = self.events
        heappop = heapq.heappop
        while events:
            t, _, kind, payload = heappop(events)
            self.t = t
            batch = [(kind, payload)]
            while events and events[0][0] == t:
                e = heappop(events)
                batch.append((e[2], e[3]))
            self.n_events += len(batch)
            fin = None
            for kind, payload in batch:
                if kind == "finish":
                    if fin is None:
                        fin = [payload]
                    else:
                        fin.append(payload)
                    continue
                if fin is not None:
                    self.on_finish_batch(fin)
                    fin = None
                if kind == "arrive":
                    self.admit(payload)
                else:
                    self.on_fault_event(kind, payload)
            if fin is not None:
                self.on_finish_batch(fin)
            self.dispatch()

    def loop_open(self, pull, autoscaler, scale_actions: list):
        """Drain the heap for ``Simulator.run_open_loop``.

        ``pull`` admits the next submission into the heap (one look-ahead);
        ``autoscaler`` is consulted on periodic ``scale`` events (``None``
        disables them — no such events are ever pushed then);
        ``scale_actions`` collects applied ``(t, pool, capacity)`` resizes.
        """
        events = self.events
        heappop = heapq.heappop
        heappush = heapq.heappush
        cluster = self.cluster
        wfs = self.wfs
        on_finish = self.on_finish
        on_finish_batch = self.on_finish_batch
        admit = self.admit
        dispatch = self.dispatch
        register_workflow = cluster.register_workflow
        while events:
            t, _, kind, payload = heappop(events)
            self.t = t
            n = 1
            while True:
                if kind == "finish":
                    if events and events[0][0] == t \
                            and events[0][2] == "finish":
                        # contiguous same-t finish run: coalesce. Finish
                        # handlers push nothing, so the run is stable.
                        fin = [payload]
                        while events and events[0][0] == t \
                                and events[0][2] == "finish":
                            fin.append(heappop(events)[3])
                        n += len(fin) - 1
                        on_finish_batch(fin)
                    else:
                        on_finish(payload)
                elif kind == "arrive":
                    admit(payload)
                    # keep exactly one future arrival in the heap
                    register_workflow(payload, wfs[payload].dag)
                    pull()
                elif kind == "scale":
                    for act in autoscaler.decide(
                            cluster, self.demand_by_pool(), t):
                        if act.lag_s > 0:
                            heappush(events,
                                     (t + act.lag_s, next(self.ctr),
                                      "scale_apply", act))
                        else:
                            autoscaler.apply(cluster, act, t)
                            scale_actions.append(
                                (t, act.pool, act.capacity))
                    if events or self.running or \
                            any(st.ready for st in wfs.values()):
                        heappush(events,
                                 (t + autoscaler.interval_s,
                                  next(self.ctr), "scale", None))
                elif kind == "scale_apply":
                    autoscaler.apply(cluster, payload, t)
                    scale_actions.append((t, payload.pool, payload.capacity))
                else:
                    self.on_fault_event(kind, payload)
                if events and events[0][0] == t:
                    t, _, kind, payload = heappop(events)
                    n += 1
                else:
                    break
            self.n_events += n
            dispatch()
