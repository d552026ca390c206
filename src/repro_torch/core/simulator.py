"""Discrete-event execution façade over the layered engine (``core/engine``).

Runs one or many workflows (DAG + ExecutionPlan) against the cluster
manager's pools: list-scheduling with dependency and capacity constraints,
warm-instance reuse, cold-start (weights-load) latencies, and energy/$
integration via ``EnergyLedger``. Produces per-task traces — the Fig-3
artifact — and is the scale path (a 1000-node cluster is just bigger pool
capacities; the engine is O(events log events)).

This module is the *stable import surface*: ``Simulator`` (run modes,
duration pricing, pool limits) plus re-exports of the engine's public
records (``Submission``/``TraceEntry``/``SimReport``/``OpenLoopReport``)
and ``render_trace``. The event loop, dispatch, accounting and recovery
layers live in :mod:`repro_torch.core.engine` (DESIGN.md §12):

- ``engine.events`` — event heap, clock, same-timestamp drain loops,
  contiguous-finish coalescing;
- ``engine.dispatch`` — admission, indexed ready-set, blocked-group epoch
  memo, task start/preempt/finish settlement;
- ``engine.ledger`` — energy/$/served charging and refunds, report
  assembly, steady-state serving metrics;
- ``engine.recovery`` — fault injection, retry/backoff, crash/repair,
  hedging.

Semantics notes:
- A *model* implementation (``load_time_s > 0`` or zoo-backed) executes on
  persistent warm instances; first use pays the load. Tools alloc/release
  per task.
- If fewer than ``n_instances`` instances fit right now, the task degrades
  gracefully to what fits (>=1) rather than deadlocking; if none fit, it
  waits for the next completion event.
- Energy: active increments per task; the idle floor for every metered pool
  is integrated over the *capacity timeline* at finalize (paper Table-2
  semantics; under autoscaling the floor follows ``set_capacity`` changes).
- Multi-tenant admission, harvest preemption and work-item
  checkpoint/resume semantics are documented on the engine layers that
  implement them (``engine.dispatch``, ``engine.ledger``).

Event-engine fast path (DESIGN.md §8): the dispatch loop keeps an *indexed
ready-set* per workflow — roots enter at admission, successors enter when
their last dependency finishes, preemption victims re-enter on cancel — so
each pass touches only genuinely ready tasks instead of rescanning every
workflow's whole DAG. Tasks that failed to start are skipped while their
pool's availability epoch is unchanged (``ClusterManager.free_epoch``).
The seed's full rescan survives as ``fast_dispatch=False`` — the reference
the equivalence tests compare byte-identical traces against.
"""
from __future__ import annotations

import heapq
import math
import time
from typing import Iterable, Iterator

from .admission import get_policy
from .agents import AgentLibrary
from .cluster import ClusterManager, Instance, kv_cache_cap
from .dag import DAG
from .energy import CATALOG
from .engine import (Engine, OpenLoopReport, SimReport, Submission,
                     TraceEntry)
from .faults import FaultProfile
from .profiles import CostQuery, ProfileStore
from .scheduler import ExecutionPlan, TaskConfig

# back-compat alias: the engine class was ``simulator._Engine`` before the
# package split
_Engine = Engine

__all__ = [
    "OpenLoopReport", "SimReport", "Simulator", "Submission", "TraceEntry",
    "render_trace",
]


class Simulator:
    """Discrete-event engine executing plans against the modeled cluster."""

    def __init__(self, cluster: ClusterManager, library: AgentLibrary,
                 profiles: ProfileStore, resume: bool = True,
                 fast_dispatch: bool = True, kv_cache: bool = True,
                 cache_affinity: bool = True,
                 faults: FaultProfile | None = None,
                 telemetry=None, routed_interfaces: tuple = ()):
        self.cluster = cluster
        self.library = library
        self.profiles = profiles
        # per-task outcome log feeding the offline routing evaluator
        # (DESIGN.md §11): a core.telemetry.TelemetryStore, written *after*
        # each task's accounting settles so it never influences the run;
        # None keeps the engine byte-identical to a telemetry-less one.
        # ``routed_interfaces`` marks which interfaces a learned router
        # chose the impl for (stamped onto the records).
        self.telemetry = telemetry
        self.routed_interfaces = frozenset(routed_interfaces)
        # seeded fault injection + recovery (DESIGN.md §10); None keeps
        # every fault path provably inert — runs are byte-identical to an
        # engine without the subsystem (the golden tests pin this)
        self.faults = faults
        # KV/prefix-cache residency (DESIGN.md §9). kv_cache is the master
        # switch: False makes every cache path provably inert (sessionless
        # pricing, no ledger writes) — the byte-identity reference.
        # cache_affinity is the placement lever: False keeps hit-rate
        # pricing but ranks warm shells cache-blind (the ablation axis the
        # cache bench compares against).
        self.kv_cache = kv_cache
        self.cache_affinity = cache_affinity
        # work-item checkpoint/resume of preempted chunkable tasks
        # (DESIGN.md §6.4); False restores restart-from-scratch for every
        # victim (the pre-resume baseline benchmarks compare against)
        self.resume = resume
        # indexed ready-set + blocked-group dispatch (DESIGN.md §8);
        # False selects the seed's full-rescan reference path, which the
        # equivalence tests compare byte-identical traces against
        self.fast_dispatch = fast_dispatch
        # autoscale limits per pool (run_open_loop fills this; closed-loop
        # runs treat current capacity as the limit)
        self._scale_limits: dict[str, int] = {}
        # pool capacities at fault-run start (seed_faults fills this):
        # with no autoscaler, a crash-shrunk pool's limit is its nominal
        # size, so over-sized plans wait for the repair instead of
        # permanently degrading to the post-crash capacity
        self._nominal_caps: dict[str, int] = {}
        # duration memo: open-loop serving re-runs identical (config, node
        # workload) pairs thousands of times; keyed on everything
        # _duration reads, including the profile-store version (pin()
        # bumps it, invalidating stale latencies)
        self._dur_memo: dict[tuple, tuple[float, float, int]] = {}

    def _pool_limit(self, pool: str) -> int:
        """Max capacity a pool may scale to (its size when not scaled).

        Autoscaler limits take precedence; otherwise a fault run answers
        with the pool's nominal (pre-crash) size, and a fault-free run
        with the current capacity (the seed's behaviour)."""
        lim = self._scale_limits.get(pool)
        if lim is not None:
            return lim
        return self._nominal_caps.get(pool,
                                      self.cluster.pools[pool].capacity)

    def _cache_cap(self, cfg: TaskConfig) -> float:
        """HBM bytes a new instance of ``cfg`` may devote to KV prefixes
        (0.0 when caches are off or the impl doesn't track KV)."""
        if not self.kv_cache:
            return 0.0
        impl = self.library.impls[cfg.impl]
        spec = CATALOG[self.cluster.pools[cfg.pool].device]
        return kv_cache_cap(spec, cfg.n_devices, impl.params_bytes,
                            impl.kv_bytes_per_token)

    # -- duration under actual warmth ------------------------------------------
    def _duration(self, node, cfg: TaskConfig, n_inst: int,
                  new_instances: int, items_done: int = 0,
                  cache_frac: float = 0.0) -> tuple[float, float, int]:
        """Wall/compute seconds (and per-instance item count) of one run.

        Returns ``(latency, compute, items_per_inst)``; the item split is
        returned so ``cancel_task``'s refund inverts *exactly* the schedule
        charged here (stored on ``_Running.items_per_inst``) rather than
        re-deriving it. ``cache_frac`` is the resident-prefix hit fraction:
        the schedule prices only the un-cached prefill (DESIGN.md §9).
        """
        key = (cfg.impl, cfg.pool, cfg.n_devices, cfg.batch, cfg.warm,
               n_inst, bool(new_instances), items_done, node.work_items,
               node.tokens_in, node.tokens_out, cache_frac,
               self.profiles.version)
        memo = self._dur_memo.get(key)
        if memo is not None:
            return memo
        impl = self.library.impls[cfg.impl]
        spec = CATALOG[self.cluster.pools[cfg.pool].device]
        work = impl.work_fn(node.tokens_in, node.tokens_out)
        batch = 1 if spec.kind == "cpu" else cfg.batch
        remaining = max(node.work_items - items_done, 0)
        items = math.ceil(remaining / max(n_inst, 1))
        # the same batched execution schedule the scheduler estimates with
        # (ProfileStore.schedule_latency: full steps + a remainder step at
        # its own price): one source of truth for plan vs actual. A resumed
        # attempt prices only the residual items (Scheduler.estimate takes
        # the same items_done, preserving estimate/actual parity); a warm
        # prefix discounts both sides through the same CostQuery.
        compute = self.profiles.schedule_latency(CostQuery(
            impl=impl, spec=spec, n_devices=cfg.n_devices, work=work,
            batch=batch, items=items, cache_hit_frac=cache_frac))
        lat = compute
        if new_instances and not cfg.warm:
            # cfg.warm = provisioned capacity (PTU-style): always-on, no load
            lat += impl.load_time_s
        out = (lat, compute, items)
        self._dur_memo[key] = out
        return out

    def _is_model(self, impl) -> bool:
        return impl.load_time_s > 0 or impl.arch is not None

    # -- closed-loop engine ------------------------------------------------------
    def run(self,
            workflows: "dict[str, tuple[DAG, ExecutionPlan, float] | Submission]",
            log: list | None = None, policy=None) -> SimReport:
        """Execute one or many workflows; returns the ``SimReport``.

        ``workflows`` maps workflow id to either a ``(dag, plan, arrival)``
        triple or a ``Submission`` (tenant class + optional admission-time
        ``plan_fn``). ``policy`` selects the admission order
        (``core.admission``: fcfs | strict-priority | weighted-fair);
        ``log`` collects human-readable event lines when provided.
        """
        pol = get_policy(policy)
        eng = Engine(self, pol, log)
        for wid, sub in workflows.items():
            if not isinstance(sub, Submission):
                dag, plan, arrival = sub
                sub = Submission(dag, plan, arrival)
            eng.add_submission(wid, sub)
        for wid, st in eng.wfs.items():
            self.cluster.register_workflow(wid, st.dag)
        if self.faults is not None:
            eng.seed_faults()
        try:
            eng.loop_closed()
        finally:
            self._nominal_caps = {}

        stuck = [(wid, tid) for wid, s in eng.wfs.items()
                 if not s.dead
                 for tid in s.dag.nodes
                 if tid not in s.done]
        if stuck:
            raise RuntimeError(f"deadlocked tasks (resources never fit): "
                               f"{stuck[:8]}")
        if __debug__:
            self.cluster.audit()
        makespan = max((st.finish for st in eng.wfs.values()), default=0.0)
        # instances still holding devices release at makespan (accounted as
        # idle power via the pool floor below).
        eng.finalize(makespan)
        return eng.report(makespan)

    # -- open-loop engine --------------------------------------------------------
    def run_open_loop(self,
                      source: "Iterable[tuple[str, Submission]]",
                      horizon_s: float,
                      *,
                      warmup_s: float = 0.0,
                      policy=None,
                      autoscaler=None,
                      log: list | None = None,
                      collect_trace: bool = True) -> OpenLoopReport:
        """Serve an open-loop arrival stream for ``horizon_s`` seconds.

        ``source`` yields ``(workflow_id, Submission)`` pairs with
        non-decreasing arrival times (``core.arrivals`` generators qualify);
        arrivals are pulled lazily — one look-ahead submission lives in the
        event heap at a time, so a 10k-workflow sweep never materializes
        its whole future. Arrivals past ``horizon_s`` are not admitted;
        admitted work drains to completion.

        Steady-state metrics trim the warmup: only workflows arriving in
        ``[warmup_s, horizon_s]`` count toward per-class SLO attainment,
        goodput, and the span percentiles. ``autoscaler`` (an
        ``core.autoscale.Autoscaler``) is consulted on periodic ``scale``
        events and applies pool resizes through
        ``ClusterManager.set_capacity`` — scale-ups after the policy lag,
        scale-downs immediately (cooldown permitting).
        """
        wall0 = time.perf_counter()
        pol = get_policy(policy)
        eng = Engine(self, pol, log, collect_trace=collect_trace)
        stream: Iterator[tuple[str, Submission]] = iter(source)
        arrivals = 0
        last_arrival = 0.0
        exhausted = False

        def _pull() -> bool:
            """Admit the next submission into the heap (one look-ahead)."""
            nonlocal arrivals, last_arrival, exhausted
            if exhausted:
                return False
            for wid, sub in stream:
                if sub.arrival > horizon_s:
                    # past the arrival window: stop pulling (the source may
                    # be an infinite generator)
                    exhausted = True
                    return False
                if sub.arrival < last_arrival:
                    raise ValueError(
                        f"open-loop source must be time-ordered: "
                        f"{wid!r} arrives at {sub.arrival} after "
                        f"{last_arrival}")
                last_arrival = sub.arrival
                eng.add_submission(wid, sub)
                arrivals += 1
                return True
            exhausted = True
            return False

        _pull()
        if self.faults is not None:
            eng.seed_faults()
        if autoscaler is not None:
            self._scale_limits = autoscaler.limits()
            autoscaler.validate(self.cluster)
            heapq.heappush(eng.events,
                           (autoscaler.interval_s, next(eng.ctr),
                            "scale", None))
        scale_actions: list[tuple] = []
        try:
            eng.loop_open(_pull, autoscaler, scale_actions)
        finally:
            self._scale_limits = {}
            self._nominal_caps = {}

        if __debug__:
            self.cluster.audit()
        makespan = max((st.finish for st in eng.wfs.values()), default=0.0)
        eng.finalize(makespan)
        rep = eng.report(makespan)
        wall = time.perf_counter() - wall0
        return eng.steady_state(rep, horizon_s, warmup_s, arrivals, wall,
                                scale_actions)

    def _relabel_lease(self, inst: Instance, harvest: bool, t: float):
        """Keep an instance lease's preemptibility in sync with the tenant
        running on it: a priority/standard task on a harvest-created warm
        instance must not be preemptible (and vice versa)."""
        lease = inst.lease
        if lease is None or lease.harvest == harvest:
            return
        if not self.cluster.lease_active(lease):
            inst.lease = None
            return
        # flip the flag in place (the lease keeps its id and devices; the
        # seed's release-then-realloc round trip was an artifact of Lease
        # being frozen). Flipping *to* harvest adds preemptible supply, so
        # the pool's availability epoch must move — a blocked priority
        # task may now preempt its way in; flipping away removes supply
        # and can never unblock anything.
        lease.harvest = harvest
        if harvest:
            self.cluster.free_epoch[lease.pool] += 1
            self.cluster.epoch_total += 1


def render_trace(report: SimReport, width: int = 72,
                 max_rows: int = 200) -> str:
    """ASCII Fig-3-style execution trace.

    Long runs are subsampled to ``max_rows`` evenly-spaced task rows (an
    open-loop sweep has tens of thousands — the full dump was unreadable
    and O(events) lines); a footer notes how many rows were elided.
    ``max_rows <= 0`` disables the cap.
    """
    if not report.trace:
        return "(empty trace)"
    span = max(report.makespan_s, 1e-9)
    entries = report.trace
    elided = 0
    if 0 < max_rows < len(entries):
        step = len(entries) / max_rows
        entries = [entries[int(i * step)] for i in range(max_rows)]
        elided = len(report.trace) - len(entries)
    lines = [f"{'task':<28s} {'pool':<10s} {'t':>7s}  timeline"]
    for e in entries:
        a = int(e.start / span * width)
        b = max(int(e.end / span * width), a + 1)
        bar = " " * a + "#" * (b - a)
        lines.append(f"{e.workflow + ':' + e.task:<28.28s} {e.pool:<10.10s} "
                     f"{e.end - e.start:7.1f}  |{bar:<{width}s}|")
    if elided:
        lines.append(f"... {elided} of {len(report.trace)} rows elided "
                     f"(raise max_rows to see more)")
    lines.append(f"makespan={report.makespan_s:.1f}s "
                 f"energy={report.energy_wh:.1f}Wh "
                 f"(active {report.active_wh:.1f} + idle {report.idle_wh:.1f})"
                 f" cost=${report.usd:.2f}")
    return "\n".join(lines)
