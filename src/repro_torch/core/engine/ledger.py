"""Ledger layer: energy/$/served charging, refunds, and run reports.

Charging happens at task start (``DispatchMixin.try_start`` bills active
energy/$ for the compute device-seconds up front); this layer owns the
inverse operations — the step-granular ``_refund`` that preemption, fault
failure and hedge cancellation share — plus the idle-floor integration
over each pool's capacity timeline at ``finalize`` and the report
assembly (``SimReport`` / ``OpenLoopReport``).

The refund contract (DESIGN.md §6.4): a chunkable victim's completed
batch steps survive — ``ProfileStore.completed_items`` inverts the exact
schedule ``_duration`` charged, including its prefix-cache discount — so
a resumed task's total charge across attempts is exactly
``schedule_latency(total items)``. Non-chunkable victims refund the
unexecuted remainder of the compute window; executed-then-discarded
device-seconds accrue in ``wasted_dev_s`` either way.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..profiles import CostQuery
from .events import TraceEntry, _Running, _WfState


@dataclass
class SimReport:
    """Aggregate outcome of one simulated run (energy, trace, spans)."""

    makespan_s: float
    energy_wh: float
    active_wh: float
    idle_wh: float
    usd: float
    trace: list[TraceEntry]
    per_workflow: dict[str, dict]
    pool_busy_device_s: dict[str, float]
    preemptions: int = 0
    requeues: int = 0            # task re-executions caused by preemption
    resumed_items: int = 0       # work-items salvaged by checkpoint/resume
    wasted_dev_s: float = 0.0    # executed-then-discarded device-seconds
    # KV/prefix-cache residency (DESIGN.md §9): lookups = session tasks
    # that could have hit, hits = tasks that started with a warm prefix
    cache_lookups: int = 0
    cache_hits: int = 0
    cache_hit_rate: float = 0.0
    prefill_tokens_saved: float = 0.0   # un-recomputed prefill tokens
    # fault injection + recovery (DESIGN.md §10); all zero when faults=None
    faults_injected: int = 0     # crashes + transient fails + stragglers
    instance_crashes: int = 0    # crash events that killed a live instance
    task_faults: int = 0         # transient mid-compute task failures
    fault_retries: int = 0       # task re-executions after a fault backoff
    hedges_launched: int = 0     # straggler duplicates started
    hedges_won: int = 0          # duplicates that beat their primary
    dead_letters: int = 0        # workflows abandoned (retries exhausted)
    degrade_replans: int = 0     # replans onto the degraded live cluster

    def workflow_span(self, wf: str) -> float:
        """Arrival-to-finish seconds for one workflow (tenant latency)."""
        return self.per_workflow[wf]["finish"] - self.per_workflow[wf]["start"]


@dataclass
class OpenLoopReport(SimReport):
    """SimReport + steady-state serving metrics from ``run_open_loop``."""

    horizon_s: float = 0.0       # arrival window length
    warmup_s: float = 0.0        # arrivals before this are trimmed
    offered_rps: float = 0.0     # arrivals / horizon
    arrivals: int = 0            # workflows admitted
    completed: int = 0           # workflows finished
    measured: int = 0            # completions past warmup (metric base)
    goodput_rps: float = 0.0     # SLO-met completions / measured seconds
    per_class: dict = field(default_factory=dict)
    n_events: int = 0            # heap events processed
    n_attempts: int = 0          # dispatch attempts (try_start calls)
    wall_s: float = 0.0
    events_per_s: float = 0.0    # (n_events + n_attempts) / wall_s
    scale_actions: list = field(default_factory=list)


class LedgerMixin:
    """Refunds, idle-floor finalization and report assembly."""

    def _refund(self, rec: _Running, vst: _WfState, vtid: str, t: float,
                salvage: bool = True):
        """Roll back an interrupted run's energy/$ charge, step-granularly.

        Shared by preemption (``cancel_task``), fault failures
        (``fail_task``) and hedge cancellation (``_kill_hedge``, with
        ``salvage=False`` — a losing duplicate's completed steps are
        discarded, never checkpointed). For a straggling run
        (``rec.slow != 1.0``) the schedule inversion sees the *unslowed*
        clock (the schedule charged normal step times; the wall merely
        stretched), and kept charges scale back up by ``slow`` — so the
        refund inverts exactly what ``try_start`` billed.
        """
        spec = self.specs[rec.cfg.pool]
        # the charged dev_s covers compute only (weights-load is an
        # idle-power period), so progress is measured over the compute
        # window [compute_begin, end] — a victim preempted mid-load
        # gets a full refund either way
        window = max(rec.end - rec.compute_begin, 1e-12)
        elapsed = min(max(t - rec.compute_begin, 0.0), window)
        # executed device-seconds so far; dev_s spreads uniformly over
        # the window (paths run concurrently, so the rate is
        # ndev * paths even when the wall clock is path-multiplied)
        exec_dev_s = rec.dev_s * (elapsed / window)
        if salvage and rec.resumable and self.resume:
            # checkpoint/resume: invert the step schedule over the
            # compute window — completed batch steps survive, the
            # in-flight step is discarded
            impl = self.impls[rec.cfg.impl]
            node = vst.dag.nodes[vtid]
            work = impl.work_fn(node.tokens_in, node.tokens_out)
            # the refund inverts the exact schedule _duration charged,
            # including its prefix-cache discount (rec.cache_frac)
            sched_elapsed = (elapsed if rec.slow == 1.0
                             else elapsed / rec.slow)
            done, wall = self.profiles.completed_items(CostQuery(
                impl=impl, spec=spec, n_devices=rec.cfg.n_devices,
                work=work, batch=rec.batch, items=rec.items_per_inst,
                elapsed_s=sched_elapsed, cache_hit_frac=rec.cache_frac))
            kept_items = min(done * rec.n_inst,
                             node.work_items - rec.items_done0)
            if kept_items:
                vst.items_done[vtid] = rec.items_done0 + kept_items
                self.resumed_items += kept_items
            # step-granular refund: completed steps stay charged (their
            # items never re-run); the in-flight step is refunded — its
            # items ride the residual requeue, which re-charges them,
            # so the task's total charge across attempts is exactly
            # schedule_latency(total items)
            kept_dev_s = wall * rec.ndev * rec.cfg.paths
            if rec.slow != 1.0:
                kept_dev_s *= rec.slow
            refund = max(rec.dev_s - kept_dev_s, 0.0)
            self.wasted_dev_s += max(exec_dev_s - kept_dev_s, 0.0)
        else:
            # restart from scratch (non-chunkable / resume disabled /
            # losing hedge): refund only the unexecuted remainder — the
            # executed compute stays charged (that energy was really
            # burned) and is all wasted, since nothing of it survives
            refund = rec.dev_s * (1.0 - elapsed / window)
            self.wasted_dev_s += exec_dev_s
        self.ledger.charge_active(spec, -refund,
                                  utilization=rec.pf, pool=rec.cfg.pool)
        self.busy[rec.cfg.pool] = self.busy.get(rec.cfg.pool, 0.0) - refund
        self.served.charge(vst.tenant, -refund)

    # -- accounting -----------------------------------------------------------
    def finalize(self, makespan: float):
        """Integrate the idle-power floor over each pool's capacity log."""
        for pool, p in self.cluster.pools.items():
            spec = p.spec
            log = self.cluster.capacity_log(pool)
            if len(log) == 1:
                # constant capacity: the seed's exact expression (golden
                # traces pin the float op order)
                self.ledger.charge_idle(spec, p.capacity, makespan)
            else:
                dev_s = self.cluster.capacity_device_seconds(pool, makespan)
                self.ledger.charge_idle(spec, 1, dev_s)

    def report(self, makespan: float) -> SimReport:
        per_wf = {wid: {"start": st.arrival, "finish": st.finish,
                        "tasks": len(st.dag), "tenant": st.tenant}
                  for wid, st in self.wfs.items()}
        return SimReport(
            makespan_s=makespan,
            energy_wh=self.ledger.wh,
            active_wh=self.ledger.active_joules / 3600.0,
            idle_wh=self.ledger.idle_joules / 3600.0,
            usd=self.ledger.usd,
            trace=sorted(self.trace,
                         key=lambda e: (e.start, e.end, e.workflow)),
            per_workflow=per_wf,
            pool_busy_device_s=self.busy,
            preemptions=self.cluster.preemptions - self.preempt0,
            requeues=self.requeues,
            resumed_items=self.resumed_items,
            wasted_dev_s=self.wasted_dev_s,
            cache_lookups=self.cache_lookups,
            cache_hits=self.cache_hits,
            cache_hit_rate=(self.cache_hits / self.cache_lookups
                            if self.cache_lookups else 0.0),
            prefill_tokens_saved=self.prefill_tokens_saved,
            faults_injected=self.faults_injected,
            instance_crashes=self.instance_crashes,
            task_faults=self.task_faults,
            fault_retries=self.fault_retries,
            hedges_launched=self.hedges_launched,
            hedges_won=self.hedges_won,
            dead_letters=self.dead_letters,
            degrade_replans=self.degrade_replans,
        )

    def steady_state(self, rep: SimReport, horizon_s: float,
                     warmup_s: float, arrivals: int, wall: float,
                     scale_actions: list) -> OpenLoopReport:
        """Fold steady-state serving metrics into an OpenLoopReport."""
        completed = 0
        per_class: dict[str, dict] = {}
        spans: dict[str, list[float]] = {}
        met: dict[str, int] = {}
        # dead-lettered workflows per tenant (post-warmup): they count
        # against SLO attainment — an abandoned request is a missed SLO,
        # not a dropped sample — but contribute no latency span
        dead: dict[str, int] = {}
        measured = 0
        goodput_n = 0
        for wid, st in self.wfs.items():
            done = len(st.done) == len(st.dag.nodes)
            if done:
                completed += 1
            if st.arrival < warmup_s:
                continue
            if st.dead:
                measured += 1
                dead[st.tenant] = dead.get(st.tenant, 0) + 1
                continue
            if not done:
                continue
            measured += 1
            span = st.finish - st.arrival
            spans.setdefault(st.tenant, []).append(span)
            if st.slo_s is not None:
                ok = span <= st.slo_s
                met[st.tenant] = met.get(st.tenant, 0) + (1 if ok else 0)
                if ok:
                    goodput_n += 1
        for tenant, ss in sorted(spans.items()):
            ss.sort()
            n = len(ss)
            per_class[tenant] = {
                "n": n,
                "p50_s": ss[int(0.50 * (n - 1))],
                "p95_s": ss[int(0.95 * (n - 1))],
                "p99_s": ss[int(0.99 * (n - 1))],
                "mean_s": sum(ss) / n,
                "dead": dead.get(tenant, 0),
                "slo_attainment": (
                    met[tenant] / (n + dead.get(tenant, 0))
                    if tenant in met else None),
            }
        for tenant, n_dead in sorted(dead.items()):
            if tenant not in per_class:
                # every post-warmup workflow of this class dead-lettered
                per_class[tenant] = {
                    "n": 0, "p50_s": 0.0, "p95_s": 0.0, "p99_s": 0.0,
                    "mean_s": 0.0, "dead": n_dead, "slo_attainment": 0.0,
                }
        elapsed = max(rep.makespan_s - warmup_s, 1e-9)
        n_ev = self.n_events + self.n_attempts
        return OpenLoopReport(
            **{f: getattr(rep, f) for f in (
                "makespan_s", "energy_wh", "active_wh", "idle_wh", "usd",
                "trace", "per_workflow", "pool_busy_device_s",
                "preemptions", "requeues", "resumed_items", "wasted_dev_s",
                "cache_lookups", "cache_hits", "cache_hit_rate",
                "prefill_tokens_saved", "faults_injected",
                "instance_crashes", "task_faults", "fault_retries",
                "hedges_launched", "hedges_won", "dead_letters",
                "degrade_replans")},
            horizon_s=horizon_s,
            warmup_s=warmup_s,
            offered_rps=arrivals / max(horizon_s, 1e-9),
            arrivals=arrivals,
            completed=completed,
            measured=measured,
            goodput_rps=goodput_n / elapsed,
            per_class=per_class,
            n_events=self.n_events,
            n_attempts=self.n_attempts,
            wall_s=wall,
            events_per_s=n_ev / max(wall, 1e-9),
            scale_actions=scale_actions,
        )
