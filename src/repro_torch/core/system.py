"""Murakkab: the integrated system facade (Fig. 2).

Wires the agent library, profile store, cluster manager, planner, scheduler
and execution engine together. One object owns both halves the paper says
must talk: the *workflow orchestrator* (planner + scheduler) and the
*cluster manager* — DAGs flow down, utilization stats flow up.

    system = Murakkab.paper_cluster()
    result = Job(description=..., inputs=videos,
                 constraints=MIN_COST).execute(system)
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field, replace

from .agents import AgentLibrary, default_library
from .cluster import ClusterManager, Instance, Pool
from .dag import DAG
from .orchestrator import RulePlanner
from .profiles import ProfileStore
from .scheduler import ExecutionPlan, Scheduler
from .arrivals import SERVING_PRESETS, ArrivalProcess
from .simulator import (OpenLoopReport, SimReport, Simulator, Submission,
                        render_trace)
from .spec import build_node, input_units
from .workflow import COMPONENT_ALIASES, ImperativeWorkflow, Job


@dataclass
class JobResult:
    """Everything one declarative job execution produced."""

    makespan_s: float
    energy_wh: float
    usd: float
    quality: float
    dag: DAG
    plan: ExecutionPlan
    toolcalls: dict[str, str]
    sim: SimReport
    log: list[str] = field(default_factory=list)

    def trace_str(self) -> str:
        """ASCII Fig-3-style execution trace of the run."""
        return render_trace(self.sim)


class Murakkab:
    """The integrated system: orchestrator + scheduler + cluster manager."""

    PLAN_CACHE_MAX = 256

    def __init__(self, cluster: ClusterManager,
                 library: AgentLibrary | None = None,
                 planner=None, router=None, telemetry=None):
        self.library = library or default_library()
        self.profiles = ProfileStore(self.library)
        self.cluster = cluster
        self.planner = planner or RulePlanner(self.library)
        self.scheduler = Scheduler(self.library, self.profiles, self.cluster)
        # learned routing + telemetry feedback loop (DESIGN.md §11):
        # ``router`` is a core.router.Router consulted at the scheduler's
        # level-1 implementation choice; ``telemetry`` a
        # core.telemetry.TelemetryStore every simulator run logs per-task
        # outcomes into. Both default to None — provably inert: plans and
        # traces stay byte-identical to a system without the subsystem.
        self.scheduler.router = router
        self.telemetry = telemetry
        # admission-time plan reuse (DESIGN.md §7): identical tenants
        # arriving into an unchanged cluster skip the greedy search
        self._plan_cache: OrderedDict[tuple, ExecutionPlan] = OrderedDict()
        self.plan_cache_enabled = True
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0

    # -- the routing/telemetry loop (DESIGN.md §11) -----------------------------
    @property
    def router(self):
        """The learned router the scheduler consults (None = static)."""
        return self.scheduler.router

    @router.setter
    def router(self, r):
        self.scheduler.router = r

    def _routed_interfaces(self) -> tuple:
        """Interfaces whose impl choice the attached router decides."""
        r = self.scheduler.router
        return r.interfaces if r is not None else ()

    # -- cluster factories -------------------------------------------------------
    @classmethod
    def paper_cluster(cls, library: AgentLibrary | None = None,
                      calibrated: bool = True, router=None,
                      telemetry=None) -> "Murakkab":
        """The paper's testbed: 2x ND96amsr = 16x A100 + 192 EPYC vCPUs."""
        cluster = ClusterManager([
            Pool("gpu", "a100-80g", capacity=16),
            Pool("cpu", "epyc-7v12-core", capacity=192),
        ])
        sys = cls(cluster, library, router=router, telemetry=telemetry)
        if calibrated:
            from ..configs.workflow_video import calibrate_paper_profiles
            calibrate_paper_profiles(sys.profiles)
        return sys

    @classmethod
    def tpu_cluster(cls, v5e: int = 256, v5p: int = 64, v4_harvest: int = 128,
                    host_cores: int = 512,
                    library: AgentLibrary | None = None, router=None,
                    telemetry=None) -> "Murakkab":
        """Deployment target: TPU pools + CPU hosts + harvestable v4 slices."""
        cluster = ClusterManager([
            Pool("v5e", "tpu-v5e", capacity=v5e),
            Pool("v5p", "tpu-v5p", capacity=v5p),
            Pool("v4_harvest", "tpu-v4", capacity=v4_harvest,
                 harvestable=True),
            Pool("cpu", "host-core", capacity=host_cores),
        ])
        return cls(cluster, library, router=router, telemetry=telemetry)

    def prewarm(self, impl: str, pool: str, n_devices: int, count: int = 1):
        """Provision warm instances (PTU-style always-on capacity)."""
        for _ in range(count):
            lease = self.cluster.alloc(pool, n_devices, t=0.0)
            if lease is None:
                raise RuntimeError(f"prewarm {impl}: {pool} pool full")
            self.cluster.add_instance(Instance(impl, pool, n_devices,
                                               lease=lease))

    # -- declarative path -----------------------------------------------------------
    def lower(self, job: Job) -> DAG:
        """Decompose a declarative job into the task-DAG IR."""
        return self.planner.lower(job)

    def plan(self, job: Job) -> tuple[DAG, ExecutionPlan]:
        """Lower a job and choose a configuration for every task."""
        dag = self.lower(job)
        plan = self.scheduler.plan(dag, job.constraint_spec,
                                   job.quality_floor,
                                   session=job.session)
        return dag, plan

    def execute(self, job: Job, arrival: float = 0.0) -> JobResult:
        """Plan and run one declarative job on the simulated cluster.

        The single-tenant entry point (paper Listing 2): lowers the job,
        runs the greedy lever search under its constraints and quality
        floors, executes the plan on the discrete-event engine and returns
        the full ``JobResult`` (makespan/energy/$, DAG, plan, toolcalls,
        trace). For multi-tenant workloads use ``execute_many``.
        """
        dag, plan = self.plan(job)
        return self._run({"job": (dag, plan, arrival)}, dag, plan)

    def execute_many(self, jobs: dict[str, tuple[Job, float]],
                     policy: str | None = "fcfs",
                     log: list | None = None,
                     resume: bool = True,
                     faults=None) -> SimReport:
        """Multi-tenant submission: {id: (job, arrival_s)}.

        Jobs enter an admission queue ordered by ``policy`` (core/admission:
        ``fcfs`` | ``strict-priority`` | ``weighted-fair``) and are *planned
        on admission* — the scheduler sees the cluster state at each job's
        arrival (warm instances, devices held by earlier tenants) instead of
        planning every job upfront against an empty cluster. Each job's
        ``tenant_class`` decides its queue rank and whether its allocations
        are preemptible (harvest class). ``resume=False`` disables work-item
        checkpoint/resume of preempted tasks (DESIGN.md §6.4) — every
        victim restarts from scratch, the pre-resume baseline. ``faults``
        takes a :class:`core.faults.FaultProfile` to run under seeded
        fault injection with retry/hedge recovery (DESIGN.md §10).

        Admission-time planning goes through a plan cache keyed by (DAG
        structural signature, constraint spec, quality floor, cluster-state
        digest): an identical tenant arriving into an unchanged cluster
        reuses the prior plan instead of re-running the greedy search.
        """
        subs = {}
        for wid, (job, arrival) in jobs.items():
            dag = self.lower(job)

            def _plan(dag=dag, job=job):
                return self.plan_admitted(dag, job)

            subs[wid] = Submission(dag=dag, plan=None, arrival=arrival,
                                   tenant=job.tenant_class, plan_fn=_plan)
        sim = Simulator(self.cluster, self.library, self.profiles,
                        resume=resume, faults=faults,
                        telemetry=self.telemetry,
                        routed_interfaces=self._routed_interfaces())
        return sim.run(subs, log=log, policy=policy)

    def open_loop(self, process: ArrivalProcess, horizon_s: float, *,
                  warmup_s: float = 0.0, presets: dict | None = None,
                  policy: str | None = "strict-priority", autoscaler=None,
                  log: list | None = None, collect_trace: bool = True,
                  resume: bool = True, fast_dispatch: bool = True,
                  plan_mode: str = "amortized", kv_cache: bool = True,
                  cache_affinity: bool = True,
                  faults=None) -> OpenLoopReport:
        """Serve an open-loop arrival stream (DESIGN.md §8).

        ``process`` is a ``core.arrivals`` generator (Poisson / MMPP /
        trace replay); each :class:`ArrivalEvent` is turned into a
        ``Submission`` via the scenario's :class:`ServingPreset` (job
        factory + per-class SLO). Scenario DAGs are lowered once and
        shared across arrivals — sound because the engine only mutates
        private plan copies and per-workflow state — so a 10k-arrival
        sweep pays one lowering, not 10k.

        ``plan_mode`` picks the planning amortization:

        - ``"amortized"`` (default): each scenario is planned once, on its
          first arrival, and later arrivals reuse a private copy of that
          plan. This is the serving posture — plans are compiled per
          workflow template, not per request — and what makes a
          10k-arrival sweep feasible (the admission-time plan cache is
          keyed by the cluster digest, which differs at almost every
          open-loop arrival, so per-request planning re-runs the search).
        - ``"admission"``: the closed-loop semantics — every arrival plans
          against the live cluster digest through ``plan_admitted``.

        ``autoscaler`` is a ``core.autoscale.Autoscaler``; steady-state
        metrics trim the first ``warmup_s`` of arrivals.

        Session-aware presets (``ServingPreset.session_aware``) lower one
        job template per *turn index* — conversation history grows the
        token footprint — and each submission carries the event's session
        id, which the engine uses for KV-affinity placement and hit-rate
        prefill pricing (DESIGN.md §9). ``kv_cache``/``cache_affinity``
        forward to the :class:`Simulator` switches, as does ``faults``
        (a :class:`core.faults.FaultProfile` for seeded fault injection
        with retry/hedge/degradation recovery, DESIGN.md §10).
        """
        if plan_mode not in ("amortized", "admission"):
            raise ValueError(f"plan_mode must be 'amortized' or "
                             f"'admission', got {plan_mode!r}")
        presets = presets if presets is not None else SERVING_PRESETS
        if not presets:
            raise RuntimeError(
                "no serving presets available — import repro_torch.configs "
                "(workflow_video/rag/docingest) or pass presets=")
        lowered: dict[tuple, tuple[DAG, Job]] = {}
        plans: dict[tuple, ExecutionPlan] = {}

        def _stream():
            for i, ev in enumerate(process.events()):
                if ev.t > horizon_s:
                    break     # the engine stops pulling here anyway
                preset = presets[ev.scenario]
                # session-aware scenarios lower one template per turn
                # index (history grows the footprint); stateless ones
                # share a single template
                key = (ev.scenario,
                       ev.turn if preset.session_aware else 0)
                pair = lowered.get(key)
                if pair is None:
                    kw = ({"session": "", "turn": ev.turn}
                          if preset.session_aware else {})
                    job = (preset.make_job(preset.constraints, **kw)
                           if preset.constraints is not None
                           else preset.make_job(**kw))
                    pair = lowered[key] = (self.lower(job), job)
                dag, job = pair
                plan = plan_fn = None
                if plan_mode == "amortized":
                    tmpl = plans.get(key)
                    if tmpl is None:
                        tmpl = plans[key] = \
                            self.plan_admitted(dag, job)
                    # submissions share the template: the engine's only
                    # in-place plan mutation (capacity degrade) takes a
                    # copy-on-write private plan first
                    plan = tmpl
                    if faults is not None:
                        # degradation replans (retry pressure) re-plan
                        # this workflow against the live cluster; inert
                        # without faults, so the amortized fast path
                        # stays closure-free
                        def plan_fn(dag=dag, job=job):
                            return self.plan_admitted(dag, job)
                else:
                    pjob = (replace(job, session=ev.session)
                            if ev.session else job)

                    def plan_fn(dag=dag, job=pjob):
                        return self.plan_admitted(dag, job)

                yield f"w{i:06d}", Submission(
                    dag=dag, plan=plan, arrival=ev.t, tenant=ev.tenant,
                    plan_fn=plan_fn, slo_s=preset.slo_for(ev.tenant),
                    scenario=ev.scenario, session=ev.session)

        sim = Simulator(self.cluster, self.library, self.profiles,
                        resume=resume, fast_dispatch=fast_dispatch,
                        kv_cache=kv_cache, cache_affinity=cache_affinity,
                        faults=faults, telemetry=self.telemetry,
                        routed_interfaces=self._routed_interfaces())
        return sim.run_open_loop(_stream(), horizon_s, warmup_s=warmup_s,
                                 policy=policy, autoscaler=autoscaler,
                                 log=log, collect_trace=collect_trace)

    def plan_admitted(self, dag: DAG, job: Job) -> ExecutionPlan:
        """Plan one admitted workflow against live cluster state, reusing a
        cached plan when an identical (workflow, constraints, cluster-state)
        triple was already planned. Returns a private copy — the simulator
        may degrade configs in place when capacity shrank since planning."""
        if not self.plan_cache_enabled:
            return self.scheduler.plan(dag, job.constraint_spec,
                                       job.quality_floor,
                                       session=job.session)
        floor = job.quality_floor
        key = (dag.signature(), job.constraint_spec,
               tuple(sorted(floor.items())) if isinstance(floor, dict)
               else floor,
               self.cluster.digest(), self.profiles.version,
               # unlike pruning (plan-preserving), the search mode changes
               # chosen plans — toggling it must not serve cross-mode plans
               self.scheduler.joint_batch,
               # session affinity prices plans per session (warm-prefix
               # discounts differ even at equal cluster digests)
               job.session,
               # a learned router changes level-1 impl choices: any change
               # to what it would answer (weights version, epsilon, seed)
               # must invalidate cached plans; None when routing is off
               self.scheduler.router.fingerprint()
               if self.scheduler.router is not None else None)
        cached = self._plan_cache.get(key)
        if cached is not None:
            self._plan_cache.move_to_end(key)
            self.plan_cache_hits += 1
            return ExecutionPlan(dict(cached.configs))
        self.plan_cache_misses += 1
        plan = self.scheduler.plan(dag, job.constraint_spec,
                                   job.quality_floor,
                                   session=job.session)
        self._plan_cache[key] = ExecutionPlan(dict(plan.configs))
        if len(self._plan_cache) > self.PLAN_CACHE_MAX:
            self._plan_cache.popitem(last=False)
        return plan

    # -- imperative (baseline) path ----------------------------------------------------
    def execute_imperative(self, wf: ImperativeWorkflow,
                           inputs=()) -> JobResult:
        """Run a Listing-1 pinned workflow (the evaluation baseline)."""
        dag, plan = self.lower_imperative(wf, inputs)
        return self._run({"baseline": (dag, plan, 0.0)}, dag, plan)

    def lower_imperative(self, wf: ImperativeWorkflow, inputs=()) \
            -> tuple[DAG, ExecutionPlan]:
        """Listing-1 semantics: pinned impls/resources, sequential chain.

        Work-item cardinality and token footprints come from the component's
        interface (its declared ``CardinalityModel``/``TokenModel``) applied
        to the inputs' merged unit counts — no scenario knowledge here.
        """
        units = input_units(inputs)
        nodes, plan = [], ExecutionPlan()
        prev = None
        for i, comp in enumerate(wf.components()):
            alias = COMPONENT_ALIASES.get(comp.name.lower())
            if alias is None:
                raise KeyError(f"unknown component {comp.name!r}; aliases: "
                               f"{sorted(COMPONENT_ALIASES)}")
            iface_name, impl_name = alias
            iface = self.library.interfaces[iface_name]
            tid = f"c{i}_{iface_name}"
            node = build_node(tid, f"{comp.name} ({comp.kind})", iface,
                              (prev,) if prev else (), dict(comp.params),
                              units, chunkable=False)
            nodes.append(node)
            pool, n = self._resources_to_pool(comp.resources)
            cfg = self.scheduler.pin(node, impl_name, pool, n)
            # provisioned capacity (PTUs / pinned GPUs) is always-on => warm
            plan.configs[tid] = cfg.with_(warm=True)
            prev = tid
        return DAG(nodes), plan

    def _resources_to_pool(self, resources: dict) -> tuple[str, int]:
        for key, n in resources.items():
            k = key.lower()
            kind = {"gpus": "gpu", "ptus": "gpu", "cpus": "cpu",
                    "tpus": "tpu"}.get(k)
            if kind is None:
                continue
            if int(n) <= 0:
                raise ValueError(
                    f"non-positive device count {key}={n!r}; a pinned "
                    f"component must request >= 1 device")
            pools = self.cluster.pools_of_kind(kind)
            if not pools:
                raise ValueError(f"no pool of kind {kind!r} in cluster")
            # pinned (always-on) components need non-preemptible capacity:
            # a harvestable pool can be reclaimed under a component that
            # assumes its devices never go away
            pinned = [p for p in pools if not p.harvestable]
            if not pinned:
                raise ValueError(
                    f"only harvestable (preemptible) {kind!r} capacity in "
                    f"this cluster ({[p.name for p in pools]}); a pinned "
                    f"imperative component needs an always-on pool")
            return pinned[0].name, int(n)
        raise ValueError(f"unintelligible resources {resources!r}")

    # -- shared run ------------------------------------------------------------------
    def _run(self, wfs, dag: DAG, plan: ExecutionPlan) -> JobResult:
        log: list[str] = []
        sim = Simulator(self.cluster, self.library, self.profiles,
                        telemetry=self.telemetry,
                        routed_interfaces=self._routed_interfaces())
        report = sim.run(wfs, log=log)
        toolcalls = (self.planner.toolcalls(dag)
                     if hasattr(self.planner, "toolcalls") else {})
        return JobResult(
            makespan_s=report.makespan_s,
            energy_wh=report.energy_wh,
            usd=report.usd,
            quality=plan.total_quality(dag),
            dag=dag, plan=plan, toolcalls=toolcalls, sim=report, log=log)
