"""Port vs reference: the Murakkab runtime (``repro_torch.core`` and the
workflow configs) against ``repro.core``, bitwise.

The runtime is host code made of Python floats, so the port keeps the
reference's operations in their order and every comparison here is exact:
floats by their bits (``float.hex``), DAGs by ``to_json()``, traces by
``trace_str()``. Each case builds the same objects from both packages and
compares what they give: the agent library, the paper cluster's calibrated
profile store, every built-in scenario under every constraint form, the
baseline's imperative path, the paper's endpoints, multi-tenant admission,
the open-loop determinism witness (plain, autoscaled, and under faults with
hedging), and the learned router.
"""
import dataclasses
import enum
import importlib
import random
from types import MappingProxyType, SimpleNamespace

import pytest

SCENARIO_MODULES = ("workflow_video", "workflow_rag", "workflow_docingest",
                    "workflow_chat")


def _pkg(root: str) -> SimpleNamespace:
    """The runtime modules of one package (the configs register their
    scenarios and serving presets on import)."""
    ns = SimpleNamespace(**{
        name: importlib.import_module(f"{root}.configs.{name}")
        for name in SCENARIO_MODULES})
    for name in ("arrivals", "autoscale", "dag", "energy", "faults",
                 "simulator"):
        setattr(ns, name, importlib.import_module(f"{root}.core.{name}"))
    ns.core = importlib.import_module(f"{root}.core")
    return ns


REF, PORT = _pkg("repro"), _pkg("repro_torch")


def _plain(x):
    """A structure comparable across the two packages: dataclasses as their
    class name and fields, enums by name, floats by their bits, callables by
    qualified name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, float):
        return ("float", x.hex())
    if isinstance(x, (dict, MappingProxyType)):
        return {_key(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
        items = sorted(x, key=repr) if isinstance(x, (set, frozenset)) else x
        return (type(x).__name__, [_plain(v) for v in items])
    if callable(x):
        return ("callable", getattr(x, "__qualname__", type(x).__name__))
    return x


def _key(k):
    plain = _plain(k)
    return repr(plain) if isinstance(plain, (dict, tuple, list)) else plain


def _both(fn):
    """``fn`` on the reference's modules and on the port's, compared."""
    want, got = fn(REF), fn(PORT)
    assert got == want
    return got


# -- the agent library and the profile store -----------------------------------

_LIB = REF.core.default_library()
TOKEN_GRID = [(0, 0), (1, 1), (900, 120), (1024, 256), (4096, 1), (6000, 24)]


@pytest.mark.parametrize("impl", sorted(_LIB.impls))
def test_agent_impl(impl):
    """Each impl's fields, its interface, its arch and its ``Work`` on a
    grid of (tokens_in, tokens_out)."""
    def row(pkg):
        lib = pkg.core.default_library()
        imp = lib.impls[impl]
        return (_plain(imp), _plain(lib.interfaces[imp.interface]), imp.arch,
                [_plain(imp.work_fn(i, o)) for i, o in TOKEN_GRID])
    _both(row)


def test_agent_library_interfaces_and_toolcalls():
    def rows(pkg):
        lib = pkg.core.default_library()
        return (_plain(lib.interfaces), sorted(lib.impls),
                {name: lib.toolcall(name, {"x": 1, "a": "b"})
                 for name in lib.interfaces})
    _both(rows)


@pytest.mark.parametrize("device", sorted(REF.energy.CATALOG))
def test_paper_cluster_profiles(device):
    """``paper_cluster()``'s calibrated store: its pins, and every profile
    row that runs on ``device`` (each compatible impl at 1 to 64 devices),
    with the catalog entry that prices them."""
    def rows(pkg):
        store = pkg.core.Murakkab.paper_cluster().profiles
        return (_plain(pkg.energy.CATALOG[device]), _plain(store._pinned),
                _plain(store._quality),
                [_plain(p) for p in store.profile_table(
                    {device: [1, 2, 4, 8, 16, 32, 64]})])
    _both(rows)


# -- the scenarios under every constraint form ----------------------------------

JOBS = {"video": ("workflow_video", "make_declarative_job"),
        "rag": ("workflow_rag", "make_rag_job"),
        "docingest": ("workflow_docingest", "make_docingest_job"),
        "chat": ("workflow_chat", "make_chat_job")}

CONSTRAINTS = {
    "min_cost": lambda c: c.MIN_COST,
    "min_energy": lambda c: c.MIN_ENERGY,
    "min_latency": lambda c: c.MIN_LATENCY,
    "max_quality": lambda c: c.MAX_QUALITY,
    "deadline_then_cost": lambda c: c.Lexicographic(c.Deadline(s=60.0),
                                                    c.MinCost()),
    "budget": lambda c: c.Lexicographic(c.Budget(usd=0.5, wh=40.0),
                                        c.MinLatency()),
    "weighted": lambda c: c.Weighted.of(cost=1.0, energy=0.5, latency=2.0,
                                        quality=0.25),
}


def _job(pkg, scenario: str, constraint: str):
    module, factory = JOBS[scenario]
    return getattr(getattr(pkg, module), factory)(
        CONSTRAINTS[constraint](pkg.core))


def _result(res) -> dict:
    return {"makespan_s": res.makespan_s.hex(), "energy_wh": res.energy_wh.hex(),
            "usd": res.usd.hex(), "quality": res.quality.hex(),
            "dag": res.dag.to_json(), "toolcalls": res.toolcalls,
            "plan": {t: _plain(c) for t, c in res.plan.configs.items()},
            "trace": res.trace_str(), "log": res.log}


@pytest.mark.parametrize("constraint", sorted(CONSTRAINTS))
@pytest.mark.parametrize("scenario", sorted(JOBS))
def test_scenario_plans_and_runs(scenario, constraint):
    """The DAG, toolcalls, every TaskConfig and the simulated result of one
    scenario under one constraint form on the paper cluster, and its plan
    on the TPU cluster."""
    def run(pkg):
        job = _job(pkg, scenario, constraint)
        tpu_dag, tpu_plan = pkg.core.Murakkab.tpu_cluster().plan(job)
        return (_result(job.execute(pkg.core.Murakkab.paper_cluster())),
                tpu_dag.to_json(),
                {t: _plain(c) for t, c in tpu_plan.configs.items()})
    _both(run)


def test_baseline_imperative_path():
    """The Listing-1 baseline: ``lower_imperative`` and
    ``execute_imperative`` over the paper videos."""
    def run(pkg):
        v = pkg.workflow_video
        system = pkg.core.Murakkab.paper_cluster()
        dag, plan = system.lower_imperative(v.make_baseline_workflow(),
                                            v.PAPER_VIDEOS)
        res = pkg.core.Murakkab.paper_cluster().execute_imperative(
            v.make_baseline_workflow(), v.PAPER_VIDEOS)
        return (dag.to_json(), {t: _plain(c) for t, c in plan.configs.items()},
                _result(res))
    _both(run)


def test_paper_endpoints():
    """The video scenario's endpoints: the baseline, MIN_COST's CPU row on
    the prewarmed cluster, and the STT-on-one-A100 row, with the
    baseline-to-Murakkab makespan and energy ratios."""
    def run(pkg):
        v = pkg.workflow_video

        def prewarmed():
            system = pkg.core.Murakkab.paper_cluster()
            system.prewarm("nvlm-72b", "gpu", 8)
            system.prewarm("nvlm-embed", "gpu", 2)
            system.prewarm("whisper-large", "gpu", 1)
            return system

        base = v.make_baseline_workflow().execute(
            pkg.core.Murakkab.paper_cluster(), inputs=v.PAPER_VIDEOS)
        cpu = v.make_declarative_job(pkg.core.MIN_COST).execute(prewarmed())
        system = prewarmed()
        job = v.make_declarative_job(pkg.core.MIN_COST)
        dag = system.lower(job)
        plan = system.scheduler.plan(dag, job.constraint_order, job.quality_floor)
        stt = next(t for t in dag.topo_order if "speech" in t)
        plan.configs[stt] = system.scheduler.pin(
            dag.nodes[stt], "whisper-large", "gpu", 1).with_(batch=2, warm=True)
        gpu = pkg.simulator.Simulator(system.cluster, system.library,
                                      system.profiles).run(
            {"gpu": (dag, plan, 0.0)})
        rows = {"baseline": base, "cpu": cpu, "gpu": gpu}
        return ({k: (r.makespan_s.hex(), r.energy_wh.hex())
                 for k, r in rows.items()},
                {k: ((base.makespan_s / r.makespan_s).hex(),
                     (base.energy_wh / r.energy_wh).hex())
                 for k, r in rows.items() if k != "baseline"})
    _both(run)


def test_planners_and_dag_overhead():
    """``RulePlanner``'s decomposition, ``LLMPlanner`` over a fixed reply,
    and ``dag_creation_overhead``."""
    reply = ('{"tasks": [{"id": "a", "agent": "frame_extract", "deps": [], '
             '"args": {"file": "x"}}, {"id": "b", "agent": "object_detect", '
             '"deps": ["a"], "args": {}}]}')

    def run(pkg):
        lib = pkg.core.default_library()
        job = pkg.workflow_video.make_declarative_job()
        rule = pkg.core.RulePlanner(lib)
        llm = pkg.core.LLMPlanner(lib, lambda system, user: reply)
        dag = rule.lower(job)
        return (_plain(rule.decompose(job)), dag.to_json(), rule.toolcalls(dag),
                llm.system_prompt(), llm.lower(job).to_json(),
                pkg.core.dag_creation_overhead(dag, 83.0).hex())
    _both(run)


# -- multi-tenant admission ------------------------------------------------------

def _tenant_mix(pkg, seed: int = 11, n: int = 12) -> dict:
    """A seeded mix of the three stateless scenarios over the three tenant
    classes, arrivals spread over two minutes."""
    rng = random.Random(seed)
    jobs = {}
    for i in range(n):
        scenario = rng.choice(("video", "rag", "docingest"))
        constraint = rng.choice(("min_cost", "min_latency", "min_energy"))
        tenant = rng.choice(("priority", "standard", "harvest"))
        job = dataclasses.replace(_job(pkg, scenario, constraint),
                                  tenant_class=tenant)
        jobs[f"w{i}_{scenario}_{tenant}"] = (job, rng.uniform(0.0, 120.0))
    return jobs


def _report(rep) -> dict:
    fields = _plain(rep)[1]
    for timing in ("wall_s", "events_per_s"):     # host clock, not the model
        fields.pop(timing, None)
    return fields


@pytest.mark.parametrize("policy", ["fcfs", "strict-priority", "weighted-fair"])
def test_execute_many_admission(policy):
    def run(pkg):
        system = pkg.core.Murakkab.tpu_cluster(v5e=64, v5p=16, v4_harvest=32,
                                               host_cores=128)
        log = []
        rep = system.execute_many(_tenant_mix(pkg), policy=policy, log=log)
        return _report(rep), log, system.plan_cache_hits
    _both(run)


# -- the open-loop determinism witness --------------------------------------------

def _witness(pkg, *, autoscaler=None, faults=None):
    """The serving sweep's middle point: rate 1.0, seed 3, horizon 10000,
    warmup 1000 on the 256/64/128/512 TPU cluster."""
    a = pkg.arrivals
    return pkg.core.Murakkab.tpu_cluster(
        v5e=256, v5p=64, v4_harvest=128, host_cores=512).open_loop(
        a.PoissonArrivals(rate_per_s=1.0, mix=a.default_mix(), seed=3),
        horizon_s=10000.0, warmup_s=1000.0, autoscaler=autoscaler,
        faults=faults, collect_trace=False)


def _harvest_autoscaler(pkg):
    s = pkg.autoscale
    return s.Autoscaler({"v4_harvest": s.PoolPolicy(
        min_devices=0, max_devices=128, target_util=0.75, scale_up_lag_s=30.0,
        cooldown_s=60.0)}, interval_s=15.0)


def _faults(pkg):
    return pkg.faults.FaultProfile(
        seed=17, instance_mtbf_s={"v5e": 900.0, "v5p": 1200.0,
                                  "v4_harvest": 600.0},
        repair_s=120.0, task_fail_p=0.02, straggler_p=0.03, hedge=True)


WITNESSES = {
    "plain": lambda pkg: _witness(pkg),
    "autoscaled": lambda pkg: _witness(pkg, autoscaler=_harvest_autoscaler(pkg)),
    "faults_hedged": lambda pkg: _witness(pkg, faults=_faults(pkg)),
}


@pytest.mark.parametrize("variant", sorted(WITNESSES))
def test_open_loop_determinism_witness(variant):
    """Energy, events and attempts equal to the reference's, and every other
    field of the report but the host's wall clock."""
    rep = {}

    def run(pkg):
        rep[pkg is PORT] = r = WITNESSES[variant](pkg)
        return (r.energy_wh.hex(), r.n_events, r.n_attempts, _report(r))
    _both(run)
    if variant == "faults_hedged":
        assert rep[True].faults_injected > 0 and rep[True].hedges_launched > 0


def test_open_loop_chat_sessions_with_kv_cache():
    """The stateful stream: multi-turn chat sessions with KV residency and
    cache affinity, with its trace."""
    def run(pkg):
        rep = pkg.core.Murakkab.tpu_cluster(
            v5e=64, v5p=16, v4_harvest=32, host_cores=128).open_loop(
            pkg.arrivals.SessionArrivals(0.2, scenario="chat", mean_turns=6.0,
                                         think_time_s=30.0, seed=7),
            horizon_s=400.0, warmup_s=60.0,
            presets={"chat": pkg.arrivals.SERVING_PRESETS["chat"]},
            kv_cache=True, cache_affinity=True)
        return _report(rep)
    _both(run)


# -- the learned router ------------------------------------------------------------

LOOKUP = "10-K 2024 item 1A filing"
SEMANTIC = "how does management describe margin pressure over time"


def _rec(pkg, impl, text, quality, usd, t=1.0):
    return pkg.core.TaskRecord(
        t=t, workflow="w", task="t", interface="retrieve", impl=impl, pool="p",
        features=pkg.core.featurize(text), latency_s=0.5, energy_j=0.0,
        usd=usd, quality=quality)


def _drift_log(pkg):
    store = pkg.core.TelemetryStore()
    for i in range(18):
        store.log(_rec(pkg, "drift-arm", LOOKUP, 0.95, 0.01, t=5.0 * i))
    for i in range(2):
        store.log(_rec(pkg, "drift-arm", LOOKUP, 0.40, 0.01, t=1000.0 + 10 * i))
    for t in (10.0, 60.0, 1000.0, 1010.0):
        store.log(_rec(pkg, "steady-arm", LOOKUP, 0.80, 0.01, t=t))
    return store


def _two_arm_log(pkg):
    store = pkg.core.TelemetryStore()
    for _ in range(6):
        store.log(_rec(pkg, "cheap-arm", LOOKUP, 0.93, 0.001))
        store.log(_rec(pkg, "good-arm", LOOKUP, 0.92, 0.010))
        store.log(_rec(pkg, "cheap-arm", SEMANTIC, 0.65, 0.001))
        store.log(_rec(pkg, "good-arm", SEMANTIC, 0.92, 0.010))
    return store


def test_offline_evaluator_rewards():
    """The evaluator's rewards on the drift log, as a lifetime mean and with
    a half-life, bitwise the reference's: the port keeps the reference's
    order of summation, which is not the plain mean's."""
    def run(pkg):
        store = _drift_log(pkg)
        ev = pkg.core.OfflineEvaluator
        return (_plain(ev(cost_weight=0.0).rewards(store)),
                _plain(ev(cost_weight=0.0, half_life_s=100.0).rewards(store)),
                _plain(ev(cost_weight=0.0, window_s=500.0).rewards(store)),
                store.to_jsonl())
    _both(run)


def test_trained_router_picks():
    """One update on the two-arm smoke log: the trained router's weights,
    fingerprint and pick for each query shape (and an exploring router's
    picks over a run of nodes)."""
    def run(pkg):
        core = pkg.core
        ev = core.OfflineEvaluator(quality_target=0.85, cost_weight=0.05,
                                   cost_key="usd")
        trained = ev.update(core.Router(interfaces=("retrieve",), epsilon=0.0,
                                        seed=0), _two_arm_log(pkg))
        explore = core.Router(interfaces=("retrieve",), epsilon=0.3, seed=5,
                              weights=dict(trained.weights))
        arms = ["cheap-arm", "good-arm"]
        nodes = [pkg.dag.TaskNode(id=f"t{i}", description="", agent="retrieve",
                                  args={"query": text})
                 for i, text in enumerate([LOOKUP, SEMANTIC] * 4)]
        return (_plain(trained.weights), trained.fingerprint(), trained.version,
                [trained.route(n, arms) for n in nodes],
                [explore.route(n, arms) for n in nodes])
    picks = _both(run)
    assert picks[3][:2] == ["cheap-arm", "good-arm"]


def test_port_core_exports_the_reference_api():
    """``repro_torch.core`` exports every name of ``repro.core.__all__``,
    and the executor's."""
    assert set(REF.core.__all__) <= set(PORT.core.__all__)
    assert {"Media", "RealExecutor", "seeded_sessions"} <= set(PORT.core.__all__)
    for name in PORT.core.__all__:
        assert hasattr(PORT.core, name), name
