"""Layered discrete-event engine (DESIGN.md §12).

``core/simulator.py`` used to hold the whole engine as one monolith; it is
now a thin façade over this package, whose modules are the engine's
layers:

- :mod:`.events` — the event heap, clock, same-timestamp drain loops and
  the state records events carry (``TraceEntry``/``Submission``/
  ``_WfState``/``_Running``), including contiguous-finish coalescing;
- :mod:`.dispatch` — admission, the indexed ready-set, the blocked-group
  epoch memo, task start/preemption and finish settlement;
- :mod:`.ledger` — energy/$/served charging inverses (step-granular
  refunds), the idle-floor capacity-timeline integration, and the
  ``SimReport``/``OpenLoopReport`` assembly;
- :mod:`.recovery` — fault injection, retry/backoff, crash/repair and
  hedge paths (all provably inert when ``faults=None``).

``Engine`` composes the four mixins over one shared state bag built here:
one instance per ``Simulator.run``/``run_open_loop`` call. The layers
deliberately share ``self`` (a run's state is one object graph — heap,
workflows, cluster, ledgers); the split is about *reading* the engine,
and about making each layer's contract explicit, not about isolating
state behind interfaces the hot path would then have to cross.
"""
from __future__ import annotations

import heapq
import itertools

from ..admission import ServedLedger
from ..energy import EnergyLedger
from ..faults import FaultProfile
from .dispatch import DispatchMixin
from .events import (EventLoopMixin, Submission, TraceEntry, _Running,
                     _WfState)
from .ledger import LedgerMixin, OpenLoopReport, SimReport
from .recovery import RecoveryMixin

__all__ = [
    "Engine", "OpenLoopReport", "SimReport", "Submission", "TraceEntry",
]


class Engine(EventLoopMixin, DispatchMixin, RecoveryMixin, LedgerMixin):
    """One run's event-loop state, shared by ``run`` and ``run_open_loop``.

    The seed kept all of this in closures inside ``run``; hoisting it lets
    the open-loop mode reuse admission, preemption, dispatch and accounting
    verbatim (identical float-op order — the golden tests pin it).
    """

    def __init__(self, sim, pol, log: list | None,
                 collect_trace: bool = True):
        self.sim = sim
        self.cluster = sim.cluster
        self.pol = pol
        self.log = log
        self.collect_trace = collect_trace
        # hot-path caches: pool -> device spec (device SKUs never change
        # mid-run; capacities may), impl name -> "is a model" (vs tool),
        # and the per-Simulator constants try_start reads on every attempt
        self.specs = {name: p.spec for name, p in sim.cluster.pools.items()}
        self.impls = sim.library.impls
        self.is_model = {name: sim._is_model(impl)
                         for name, impl in sim.library.impls.items()}
        self.profiles = sim.profiles
        self.resume = sim.resume
        self.kv_cache = sim.kv_cache
        self.cache_affinity = sim.cache_affinity
        self.tele = sim.telemetry
        # power_frac memo: pins never change mid-run, so (impl, pool,
        # n_devices) fully determines the fraction
        self._pf_memo: dict[tuple, float] = {}
        self.wfs: dict[str, _WfState] = {}
        self.ledger = EnergyLedger()
        self.served = ServedLedger()
        self.preempt0 = sim.cluster.preemptions
        self.trace: list[TraceEntry] = []
        self.busy: dict[str, float] = {}
        self.running: dict[tuple[str, str], _Running] = {}
        self.lease_owner: dict[int, tuple[str, str]] = {}
        self.requeues = 0
        self.resumed_items = 0
        self.wasted_dev_s = 0.0
        # fault injection + recovery (DESIGN.md §10). ``faults`` is None on
        # a fault-free run: every fault path below is gated on it, so the
        # event heap, float-op order and counters stay byte-identical.
        self.faults: FaultProfile | None = sim.faults
        self.retry = sim.faults.retry if sim.faults is not None else None
        self.hedges: dict[tuple[str, str], _Running] = {}
        self._pool_rng: dict = {}        # pool -> crash-process generator
        self.incomplete = 0              # live (not finished/dead) workflows
        self.faults_injected = 0
        self.instance_crashes = 0
        self.task_faults = 0
        self.fault_retries = 0
        self.hedges_launched = 0
        self.hedges_won = 0
        self.dead_letters = 0
        self.degrade_replans = 0
        # KV/prefix-cache counters (DESIGN.md §9)
        self.cache_lookups = 0
        self.cache_hits = 0
        self.prefill_tokens_saved = 0.0
        self.events: list[tuple[float, int, str, object]] = []
        self.ctr = itertools.count()
        self.t = 0.0
        self.n_events = 0
        self.n_attempts = 0
        # dispatch-order index over admitted, incomplete workflows:
        # static policies keep a key-sorted list (keys are immutable
        # admission facts); weighted-fair re-sorts per pass (virtual time
        # moves between passes)
        self.active: list[tuple[tuple, str]] = []    # static: (key, wid)
        self.active_dyn: list[str] = []              # dynamic: wids
        # static policies only: the subset of ``active`` whose ready set is
        # nonempty, kept key-sorted — dispatch passes iterate this instead
        # of filtering every active workflow (invariant: (key, wid) here
        # ⟺ wfs[wid].ready nonempty)
        self.active_ready: list[tuple[tuple, str]] = []
        # blocked-group memo: (impl, pool, n_devices, n_instances, tenant)
        # -> pool free_epoch at last failed attempt. Skip while unchanged.
        self.blocked: dict[tuple, int] = {}
        # root (topo_rank, tid) pairs per distinct DAG object (id-keyed;
        # the DAGs are kept alive by wfs entries)
        self._roots: dict[int, list] = {}
        # coalesced-finish-group state (events.py): inside a group this is
        # an ordered set (dict) of pools whose epoch bump is deferred to
        # group end; None outside a group (the per-finish bump path)
        self._pend_pools: dict | None = None

    def push_event(self, t: float, kind: str, payload) -> None:
        """Queue one event (cold-path helper; hot paths push inline)."""
        heapq.heappush(self.events, (t, next(self.ctr), kind, payload))
