"""Workflow-aware cluster manager (paper §3.2).

Tracks resource pools (TPU slices / GPUs / CPU-host cores), serves
allocations to the scheduler, and — the paper's key point — *sees workflow
DAGs*, so it can anticipate demand: pre-warm model instances for upcoming
tasks and reclaim instances no registered workflow will need
("if no workflows are expected to require a Speech-To-Text agent soon, it
can reallocate GPU resources from Whisper to Llama").

Also exposes *harvestable* capacity (the spot/harvest-VM analogue): devices
that are free right now but may be reclaimed; the orchestrator uses them for
optional execution paths (CoT top-k) but not for critical-path work.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from .dag import DAG
from .energy import CATALOG, DeviceSpec

# fraction of an instance's post-weights HBM headroom budgeted for the
# KV/prefix cache (the rest is activations/fragmentation slack)
KV_BUDGET_FRAC = 0.9


def kv_cache_cap(spec: DeviceSpec, n_devices: int, params_bytes: float,
                 kv_bytes_per_token: float) -> float:
    """HBM bytes an instance can devote to resident prefix KV.

    Weights are sharded across the device group, so the budget is the
    group's aggregate HBM minus one copy of the weights, scaled by
    :data:`KV_BUDGET_FRAC`. Zero when the implementation declares no KV
    footprint (tools, non-attention models) — such instances never cache.
    """
    if kv_bytes_per_token <= 0:
        return 0.0
    return max(spec.hbm_bytes * n_devices - params_bytes, 0.0) \
        * KV_BUDGET_FRAC


@dataclass(slots=True)
class CacheEntry:
    """One resident prefix: a session's KV bytes held on an instance."""

    session: str
    tokens: int                # prefix tokens the entry can serve
    bytes: float               # HBM residency (kv_bytes_per_token * tokens)
    last_used: float           # LRU recency (sim time)


@dataclass
class Pool:
    """One homogeneous capacity pool of a single device SKU."""

    name: str
    device: str                # DeviceSpec name
    capacity: int
    reserved: int = 0          # devices reserved for priority tenants
    harvestable: bool = False  # spot-like: allocs may be preempted

    @property
    def spec(self) -> DeviceSpec:
        """The pool's hardware SKU record."""
        return CATALOG[self.device]


class Lease:
    """A granted device allocation (preemptible when ``harvest``).

    A plain ``__slots__`` class rather than a frozen dataclass: the engine
    mints one per allocation on its hot path, and slot assignment is several
    times cheaper than the frozen-dataclass ``object.__setattr__`` chain.
    Only ``harvest`` is ever reassigned (the engine's lease relabeling);
    treat everything else as immutable. ``session`` is the chat/agent-loop
    session the allocation serves, when known — an attribution hint for
    debugging and audits, not a scheduling input.
    """

    __slots__ = ("id", "pool", "n_devices", "t_start", "harvest", "session")

    def __init__(self, id: int, pool: str, n_devices: int, t_start: float,
                 harvest: bool = False, session: str = ""):
        self.id = id
        self.pool = pool
        self.n_devices = n_devices
        self.t_start = t_start
        self.harvest = harvest            # preemptible allocation
        self.session = session            # serving-session attribution hint

    def __repr__(self):
        return (f"Lease(id={self.id}, pool={self.pool!r}, "
                f"n_devices={self.n_devices}, t_start={self.t_start}, "
                f"harvest={self.harvest})")


@dataclass(eq=False, slots=True)
class Instance:
    """A warm model instance: weights resident on a device group.

    Identity equality (``eq=False``): instances are unique live objects,
    and the eviction path removes them from lists — value equality would
    make every ``list.remove`` compare all fields of every element.
    """

    impl: str
    pool: str
    n_devices: int
    busy_until: float = 0.0
    warm_since: float = 0.0
    lease: "Lease | None" = None   # the devices this instance holds
    # provisioning sequence number (assigned by ``add_instance``): lets
    # index-driven scans reproduce the global instance-list order exactly
    seq: int = 0
    # KV/prefix-cache residency (DESIGN.md §9): HBM budget left after the
    # weights, and the prefix entries resident in it, keyed by session.
    # Entries live and die with the instance — eviction drops them.
    cache_cap_bytes: float = 0.0
    cache: dict[str, CacheEntry] = field(default_factory=dict)


class ClusterManager:
    """Pools + leases + warm instances + workflow-aware reclamation."""

    def __init__(self, pools: list[Pool]):
        self.pools: dict[str, Pool] = {p.name: p for p in pools}
        self._used: dict[str, int] = {p.name: 0 for p in pools}
        self._leases: dict[int, Lease] = {}
        self._ids = itertools.count()
        self.instances: list[Instance] = []
        self._dags: dict[str, DAG] = {}
        self._done: dict[str, set[str]] = {}
        self.preemptions: int = 0
        # dirty-flag-cached digest (DESIGN.md §8): recomputed only after a
        # mutation that the planner could observe (alloc/release/instance
        # add/evict/capacity change) instead of on every admission
        self._digest: tuple | None = None
        # per-pool availability epoch: bumped whenever a blocked task could
        # newly fit (devices freed, capacity raised, preemptible supply
        # appeared). The simulator's dispatch memo skips re-attempting
        # tasks whose pool epoch hasn't moved since they last failed.
        self.free_epoch: dict[str, int] = {p.name: 0 for p in pools}
        # sum of all per-pool epoch bumps: lets the dispatcher prove a
        # whole re-scan pass would be a no-op (nothing became available)
        self.epoch_total: int = 0
        # capacity timeline per pool: [(t, capacity), ...] — the idle-power
        # floor integrates over this (autoscaled pools stop paying idle for
        # capacity they scaled away)
        self._cap_log: dict[str, list[tuple[float, int]]] = {
            p.name: [(0.0, p.capacity)] for p in pools}
        # warm-instance index: (impl, pool, n_devices) -> instances, so the
        # engine's reuse scan is O(matching) not O(all instances)
        self._inst_index: dict[tuple[str, str, int], list[Instance]] = {}
        # per-pool instance index (insertion-ordered like ``instances``, so
        # scans over one pool see victims in the same order a scan over the
        # global list would): the engine's idle-eviction and crash-victim
        # scans are O(pool) not O(cluster)
        self._pool_insts: dict[str, list[Instance]] = {
            p.name: [] for p in pools}
        # per-impl instance index + provisioning sequence: ``rebalance``
        # scans only the dead interfaces' instances (merged back into
        # global provisioning order via ``Instance.seq``) instead of the
        # whole cluster
        self._impl_insts: dict[str, list[Instance]] = {}
        self._iseq = itertools.count()
        # session -> instances holding a resident prefix entry for it (the
        # scheduler's affinity lookup; mirrors Instance.cache exactly)
        self._cache_index: dict[str, list[Instance]] = {}
        # incrementally-maintained pending-task count per agent interface
        # (upcoming_demand used to rescan every registered DAG)
        self._demand: dict[str, int] = {}
        # set when some interface's pending count just hit zero — the only
        # moment rebalance() can newly reclaim instances, so the engine
        # gates its per-finish rebalance call on this
        self.demand_zeroed: bool = False

    # -- allocation ------------------------------------------------------------
    def free(self, pool: str) -> int:
        """Unallocated devices in ``pool`` right now."""
        p = self.pools[pool]
        return p.capacity - self._used[pool]

    def alloc(self, pool: str, n: int, t: float, harvest: bool = False, *,
              session: str = "") -> Lease | None:
        """Grant ``n`` devices, or None when they don't fit.

        ``session`` (keyword-only) attributes the allocation to a serving
        session — recorded on the lease for audits/debugging; it does not
        change what fits.
        """
        if n <= 0 or self.pools[pool].capacity - self._used[pool] < n:
            return None
        self._used[pool] += n
        lease = Lease(next(self._ids), pool, n, t, harvest, session)
        self._leases[lease.id] = lease
        self._digest = None
        if harvest:
            # new preemptible supply: a blocked priority task that could
            # not preempt its way in before may fit now
            self.free_epoch[pool] += 1
            self.epoch_total += 1
        return lease

    def release(self, lease: Lease, t: float):
        """Return a lease's devices; double release is an error."""
        if lease.id not in self._leases:
            raise KeyError(f"double release of lease {lease.id}")
        del self._leases[lease.id]
        self._used[lease.pool] -= lease.n_devices
        self._digest = None
        self.free_epoch[lease.pool] += 1
        self.epoch_total += 1

    # -- elastic capacity (core/autoscale.py) -----------------------------------
    def set_capacity(self, pool: str, capacity: int, t: float) -> int:
        """Resize a pool (autoscaler lever); returns the applied capacity.

        Never shrinks below the devices currently allocated (live leases are
        pinned demand — the autoscaler cannot preempt by resizing), and
        records the change on the capacity timeline so the idle-power floor
        integrates capacity *over time* instead of charging the final size
        for the whole run.
        """
        p = self.pools[pool]
        capacity = max(int(capacity), self._used[pool])
        if capacity == p.capacity:
            return capacity
        grew = capacity > p.capacity
        p.capacity = capacity
        self._cap_log[pool].append((t, capacity))
        self._digest = None
        if grew:
            self.free_epoch[pool] += 1
            self.epoch_total += 1
        return capacity

    def capacity_device_seconds(self, pool: str, until: float) -> float:
        """∫ capacity dt over [0, until] (the idle-floor integral)."""
        log = self._cap_log[pool]
        total = 0.0
        for (t0, cap), (t1, _) in zip(log, log[1:]):
            total += cap * (min(t1, until) - min(t0, until))
        t_last, cap_last = log[-1]
        total += cap_last * max(until - t_last, 0.0)
        return total

    def capacity_log(self, pool: str) -> list[tuple[float, int]]:
        """The pool's capacity timeline [(t, capacity), ...]."""
        return list(self._cap_log[pool])

    def lease_active(self, lease: Lease) -> bool:
        """True while the lease still holds devices (not yet released)."""
        return lease.id in self._leases

    def harvest_devices(self, pool: str) -> int:
        """Devices currently held by preemptible (harvest) leases."""
        return sum(lease.n_devices for lease in self._leases.values()
                   if lease.pool == pool and lease.harvest)

    def preempt_harvest(self, pool: str, n_needed: int, t: float) \
            -> list[Lease]:
        """Reclaim harvest leases to make room (spot semantics)."""
        victims = []
        for lease in list(self._leases.values()):
            if lease.pool == pool and lease.harvest and n_needed > 0:
                victims.append(lease)
                n_needed -= lease.n_devices
        for v in victims:
            self.release(v, t)
            self.preemptions += 1
        return victims

    # -- stats for the orchestrator (paper: "continuously receives stats") -----
    def stats(self) -> dict[str, dict]:
        """Per-pool scheduling facts: device/kind/capacity/free/harvestable."""
        out = {}
        for name, p in self.pools.items():
            free = self.free(name)
            out[name] = {
                "device": p.device, "kind": p.spec.kind,
                "capacity": p.capacity, "free": free,
                "harvestable": free if p.harvestable else
                    max(free - p.reserved, 0),
            }
        return out

    def pools_of_kind(self, kind: str) -> list[Pool]:
        """Pools whose device kind matches (gpu | cpu | tpu)."""
        return [p for p in self.pools.values() if p.spec.kind == kind]

    def digest(self) -> tuple:
        """Hashable snapshot of every cluster fact the scheduler reads.

        Pool occupancy (``stats()``'s free/harvestable derive from it) plus
        the warm-instance set (plan_task's warmth check). Equal digests ⟹
        the deterministic scheduler returns identical plans, which is what
        makes the admission-time plan cache sound (DESIGN.md §7). Instance
        busy-times and lease identities are deliberately excluded — the
        planner never reads them.

        Cached behind a dirty flag: ``alloc``/``release`` (which covers
        ``preempt_harvest`` and ``evict_instance``), ``add_instance`` and
        ``set_capacity`` invalidate; every other read returns the memo, so
        admission-time plan-cache lookups stop rescanning pools/instances.
        Pool capacities are part of the digest because the autoscaler makes
        them dynamic and the planner reads them.
        """
        if self._digest is None:
            self._digest = (
                tuple(sorted(self._used.items())),
                tuple(sorted((name, p.capacity)
                             for name, p in self.pools.items())),
                frozenset((i.impl, i.pool) for i in self.instances),
                # resident prefix entries: session-affinity planning reads
                # them, so equal digests must mean equal cache state (a
                # sorted tuple, not a frozenset — two same-shaped instances
                # may both hold a session and multiplicity matters).
                # last_used is excluded: the planner never reads recency.
                tuple(sorted((i.impl, i.pool, s, e.tokens)
                             for i in self.instances
                             for s, e in i.cache.items())))
        return self._digest

    # -- workflow awareness ------------------------------------------------------
    def register_workflow(self, wf_id: str, dag: DAG):
        """Announce an admitted workflow's DAG (feeds upcoming_demand)."""
        self._dags[wf_id] = dag
        self._done[wf_id] = set()
        d = self._demand
        for node in dag.nodes.values():
            d[node.agent] = d.get(node.agent, 0) + 1

    def complete_task(self, wf_id: str, task_id: str):
        """Mark a task done; fully-done workflows stop counting as demand."""
        done = self._done.get(wf_id)
        if done is not None and task_id not in done:
            done.add(task_id)
            dag = self._dags[wf_id]
            agent = dag.nodes[task_id].agent
            demand = self._demand
            demand[agent] -= 1
            if demand[agent] == 0:
                self.demand_zeroed = True
            if len(done) >= len(dag.nodes):
                del self._dags[wf_id], self._done[wf_id]

    def abandon_workflow(self, wf_id: str):
        """Drop a dead-lettered workflow's remaining demand (fault path).

        The engine calls this when a workflow exhausts its retry budget:
        its unfinished tasks will never run, so they must stop counting as
        upcoming demand (otherwise the autoscaler would hold capacity for
        work that can no longer arrive). Safe to call for unknown ids.
        """
        dag = self._dags.pop(wf_id, None)
        if dag is None:
            return
        done = self._done.pop(wf_id, set())
        d = self._demand
        for tid, node in dag.nodes.items():
            if tid in done:
                continue
            d[node.agent] -= 1
            if d[node.agent] == 0:
                self.demand_zeroed = True

    def upcoming_demand(self) -> dict[str, int]:
        """Pending task count per agent interface, across registered DAGs.

        Maintained incrementally (+1 per node at ``register_workflow``, -1
        at ``complete_task``) — the seed rescanned every registered DAG on
        each call, which the open-loop rebalance cadence can't afford.
        """
        return {agent: n for agent, n in self._demand.items() if n > 0}

    # -- warm instances ------------------------------------------------------------
    def find_instance(self, impl: str, t: float) -> Instance | None:
        """Earliest-available warm instance of ``impl``."""
        cands = self._impl_insts.get(impl)
        return min(cands, key=lambda i: i.busy_until) if cands else None

    def warm_instances(self, impl: str, pool: str,
                       n_devices: int) -> list[Instance]:
        """Instances matching (impl, pool, n_devices) exactly — O(matching)
        via the instance index (the simulator's reuse scan)."""
        return self._inst_index.get((impl, pool, n_devices), ())

    def pool_instances(self, pool: str) -> list[Instance]:
        """Live warm instances on ``pool``, in provisioning order."""
        return self._pool_insts.get(pool, ())

    def add_instance(self, inst: Instance):
        """Track a newly-provisioned warm model instance."""
        inst.seq = next(self._iseq)
        self.instances.append(inst)
        key = (inst.impl, inst.pool, inst.n_devices)
        rows = self._inst_index.get(key)
        if rows is None:
            rows = self._inst_index[key] = []
        rows.append(inst)
        rows = self._pool_insts.get(inst.pool)
        if rows is None:
            rows = self._pool_insts[inst.pool] = []
        rows.append(inst)
        rows = self._impl_insts.get(inst.impl)
        if rows is None:
            rows = self._impl_insts[inst.impl] = []
        rows.append(inst)
        self._digest = None

    # -- KV/prefix-cache ledger (DESIGN.md §9) ----------------------------------
    def cached_instances(self, session: str) -> list[Instance]:
        """Instances holding a resident prefix entry for ``session``."""
        return list(self._cache_index.get(session, ()))

    def cache_tokens(self, inst: Instance, session: str) -> int:
        """Prefix tokens resident for ``session`` on ``inst`` (0 if none)."""
        entry = inst.cache.get(session)
        return entry.tokens if entry is not None else 0

    def cache_residency(self, inst: Instance) -> float:
        """Total HBM bytes ``inst``'s resident prefix entries occupy."""
        return sum(e.bytes for e in inst.cache.values())

    def cache_touch(self, inst: Instance, session: str, t: float):
        """Refresh an entry's LRU recency (a task just reused the prefix).

        Recency is not part of the digest (the planner reads presence and
        token counts, never last-used times), so touching stays O(1) with
        no plan-cache invalidation.
        """
        entry = inst.cache.get(session)
        if entry is not None:
            entry.last_used = t

    def cache_insert(self, inst: Instance, session: str, tokens: int,
                     nbytes: float, t: float) -> bool:
        """Insert or refresh a session's prefix entry, LRU-evicting to fit.

        Returns False without touching the ledger when the instance has no
        cache budget or the entry alone exceeds it. Otherwise older entries
        (least-recently-used first, session name as the deterministic
        tie-break) are evicted until the new entry fits; residency never
        exceeds ``cache_cap_bytes`` (an ``audit()`` invariant). Mutations
        invalidate the digest so the admission plan cache re-keys.
        """
        if not session or inst.cache_cap_bytes <= 0 \
                or nbytes > inst.cache_cap_bytes:
            return False
        old = inst.cache.pop(session, None)
        resident = sum(e.bytes for e in inst.cache.values())
        while inst.cache and resident + nbytes > inst.cache_cap_bytes:
            lru = min(inst.cache,
                      key=lambda s: (inst.cache[s].last_used, s))
            resident -= inst.cache[lru].bytes
            self._drop_entry(inst, lru)
        inst.cache[session] = CacheEntry(session, int(tokens), float(nbytes),
                                         t)
        if old is None:
            self._cache_index.setdefault(session, []).append(inst)
        self._digest = None
        return True

    def _drop_entry(self, inst: Instance, session: str):
        """Remove one prefix entry, keeping the session index in sync."""
        del inst.cache[session]
        group = self._cache_index.get(session)
        if group is not None:
            group.remove(inst)
            if not group:
                del self._cache_index[session]

    def rebalance(self, library, t: float) -> list[str]:
        """Reclaim warm instances for interfaces with no upcoming demand.

        Returns a log of actions (tested; the paper's Whisper->Llama example).
        A shell holding resident session prefixes is *not* reclaimed here:
        KV residency is a first-class resource (DESIGN.md §9), and pending
        demand undercounts it — the sessions whose prefixes live on the
        shell return after think-time gaps the demand ledger cannot see.
        Such shells still fall to allocation-pressure eviction
        (``evict_instance`` via the engine's alloc path) and to harvest
        preemption, both of which drop the cache with the shell.
        """
        # only interfaces whose pending count sits at zero can lose
        # instances — when none do (the common case), skip the scan
        dead = {iface for iface, n in self._demand.items() if n <= 0}
        if not dead:
            return []
        actions = []
        impls = library.impls
        # scan only the dead interfaces' instances via the per-impl index,
        # merged back into global provisioning order (Instance.seq) so the
        # eviction sequence — and the actions log — is exactly what a scan
        # over the full instance list would produce
        cands: list[Instance] = []
        for impl_name, group in self._impl_insts.items():
            if group and impls[impl_name].interface in dead:
                cands.extend(group)
        cands.sort(key=lambda i: i.seq)
        for inst in cands:
            if inst.busy_until <= t and not inst.cache:
                iface = impls[inst.impl].interface
                self.evict_instance(inst, t)
                actions.append(f"reclaim {inst.impl} ({inst.n_devices} dev "
                               f"of {inst.pool}): no upcoming {iface} demand")
        return actions

    def evict_instance(self, inst: Instance, t: float):
        """Remove a warm instance and free its devices.

        The instance's resident prefix entries die with it — harvest
        preemption therefore evicts the preempted instance's KV cache
        (DESIGN.md §9): a resumed task re-plans against a cluster that no
        longer advertises those prefixes.
        """
        for session in list(inst.cache):
            self._drop_entry(inst, session)
        self.instances.remove(inst)
        self._inst_index[(inst.impl, inst.pool, inst.n_devices)].remove(inst)
        self._pool_insts[inst.pool].remove(inst)
        self._impl_insts[inst.impl].remove(inst)
        self._digest = None
        if inst.lease is not None and inst.lease.id in self._leases:
            self.release(inst.lease, t)

    def audit(self):
        """Assert the instance/lease bookkeeping invariants.

        Used by tests around the preemption/eviction paths: (1) per-pool
        usage equals the sum of live lease sizes and never exceeds
        capacity; (2) every instance's lease, when still live, belongs to
        the lease table and matches the instance's pool and device count;
        (3) no two instances share a lease; (4) cache-ledger invariants —
        no prefix entry indexed on a dead instance, per-instance residency
        never above the HBM cache budget, and the session index mirroring
        the per-instance entry dicts exactly. Raises ``AssertionError``
        with the violated fact otherwise.
        """
        by_pool: dict[str, int] = {name: 0 for name in self.pools}
        for lease in self._leases.values():
            by_pool[lease.pool] += lease.n_devices
        for name, p in self.pools.items():
            assert self._used[name] == by_pool[name], (
                f"pool {name}: used={self._used[name]} but live leases "
                f"hold {by_pool[name]}")
            assert 0 <= self._used[name] <= p.capacity, (
                f"pool {name}: used={self._used[name]} outside "
                f"[0, {p.capacity}]")
        seen: set[int] = set()
        for inst in self.instances:
            if inst.lease is None:
                continue
            assert inst.lease.id not in seen, (
                f"lease {inst.lease.id} held by two instances")
            seen.add(inst.lease.id)
            assert inst.lease.id in self._leases, (
                f"instance {inst.impl}@{inst.pool} holds released lease "
                f"{inst.lease.id} (dangling warm shell)")
            assert self._leases[inst.lease.id] is inst.lease
            assert inst.lease.pool == inst.pool
            assert inst.lease.n_devices == inst.n_devices
        # instance index mirrors the instance list exactly
        indexed = [i for group in self._inst_index.values() for i in group]
        assert len(indexed) == len(self.instances), (
            f"instance index holds {len(indexed)} entries but "
            f"{len(self.instances)} instances are live")
        for inst in self.instances:
            assert inst in self._inst_index.get(
                (inst.impl, inst.pool, inst.n_devices), ()), (
                f"instance {inst.impl}@{inst.pool} missing from index")
        pooled = [i for group in self._pool_insts.values() for i in group]
        assert len(pooled) == len(self.instances), (
            f"pool index holds {len(pooled)} entries but "
            f"{len(self.instances)} instances are live")
        by_impl = [i for group in self._impl_insts.values() for i in group]
        assert len(by_impl) == len(self.instances), (
            f"impl index holds {len(by_impl)} entries but "
            f"{len(self.instances)} instances are live")
        for inst in self.instances:
            assert inst in self._pool_insts.get(inst.pool, ()), (
                f"instance {inst.impl}@{inst.pool} missing from pool index")
            assert inst in self._impl_insts.get(inst.impl, ()), (
                f"instance {inst.impl}@{inst.pool} missing from impl index")
        # cache ledger: index entries live, residency within budget, and
        # index <-> per-instance entry dicts mirror each other
        live = {id(i) for i in self.instances}
        for session, group in self._cache_index.items():
            for inst in group:
                assert id(inst) in live, (
                    f"cache entry for session {session!r} on a dead "
                    f"instance ({inst.impl}@{inst.pool})")
                assert session in inst.cache, (
                    f"session {session!r} indexed on {inst.impl}@"
                    f"{inst.pool} but absent from its entry dict")
        for inst in self.instances:
            resident = sum(e.bytes for e in inst.cache.values())
            assert resident <= inst.cache_cap_bytes + 1e-6, (
                f"instance {inst.impl}@{inst.pool}: cache residency "
                f"{resident:.3e} B exceeds budget "
                f"{inst.cache_cap_bytes:.3e} B")
            for session in inst.cache:
                assert inst in self._cache_index.get(session, ()), (
                    f"entry for session {session!r} on {inst.impl}@"
                    f"{inst.pool} missing from the session index")

    def utilization(self) -> dict[str, float]:
        """Allocated fraction per pool (0..1)."""
        return {name: self._used[name] / p.capacity
                for name, p in self.pools.items() if p.capacity}
