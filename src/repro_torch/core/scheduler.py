"""Adaptive scheduling: the Table-1 levers + greedy hierarchical search.

For every task the scheduler chooses a configuration over the paper's levers:

  ========================  =======================================
  Paper lever (Table 1)     ``TaskConfig`` field
  ========================  =======================================
  GPU generation            ``pool`` (device SKU of the pool)
  CPU vs GPU                ``pool`` (kind)
  Task parallelism          ``n_instances`` (fan-out), ``batch``
  Execution paths           ``paths`` (top-k parallel reasoning)
  Model/tool                ``impl``
  ========================  =======================================

The search space explodes combinatorially (paper §3.3c), so selection is a
greedy *hierarchy of optimization functions*: (1) implementation by quality
gate + constraint preference, (2) hardware/device-count by the constraint
objective, (3) parallelism given real-time free resources from the cluster
manager. Constraints are the composable DSL of ``core.constraints`` —
lexicographic orderings in 5%-tolerance bands (a secondary objective breaks
near-ties of the primary one), weighted blends, deadlines and budget caps;
the seed ``Constraint`` enum still normalizes through ``as_spec``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

from .agents import AgentImpl, AgentLibrary
from .cluster import ClusterManager
from .constraints import Constraint, ConstraintSpec, Objective, as_spec
from .dag import DAG, TaskNode
from .energy import CATALOG, knee_batch_grid
from .profiles import CostQuery, ProfileStore


@dataclass(frozen=True)
class TaskConfig:
    """One fully-resolved execution configuration for a task."""

    impl: str
    pool: str
    n_devices: int                # per instance
    n_instances: int = 1          # fan-out across instances
    batch: int = 1                # items co-scheduled per step
    paths: int = 1                # parallel execution paths (CoT top-k)
    # estimates (filled by the scheduler; simulator recomputes actuals)
    est_latency_s: float = 0.0
    est_energy_j: float = 0.0
    est_usd: float = 0.0
    est_power_w: float = 0.0      # marginal draw while running
    quality: float = 1.0
    warm: bool = False            # a warm instance was available

    def with_(self, **kw) -> "TaskConfig":
        """Functional update (the dataclass is frozen)."""
        return replace(self, **kw)


@dataclass
class ExecutionPlan:
    """Task id -> chosen ``TaskConfig`` for one lowered workflow DAG."""

    configs: dict[str, TaskConfig] = field(default_factory=dict)

    def __getitem__(self, tid: str) -> TaskConfig:
        return self.configs[tid]

    def total_quality(self, dag: DAG) -> float:
        """End-to-end quality = product over stages (cascading effects)."""
        q = 1.0
        for tid in dag.topo_order:
            q *= self.configs[tid].quality
        return q

    def report(self, dag: DAG) -> dict:
        """Plan-level estimates: critical path, energy, $ and quality."""
        lat = {tid: c.est_latency_s for tid, c in self.configs.items()}
        cp, path = dag.critical_path(lat)
        return {
            "critical_path_s": cp,
            "critical_path": path,
            "est_energy_j": sum(c.est_energy_j
                                for c in self.configs.values()),
            "est_usd": sum(c.est_usd for c in self.configs.values()),
            "quality": self.total_quality(dag),
        }


def _pow2_range(lo: int, hi: int) -> list[int]:
    out, n = [], 1
    while n <= hi:
        if n >= lo:
            out.append(n)
        n *= 2
    return out or [lo]


class Scheduler:
    """The greedy hierarchical lever search over execution profiles."""

    def __init__(self, library: AgentLibrary, profiles: ProfileStore,
                 cluster: ClusterManager):
        self.library = library
        self.profiles = profiles
        self.cluster = cluster
        self.evals = 0          # estimate() calls (greedy-search footprint)
        self.prune = True       # dominated-config pruning in plan_task
        self.pruned = 0         # candidate configs skipped by pruning
        # joint (count x batch) level-2 search (DESIGN.md §7.2); False
        # restores the legacy sequential order (count at batch=1, then one
        # batch candidate) — kept for benchmarks/planner_bench.py
        self.joint_batch = True
        # learned routing (DESIGN.md §11): a core.router.Router consulted
        # at level 1 for its covered interfaces; None keeps the static
        # quality-gate + constraint-preference choice byte-identical
        self.router = None
        # level-3 expansion of per-(impl, pool) group bests behind a
        # fan-out-aware pruning bound (DESIGN.md §11.4); False keeps the
        # two-seed expansion (joint + batch=1 winners) — the default, so
        # chosen plans stay byte-identical to the two-seed search
        self.group_expand = False
        self._works: dict[tuple[str, int, int], object] = {}

    # -- estimation ------------------------------------------------------------
    def _work_of(self, impl: AgentImpl, node: TaskNode):
        """Memoized ``impl.work_fn`` — one Work per (impl, token footprint)."""
        key = (impl.name, node.tokens_in, node.tokens_out)
        work = self._works.get(key)
        if work is None:
            work = self._works[key] = impl.work_fn(node.tokens_in,
                                                   node.tokens_out)
        return work

    def estimate(self, node: TaskNode, impl: AgentImpl, pool: str,
                 n_devices: int, n_instances: int = 1, batch: int = 1,
                 paths: int = 1, warm: bool = False,
                 items_done: int = 0, cache_frac: float = 0.0) -> TaskConfig:
        """Cost out one candidate configuration for ``node``.

        Latency comes from the batched execution schedule
        (``ProfileStore.schedule_latency``: full steps plus a remainder
        step charged at its own size, DESIGN.md §7.2) — the same call the
        simulator's ``_duration`` makes, so estimates and actuals agree by
        construction. ``items_done`` prices a *residual* attempt of a
        preempted-and-checkpointed task (DESIGN.md §6.4): only the
        remaining ``work_items - items_done`` items are scheduled, again
        exactly mirroring ``_duration``, so parity also holds for resumed
        tasks. ``cache_frac`` is the resident-prefix hit fraction the
        placement would enjoy (DESIGN.md §9) — it discounts the prefill
        phase through the shared ``CostQuery``, the same one pricing site
        the simulator charges. Energy/$ accrue over compute
        device-seconds; weight-loading is an idle-power period covered by
        the pool floor.
        """
        self.evals += 1
        spec = CATALOG[self.cluster.pools[pool].device]
        work = self._work_of(impl, node)
        if spec.kind == "cpu":
            batch = 1     # batching is an accelerator lever (weights reuse)
        remaining = max(node.work_items - items_done, 0)
        items_per_inst = math.ceil(remaining / n_instances)
        compute = self.profiles.schedule_latency(CostQuery(
            impl=impl, spec=spec, n_devices=n_devices, work=work,
            batch=batch, items=items_per_inst, cache_hit_frac=cache_frac))
        lat = compute if warm else compute + impl.load_time_s
        pf = self.profiles.power_frac(impl, spec, n_devices)
        # active energy/$ accrue over compute time; weight-loading is an
        # idle-power period (covered by the pool idle floor).
        dev_s = compute * n_devices * n_instances * paths
        energy = dev_s * pf * (spec.active_w - spec.idle_w)
        usd = dev_s / 3600.0 * spec.usd_per_hour
        power = n_devices * n_instances * paths * pf * \
            (spec.active_w - spec.idle_w)
        # quality reads the profile store's quality column (measured pins
        # override the declared ladder, DESIGN.md §11); with no pins this
        # is exactly impl.quality
        q = 1.0 - (1.0 - self.profiles.quality(impl.name)) ** paths
        return TaskConfig(impl=impl.name, pool=pool, n_devices=n_devices,
                          n_instances=n_instances, batch=batch, paths=paths,
                          est_latency_s=lat, est_energy_j=energy,
                          est_usd=usd, est_power_w=power, quality=q,
                          warm=warm)

    # -- constraint comparison ---------------------------------------------------
    @staticmethod
    def _objective(cfg: TaskConfig, c: "Constraint | Objective") -> float:
        """Value of one objective (enum shorthand or DSL object)."""
        return as_spec(c).objectives[0].value(cfg)

    @staticmethod
    def _key(cfg: TaskConfig, order) -> tuple:
        """Comparison key under any accepted constraint form."""
        return as_spec(order).key(cfg)

    def _batch_grid(self, impl: AgentImpl, spec, work,
                    items: int) -> list[int]:
        """Batch candidates for the joint (count x batch) search.

        Measured (pinned) rows select among their calibrated batch points —
        the paper's semantics, mirroring ``pinned_counts`` — plus the
        largest feasible batch; analytic rows get the knee-derived grid of
        ``energy.knee_batch_grid`` (1, the knee, a zero-remainder divisor
        of the item count at/past the knee, and ``min(max_batch, items)``).
        """
        if impl.max_batch <= 1 or spec.kind == "cpu" or items <= 1:
            return [1]
        bmax = min(impl.max_batch, items)
        pinned_bs = self.profiles.pinned_batches(impl.name, spec.name)
        if pinned_bs:
            return sorted({b for b in pinned_bs if 1 <= b <= bmax}
                          | {1, bmax})
        return knee_batch_grid(work, spec, items, impl.max_batch,
                               impl.mxu_efficiency)

    def _dominated(self, node: TaskNode, impl: AgentImpl, pool: str,
                   counts: list[int], batches: list[int], warm: bool,
                   incumbent: TaskConfig, order: "ConstraintSpec",
                   cache_frac: float = 0.0, hi_k: int = 1) -> bool:
        """Dominated-config pruning: can *any* (device count x batch) in
        this (impl, pool) group beat the incumbent under ``order``?

        Builds one optimistic pseudo-config whose latency/$/energy/quality
        are simultaneous lower bounds over every level-2 candidate in the
        group. On the analytic roofline, per-item latency is non-increasing
        in both device count (``overhead + K/n``) and batch size (the
        weights stream amortizes), and the remainder schedule satisfies
        ``schedule(n, b) >= items * latency(n, b)``, so the latency bound
        is the grid minimum at ``max(counts)``; per-item device-seconds
        ``latency * n`` are non-decreasing in count (roofline terms x n are
        constant, the overhead share grows), so the $/energy bound is the
        grid minimum at ``min(counts)``. Pinned
        (impl, device) pairs scale off the nearest calibration anchor,
        which is *not* monotone in ``n``, so those groups take the exact
        minimum over the (count x batch) grid (cheap: memoized, short
        lists). Every objective in the DSL is monotone in those four
        quantities and the lexicographic key is monotone componentwise, so
        if even the bound cannot beat the incumbent's key, no real
        candidate can — the whole candidate loop is skipped without
        changing the chosen plan.

        ``hi_k > 1`` makes the bound *fan-out-aware* (the group-best
        level-3 expansion, DESIGN.md §11.4): expanded candidates split
        items across up to ``hi_k`` instances, so the compute part of the
        latency bound divides by ``hi_k`` (load time does not split — the
        greedy coupling the two-seed expansion was built around), while
        the $/energy bound already holds under fan-out (``k * ceil(items
        / k) >= items`` device-seconds, and extra execution paths only
        add). Quality-seeking orders additionally get the max-paths
        quality upper bound ``1 - (1-q)**4``, since expansion may boost
        quality via parallel paths.
        """
        spec = CATALOG[self.cluster.pools[pool].device]
        work = self._work_of(impl, node)
        items = node.work_items

        def per_item(n: int, b: int) -> float:
            # the group's estimates price at cache_frac, so the bound must
            # discount identically to stay a bound *and* stay tight
            return self.profiles.step_latency(CostQuery(
                impl=impl, spec=spec, n_devices=n, work=work, batch=b,
                cache_hit_frac=cache_frac)) / max(b, 1)

        if self.profiles.pinned_counts(impl.name, spec.name):
            per = [min(per_item(n, b) for b in batches) for n in counts]
            lat_lb = items * min(per)
            dev_s_lb = items * min(p * n for p, n in zip(per, counts))
        else:
            # min over the (small) batch grid instead of assuming
            # monotonicity in b: covers the deprecated alpha fallback even
            # for alpha > 1, where items * latency(b) under-cuts only at
            # b = 1 (which the grid always contains)
            lat_lb = items * min(per_item(counts[-1], b) for b in batches)
            dev_s_lb = items * counts[0] * min(per_item(counts[0], b)
                                               for b in batches)
        if hi_k > 1:
            lat_lb /= hi_k
        if not warm:
            lat_lb += impl.load_time_s
        pf_lb = min(self.profiles.power_frac(impl, spec, n) for n in counts)
        q_lb = self.profiles.quality(impl.name)
        if hi_k > 1 and order.seeks_quality:
            q_lb = 1.0 - (1.0 - q_lb) ** 4     # max execution paths
        lb = TaskConfig(
            impl=impl.name, pool=pool, n_devices=counts[0],
            est_latency_s=lat_lb,
            est_energy_j=dev_s_lb * pf_lb * (spec.active_w - spec.idle_w),
            est_usd=dev_s_lb / 3600.0 * spec.usd_per_hour,
            quality=q_lb, warm=warm)
        return order.key(lb) >= order.key(incumbent)

    # -- the greedy hierarchical search -------------------------------------------
    def plan_task(self, node: TaskNode, order,
                  quality_floor: float | dict, *,
                  session: str = "") -> TaskConfig:
        """Choose one ``TaskConfig`` for ``node`` under ``order``.

        The greedy hierarchy (paper §3.3c): (1) implementation by quality
        gate + constraint preference; (2) a *joint* search over device
        count x batch size per candidate (impl, pool) — the batch grid is
        knee-derived (``energy.knee_batch_grid``) or, for measured rows,
        the calibrated batch points, so the count choice sees each pool at
        its best batch rather than locking the count in at batch=1
        (DESIGN.md §7.2; ``joint_batch=False`` restores the sequential
        legacy order); (3) remaining parallelism levers — instance fan-out
        and execution paths — against free resources right now. The
        fan-out loop re-derives the batch grid per candidate ``k``: with
        ``k`` instances the per-instance item count (and its remainder
        step) changes, so the level-2 winner's batch size is no longer
        knee/divisor-aligned.

        Level 3 expands *two* seeds when the joint search is on: the joint
        winner and the batch=1 winner (the sequential hierarchy's level-2
        choice). Batched and unbatched configs respond differently to
        fan-out — splitting items across instances shrinks compute but not
        load time, so a cheap low-load implementation that loses the
        batched level-2 comparison can still win after fan-out. Expanding
        both seeds makes the joint search's candidate set a strict
        superset of the sequential one, so the chosen config is never
        worse under the constraint order. ``group_expand`` widens level 3
        further: *every* per-(impl, pool) group best becomes an expansion
        seed, with the fan-out-aware pruning bound (``_dominated`` with
        ``hi_k``) skipping groups that provably cannot win — plan-equal to
        exhaustively expanding all groups (DESIGN.md §11.4).

        ``session`` (keyword-only) is the serving session the task belongs
        to: (impl, pool) groups holding a resident KV prefix for it are
        priced at their hit fraction (DESIGN.md §9), making a warm cache a
        co-placement reason exactly like warm shells. Empty session (every
        cache-less workload) prices everything at hit 0 — byte-identical
        to the affinity-blind search.
        """
        order = as_spec(order)
        impls = self.library.impls_for(node.agent)
        if not impls:
            raise ValueError(f"no implementation for agent {node.agent!r}")
        floor = (quality_floor.get(node.agent, 0.0)
                 if isinstance(quality_floor, dict) else quality_floor)

        # Level 1 — implementation: quality gate, then constraint preference.
        # The gate reads the profile store's quality column (measured pins
        # from the telemetry loop override the declared ladder, §11); with
        # no pins q_of(i) == i.quality exactly.
        q_of = self.profiles.quality
        ok = [i for i in impls if q_of(i.name) >= floor] or \
            [max(impls, key=lambda i: q_of(i.name))]
        # learned routing (DESIGN.md §11): for covered interfaces the
        # router picks the arm among the floor-passing candidates — the
        # floor stays a hard gate, the router only chooses within it. A
        # None answer (untrained bucket, no exploration) falls through to
        # the static constraint-preference choice below.
        if self.router is not None and self.router.covers(node.agent):
            pick = self.router.route(node, [i.name for i in ok])
            if pick is not None:
                ok = [i for i in ok if i.name == pick]
        if order.seeks_quality:
            cand_impls = sorted(ok, key=lambda i: -q_of(i.name))[:2]
        else:
            cand_impls = ok  # defer to the objective over hw configs

        stats = self.cluster.stats()
        # warm-instance lookup, hoisted out of the candidate loop: one
        # O(instances) scan per plan_task instead of one per (impl, pool)
        warm_set = {(inst.impl, inst.pool)
                    for inst in self.cluster.instances}
        # resident-prefix hit fraction per (impl, pool): the session's best
        # cached instance in the group, clipped to the task's prefix span
        hit_frac: dict[tuple[str, str], float] = {}
        if session and node.prefix_tokens > 0 and node.tokens_in > 0:
            for inst in self.cluster.cached_instances(session):
                tok = min(inst.cache[session].tokens, node.prefix_tokens)
                if tok <= 0:
                    continue
                key = (inst.impl, inst.pool)
                frac = tok / node.tokens_in
                if frac > hit_frac.get(key, 0.0):
                    hit_frac[key] = frac

        # Level 2 — hardware + device count (x batch, when joint) per
        # candidate implementation. With ``group_expand`` the joint search
        # also collects the best config *per (impl, pool) group* — every
        # group becomes a level-3 expansion seed (DESIGN.md §11.4), so
        # pruning must use the fan-out-aware bound: a group may only be
        # skipped when no member can win even after fan-out/paths.
        groups: dict[tuple[str, str], tuple] = {}

        def search(cands, joint: bool,
                   collect: bool = False) -> TaskConfig | None:
            """Best (impl, pool, count[, batch]) config under ``order``."""
            best: TaskConfig | None = None
            for impl in cands:
                for pool_name, st in stats.items():
                    if st["kind"] not in impl.hw_kinds:
                        continue
                    cap = self.cluster.pools[pool_name].capacity
                    lo = impl.min_devices.get(st["kind"], 1)
                    hi = min(impl.max_devices.get(st["kind"], cap), cap)
                    if lo > hi:
                        continue
                    warm = (impl.name, pool_name) in warm_set
                    device = self.cluster.pools[pool_name].device
                    counts = [n for n in self.profiles.pinned_counts(
                                  impl.name, device) if lo <= n <= hi] \
                        or _pow2_range(lo, hi)
                    if joint:
                        batches = self._batch_grid(impl, CATALOG[device],
                                                   self._work_of(impl, node),
                                                   node.work_items)
                    else:
                        batches = [1]
                    cf = hit_frac.get((impl.name, pool_name), 0.0)
                    hi_k = 1
                    if collect and node.chunkable:
                        # max fan-out any member could reach: smallest
                        # device count in the group leaves the most free
                        # instance slots
                        hi_k = min(max(st["free"] // counts[0], 1),
                                   node.work_items)
                    if best is not None and self.prune and self._dominated(
                            node, impl, pool_name, counts, batches, warm,
                            best, order, cf, hi_k=hi_k):
                        self.pruned += len(counts) * len(batches)
                        continue
                    if self.profiles.cache_enabled and \
                            len(counts) * len(batches) > 1:
                        # grid prewarm: one vectorized kernel call
                        # (ProfileStore.schedule_latency_batch) prices every
                        # (count, batch) candidate's memo misses at once;
                        # the estimate loop below then runs on memo hits
                        _work = self._work_of(impl, node)
                        _spec = CATALOG[device]
                        self.profiles.schedule_latency_batch([
                            CostQuery(impl=impl, spec=_spec, n_devices=n,
                                      work=_work, batch=b,
                                      items=node.work_items,
                                      cache_hit_frac=cf)
                            for n in counts for b in batches])
                    gbest: TaskConfig | None = None
                    for n in counts:
                        for b in batches:
                            cfg = self.estimate(node, impl, pool_name, n,
                                                batch=b, warm=warm,
                                                cache_frac=cf)
                            if best is None or self._key(cfg, order) < \
                                    self._key(best, order):
                                best = cfg
                            if collect and (gbest is None or
                                            self._key(cfg, order) <
                                            self._key(gbest, order)):
                                gbest = cfg
                    if collect and gbest is not None:
                        groups[(impl.name, pool_name)] = \
                            (gbest, counts, batches, warm, cf)
            return best

        # Level 3 — remaining parallelism levers, given free resources.
        def expand(best: TaskConfig, legacy_batch: bool) -> TaskConfig:
            """Grow a level-2 seed through the level-3 parallelism levers."""
            impl = self.library.impls[best.impl]
            st = stats[best.pool]
            cf = hit_frac.get((best.impl, best.pool), 0.0)
            free_inst = max(st["free"] // best.n_devices, 1)
            if legacy_batch and impl.max_batch > 1:
                # sequential lever order: one batch candidate, tried only
                # after the count is locked in at batch=1
                b = min(impl.max_batch, node.work_items)
                cand = self.estimate(node, impl, best.pool, best.n_devices,
                                     best.n_instances, b, warm=best.warm,
                                     cache_frac=cf)
                if self._key(cand, order) < self._key(best, order):
                    best = cand
            # fan-out candidates are capped by what fits concurrently right
            # now; guard the cap explicitly — _pow2_range(2, 1) would fall
            # back to [2], offering a two-instance config the cluster
            # cannot place (the simulator would degrade it to one instance,
            # breaking estimate/actual parity)
            hi_k = min(free_inst, node.work_items)
            if node.chunkable and hi_k >= 2:
                spec = CATALOG[self.cluster.pools[best.pool].device]
                work = self._work_of(impl, node)
                for k in _pow2_range(2, hi_k):
                    if legacy_batch:
                        batches = [best.batch]
                    else:
                        # re-derive the batch grid per fan-out candidate:
                        # with k instances the per-instance item count (and
                        # its remainder step) changes, so the level-2
                        # winner's batch size is no longer knee/divisor-
                        # aligned (DESIGN.md §7.2); keeping best.batch in
                        # the grid preserves the old candidate set
                        per_inst = math.ceil(node.work_items / k)
                        batches = sorted(set(
                            self._batch_grid(impl, spec, work, per_inst))
                            | {min(best.batch, max(per_inst, 1))})
                    for b in batches:
                        cand = self.estimate(node, impl, best.pool,
                                             best.n_devices, k, b,
                                             warm=best.warm, cache_frac=cf)
                        if self._key(cand, order) < self._key(best, order):
                            best = cand
            # Execution paths: only when quality leads, on harvestable slack.
            if order.seeks_quality:
                harvest = st["harvestable"] // max(
                    best.n_devices * best.n_instances, 1)
                for p in (2, 4):
                    if p - 1 > harvest:
                        break
                    cand = self.estimate(node, impl, best.pool,
                                         best.n_devices, best.n_instances,
                                         best.batch, paths=p, warm=best.warm,
                                         cache_frac=cf)
                    if self._key(cand, order) < self._key(best, order):
                        best = cand
            return best

        collect = self.group_expand and self.joint_batch
        best = search(cand_impls, self.joint_batch, collect=collect)
        if best is None:   # quality-gated impls don't fit this cluster
            groups.clear()
            cand_impls = sorted(impls, key=lambda i: -q_of(i.name))
            best = search(cand_impls, self.joint_batch, collect=collect)
        if best is None:
            raise ValueError(
                f"no (pool x devices) fits agent {node.agent!r}; "
                f"pools: {list(stats)}")

        final = expand(best, legacy_batch=not self.joint_batch)
        expanded = {(best.impl, best.pool)}
        if self.joint_batch:
            # second seed: the sequential hierarchy's batch=1 level-2
            # winner, expanded through the legacy lever order — keeps the
            # joint candidate set a superset of the sequential one
            seed = search(cand_impls, joint=False)
            if seed is not None and seed != best:
                expanded.add((seed.impl, seed.pool))
                alt = expand(seed, legacy_batch=True)
                if self._key(alt, order) < self._key(final, order):
                    final = alt
        if collect:
            # Level-3 expansion of every remaining (impl, pool) group best
            # (DESIGN.md §11.4). A group whose fan-out-aware lower bound
            # cannot beat the incumbent is skipped — sound because the
            # bound covers everything ``expand`` can build from the seed
            # (fan-out up to the free-slot cap, any batch, paths <= 4) and
            # ``final`` only ever improves under ``order``.
            for gkey in sorted(groups):
                if gkey in expanded:
                    continue
                gcfg, counts, batches, warm, cf = groups[gkey]
                impl = self.library.impls[gcfg.impl]
                hi_k = 1
                if node.chunkable:
                    hi_k = min(max(stats[gcfg.pool]["free"]
                                   // gcfg.n_devices, 1), node.work_items)
                if self.prune and self._dominated(
                        node, impl, gcfg.pool, counts, batches, warm,
                        final, order, cf, hi_k=hi_k):
                    self.pruned += 1
                    continue
                alt = expand(gcfg, legacy_batch=False)
                if self._key(alt, order) < self._key(final, order):
                    final = alt
        return final

    def split_shares(self, dag: DAG, order,
                     quality_floor: float | dict = 0.85, *,
                     session: str = "") \
            -> dict[str, tuple[float, float]]:
        """Per-task ``(lat_frac, cost_frac)`` shares of workflow-level terms.

        A pilot plan under the legacy even split supplies per-task latency
        and cost estimates. The deadline share of task ``t`` is
        ``lat(t) / L(t)`` with ``L(t)`` the longest path *through* ``t``:
        tasks on ``dag.critical_path`` receive slack proportional to their
        latency share of the path (their shares sum to exactly 1 along it,
        handing the whole deadline to the path that needs it), and for every
        root-to-leaf path the shares sum to <= 1, so per-task feasibility
        implies workflow feasibility. The budget share is ``t``'s pilot cost
        share of the whole DAG — spend is additive across tasks, so shares
        sum to 1.
        """
        spec = as_spec(order)
        pilot_spec = spec.per_task(len(dag))
        pilot = {tid: self.plan_task(dag.nodes[tid], pilot_spec,
                                     quality_floor, session=session)
                 for tid in dag.topo_order}
        eps = 1e-12
        lat = {tid: max(cfg.est_latency_s, eps)
               for tid, cfg in pilot.items()}
        # longest path through t = forward finish + backward tail - own
        fwd: dict[str, float] = {}
        for tid in dag.topo_order:
            fwd[tid] = lat[tid] + max((fwd[d]
                                       for d in dag.nodes[tid].deps),
                                      default=0.0)
        bwd: dict[str, float] = {}
        for tid in reversed(dag.topo_order):
            bwd[tid] = lat[tid] + max((bwd[s]
                                       for s in dag.successors(tid)),
                                      default=0.0)
        cost = {tid: cfg.est_usd for tid, cfg in pilot.items()}
        total_cost = sum(cost.values())
        if total_cost <= 0:   # free tools everywhere: fall back to energy
            cost = {tid: cfg.est_energy_j for tid, cfg in pilot.items()}
            total_cost = sum(cost.values())
        shares = {}
        for tid in dag.topo_order:
            through = fwd[tid] + bwd[tid] - lat[tid]
            lat_frac = min(lat[tid] / max(through, eps), 1.0)
            cost_frac = (cost[tid] / total_cost if total_cost > 0
                         else 1.0 / len(dag))
            shares[tid] = (lat_frac, cost_frac)
        return shares

    def plan(self, dag: DAG, order,
             quality_floor: float | dict = 0.85, *,
             session: str = "") -> ExecutionPlan:
        """Choose a ``TaskConfig`` for every task of ``dag``.

        ``order`` is any accepted constraint form (seed enum member,
        sequence, DSL objective, ``ConstraintSpec``); ``quality_floor`` is
        a scalar or per-interface dict gating level-1 implementation
        choice. Workflow-level deadline/budget terms are first split
        across tasks by the critical-path-weighted shares of
        ``split_shares`` (DESIGN.md §6.1); plain objectives plan each task
        directly. ``session`` threads the job's serving session into
        :meth:`plan_task` for KV-affinity pricing (DESIGN.md §9).
        """
        spec = as_spec(order)
        plan = ExecutionPlan()
        if spec.has_workflow_terms:
            # critical-path-weighted split of deadline/budget terms: tasks
            # on the critical path get slack proportional to their pilot
            # latency/cost share, admitting tighter SLOs than the even split
            shares = self.split_shares(dag, spec, quality_floor,
                                       session=session)
            for tid in dag.topo_order:
                plan.configs[tid] = self.plan_task(
                    dag.nodes[tid], spec.for_share(*shares[tid]),
                    quality_floor, session=session)
            return plan
        for tid in dag.topo_order:
            plan.configs[tid] = self.plan_task(dag.nodes[tid], spec,
                                               quality_floor,
                                               session=session)
        return plan

    # -- pinned plans (imperative baseline) -----------------------------------------
    def pin(self, node: TaskNode, impl_name: str, pool: str,
            n_devices: int) -> TaskConfig:
        """Fixed configuration: no levers (paper Listing-1 semantics)."""
        impl = self.library.impls[impl_name]
        return self.estimate(node, impl, pool, n_devices, n_instances=1,
                             batch=1, paths=1, warm=False)

    def search_space_size(self, node: TaskNode) -> int:
        """|configs| the full cross-product would visit (overheads bench)."""
        total = 0
        stats = self.cluster.stats()
        for impl in self.library.impls_for(node.agent):
            for pool_name, st in stats.items():
                if st["kind"] not in impl.hw_kinds:
                    continue
                cap = self.cluster.pools[pool_name].capacity
                lo = impl.min_devices.get(st["kind"], 1)
                hi = min(impl.max_devices.get(st["kind"], cap), cap)
                if lo > hi:
                    continue
                nd = len(_pow2_range(lo, hi))
                ni = len(_pow2_range(1, max(node.work_items, 1)))
                nb = len(_pow2_range(1, max(impl.max_batch, 1)))
                total += nd * ni * nb * 3   # 3 = paths in {1,2,4}
        return total
