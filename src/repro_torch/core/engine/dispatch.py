"""Dispatch layer: ready-set index, blocked-group memo, epoch logic.

The fast path (DESIGN.md §8) keeps an *indexed ready-set* per workflow —
roots enter at admission, successors enter when their last dependency
finishes, preemption victims re-enter on cancel — so each pass touches
only genuinely ready tasks instead of rescanning every workflow's whole
DAG. Tasks that failed to start are skipped while their pool's
availability epoch is unchanged (``ClusterManager.free_epoch``): a failed
``try_start`` depends only on (impl, pool, n_devices, n_instances, tenant)
and pool state, so identical-key retries under unchanged state fail
identically and may be elided without changing the schedule. The seed's
full rescan survives as ``fast_dispatch=False`` — the reference the
equivalence tests compare byte-identical traces against.

Finish coalescing (DESIGN.md §12): ``on_finish_batch`` settles a
contiguous same-``t`` group of finish events with per-task work (lease
settlement, trace, telemetry, successor indexing, demand decrement) in pop
order, but defers the per-pool availability-epoch bump and the rebalance
scan to the end of the group. Both deferrals are schedule-invariant:
epochs are only *equality*-compared by the dispatch memo, which runs after
the drain, so one bump per touched pool wakes exactly the keys k bumps
would have woken; and rebalance at group end sees the union of every
zero-demand interface the per-finish calls would have seen, evicting the
same instance set (eviction only ever removes idle, cache-less shells of
zero-demand interfaces, and nothing inside the group re-raises demand —
arrivals flush the group first).
"""
from __future__ import annotations

import bisect
import heapq

from operator import attrgetter

from ..admission import Admission
from ..cluster import Instance, Lease
from ..scheduler import ExecutionPlan
from .events import Submission, TraceEntry, _Running, _WfState

_WARM_SINCE = attrgetter("warm_since")
# shared empty containers: try_start stores one of these on the branch
# that never fills it (model runs hold no tool leases and vice versa) —
# every consumer only ever iterates them
_EMPTY: tuple = ()


class DispatchMixin:
    """Admission, candidate ordering, task start and finish settlement."""

    # -- submissions / admission ----------------------------------------------
    def add_submission(self, wid: str, sub: Submission):
        """Queue a workflow's arrival event."""
        self.wfs[wid] = _WfState(sub.dag, sub.plan, sub.arrival, sub.tenant,
                                 sub.plan_fn, slo_s=sub.slo_s,
                                 scenario=sub.scenario, session=sub.session)
        self.incomplete += 1
        heapq.heappush(self.events,
                       (sub.arrival, next(self.ctr), "arrive", wid))

    def admit(self, wid: str):
        """Arrive event: resolve the plan and index the workflow's roots."""
        st = self.wfs[wid]
        if st.plan is None:
            if st.plan_fn is None:
                raise ValueError(f"workflow {wid!r} submitted without a "
                                 f"plan or plan_fn")
            # admission-time planning: the scheduler sees the live cluster
            # (warm instances, free devices)
            st.plan = st.plan_fn()
        st.adm = Admission(wid, st.tenant, st.arrival)
        dag = st.dag
        roots = self._roots.get(id(dag))
        if roots is None:
            # open-loop submissions share one DAG per scenario: compute
            # the root (topo_rank, tid) pairs once per distinct DAG
            roots = self._roots[id(dag)] = [
                (dag.topo_index(tid), tid) for tid in dag.topo_order
                if not dag.nodes[tid].deps]
        st.ready.extend(roots)
        if self.pol.dynamic:
            self.active_dyn.append(wid)
        else:
            st.sort_key = self.pol.key(st.adm, self.served.served)
            bisect.insort(self.active, (st.sort_key, wid))
            if st.ready:
                bisect.insort(self.active_ready, (st.sort_key, wid))

    def _deactivate(self, wid: str, st: _WfState):
        if self.pol.dynamic:
            self.active_dyn.remove(wid)
        else:
            i = bisect.bisect_left(self.active, (st.sort_key, wid))
            del self.active[i]

    def _push_ready(self, wid: str, st: _WfState, tid: str):
        if not st.ready and not self.pol.dynamic:
            bisect.insort(self.active_ready, (st.sort_key, wid))
        bisect.insort(st.ready, (st.dag.topo_index(tid), tid))

    # -- dispatch candidates --------------------------------------------------
    def _ready_scan(self) -> list[tuple[str, str]]:
        """The seed's full rescan: every workflow, every task, every pass.

        Kept verbatim as the ``fast_dispatch=False`` reference path; the
        equivalence tests assert the indexed ready-set produces
        byte-identical traces against this.
        """
        out = []
        t = self.t
        admitted = [Admission(wid, st.tenant, st.arrival)
                    for wid, st in self.wfs.items()
                    if t >= st.arrival and st.plan is not None]
        for adm in sorted(admitted,
                          key=lambda a: self.pol.key(a, self.served.served)):
            st = self.wfs[adm.workflow]
            for tid in st.dag.topo_order:
                if tid in st.done or tid in st.started:
                    continue
                if all(d in st.done for d in st.dag.nodes[tid].deps):
                    out.append((adm.workflow, tid))
        return out

    def _candidates(self) -> list[tuple[str, str]]:
        """Ready (workflow, task) pairs in admission-policy order, from the
        incremental index: O(active + ready) instead of O(total tasks)."""
        out = []
        wfs = self.wfs
        if self.pol.dynamic:
            served = self.served.served
            # filtering to ready-nonempty before the sort commutes with it
            order = sorted((w for w in self.active_dyn if wfs[w].ready),
                           key=lambda w: self.pol.key(wfs[w].adm, served))
            for wid in order:
                out += [(wid, tid) for _, tid in wfs[wid].ready]
            return out
        for _, wid in self.active_ready:
            out += [(wid, tid) for _, tid in wfs[wid].ready]
        return out

    def dispatch(self):
        """Start whatever is ready and fits, repeating while progress."""
        if not self.sim.fast_dispatch:
            progress = True
            while progress:
                progress = False
                for wid, tid in self._ready_scan():
                    self.n_attempts += 1
                    if self.try_start(wid, tid):
                        progress = True
            return
        dynamic = self.pol.dynamic
        if not dynamic and not self.active_ready:
            return      # nothing ready anywhere: the common post-event case
        cluster = self.cluster
        epochs = cluster.free_epoch
        wfs = self.wfs
        blocked = self.blocked
        blocked_get = blocked.get
        try_start = self.try_start
        attempts = 0
        progress = True
        while progress:
            progress = False
            epoch_snap = cluster.epoch_total
            if dynamic:
                cands = self._candidates()
            else:
                # inlined static-policy _candidates (hot: once per event)
                cands = []
                for _, w in self.active_ready:
                    cands += [(w, tid) for _, tid in wfs[w].ready]
            for wid, tid in cands:
                st = wfs[wid]
                if tid in st.started or tid in st.done:
                    continue
                cfg = st.plan.configs[tid]
                key = (cfg.impl, cfg.pool, cfg.n_devices, cfg.n_instances,
                       st.tenant)
                # a failed start depends only on this key and pool state;
                # while the pool epoch hasn't moved since the last failure,
                # a retry fails identically — skip it (DESIGN.md §8)
                if blocked_get(key) == epochs[cfg.pool]:
                    continue
                attempts += 1
                if try_start(wid, tid):
                    progress = True
                else:
                    # record *post*-attempt epoch: a failing attempt may
                    # itself evict idle instances (bumping the epoch), and
                    # those evictions don't make this key startable
                    cfg2 = st.plan.configs[tid]   # degrade may have moved it
                    key2 = (cfg2.impl, cfg2.pool, cfg2.n_devices,
                            cfg2.n_instances, st.tenant)
                    blocked[key2] = epochs[cfg2.pool]
            # a re-scan pass can only start something if availability
            # moved during this pass (preemption, eviction, release,
            # harvest supply): every survivor is memoized at the current
            # epoch, and new ready entries only appear via cancel_task,
            # which releases (bumping the epoch). No movement ⟹ the next
            # pass is provably a no-op — skip it.
            if progress and cluster.epoch_total == epoch_snap:
                break
        self.n_attempts += attempts
        return

    def demand_by_pool(self) -> dict[str, int]:
        """Devices wanted right now per pool: held + queued (ready) work."""
        demand = dict(self.cluster._used)
        for st in self.wfs.values():
            if st.plan is None:
                continue
            for _, tid in st.ready:
                cfg = st.plan.configs[tid]
                demand[cfg.pool] = demand.get(cfg.pool, 0) + \
                    cfg.n_devices * cfg.n_instances
        return demand

    # -- preemption -----------------------------------------------------------
    def cancel_task(self, vwid: str, vtid: str):
        """Preemption: roll a task back to pending, checkpoint the work
        already finished (chunkable tasks), refund the unearned energy/$
        and release whatever it still holds."""
        t = self.t
        rec = self.running.pop((vwid, vtid), None)
        if rec is None:
            return
        if self.hedges:
            # a hedge dies with its primary: any rollback of the primary
            # also cancels the in-flight duplicate (its work is discarded)
            self._kill_hedge(vwid, vtid)
        vst = self.wfs[vwid]
        vst.started.discard(vtid)
        self._push_ready(vwid, vst, vtid)
        vst.attempt[vtid] = vst.attempt.get(vtid, 0) + 1
        for lease in rec.leases:
            self.lease_owner.pop(lease.id, None)
            if self.cluster.lease_active(lease):
                self.cluster.release(lease, t)
        for inst in rec.insts:
            if inst.lease is not None:
                self.lease_owner.pop(inst.lease.id, None)
            if inst in self.cluster.instances:
                self.cluster.evict_instance(inst, t)
        self._refund(rec, vst, vtid, t)
        self.requeues += 1
        if self.collect_trace:
            self.trace.append(TraceEntry(vwid, vtid, rec.cfg.impl,
                                         rec.cfg.pool, rec.ndev, rec.start,
                                         t, note="preempted"))
        if self.log is not None:
            kept = vst.items_done.get(vtid, 0)
            self.log.append(f"[{t:8.1f}s] preempt {vwid}:{vtid} "
                            f"({rec.ndev}x{rec.cfg.pool}); requeued"
                            + (f" ({kept} items checkpointed)" if kept
                               else ""))

    def try_preempt(self, pool: str, n_needed: int) -> bool:
        """Reclaim harvest-class leases for a priority tenant."""
        t = self.t
        deficit = n_needed - self.cluster.free(pool)
        if deficit <= 0 or self.cluster.harvest_devices(pool) < deficit:
            return False
        victims = self.cluster.preempt_harvest(pool, deficit, t)
        for lease in victims:
            # idle warm instance on a preempted lease: drop the shell
            # through the manager's eviction path so its bookkeeping
            # (instance list + lease table) stays consistent; the lease
            # itself was already released by preempt_harvest, which
            # evict_instance tolerates
            for inst in [i for i in self.cluster.instances
                         if i.lease is not None
                         and i.lease.id == lease.id]:
                self.cluster.evict_instance(inst, t)
            owner = self.lease_owner.pop(lease.id, None)
            if owner is not None:
                if len(owner) == 3:
                    # ("h", wid, tid): a hedge duplicate lost its devices —
                    # cancel just the hedge; its primary keeps running
                    self._kill_hedge(owner[1], owner[2])
                else:
                    self.cancel_task(*owner)
        return bool(victims)

    # -- task start -----------------------------------------------------------
    def _alloc_or_evict(self, cluster, cfg, n: int, t: float,
                        harvest: bool):
        """Allocate ``n`` devices, evicting idle other-impl warm instances
        (LRU by warm_since) until the allocation fits or nothing is left."""
        pool = cfg.pool
        lease = cluster.alloc(pool, n, t, harvest=harvest)
        if lease is None:
            impl = cfg.impl
            idle = [i for i in cluster.pool_instances(pool)
                    if i.busy_until <= t and i.impl != impl]
            idle.sort(key=_WARM_SINCE)
            for victim in idle:
                cluster.evict_instance(victim, t)
                lease = cluster.alloc(pool, n, t, harvest=harvest)
                if lease is not None:
                    break
        return lease

    def _acquire(self, cluster, cfg, t: float, harvest: bool,
                 insts: list, session: str = "") -> int:
        """Fill ``insts`` up to ``cfg.n_instances`` — reusing idle warm
        instances first (first-fit in index order), then provisioning new
        ones; returns how many were newly provisioned.

        A non-empty ``session`` reorders the warm-reuse scan by resident
        prefix tokens for that session, descending (stable, so instances
        with no cache entry keep index order): session affinity prefers the
        shell whose KV cache already holds the conversation prefix
        (DESIGN.md §9). With ``session == ""`` the scan is byte-identical
        to the affinity-less engine.
        """
        new_inst = 0
        target = cfg.n_instances
        need = target - len(insts)
        warm = cluster.warm_instances(cfg.impl, cfg.pool, cfg.n_devices)
        if session:
            warm = sorted(
                warm, key=lambda i: -i.cache[session].tokens
                if session in i.cache else 0)
        if need > 0:
            if insts:
                for i in warm:
                    if i.busy_until <= t and i not in insts:
                        insts.append(i)
                        need -= 1
                        if need <= 0:
                            break
            else:
                # fresh fill: ``warm`` has no duplicates, so everything
                # appended here came from this scan — no containment check
                append = insts.append
                for i in warm:
                    if i.busy_until <= t:
                        append(i)
                        need -= 1
                        if need <= 0:
                            break
        while len(insts) < target:
            lease = self._alloc_or_evict(cluster, cfg, cfg.n_devices, t,
                                         harvest)
            if lease is None:
                break
            inst = Instance(cfg.impl, cfg.pool, cfg.n_devices,
                            warm_since=t, lease=lease,
                            cache_cap_bytes=self.sim._cache_cap(cfg))
            cluster.add_instance(inst)
            insts.append(inst)
            new_inst += 1
        return new_inst

    def try_start(self, wid: str, tid: str) -> bool:
        """Start a ready task if its resources fit right now."""
        t = self.t
        sim = self.sim
        st = self.wfs[wid]
        cluster = self.cluster
        node = st.dag.nodes[tid]
        cfg = st.plan.configs[tid]
        impl = self.impls[cfg.impl]
        spec = self.specs[cfg.pool]
        harvest = st.tenant == "harvest"
        priority = st.tenant == "priority"
        new_inst = 0
        # degrade configs planned for a larger cluster (elasticity)
        cap = cluster.pools[cfg.pool].capacity
        if cfg.n_devices > cap:
            if cap < sim._pool_limit(cfg.pool):
                # the pool is autoscaled below its limit right now: wait
                # for the scale-up instead of permanently degrading the
                # plan to the shrunken size
                return False
            lo = impl.min_devices.get(spec.kind, 1)
            n = 1
            while n * 2 <= cap:
                n *= 2
            if n < lo:
                raise RuntimeError(
                    f"{cfg.impl} needs >= {lo} {spec.kind} devices; "
                    f"pool {cfg.pool} has {cap}")
            cfg = cfg.with_(n_devices=n, n_instances=1)
            # copy-on-write: amortized open-loop submissions share one
            # template plan per scenario; take a private copy before the
            # only in-place plan mutation the engine ever performs
            st.plan = ExecutionPlan(dict(st.plan.configs))
            st.plan.configs[tid] = cfg

        # KV/prefix cache (DESIGN.md §9): a task is cache-eligible when the
        # engine models caches, the workflow carries a session and the node
        # has a session-shared prefix on a KV-tracking impl. The affinity
        # lever (cache_affinity) only reorders warm-shell reuse — pricing
        # below uses whatever cache the acquired shells actually hold.
        session = (st.session if self.kv_cache and st.session
                   and node.prefix_tokens > 0
                   and impl.kv_bytes_per_token > 0 else "")
        cfg_impl = cfg.impl
        cfg_pool = cfg.pool
        cfg_ndev = cfg.n_devices
        if self.is_model[cfg_impl]:
            leases: "list[Lease] | tuple" = _EMPTY
            insts: "list[Instance] | tuple" = []
            affinity = session if self.cache_affinity else ""
            new_inst = self._acquire(cluster, cfg, t, harvest, insts,
                                     affinity)
            if not insts and priority and \
                    self.try_preempt(cfg_pool, cfg_ndev):
                new_inst += self._acquire(cluster, cfg, t, harvest, insts,
                                          affinity)
            if not insts:
                return False
            # keep each lease's preemptibility in sync with the tenant now
            # running on it (Simulator._relabel_lease, inlined: mismatches
            # are common enough under a mixed tenant stream to be hot)
            for inst in insts:
                lease = inst.lease
                if lease is not None and lease.harvest != harvest:
                    if lease.id not in cluster._leases:
                        inst.lease = None
                    else:
                        lease.harvest = harvest
                        if harvest:
                            # new preemptible supply: epoch must move
                            cluster.free_epoch[lease.pool] += 1
                            cluster.epoch_total += 1
            n_inst = len(insts)
        else:
            insts = _EMPTY
            total = cfg_ndev * cfg.n_instances
            lease = cluster.alloc(cfg_pool, total, t, harvest=harvest)
            n_inst = cfg.n_instances
            if lease is None:
                lease = self._alloc_or_evict(cluster, cfg, cfg_ndev,
                                             t, harvest)
                n_inst = 1
                if lease is None and priority and \
                        self.try_preempt(cfg_pool, cfg_ndev):
                    lease = self._alloc_or_evict(cluster, cfg,
                                                 cfg_ndev, t, harvest)
                if lease is None:
                    return False
            leases = [lease]

        items_done = st.items_done.get(tid, 0) if self.resume else 0
        cache_frac = 0.0
        if session and insts:
            self.cache_lookups += 1
            # every acquired shell must hold the prefix for the discount
            # to apply to the whole (identically-priced) instance group;
            # in practice chat turns run on one instance
            tok = min((inst.cache[session].tokens if session in inst.cache
                       else 0) for inst in insts)
            hit_tokens = min(tok, node.prefix_tokens)
            if hit_tokens > 0 and node.tokens_in > 0:
                cache_frac = hit_tokens / node.tokens_in
                self.cache_hits += 1
                remaining = max(node.work_items - items_done, 0)
                self.prefill_tokens_saved += hit_tokens * remaining
                for inst in insts:
                    cluster.cache_touch(inst, session, t)
        dur, compute, per_inst = sim._duration(node, cfg, n_inst,
                                               new_inst, items_done,
                                               cache_frac)
        pmult = cfg.paths if cfg.paths > 1 and not node.chunkable else 1.0
        dur *= pmult
        # seeded fault draws (DESIGN.md §10): a pure function of
        # (seed, wid, tid, attempt), so replay and the fast/reference
        # dispatch paths see identical fault streams regardless of
        # dispatch order. All three draws always happen (stream stability).
        attempt = st.attempt.get(tid, 0)
        slow, fail_frac = 1.0, 0.0
        fp = self.faults
        if fp is not None:
            u_fail, u_frac, u_strag = fp.task_draws(wid, tid, attempt)
            if u_fail < fp.task_fail_p:
                # transient failure somewhere inside the compute window
                fail_frac = 0.05 + 0.9 * u_frac
            elif u_strag < fp.straggler_p:
                slow = fp.straggler_mult
                self.faults_injected += 1
        base_dur = dur          # the CostQuery estimate (hedge trigger)
        if slow != 1.0:
            extra = compute * (slow - 1.0)
            compute = compute * slow
            dur = dur + extra * pmult
        end = t + dur
        # the tail of the run is compute; any lead-in is weights load
        compute_begin = end - compute * pmult
        for inst in insts:
            inst.busy_until = end
        ndev = cfg_ndev * n_inst
        dev_s = compute * ndev * cfg.paths
        pfkey = (cfg_impl, cfg_pool, cfg_ndev)
        pf = self._pf_memo.get(pfkey)
        if pf is None:
            pf = self._pf_memo[pfkey] = \
                self.profiles.power_frac(impl, spec, cfg_ndev)
        self.ledger.charge_active(spec, dev_s, pf, cfg_pool)
        busy = self.busy
        busy[cfg_pool] = busy.get(cfg_pool, 0.0) + dev_s
        # ServedCounter.charge, inlined (same float op)
        srv = self.served.served
        tenant = st.tenant
        srv[tenant] = srv.get(tenant, 0.0) + dev_s
        st.started.add(tid)
        ready = st.ready
        i = bisect.bisect_left(ready, (st.dag.topo_index(tid), tid))
        if i < len(ready) and ready[i][1] == tid:
            del ready[i]
            if not ready and not self.pol.dynamic:
                active_ready = self.active_ready
                j = bisect.bisect_left(active_ready, (st.sort_key, wid))
                if j < len(active_ready) and active_ready[j][1] == wid:
                    del active_ready[j]
        if self.collect_trace or self.log is not None:
            # compose the note: restart kind + warmth, so preemption
            # analysis sees a requeue that also paid a cold weights load
            # ("requeue+cold") rather than losing the restart cost. An
            # untraced, unlogged run (the benchmark posture) skips the
            # string work — nothing downstream ever reads the note then.
            restart = ("resume" if attempt and items_done else
                       "requeue" if attempt else "")
            warmth = "cold" if new_inst else ("warm" if insts else "")
            if cache_frac > 0.0:
                # surface the prefix hit in the trace ("warm+kv")
                warmth = warmth + "+kv" if warmth else "kv"
            note = (restart + "+" + warmth if restart and warmth
                    else restart or warmth)
            if slow != 1.0:
                note = note + "+slow" if note else "slow"
        else:
            restart = note = ""
        lease_owner = self.lease_owner
        owner = (wid, tid)
        for lease in leases:
            lease_owner[lease.id] = owner
        for inst in insts:
            lease = inst.lease
            if lease is not None:
                lease_owner[lease.id] = owner
        # _Running's positional field order; kwargs cost real time here
        self.running[owner] = _Running(
            cfg, leases, insts, t, end, compute_begin, ndev, dev_s, pf,
            note, n_inst, (1 if spec.kind == "cpu" else cfg.batch),
            items_done, per_inst, node.chunkable, session, cache_frac,
            slow)
        if fail_frac:
            # this attempt dies mid-compute instead of finishing
            fail_t = compute_begin + (end - compute_begin) * fail_frac
            heapq.heappush(self.events, (fail_t, next(self.ctr), "tfail",
                                         (wid, tid, attempt)))
        else:
            heapq.heappush(self.events, (end, next(self.ctr), "finish",
                                         (wid, tid, attempt)))
            if fp is not None and fp.hedge and slow >= fp.hedge_threshold:
                # straggler detected against the CostQuery estimate: at
                # threshold x the estimated duration the task is still
                # running — launch a duplicate then (first finish wins)
                heapq.heappush(
                    self.events,
                    (t + base_dur * fp.hedge_threshold, next(self.ctr),
                     "hedge", (wid, tid, attempt)))
        if self.log is not None:
            self.log.append(f"[{t:8.1f}s] start {wid}:{tid} on "
                            f"{ndev}x{cfg.pool} ({cfg.impl})"
                            + (f" [{restart}]" if restart else ""))
        return True

    # -- finish ---------------------------------------------------------------
    def on_finish(self, payload) -> bool:
        """Finish event; returns True when the whole workflow completed."""
        wid, tid, attempt = payload
        st = self.wfs[wid]
        if st.attempt.get(tid, 0) != attempt:
            return False    # stale: this execution was preempted
        rec = self.running.pop((wid, tid))
        if self.hedges:
            # the primary beat its duplicate: cancel the hedge, discard
            # and waste whatever it had executed (first finish wins)
            self._kill_hedge(wid, tid)
        return self._complete(wid, tid, st, rec)

    def on_finish_batch(self, payloads: list):
        """Settle a contiguous same-``t`` run of finish events as a group.

        Per-task settlement runs in pop order (identical to the uncoalesced
        loop); the per-pool epoch bump and the rebalance scan are deferred
        to the end of the group via ``_pend_pools`` (see the module
        docstring for the schedule-invariance argument).
        """
        if len(payloads) == 1:
            self.on_finish(payloads[0])
            return
        pend = self._pend_pools = {}
        for payload in payloads:
            self.on_finish(payload)
        self._pend_pools = None
        cluster = self.cluster
        if pend:
            epochs = cluster.free_epoch
            for pool in pend:
                epochs[pool] += 1
            cluster.epoch_total += len(pend)
        if cluster.demand_zeroed:
            cluster.demand_zeroed = False
            log = self.log
            for action in cluster.rebalance(self.sim.library, self.t):
                if log is not None:
                    log.append(f"[{self.t:8.1f}s] rebalance: {action}")

    def _complete(self, wid: str, tid: str, st: _WfState,
                  rec: _Running) -> bool:
        """Book a finished run (shared by primary finishes and hedge wins).

        For a dead-lettered workflow the run still settles its resources
        and trace, but spawns no successors and can never count as a
        workflow completion.
        """
        t = self.t
        cluster = self.cluster
        done = st.done
        done.add(tid)
        if t > st.finish:
            st.finish = t
        cluster.complete_task(wid, tid)
        if rec.slow != 1.0:
            # a straggler that ran to completion burned ``slow``x the
            # compute the work required: the excess is overhead of the
            # fault, booked as waste — the same currency a hedge-beaten
            # primary's discarded run is booked in, so the fault bench
            # compares hedging against let-it-drag honestly
            self.wasted_dev_s += rec.dev_s * (rec.slow - 1.0) / rec.slow
        cfg = rec.cfg
        model = self.is_model[cfg.impl]
        lease_owner = self.lease_owner
        for lease in rec.leases:
            # model instances keep their devices (stay warm); tools
            # release. Instance devices are reclaimed by rebalance.
            lease_owner.pop(lease.id, None)
            if not model:
                cluster.release(lease, t)
        for inst in rec.insts:
            lease = inst.lease
            if lease is not None:
                lease_owner.pop(lease.id, None)
        # session finished a turn on these shells: the full prompt+reply KV
        # is now resident, serving the *next* turn's prefix (DESIGN.md §9).
        # Insertion is gated like the pricing above, so cache-less runs
        # never touch the ledger (byte-identity with the pre-cache engine).
        if rec.session:
            node = st.dag.nodes[tid]
            impl = self.impls[cfg.impl]
            tokens = node.tokens_in + node.tokens_out
            nbytes = impl.kv_bytes_per_token * tokens
            for inst in rec.insts:
                cluster.cache_insert(inst, rec.session, tokens, nbytes, t)
        # the task's instances just went idle: blocked tasks keyed on this
        # pool may now reuse (or evict) them, so the availability epoch
        # must move even though no lease was released (model path). Inside
        # a coalesced finish group the bump is deferred — one per touched
        # pool at group end (the memo only equality-compares epochs, and
        # dispatch runs after the drain).
        pend = self._pend_pools
        if pend is None:
            cluster.free_epoch[cfg.pool] += 1
            cluster.epoch_total += 1
        else:
            pend[cfg.pool] = True
        if self.collect_trace:
            self.trace.append(TraceEntry(wid, tid, rec.cfg.impl,
                                         rec.cfg.pool, rec.ndev,
                                         rec.start, t, note=rec.note))
        tele = self.tele
        if tele is not None:
            # one record per completed attempt, priced exactly as the
            # ledger charged it (marginal energy over idle; $ over the full
            # device-seconds). Pure observation — nothing above read it.
            node = st.dag.nodes[tid]
            spec = self.specs[cfg.pool]
            energy = (rec.dev_s * rec.pf * (spec.active_w - spec.idle_w)
                      if spec.metered else 0.0)
            tele.observe(
                t=t, workflow=wid, task=tid, node=node,
                interface=node.agent, impl=cfg.impl, pool=cfg.pool,
                latency_s=t - rec.start, energy_j=energy,
                usd=rec.dev_s / 3600.0 * spec.usd_per_hour,
                declared_quality=cfg.quality,
                routed=node.agent in self.sim.routed_interfaces)
        # index newly-ready successors (their last dependency just
        # finished); a dead workflow spawns nothing
        nodes = st.dag.nodes
        if not st.dead:
            started = st.started
            for succ in st.dag.succ(tid):
                if succ in done or succ in started:
                    continue
                for d in nodes[succ].deps:
                    if d not in done:
                        break
                else:
                    self._push_ready(wid, st, succ)
        finished = not st.dead and len(done) == len(nodes)
        if finished:
            self._deactivate(wid, st)
            self.incomplete -= 1
        # workflow-aware reclamation once demand disappears. Gated on the
        # demand-hit-zero flag: rebalance can only newly reclaim at the
        # instant some interface's pending count reaches 0 (an interface
        # with zero demand has no running tasks either, so its instances
        # were all idle — and evicted — the moment it zeroed), which makes
        # skipping the other calls a pure no-op elision. Deferred to group
        # end inside a coalesced finish batch.
        if pend is None and cluster.demand_zeroed:
            cluster.demand_zeroed = False
            for action in cluster.rebalance(self.sim.library, t):
                if self.log is not None:
                    self.log.append(f"[{t:8.1f}s] rebalance: {action}")
        return finished
