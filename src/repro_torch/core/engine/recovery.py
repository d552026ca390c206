"""Recovery layer: fault injection, retry/backoff, hedges, crash repair.

All handlers here are inert when ``Simulator.faults`` is ``None`` — no
events of these kinds are ever pushed then, so a fault-free run's heap,
float-op order and counters stay byte-identical to an engine without the
subsystem (DESIGN.md §10; the golden tests pin it). Fault draws are pure
functions of (seed, workflow, task, attempt), so the fast and reference
dispatch paths see identical fault streams regardless of dispatch order.
"""
from __future__ import annotations

import bisect
import heapq

from ..cluster import Instance, Lease
from ..scheduler import ExecutionPlan
from .events import TraceEntry, _Running, _WfState


class RecoveryMixin:
    """Crash/fail/retry/hedge event handlers mixed into ``Engine``."""

    def seed_faults(self):
        """Arm the per-pool crash processes (called once, at run start)."""
        fp = self.faults
        fp.validate_pools(self.cluster.pools)
        # crash-shrunk pools must make over-sized plans *wait* for repair,
        # not permanently degrade them: remember the nominal capacities as
        # the no-autoscaler pool limit (Simulator._pool_limit)
        self.sim._nominal_caps = {name: p.capacity
                                  for name, p in self.cluster.pools.items()}
        for pool in sorted(fp.instance_mtbf_s):
            rng = self._pool_rng[pool] = fp.pool_stream(pool)
            gap = rng.expovariate(1.0 / fp.instance_mtbf_s[pool])
            heapq.heappush(self.events,
                           (gap, next(self.ctr), "crash", pool))

    def on_fault_event(self, kind: str, payload) -> None:
        """Dispatch one fault-machinery heap event."""
        if kind == "crash":
            self.on_crash(payload)
        elif kind == "repair":
            self.on_repair(payload)
        elif kind == "tfail":
            wid, tid, attempt = payload
            self.fail_task(wid, tid, attempt, "fault")
        elif kind == "retry":
            self.on_retry(payload)
        elif kind == "hedge":
            self.on_hedge(payload)
        elif kind == "hfinish":
            self.on_hfinish(payload)
        else:
            raise RuntimeError(f"unknown event kind {kind!r}")

    def fail_task(self, wid: str, tid: str, t_attempt: int, reason: str,
                  crashed: Instance | None = None):
        """A running task just failed (transient fault or instance crash).

        Like ``cancel_task``, but: surviving shells go *idle* instead of
        being evicted (the software failed, not the hardware), the failure
        counts against the workflow's retry budget, and the task re-queues
        only after a seeded exponential backoff (the retry event) — or the
        workflow dead-letters once the budget is exhausted. Chunkable tasks
        checkpoint their completed steps through the same ``_refund``
        inversion preemption uses, so a retry resumes from ``items_done``.
        """
        st = self.wfs[wid]
        if st.attempt.get(tid, 0) != t_attempt:
            return                      # stale: that execution already ended
        rec = self.running.pop((wid, tid), None)
        if rec is None:
            return
        t = self.t
        if self.hedges:
            self._kill_hedge(wid, tid)  # a hedge dies with its primary
        st.started.discard(tid)
        st.attempt[tid] = t_attempt + 1
        for lease in rec.leases:
            self.lease_owner.pop(lease.id, None)
            if self.cluster.lease_active(lease):
                self.cluster.release(lease, t)
        for inst in rec.insts:
            if inst.lease is not None:
                self.lease_owner.pop(inst.lease.id, None)
            if inst is crashed or inst not in self.cluster.instances:
                continue
            inst.busy_until = t         # surviving shells idle immediately
        if rec.insts:
            # availability moved (shells idled / died): wake blocked keys
            self.cluster.free_epoch[rec.cfg.pool] += 1
            self.cluster.epoch_total += 1
        self._refund(rec, st, tid, t)
        self.faults_injected += 1
        if reason == "fault":
            self.task_faults += 1
        if self.collect_trace:
            self.trace.append(TraceEntry(
                wid, tid, rec.cfg.impl, rec.cfg.pool, rec.ndev, rec.start,
                t, note=("crashed" if reason == "crash" else "failed")))
        if st.dead:
            return      # already dead-lettered: this run just settled
        fails = st.fails.get(tid, 0) + 1
        st.fails[tid] = fails
        if fails >= self.retry.attempts_for(st.tenant):
            if self.log is not None:
                self.log.append(f"[{t:8.1f}s] {reason} {wid}:{tid} "
                                f"(attempt {fails}); retries exhausted")
            self._dead_letter(wid, st)
            return
        delay = self.retry.backoff_s(
            fails, self.faults.retry_jitter(wid, tid, fails))
        heapq.heappush(self.events,
                       (t + delay, next(self.ctr), "retry",
                        (wid, tid, fails)))
        if self.log is not None:
            self.log.append(f"[{t:8.1f}s] {reason} {wid}:{tid} "
                            f"(attempt {fails}); retry in {delay:.1f}s")

    def _dead_letter(self, wid: str, st: _WfState):
        """Abandon a workflow whose task exhausted its retry budget."""
        self.dead_letters += 1
        st.dead = True
        if st.ready and not self.pol.dynamic:
            j = bisect.bisect_left(self.active_ready, (st.sort_key, wid))
            if j < len(self.active_ready) and \
                    self.active_ready[j][1] == wid:
                del self.active_ready[j]
        st.ready.clear()
        self._deactivate(wid, st)
        # its unfinished tasks are no longer upcoming demand
        self.cluster.abandon_workflow(wid)
        self.incomplete -= 1
        if self.log is not None:
            self.log.append(f"[{self.t:8.1f}s] dead-letter {wid} "
                            f"({st.tenant})")

    def on_crash(self, pool: str):
        """Exponential-MTBF instance crash on ``pool``.

        The victim dies through ``evict_instance`` — its lease is released
        and its KV/prefix entries die with the shell — and the crashed
        device group leaves the pool's capacity until a seeded repair
        restores it (the autoscaler may backfill sooner). The draws happen
        unconditionally so the crash clock is a pure function of the seed,
        whatever the cluster looks like when it fires.
        """
        fp = self.faults
        rng = self._pool_rng[pool]
        u_victim = rng.random()
        gap = rng.expovariate(1.0 / fp.instance_mtbf_s[pool])
        repair = rng.expovariate(1.0 / fp.repair_s)
        if self.incomplete <= 0:
            return      # run drained: stop the crash process
        t = self.t
        live = list(self.cluster.pool_instances(pool))
        if live:
            victim = live[min(int(u_victim * len(live)), len(live) - 1)]
            self.instance_crashes += 1
            lease = victim.lease
            owner = (self.lease_owner.pop(lease.id, None)
                     if lease is not None else None)
            n = victim.n_devices
            self.cluster.evict_instance(victim, t)
            cap = self.cluster.pools[pool].capacity
            self.cluster.set_capacity(pool, cap - n, t)
            heapq.heappush(self.events,
                           (t + repair, next(self.ctr), "repair",
                            (pool, n)))
            if self.log is not None:
                self.log.append(f"[{t:8.1f}s] crash {victim.impl} "
                                f"({n}x{pool}); repair in {repair:.0f}s")
            if owner is None:
                self.faults_injected += 1   # idle shell (KV died with it)
            elif len(owner) == 3:
                self.faults_injected += 1
                self._kill_hedge(owner[1], owner[2])
            else:
                wid, tid = owner
                self.fail_task(wid, tid,
                               self.wfs[wid].attempt.get(tid, 0),
                               "crash", crashed=victim)
        if self.incomplete > 0:
            heapq.heappush(self.events,
                           (t + gap, next(self.ctr), "crash", pool))

    def on_repair(self, payload):
        """Restore a crashed device group's capacity (clamped to the pool
        limit, so an autoscaler keeps authority over the final size)."""
        pool, n = payload
        cap = self.cluster.pools[pool].capacity
        new_cap = min(cap + n, self.sim._pool_limit(pool))
        if new_cap > cap:
            self.cluster.set_capacity(pool, new_cap, self.t)
            if self.log is not None:
                self.log.append(f"[{self.t:8.1f}s] repair +{n}x{pool}")

    def on_retry(self, payload):
        """Backoff elapsed: requeue the failed task (maybe replanned)."""
        wid, tid, fails = payload
        st = self.wfs.get(wid)
        if st is None or st.dead or st.fails.get(tid, 0) != fails:
            return
        if tid in st.done or tid in st.started:
            return
        self.fault_retries += 1
        rp = self.retry
        if rp.replan_after > 0 and fails >= rp.replan_after \
                and st.plan_fn is not None:
            # graceful degradation: under retry pressure, replan the
            # workflow's remaining tasks against the *live* (possibly
            # capacity-degraded) cluster — the planner picks a cheaper
            # impl/config within the quality floor if the original no
            # longer fits well
            self._degrade_replan(wid, st)
        self._push_ready(wid, st, tid)
        if self.log is not None:
            self.log.append(f"[{self.t:8.1f}s] retry {wid}:{tid} "
                            f"(failure {fails})")

    def _degrade_replan(self, wid: str, st: _WfState):
        """Re-plan remaining tasks on the degraded cluster (copy-on-write)."""
        try:
            fresh = st.plan_fn()
        except Exception:
            return                      # planning may fail mid-degradation
        cfgs = dict(st.plan.configs)
        changed = False
        for tid, cfg in fresh.configs.items():
            if tid in st.done or tid in st.started:
                continue                # only not-yet-run tasks may move
            if cfgs.get(tid) != cfg:
                cfgs[tid] = cfg
                changed = True
        if changed:
            st.plan = ExecutionPlan(cfgs)
            self.degrade_replans += 1
            if self.log is not None:
                self.log.append(f"[{self.t:8.1f}s] degrade-replan {wid}")

    def on_hedge(self, payload):
        """Straggler-detection event: the task has now run for
        ``hedge_threshold x`` its estimate — launch a duplicate if it is
        still running and resources fit."""
        wid, tid, attempt = payload
        st = self.wfs.get(wid)
        if st is None or st.dead or st.attempt.get(tid, 0) != attempt:
            return
        rec = self.running.get((wid, tid))
        if rec is None or (wid, tid) in self.hedges:
            return
        self._start_hedge(wid, tid, attempt, st, rec)

    def _start_hedge(self, wid: str, tid: str, attempt: int,
                     st: _WfState, rec: _Running):
        """Duplicate a straggling run on other shells (first finish wins).

        Hedges are opportunistic: they use genuinely free capacity only —
        no eviction, no preemption — and are themselves preemptible and
        crash-prone, but never straggle or fault (one level of recursion
        is enough). The duplicate prices the same residual the primary
        did (``items_done0``), sessionless (its shells hold no prefix).
        """
        t = self.t
        cluster = self.cluster
        cfg = rec.cfg
        node = st.dag.nodes[tid]
        impl = self.impls[cfg.impl]
        spec = self.specs[cfg.pool]
        harvest = st.tenant == "harvest"
        leases: list[Lease] = []
        insts: list[Instance] = []
        new_inst = 0
        if self.is_model[cfg.impl]:
            for i in cluster.warm_instances(cfg.impl, cfg.pool,
                                            cfg.n_devices):
                if len(insts) >= rec.n_inst:
                    break
                if i.busy_until <= t and i not in rec.insts:
                    insts.append(i)
            provisioned = []
            while len(insts) < rec.n_inst:
                lease = cluster.alloc(cfg.pool, cfg.n_devices, t,
                                      harvest=harvest)
                if lease is None:
                    break
                inst = Instance(cfg.impl, cfg.pool, cfg.n_devices,
                                warm_since=t, lease=lease,
                                cache_cap_bytes=self.sim._cache_cap(cfg))
                cluster.add_instance(inst)
                insts.append(inst)
                provisioned.append(inst)
                new_inst += 1
            if len(insts) < rec.n_inst:
                for inst in provisioned:    # couldn't fit: roll back
                    cluster.evict_instance(inst, t)
                return
        else:
            lease = cluster.alloc(cfg.pool, cfg.n_devices * rec.n_inst, t,
                                  harvest=harvest)
            if lease is None:
                return
            leases.append(lease)
        n_inst = rec.n_inst
        dur, compute, per_inst = self.sim._duration(
            node, cfg, n_inst, new_inst, rec.items_done0, 0.0)
        pmult = cfg.paths if cfg.paths > 1 and not node.chunkable else 1.0
        dur *= pmult
        end = t + dur
        compute_begin = end - compute * pmult
        for inst in insts:
            inst.busy_until = end
        ndev = cfg.n_devices * n_inst
        dev_s = compute * ndev * cfg.paths
        pf = self.profiles.power_frac(impl, spec, cfg.n_devices)
        self.ledger.charge_active(spec, dev_s, utilization=pf,
                                  pool=cfg.pool)
        self.busy[cfg.pool] = self.busy.get(cfg.pool, 0.0) + dev_s
        self.served.charge(st.tenant, dev_s)
        howner = ("h", wid, tid)
        for lease in leases:
            self.lease_owner[lease.id] = howner
        for inst in insts:
            if inst.lease is not None:
                self.lease_owner[inst.lease.id] = howner
        self.hedges[(wid, tid)] = _Running(
            cfg, leases, insts, t, end, compute_begin, ndev, dev_s, pf,
            note="hedge+" + ("cold" if new_inst else "warm"),
            n_inst=n_inst, batch=(1 if spec.kind == "cpu" else cfg.batch),
            items_done0=rec.items_done0, items_per_inst=per_inst,
            resumable=node.chunkable)
        self.hedges_launched += 1
        heapq.heappush(self.events, (end, next(self.ctr), "hfinish",
                                     (wid, tid, attempt)))
        if self.log is not None:
            self.log.append(f"[{t:8.1f}s] hedge {wid}:{tid} on "
                            f"{ndev}x{cfg.pool} (primary "
                            f"{rec.slow:.1f}x slow)")

    def _kill_hedge(self, wid: str, tid: str):
        """Cancel an in-flight hedge; its executed work is discarded."""
        hrec = self.hedges.pop((wid, tid), None)
        if hrec is None:
            return
        t = self.t
        for lease in hrec.leases:
            self.lease_owner.pop(lease.id, None)
            if self.cluster.lease_active(lease):
                self.cluster.release(lease, t)
        for inst in hrec.insts:
            if inst.lease is not None:
                self.lease_owner.pop(inst.lease.id, None)
            if inst in self.cluster.instances:
                inst.busy_until = t
        if hrec.insts:
            self.cluster.free_epoch[hrec.cfg.pool] += 1
            self.cluster.epoch_total += 1
        # salvage=False: the loser's completed steps don't checkpoint (the
        # winner runs the full residual itself — crediting both would
        # double-count items), so executed = wasted, unexecuted = refunded
        self._refund(hrec, self.wfs[wid], tid, t, salvage=False)
        if self.collect_trace:
            self.trace.append(TraceEntry(
                wid, tid, hrec.cfg.impl, hrec.cfg.pool, hrec.ndev,
                hrec.start, t, note="hedge_lost"))

    def on_hfinish(self, payload):
        """A hedge finished first: cancel the straggling primary and
        complete the task through the duplicate's run."""
        wid, tid, attempt = payload
        hrec = self.hedges.get((wid, tid))
        st = self.wfs.get(wid)
        if hrec is None or st is None or \
                st.attempt.get(tid, 0) != attempt:
            return
        del self.hedges[(wid, tid)]
        t = self.t
        prec = self.running.pop((wid, tid), None)
        if prec is not None:
            # invalidate the primary's in-flight finish event
            st.attempt[tid] = attempt + 1
            for lease in prec.leases:
                self.lease_owner.pop(lease.id, None)
                if self.cluster.lease_active(lease):
                    self.cluster.release(lease, t)
            for inst in prec.insts:
                if inst.lease is not None:
                    self.lease_owner.pop(inst.lease.id, None)
                if inst in self.cluster.instances:
                    inst.busy_until = t
            if prec.insts:
                self.cluster.free_epoch[prec.cfg.pool] += 1
                self.cluster.epoch_total += 1
            self._refund(prec, st, tid, t, salvage=False)
            if self.collect_trace:
                self.trace.append(TraceEntry(
                    wid, tid, prec.cfg.impl, prec.cfg.pool, prec.ndev,
                    prec.start, t, note="hedge_beat_primary"))
        self.hedges_won += 1
        self._complete(wid, tid, st, hrec)
