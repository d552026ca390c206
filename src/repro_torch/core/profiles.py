"""Execution profiles: (implementation x hardware) efficiency/quality records.

The paper (§3.2 Model/Tool Selection): "Murakkab generates an execution
profile for each model/tool and hardware resource pair when a new one is
added to the library — the profile captures an efficiency vs quality
tradeoff."

Here a profile is generated analytically from the same three-term roofline
the perf analysis uses (DESIGN.md §5.4): latency = max(compute, memory,
collective) over the implementation's workload model and the device's specs.
Measured calibration points (e.g. the paper-cluster Whisper timings in
``configs/workflow_video.py``) can be *pinned* and take precedence — that is
the moral equivalent of the paper's offline profiling runs, amortized across
workflows. A pin may carry a per-batch latency *curve* (DESIGN.md §7.2), so
measured rows batch on calibration data instead of the deprecated
``batch ** alpha`` scalar.
"""
from __future__ import annotations

import math
import warnings
from collections import OrderedDict
from dataclasses import dataclass
from typing import Sequence

try:                                    # the vectorized pricing kernel
    import numpy as _np                 # (DESIGN.md §12); the scalar path
except ImportError:                     # needs no numpy, so its absence
    _np = None                          # only disables batching

from .agents import AgentImpl, AgentLibrary, Work
from .energy import (CATALOG, DeviceSpec, batch_roofline_latency,
                     roofline_latency)


@dataclass(frozen=True, kw_only=True)
class CostQuery:
    """One cost-model query: everything a latency/price question names.

    The four ``ProfileStore`` entry points (``step_latency`` /
    ``schedule_latency`` / ``completed_items`` / ``latency``) used to share
    a positional-kwarg sprawl of ``(impl, spec, n_devices, work, batch,
    items, elapsed_s, ...)``; they now all accept one frozen keyword-only
    query object, so a new pricing dimension threads through one site
    instead of four. ``cache_hit_frac`` is that dimension for KV/prefix
    caching (DESIGN.md §9): the fraction of the item's *input* tokens whose
    prefix KV is already resident on the serving instance — the prefill
    phase is charged only for the un-cached remainder, in both the
    scheduler's estimates and the simulator's actuals (parity by
    construction, since both price through the same query).

    Not hashable (``AgentImpl`` carries dict fields); the memo key is the
    name-based tuple ``ProfileStore`` derives, unchanged from the
    positional era so cache-less queries hit the same entries.
    """

    impl: AgentImpl
    spec: DeviceSpec
    n_devices: int
    work: Work
    batch: int = 1
    items: int = 1
    items_done: int = 0
    elapsed_s: float = 0.0
    cache_hit_frac: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.cache_hit_frac <= 1.0:
            raise ValueError(
                f"cache_hit_frac must be in [0, 1], got {self.cache_hit_frac}")

    def effective_work(self) -> Work:
        """The work actually charged: prefill scaled by the cache miss rate.

        A hit fraction of ``h`` makes ``h`` of the prompt's prefix KV
        resident, so only ``(1-h)`` of the prefill FLOPs/bytes are
        executed; decode is untouched (every output token is new). Works
        without a prefill/decode phase split have no prefill to discount
        and are returned as-is, as is the ``h == 0`` case — the *same*
        object, no float ops, so cold-path pricing is byte-identical to
        the pre-cache model.
        """
        h = self.cache_hit_frac
        w = self.work
        if h <= 0.0 or not w.has_phases:
            return w
        keep = 1.0 - h
        return Work.two_phase(
            prefill_flops=w.prefill_flops * keep,
            decode_flops=w.decode_flops,
            prefill_bytes=w.prefill_bytes * keep,
            decode_bytes=w.decode_bytes,
            weight_bytes=w.weight_bytes,
            decode_steps=w.decode_steps,
            coll_bytes=w.coll_bytes)


# a pinned calibration row: ((batch, per_item_latency_s), ...), sorted by
# batch, per-item latency non-increasing (see _as_curve)
BatchCurve = tuple[tuple[int, float], ...]


def _as_curve(latency_s) -> BatchCurve:
    """Normalize a pin's latency argument into a monotone batch curve.

    Accepts a scalar (per-item seconds at batch=1 — the legacy single-point
    form), a ``{batch: per_item_s}`` mapping, or an iterable of ``(batch,
    per_item_s)`` pairs. Per-item latencies are made non-increasing in batch
    by a running minimum (absorbs measurement noise; co-scheduling more
    items can never *raise* per-item latency on real hardware), and the
    implied step latency ``batch * per_item`` must be non-decreasing — a
    superlinear batching speedup is unphysical and would unsound the
    scheduler's dominated-config pruning bound.
    """
    if isinstance(latency_s, (int, float)):
        pts = [(1, float(latency_s))]
    else:
        items = (latency_s.items() if isinstance(latency_s, dict)
                 else latency_s)
        pts = sorted((int(b), float(v)) for b, v in items)
    if not pts:
        raise ValueError("empty batch-latency curve")
    seen = set()
    for b, v in pts:
        if b < 1:
            raise ValueError(f"batch sizes must be >= 1, got {b}")
        if v <= 0:
            raise ValueError(f"per-item latency must be positive, got {v}")
        if b in seen:
            raise ValueError(f"duplicate batch size {b} in curve")
        seen.add(b)
    if len(pts) == 1 and pts[0][0] != 1:
        raise ValueError(
            f"a single-point pin must be the batch=1 per-item latency "
            f"(got batch {pts[0][0]}): the alpha fallback anchors at b=1 — "
            f"include more batch points to pin a curve instead")
    lo = math.inf
    curve = []
    for b, v in pts:
        lo = min(lo, v)
        curve.append((b, lo))
    for (b0, v0), (b1, v1) in zip(curve, curve[1:]):
        if b1 * v1 < b0 * v0 * (1 - 1e-9):
            raise ValueError(
                f"step latency decreases from batch {b0} ({b0 * v0:.4g}s) "
                f"to batch {b1} ({b1 * v1:.4g}s): a batched step cannot "
                f"take less wall time than a smaller one")
    return tuple(curve)


def _curve_per_item(curve: BatchCurve, batch: int) -> float:
    """Per-item latency at ``batch``, interpolating the measured points.

    Log-log linear between bracketing points — exact for power-law curves
    (``lat1 * b ** (alpha - 1)``), which is how legacy ``batch_alpha``
    calibrations migrate without moving any number — and clamped flat
    outside the measured range (extrapolating a measured curve would claim
    speedups nobody observed).
    """
    if batch <= curve[0][0]:
        return curve[0][1]
    if batch >= curve[-1][0]:
        return curve[-1][1]
    for (b0, v0), (b1, v1) in zip(curve, curve[1:]):
        if b0 <= batch <= b1:
            if batch == b0:
                return v0
            if batch == b1:
                return v1
            t = (math.log(batch) - math.log(b0)) \
                / (math.log(b1) - math.log(b0))
            return math.exp(math.log(v0) + t * (math.log(v1) - math.log(v0)))
    return curve[-1][1]   # unreachable; curve is sorted


@dataclass(frozen=True)
class Profile:
    """One (impl, device SKU, device count) profile row."""

    impl: str
    device: str
    n_devices: int
    latency_s: float          # per work-item
    energy_j: float           # marginal (above idle) energy per work-item
    usd: float                # $ per work-item
    quality: float
    pinned: bool = False      # measured (calibrated) vs analytic


class ProfileStore:
    """Profile generation + pinned calibration overrides.

    ``step_latency`` is the single latency model both the scheduler's
    estimates and the simulator's actuals consume (DESIGN.md §7);
    ``schedule_latency`` composes it into the batched execution schedule of
    a whole task (full steps + one remainder step, §7.2). Results are
    memoized in a bounded LRU keyed by ``(impl, device, n_devices, batch,
    work)`` — the work signature is the frozen ``Work`` dataclass itself —
    so repeated planning over the same library/cluster pays the roofline
    math once; remainder steps land in the same cache under their own
    batch key.
    """

    CACHE_MAX = 8192

    def __init__(self, library: AgentLibrary):
        self.library = library
        # (impl, device, n_devices) -> (batch curve, power_frac)
        self._pinned: dict[tuple[str, str, int], tuple[BatchCurve, float]] = {}
        # impl -> measured quality override (the telemetry feedback loop's
        # calibration target, DESIGN.md §11); absent impls answer with
        # their declared ladder score
        self._quality: dict[str, float] = {}
        self._cache: OrderedDict[tuple, float] = OrderedDict()
        self.cache_enabled = True
        self.cache_hits = 0
        self.cache_misses = 0
        # bumped on every pin(): downstream caches keyed on estimates (the
        # admission plan cache) include it so calibration invalidates them
        self.version = 0
        self._alpha_warned: set[tuple[str, str]] = set()

    # -- calibration ---------------------------------------------------------
    def pin(self, impl: str, device: str, n_devices: int, latency_s,
            power_frac: float | None = None):
        """Pin a measured calibration row for (impl, device, count).

        ``latency_s`` is either a scalar — per-item seconds at batch=1, the
        legacy single-point form — or a per-batch latency curve
        (``{batch: per_item_s}`` mapping or ``(batch, per_item_s)`` pairs)
        captured by e.g. ``benchmarks/calibrate_batch_curves.py``. Curves
        batch by monotone log-log interpolation over the measured points;
        single-point pins fall back to the deprecated ``batch ** alpha``
        scalar (and warn the first time a batched step asks for one).
        Pinned rows take precedence over the analytic roofline, and every
        pin bumps ``version`` / drops the estimate memo so calibration
        invalidates cached plans.
        """
        imp = self.library.impls[impl]
        pf = imp.power_frac if power_frac is None else power_frac
        self._pinned[(impl, device, n_devices)] = (_as_curve(latency_s), pf)
        self._cache.clear()     # calibration invalidates memoized estimates
        self.version += 1

    def pin_quality(self, impl: str, quality: float):
        """Pin a *measured* quality for an implementation (DESIGN.md §11).

        The quality column of the profile library: the scheduler's
        ``quality_floor`` gate and quality estimates read
        :meth:`quality`, so a telemetry-calibrated value (e.g. from
        ``OfflineEvaluator.calibrate_profiles``) changes which impls are
        selectable under a floor. Bumps ``version`` — the admission plan
        cache is keyed on it, so stale plans are invalidated — without
        touching the latency memo (quality prices nothing).
        """
        if impl not in self.library.impls:
            raise KeyError(f"unknown implementation {impl!r}")
        if not 0.0 < quality <= 1.0:
            raise ValueError(f"quality must be in (0, 1], got {quality}")
        self._quality[impl] = float(quality)
        self.version += 1

    def quality(self, impl_name: str) -> float:
        """Implementation quality: the measured (pinned) value when the
        telemetry loop calibrated one, else the declared ladder score.
        With no pins this is exactly ``impl.quality`` — the scheduler's
        pre-quality-column behaviour, byte-identical."""
        q = self._quality.get(impl_name)
        if q is not None:
            return q
        return self.library.impls[impl_name].quality

    # -- queries --------------------------------------------------------------
    def _pinned_curve(self, impl: AgentImpl, spec: DeviceSpec,
                      n_devices: int) -> BatchCurve | None:
        """Calibrated batch curve, or None when only analytic."""
        key = (impl.name, spec.name, n_devices)
        if key in self._pinned:
            return self._pinned[key][0]
        # nearest pinned device-count, strong-scaled (90% efficiency/doubling)
        cands = [(n, v) for (i, d, n), v in self._pinned.items()
                 if i == impl.name and d == spec.name]
        if cands:
            n0, (curve, _) = min(cands, key=lambda c: abs(
                math.log(c[0] / max(n_devices, 1))))
            scale = (n0 / n_devices) ** 0.9
            return tuple((b, v * scale) for b, v in curve)
        return None

    def _warn_alpha_fallback(self, impl: AgentImpl, spec: DeviceSpec):
        key = (impl.name, spec.name)
        if key in self._alpha_warned:
            return
        self._alpha_warned.add(key)
        warnings.warn(
            f"single-point pinned profile for ({impl.name}, {spec.name}): "
            f"batched steps fall back to the deprecated batch_alpha scalar. "
            f"Pin a per-batch latency curve instead (ProfileStore.pin with "
            f"a {{batch: per_item_s}} mapping; capture one with "
            f"benchmarks/calibrate_batch_curves.py).",
            DeprecationWarning, stacklevel=3)

    def _alpha_step(self, impl: AgentImpl, spec: DeviceSpec, base: float,
                    b: int, *, pinned: bool) -> float:
        """The deprecated ``batch ** alpha`` batch model — the one site.

        ``base`` is the batch=1 step latency: a single-point pin's
        per-item latency, or the analytic ``overhead + roofline`` for a
        work without a prefill/decode phase split. Pinned rows warn once
        per (impl, device) when actually batched — they *could* carry a
        measured curve and should; analytic phase-less works stay silent
        (alpha is their declared batch model, there is nothing to
        migrate).
        """
        if pinned and b > 1:
            self._warn_alpha_fallback(impl, spec)
        return base * b ** impl.batch_alpha

    @staticmethod
    def _require_query(method: str, query) -> None:
        if not isinstance(query, CostQuery):
            raise TypeError(
                f"ProfileStore.{method} takes a CostQuery; the positional "
                f"(impl, spec, n_devices, ...) form was removed — build "
                f"CostQuery(impl=..., spec=..., n_devices=..., work=...)")

    def _step(self, impl: AgentImpl, spec: DeviceSpec, n_devices: int,
              work: Work, batch: int) -> float:
        """Memoized one-step latency on an *effective* (post-discount) work.

        Three regimes, in precedence order:

        - *pinned* (measured) rows batch over their calibrated per-batch
          latency curve (monotone log-log interpolation); single-point pins
          carry no batch information, so the deprecated ``batch ** alpha``
          scalar stays their batch model (with a one-time warning);
        - analytic works *with* a prefill/decode phase split use the
          batch-aware roofline (weights stream amortizes across the batch);
        - analytic works without a split fall back to ``batch ** alpha``.
        """
        key = (impl.name, spec.name, n_devices, batch, work)
        if self.cache_enabled:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                self.cache_hits += 1
                return hit
            self.cache_misses += 1
        curve = self._pinned_curve(impl, spec, n_devices)
        b = max(batch, 1)
        if curve is not None:
            if len(curve) > 1:
                step = b * _curve_per_item(curve, b)
            else:
                step = self._alpha_step(impl, spec, curve[0][1], b,
                                        pinned=True)
        elif work.has_phases:
            step = impl.overhead_s + b * batch_roofline_latency(
                work, spec, n_devices=n_devices, batch=batch,
                efficiency=impl.mxu_efficiency)
        else:
            step = self._alpha_step(
                impl, spec,
                impl.overhead_s + roofline_latency(
                    work.flops, work.hbm_bytes, spec, n_devices=n_devices,
                    collective_bytes=work.coll_bytes,
                    efficiency=impl.mxu_efficiency),
                b, pinned=False)
        if self.cache_enabled:
            self._cache[key] = step
            if len(self._cache) > self.CACHE_MAX:
                self._cache.popitem(last=False)
        return step

    def step_latency(self, query: CostQuery) -> float:
        """Wall time of ONE step co-scheduling ``query.batch`` work-items.

        The query's ``cache_hit_frac`` discounts the prefill phase before
        pricing (:meth:`CostQuery.effective_work`); at hit 0 the step is
        priced on the original work object, byte-identical to the cache-less
        model.
        """
        self._require_query("step_latency", query)
        return self._step(query.impl, query.spec, query.n_devices,
                          query.effective_work(), query.batch)

    def schedule_latency(self, query: CostQuery) -> float:
        """Wall time to run ``query.items`` work-items in ``batch`` batches.

        The batched execution schedule (DESIGN.md §7.2): ``floor(items/b)``
        full steps plus — when ``items % b != 0`` — one *remainder* step
        charged at ``step_latency(items % b)``, not at the full batch's
        price. ``Scheduler.estimate`` and ``Simulator._duration`` both call
        this, so estimate/actual parity holds by construction — including
        the prefill discount at ``query.cache_hit_frac`` (one pricing site,
        DESIGN.md §9). The schedule never exceeds the legacy
        ``ceil(items/b)`` full-step charge
        (``tests/test_batch_schedule.py`` holds the property).
        """
        self._require_query("schedule_latency", query)
        eff = query.effective_work()
        b = max(int(query.batch), 1)
        items = max(int(query.items), 0)
        if items == 0:
            return 0.0
        full, rem = divmod(items, b)
        total = full * self._step(query.impl, query.spec, query.n_devices,
                                  eff, b) if full else 0.0
        if rem:
            total += self._step(query.impl, query.spec, query.n_devices,
                                eff, rem)
        return total

    # -- vectorized batch kernel (DESIGN.md §12) ------------------------------
    def step_latency_batch(self, queries: "Sequence[CostQuery]") \
            -> list[float]:
        """Price many one-step queries in one call — the batch kernel.

        Bitwise-identical to mapping :meth:`step_latency` over ``queries``,
        by construction: the analytic regimes' roofline arithmetic
        (divisions, maxima, multiply-adds) runs as numpy elementwise ops
        over the whole miss set — each IEEE-754 elementwise ``+ - * /`` and
        ``maximum`` has exactly one correctly-rounded answer, so the lanes
        match the scalar path bit for bit. Transcendentals do NOT vectorize
        safely (numpy's SIMD ``log``/``exp``/``power`` round differently
        from libm on ~3% of inputs), so the ``batch ** alpha`` power law
        and the pinned curve's log-log interpolation stay scalar per
        element. Results land in the shared step memo: later scalar calls
        on the same keys are hits, which is how the scheduler's grid
        prewarm feeds the estimate loop.
        """
        n_q = len(queries)
        out: list = [None] * n_q
        cache = self._cache if self.cache_enabled else None
        # miss buckets: row = (position, resolved inputs...)
        phased: list[tuple] = []        # analytic, prefill/decode split
        alpha: list[tuple] = []         # analytic, no split (power law)
        for i, q in enumerate(queries):
            self._require_query("step_latency_batch", q)
            work = q.effective_work()
            key = (q.impl.name, q.spec.name, q.n_devices, q.batch, work)
            if cache is not None:
                hit = cache.get(key)
                if hit is not None:
                    cache.move_to_end(key)
                    self.cache_hits += 1
                    out[i] = hit
                    continue
            curve = self._pinned_curve(q.impl, q.spec, q.n_devices)
            if curve is not None or _np is None:
                # pinned rows (and the no-numpy fallback) price through
                # the scalar path — it owns the memo bookkeeping
                out[i] = self._step(q.impl, q.spec, q.n_devices, work,
                                    q.batch)
                continue
            self.cache_misses += 1
            b = max(q.batch, 1)
            n = max(q.n_devices, 1)
            if work.has_phases:
                phased.append((i, key, q, work, b, n))
            else:
                alpha.append((i, key, q, work, b, n))
        if phased:
            # step = overhead + b * (max(compute, memory, coll) / b), with
            # every expression shaped exactly like batch_roofline_latency's
            bv = _np.array([r[4] for r in phased], dtype=float)
            nv = _np.array([r[5] for r in phased], dtype=float)
            flops = _np.array([r[3].flops for r in phased])
            shared = _np.array([r[3].shared_bytes for r in phased])
            per_it = _np.array([r[3].per_item_bytes for r in phased])
            coll = _np.array([r[3].coll_bytes for r in phased])
            peak = _np.array([r[2].spec.peak_flops for r in phased])
            hbm = _np.array([r[2].spec.hbm_bw for r in phased])
            link = _np.array([r[2].spec.link_bw for r in phased])
            eff = _np.array([r[2].impl.mxu_efficiency for r in phased])
            over = _np.array([r[2].impl.overhead_s for r in phased])
            t_c = bv * flops / (nv * peak * eff)
            t_m = (shared + bv * per_it) / (nv * hbm)
            t_x = _np.zeros_like(t_c)
            nz = link != 0.0
            if nz.any():
                t_x[nz] = bv[nz] * coll[nz] / (nv[nz] * link[nz])
            step = over + bv * (_np.maximum(_np.maximum(t_c, t_m), t_x)
                                / bv)
            for (i, key, _q, _w, _b, _n), s in zip(phased, step):
                out[i] = s = float(s)
                if cache is not None:
                    cache[key] = s
        if alpha:
            # base = overhead + max(three roofline terms); the power law
            # itself stays scalar (libm, via _alpha_step — one fallback
            # site, shared with the scalar path)
            nv = _np.array([r[5] for r in alpha], dtype=float)
            flops = _np.array([r[3].flops for r in alpha])
            hbytes = _np.array([r[3].hbm_bytes for r in alpha])
            coll = _np.array([r[3].coll_bytes for r in alpha])
            peak = _np.array([r[2].spec.peak_flops for r in alpha])
            hbm = _np.array([r[2].spec.hbm_bw for r in alpha])
            link = _np.array([r[2].spec.link_bw for r in alpha])
            eff = _np.array([r[2].impl.mxu_efficiency for r in alpha])
            over = _np.array([r[2].impl.overhead_s for r in alpha])
            t_c = flops / (nv * peak * eff)
            t_m = hbytes / (nv * hbm)
            t_x = _np.zeros_like(t_c)
            nz = link != 0.0
            if nz.any():
                t_x[nz] = coll[nz] / (nv[nz] * link[nz])
            base = over + _np.maximum(_np.maximum(t_c, t_m), t_x)
            for (i, key, q, _w, b, _n), bs in zip(alpha, base):
                out[i] = s = float(self._alpha_step(q.impl, q.spec,
                                                    float(bs), b,
                                                    pinned=False))
                if cache is not None:
                    cache[key] = s
        if cache is not None:
            while len(cache) > self.CACHE_MAX:
                cache.popitem(last=False)
        return out

    def schedule_latency_batch(self, queries: "Sequence[CostQuery]") \
            -> list[float]:
        """Batched-execution schedules for many queries in one kernel call.

        Expands each query into its full-batch step and (when ``items %
        batch != 0``) its remainder step, prices all steps through
        :meth:`step_latency_batch`, and recomposes ``full * step(b) +
        step(rem)`` — the exact float-op sequence of
        :meth:`schedule_latency`, so results (and the memo entries left
        behind) are bitwise-identical to the scalar path.
        """
        step_qs: list[CostQuery] = []
        plan: list[tuple] = []
        for q in queries:
            self._require_query("schedule_latency_batch", q)
            eff = q.effective_work()
            b = max(int(q.batch), 1)
            items = max(int(q.items), 0)
            if items == 0:
                plan.append((0, 0, None, None))
                continue
            full, rem = divmod(items, b)
            i_b = i_r = None
            if full:
                i_b = len(step_qs)
                step_qs.append(CostQuery(impl=q.impl, spec=q.spec,
                                         n_devices=q.n_devices, work=eff,
                                         batch=b))
            if rem:
                i_r = len(step_qs)
                step_qs.append(CostQuery(impl=q.impl, spec=q.spec,
                                         n_devices=q.n_devices, work=eff,
                                         batch=rem))
            plan.append((full, rem, i_b, i_r))
        steps = self.step_latency_batch(step_qs)
        out = []
        for full, rem, i_b, i_r in plan:
            total = full * steps[i_b] if full else 0.0
            if rem:
                total += steps[i_r]
            out.append(total)
        return out

    def completed_items(self, query: CostQuery) -> tuple[int, float]:
        """Invert the ``schedule_latency`` step schedule at ``elapsed_s``.

        Returns ``(items_done, wall_s)``: how many work-items' batch steps
        had *fully completed* after ``query.elapsed_s`` seconds of the
        schedule, and the wall time those completed steps took. A step
        checkpoints only at its end — a preempted in-flight step is
        discarded work — so full steps complete every ``step_latency(b)``
        seconds and the remainder step only at the schedule's very end. The
        simulator uses this to salvage a preempted task's finished items
        (DESIGN.md §6.4): re-running the residual then costs exactly
        ``schedule_latency(items) - wall_s``, which is what keeps the
        step-granular refund and estimate/actual parity exact. The
        inversion prices the same effective (cache-discounted) work the
        schedule charged, so refunds invert exactly what was billed.
        """
        self._require_query("completed_items", query)
        eff = query.effective_work()
        b = max(int(query.batch), 1)
        items = max(int(query.items), 0)
        elapsed_s = query.elapsed_s
        if items == 0 or elapsed_s <= 0:
            return 0, 0.0
        step_b = self._step(query.impl, query.spec, query.n_devices, eff, b)
        full, rem = divmod(items, b)
        # 1e-9 of slack so a preemption landing exactly on a step boundary
        # credits the step that just finished
        steps = min(int((elapsed_s + 1e-9) / max(step_b, 1e-12)), full)
        done, wall = steps * b, steps * step_b
        if steps == full and rem:
            rem_lat = self._step(query.impl, query.spec, query.n_devices,
                                 eff, rem)
            if elapsed_s + 1e-9 >= wall + rem_lat:
                done, wall = items, wall + rem_lat
        return done, wall

    def cache_info(self) -> dict:
        """Estimate-memo counters: hits, misses, size, cap and hit rate."""
        total = self.cache_hits + self.cache_misses
        return {"hits": self.cache_hits, "misses": self.cache_misses,
                "size": len(self._cache), "max": self.CACHE_MAX,
                "hit_rate": self.cache_hits / total if total else 0.0}

    def cache_reset(self, enabled: bool = True):
        """Drop memoized estimates and zero the counters (benchmarks)."""
        self._cache.clear()
        self.cache_enabled = enabled
        self.cache_hits = self.cache_misses = 0

    def pinned_counts(self, impl_name: str, device: str) -> list[int]:
        """Profiled device counts for (impl, device). When non-empty, the
        scheduler selects among exactly these configurations — the paper's
        semantics: selection happens over the profile library."""
        return sorted(n for (i, d, n) in self._pinned
                      if i == impl_name and d == device)

    def pinned_batches(self, impl_name: str, device: str) -> list[int]:
        """Calibrated batch sizes for (impl, device), across all pinned
        counts. Non-empty for measured rows; the joint lever search uses
        these points as the batch candidate grid (selection over the
        profile library, mirroring ``pinned_counts``)."""
        out: set[int] = set()
        for (i, d, _n), (curve, _pf) in self._pinned.items():
            if i == impl_name and d == device:
                out.update(b for b, _ in curve)
        return sorted(out)

    def power_frac(self, impl: AgentImpl, spec: DeviceSpec,
                   n_devices: int) -> float:
        """Fraction of (active - idle) power drawn while running; pinned
        rows override the implementation's declared fraction."""
        key = (impl.name, spec.name, n_devices)
        if key in self._pinned:
            return self._pinned[key][1]
        return impl.power_frac

    def profile(self, impl_name: str, device: str, n_devices: int,
                tokens_in: int = 1024, tokens_out: int = 256) -> Profile:
        """One profile row: per-item latency/energy/$ and quality for an
        (impl, device, count) triple at the given token footprint."""
        impl = self.library.impls[impl_name]
        spec = CATALOG[device]
        work = impl.work_fn(tokens_in, tokens_out)
        lat = self._step(impl, spec, n_devices, work, 1)
        pf = self.power_frac(impl, spec, n_devices)
        energy = lat * n_devices * pf * (spec.active_w - spec.idle_w)
        usd = lat * n_devices / 3600.0 * spec.usd_per_hour
        return Profile(impl=impl_name, device=device, n_devices=n_devices,
                       latency_s=lat, energy_j=energy, usd=usd,
                       quality=self.quality(impl_name),
                       pinned=(impl_name, device, n_devices) in self._pinned)

    # -- the "profile everything on add" sweep --------------------------------
    def profile_table(self, devices: dict[str, list[int]],
                      tokens_in: int = 1024, tokens_out: int = 256) \
            -> list[Profile]:
        """Profiles for every (impl x compatible device x count) pair.

        ``devices``: device-SKU name -> candidate device counts.
        """
        rows: list[Profile] = []
        for impl in self.library.impls.values():
            for dev, counts in devices.items():
                spec = CATALOG[dev]
                if spec.kind not in impl.hw_kinds:
                    continue
                lo = impl.min_devices.get(spec.kind, 1)
                hi = impl.max_devices.get(spec.kind, max(counts))
                for n in counts:
                    if lo <= n <= hi:
                        rows.append(self.profile(impl.name, dev, n,
                                                 tokens_in, tokens_out))
        return rows
