"""Hardware SKU catalog + energy / $-cost accounting.

The paper's levers (Table 1) are grounded in hardware numbers. Two catalogs:

- ``PAPER_HW``  — the A100/EPYC cluster of the paper's evaluation (§4), used
  by the Fig-3 / Table-2 reproduction benchmarks. Power model follows the
  paper's simplification: *only GPU energy is measured* (CPU rated 16x lower).
- ``TPU_HW``    — the deployment target: TPU v5e/v5p/v4 pools + CPU hosts.
  The per-chip constants are the same ones EXPERIMENTS.md §Roofline uses
  (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI for v5e), so the
  scheduler's cost model and the roofline analysis share one source of truth.

Energy model (per device): ``P(t) = idle_w + util(t) * (active_w - idle_w)``.
Idle power is integrated over the full makespan for every device in a
*metered* pool (matching how the paper's 155 Wh baseline includes idle GPUs);
active increments accrue only while a task runs on the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class DeviceSpec:
    """One hardware SKU."""

    name: str
    kind: str                 # "gpu" | "cpu" | "tpu"
    peak_flops: float         # FLOP/s (bf16 for accelerators, fp32 for CPU)
    hbm_bw: float             # bytes/s
    hbm_bytes: float          # capacity
    link_bw: float            # bytes/s per interconnect link (ICI / NVLink)
    idle_w: float
    active_w: float
    usd_per_hour: float
    metered: bool = True      # counted in the energy report?
    generation: int = 0       # newer = larger (the GPU-generation lever)


# --- the paper's cluster (2x Standard_ND96amsr_A100_v4) ---------------------
A100 = DeviceSpec("a100-80g", "gpu", peak_flops=312e12, hbm_bw=2.039e12,
                  hbm_bytes=80e9, link_bw=300e9, idle_w=88.0, active_w=400.0,
                  usd_per_hour=3.40, generation=8)
H100 = DeviceSpec("h100-80g", "gpu", peak_flops=989e12, hbm_bw=3.35e12,
                  hbm_bytes=80e9, link_bw=450e9, idle_w=110.0, active_w=700.0,
                  usd_per_hour=6.98, generation=9)
EPYC_CORE = DeviceSpec("epyc-7v12-core", "cpu", peak_flops=70e9,
                       hbm_bw=3.4e9, hbm_bytes=4e9, link_bw=0.0,
                       # paper: GPU rated ~16x higher than the (whole) CPU;
                       # per-core share of a 240 W socket over 48 cores.
                       # $-rate: marginal cost of idle cores on the already-
                       # provisioned ND96amsr VM (paper Table 1: CPU = lower $)
                       idle_w=1.5, active_w=3.5, usd_per_hour=0.008,
                       metered=False, generation=7)

# --- TPU deployment target ---------------------------------------------------
TPU_V5E = DeviceSpec("tpu-v5e", "tpu", peak_flops=197e12, hbm_bw=819e9,
                     hbm_bytes=16e9, link_bw=50e9, idle_w=65.0,
                     active_w=220.0, usd_per_hour=1.20, generation=9)
TPU_V5P = DeviceSpec("tpu-v5p", "tpu", peak_flops=459e12, hbm_bw=2.765e12,
                     hbm_bytes=95e9, link_bw=100e9, idle_w=120.0,
                     active_w=450.0, usd_per_hour=4.20, generation=10)
TPU_V4 = DeviceSpec("tpu-v4", "tpu", peak_flops=275e12, hbm_bw=1.228e12,
                    hbm_bytes=32e9, link_bw=50e9, idle_w=90.0,
                    active_w=300.0, usd_per_hour=2.10, generation=8)
HOST_CORE = DeviceSpec("host-core", "cpu", peak_flops=80e9, hbm_bw=4e9,
                       hbm_bytes=4e9, link_bw=0.0, idle_w=1.5, active_w=3.5,
                       usd_per_hour=0.008, metered=False, generation=8)

CATALOG: dict[str, DeviceSpec] = {
    d.name: d for d in (A100, H100, EPYC_CORE, TPU_V5E, TPU_V5P, TPU_V4,
                        HOST_CORE)
}


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------


@dataclass
class EnergyLedger:
    """Integrates energy/cost over a run; fed by the simulator/executor.

    ``charge_active`` accrues the *increment above idle* for device-seconds
    of real work; ``finalize(makespan, pool_sizes)`` adds the idle floor for
    every metered device over the whole run (paper Table-2 semantics).
    """

    active_joules: float = 0.0
    idle_joules: float = 0.0
    usd: float = 0.0
    per_pool_active: dict[str, float] = field(default_factory=dict)

    def charge_active(self, spec: DeviceSpec, device_seconds: float,
                      utilization: float = 1.0, pool: str = ""):
        """Accrue the above-idle energy (and $) for real device-seconds."""
        if spec.metered:
            j = device_seconds * utilization * (spec.active_w - spec.idle_w)
            self.active_joules += j
            if pool:
                self.per_pool_active[pool] = \
                    self.per_pool_active.get(pool, 0.0) + j
        self.usd += device_seconds / 3600.0 * spec.usd_per_hour

    def charge_idle(self, spec: DeviceSpec, n_devices: int, seconds: float):
        """Integrate the idle-power floor for ``n_devices`` over a period."""
        if spec.metered:
            self.idle_joules += n_devices * seconds * spec.idle_w

    @property
    def joules(self) -> float:
        """Total energy: active increments plus the idle floor."""
        return self.active_joules + self.idle_joules

    @property
    def wh(self) -> float:
        """Total energy in watt-hours (the paper's Table-2 unit)."""
        return self.joules / 3600.0


def roofline_latency(flops: float, bytes_moved: float, spec: DeviceSpec,
                     n_devices: int = 1, collective_bytes: float = 0.0,
                     efficiency: float = 0.6) -> float:
    """Three-term roofline time (the scheduler's latency model).

    Identical structure to EXPERIMENTS.md §Roofline:
        compute   = flops / (n * peak * eff)
        memory    = bytes / (n * hbm_bw)
        collective= coll_bytes / (n * link_bw)
    Latency = max of the three (bound by the dominant term).
    """
    n = max(n_devices, 1)
    t_c = flops / (n * spec.peak_flops * efficiency)
    t_m = bytes_moved / (n * spec.hbm_bw)
    t_x = (collective_bytes / (n * spec.link_bw)) if spec.link_bw else 0.0
    return max(t_c, t_m, t_x)


def batch_roofline_latency(work, spec: DeviceSpec, n_devices: int = 1,
                           batch: int = 1, efficiency: float = 0.6) -> float:
    """Per-item latency of one step over a batch of ``batch`` items.

    The batch-aware extension of :func:`roofline_latency` (DESIGN.md §7):
    the ``work``'s prefill/decode phase split decides which HBM traffic
    amortizes across the batch. Weights stream once per decode step (and
    once for prefill) *regardless* of batch size — ``work.shared_bytes`` —
    while per-item activation/KV traffic scales with ``batch``:

        compute(b) = b * flops / (n * peak * eff)
        memory(b)  = (shared_bytes + b * per_item_bytes) / (n * hbm_bw)
        coll(b)    = b * coll_bytes / (n * link_bw)
        per_item   = max(compute, memory, coll) / b

    Small ``b``: weights-streaming-bound, per-item latency falls ~1/b.
    Past the knee (:func:`batch_knee`): compute-bound, per-item flattens.
    At ``batch=1`` this is exactly the seed roofline (memory(1) =
    hbm_bytes / (n * hbm_bw)), so unbatched estimates are unchanged.
    """
    n = max(n_devices, 1)
    b = max(batch, 1)
    t_c = b * work.flops / (n * spec.peak_flops * efficiency)
    t_m = (work.shared_bytes + b * work.per_item_bytes) / (n * spec.hbm_bw)
    t_x = (b * work.coll_bytes / (n * spec.link_bw)) if spec.link_bw else 0.0
    return max(t_c, t_m, t_x) / b


def batch_knee(work, spec: DeviceSpec, n_devices: int = 1,
               efficiency: float = 0.6) -> float:
    """Batch size where the weights stream stops dominating compute.

    Solves ``compute(b) = memory(b)`` of :func:`batch_roofline_latency` for
    ``b``: below the knee a batched step is bound by the shared weights
    stream (batching is nearly free), above it by compute (batching only
    adds latency). ``inf`` when the work never becomes compute-bound
    (per-item memory traffic alone outweighs compute — batching always
    pays); 1.0 when it is compute-bound already at ``b=1``.
    """
    n = max(n_devices, 1)
    c = work.flops / (n * spec.peak_flops * efficiency)     # compute / item
    p = work.per_item_bytes / (n * spec.hbm_bw)             # memory / item
    s = work.shared_bytes / (n * spec.hbm_bw)               # shared stream
    if c <= p:
        return math.inf
    return max(s / (c - p), 1.0)


def _largest_divisor_in(items: int, lo: int, hi: int) -> int | None:
    """Largest divisor of ``items`` inside ``[lo, hi]``, or None."""
    best = None
    i = 1
    while i * i <= items:
        if items % i == 0:
            for d in (i, items // i):
                if lo <= d <= hi and (best is None or d > best):
                    best = d
        i += 1
    return best


def knee_batch_grid(work, spec: DeviceSpec, items: int, max_batch: int,
                    efficiency: float = 0.6) -> list[int]:
    """Candidate batch sizes for the joint (count x batch) lever search.

    The full batch range is too wide to scan per (impl, pool, count), but
    the roofline's shape pins where the optimum can sit (DESIGN.md §7.2):

    - ``1`` — the unbatched baseline;
    - ``min(max_batch, items)`` — the largest feasible batch, optimal
      whenever per-item latency keeps falling (below the knee) or the
      remainder lands at/past the knee;
    - ``floor/ceil`` of :func:`batch_knee` — the smallest batches that
      already run compute-bound (same per-item latency as larger ones,
      smaller co-residency);
    - the largest divisor of ``items`` in ``[knee, max]`` — a zero-remainder
      schedule whose every step is past the knee. When ``max_batch`` does
      not divide ``items`` and the remainder ``items % max_batch`` falls
      below the knee, that remainder step runs weights-streaming-bound and
      this divisor strictly beats the max batch.

    The knee is independent of the device count (compute, per-item and
    shared-stream terms all scale 1/n), so one grid serves every count in
    the joint search. Works without a phase split have no knee — the
    deprecated ``batch ** alpha`` power law is monotone, so its optimum is
    an endpoint and the grid is just ``{1, min(max_batch, items)}``.
    """
    items = max(int(items), 1)
    bmax = max(min(max_batch, items), 1)
    if bmax == 1:
        return [1]
    cands = {1, bmax}
    if work.has_phases:
        knee = batch_knee(work, spec, 1, efficiency)
        if math.isfinite(knee):
            lo = min(max(int(math.floor(knee)), 1), bmax)
            hi = min(max(int(math.ceil(knee)), 1), bmax)
            cands.update((lo, hi))
            d = _largest_divisor_in(items, hi, bmax)
            if d is not None:
                cands.add(d)
    return sorted(cands)
