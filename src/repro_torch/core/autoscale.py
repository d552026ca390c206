"""Pool autoscaling policy for the open-loop serving engine (DESIGN.md §8).

The paper's cluster-manager collaboration includes elastic pool sizing:
capacity should follow offered load, because every provisioned-but-idle
device pays the idle-power floor (``EnergyLedger.charge_idle``) for the
whole run. The :class:`Autoscaler` is a *policy* object — the simulator
consults it on periodic ``scale`` events and applies its decisions through
``ClusterManager.set_capacity``, which clamps at live allocations (pinned
demand) and logs the change on the capacity timeline the idle-energy
integral reads.

Policy math (per pool, at each tick):

    desired = ceil(demand / target_util)        # demand = held + queued
    desired = clamp(desired, min_devices, max_devices)
    desired = max(desired, used)                # never below pinned demand

- **Scale-up** is issued with ``scale_up_lag_s`` of provisioning delay
  (the engine applies it as a lagged event), and at most one scale-up is
  in flight per pool.
- **Scale-down** applies immediately but only after ``cooldown_s`` since
  the pool's last capacity change (hysteresis: a burst that just ended
  doesn't thrash capacity down before the next one).
- **Scale-to-zero** (``min_devices == 0``) is only legal for harvestable
  pools — reserved/priority pools must keep warm capacity; ``validate``
  rejects anything else.

Under fault injection (DESIGN.md §10) the same target-utilization law
doubles as crash backfill: an instance crash shrinks the pool via
``set_capacity``, demand per device rises, and the next tick scales the
pool back toward its policy envelope without any fault-specific wiring —
whichever of the autoscaler or the seeded repair event fires first
restores capacity (both are clamped to the pool limit).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .cluster import ClusterManager


@dataclass(frozen=True)
class PoolPolicy:
    """Autoscaling envelope + dynamics for one pool."""

    min_devices: int
    max_devices: int
    target_util: float = 0.75     # size so demand / capacity ≈ this
    scale_up_lag_s: float = 30.0  # provisioning delay for added capacity
    cooldown_s: float = 60.0      # min gap between a change and a shrink

    def __post_init__(self):
        if not 0 <= self.min_devices <= self.max_devices:
            raise ValueError(f"need 0 <= min <= max, got "
                             f"[{self.min_devices}, {self.max_devices}]")
        if not 0 < self.target_util <= 1.0:
            raise ValueError(f"target_util in (0, 1], got "
                             f"{self.target_util}")
        if self.scale_up_lag_s < 0 or self.cooldown_s < 0:
            raise ValueError("lag/cooldown must be >= 0")


@dataclass(frozen=True)
class ScaleAction:
    """One decided resize; ``lag_s > 0`` means apply after that delay."""

    pool: str
    capacity: int
    lag_s: float = 0.0


class Autoscaler:
    """Target-utilization pool sizing with lag + cooldown hysteresis."""

    def __init__(self, policies: dict[str, PoolPolicy],
                 interval_s: float = 15.0):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.policies = dict(policies)
        self.interval_s = interval_s
        self._last_change: dict[str, float] = {}
        self._pending_up: dict[str, float] = {}   # pool -> apply time

    def limits(self) -> dict[str, int]:
        """Per-pool max capacity (the engine's degrade-vs-wait boundary)."""
        return {pool: pol.max_devices for pool, pol in self.policies.items()}

    def validate(self, cluster: ClusterManager):
        """Reject policies that reference unknown pools or scale a
        non-harvestable pool to zero (reserved capacity must stay warm)."""
        for pool, pol in self.policies.items():
            p = cluster.pools.get(pool)
            if p is None:
                raise ValueError(f"autoscale policy for unknown pool "
                                 f"{pool!r}")
            if pol.min_devices == 0 and not p.harvestable:
                raise ValueError(
                    f"scale-to-zero on non-harvestable pool {pool!r}: "
                    f"only harvest capacity may drop its warm floor")

    def decide(self, cluster: ClusterManager, demand: dict[str, int],
               t: float) -> list[ScaleAction]:
        """Resize decisions for this tick; the caller applies/schedules."""
        actions: list[ScaleAction] = []
        for pool, pol in self.policies.items():
            cap = cluster.pools[pool].capacity
            used = cluster._used[pool]
            want = demand.get(pool, used)
            desired = math.ceil(want / pol.target_util) if want > 0 else 0
            desired = min(max(desired, pol.min_devices), pol.max_devices)
            desired = max(desired, used)      # never below pinned demand
            if pool in self._pending_up:
                if t < self._pending_up[pool]:
                    continue                  # a scale-up is in flight
                self._pending_up.pop(pool)
            if desired > cap:
                actions.append(ScaleAction(pool, desired,
                                           lag_s=pol.scale_up_lag_s))
                self._pending_up[pool] = t + pol.scale_up_lag_s
            elif desired < cap:
                last = self._last_change.get(pool, -math.inf)
                if t - last >= pol.cooldown_s:
                    actions.append(ScaleAction(pool, desired))
        return actions

    def apply(self, cluster: ClusterManager, action: ScaleAction,
              t: float) -> int:
        """Apply a decided resize; returns the capacity actually set
        (``set_capacity`` clamps at live allocations)."""
        applied = cluster.set_capacity(action.pool, action.capacity, t)
        self._last_change[action.pool] = t
        self._pending_up.pop(action.pool, None)
        return applied
