"""Seeded fault injection + recovery policy for the serving engine.

DESIGN.md §10.  A :class:`FaultProfile` describes *what goes wrong* — per-pool
exponential MTBF instance crashes, per-task transient failure probability,
straggler slowdowns — and a :class:`RetryPolicy` describes *how the engine
recovers* — per-tenant-class attempt budgets, exponential backoff with seeded
jitter, and dead-letter accounting once a workflow exhausts its budget.

Everything is a pure function of ``(profile.seed, identity)`` so fault runs
replay byte-identically:

* per-task draws come from a dedicated ``random.Random`` keyed by
  ``(seed, workflow, task, attempt)`` — independent of dispatch order;
* per-pool crash processes come from ``pool_stream(pool)``, a fresh generator
  per run whose event times depend only on the seed.

``random.Random(str)`` hashes the seed string with SHA-512, so streams are
stable across processes and Python versions (no ``PYTHONHASHSEED`` exposure).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from types import MappingProxyType
from typing import Mapping

from ..runtime.fault_tolerance import DEFAULT_STRAGGLER_THRESHOLD

#: Default per-tenant-class attempt budgets: priority work is retried hardest,
#: harvest work is cheapest to abandon.
DEFAULT_MAX_ATTEMPTS: Mapping[str, int] = MappingProxyType(
    {"priority": 4, "standard": 3, "harvest": 2})


@dataclass(frozen=True)
class RetryPolicy:
    """How failed tasks are retried, backed off, and eventually abandoned."""

    #: tenant class -> max execution attempts (first run counts as one).
    max_attempts: Mapping[str, int] = \
        field(default_factory=lambda: DEFAULT_MAX_ATTEMPTS)
    #: attempts a tenant class not listed in ``max_attempts`` gets.
    default_attempts: int = 3
    backoff_base_s: float = 2.0     # delay after the first failure
    backoff_mult: float = 2.0       # exponential growth per failure
    backoff_cap_s: float = 60.0     # ceiling on any single delay
    jitter_frac: float = 0.25       # +-fraction of seeded jitter on the delay
    #: failures of one task before the workflow is replanned against the
    #: (degraded) live cluster; 0 disables degradation replanning.
    replan_after: int = 2

    def attempts_for(self, tenant: str) -> int:
        """Max execution attempts for ``tenant`` (always at least one)."""
        return max(int(self.max_attempts.get(tenant, self.default_attempts)),
                   1)

    def backoff_s(self, fails: int, u: float) -> float:
        """Delay before retry number ``fails`` (>=1); ``u`` in [0,1) jitters."""
        base = min(self.backoff_base_s * self.backoff_mult ** (fails - 1),
                   self.backoff_cap_s)
        return base * (1.0 + self.jitter_frac * (2.0 * u - 1.0))


@dataclass(frozen=True)
class FaultProfile:
    """Seeded description of cluster failures injected into a run.

    With an instantiated-but-empty profile (no MTBF entries, zero
    probabilities) the engine's event heap, float-op order, traces, and
    ledgers are byte-identical to ``faults=None``.
    """

    seed: int = 0
    #: pool name -> mean time between instance crashes (s); absent pools
    #: never crash.
    instance_mtbf_s: Mapping[str, float] = field(default_factory=dict)
    #: mean time to restore a crashed device group's capacity (s).
    repair_s: float = 300.0
    #: probability any one task attempt fails mid-compute.
    task_fail_p: float = 0.0
    #: probability any one task attempt runs slow by ``straggler_mult``.
    straggler_p: float = 0.0
    straggler_mult: float = 4.0
    #: launch a duplicate attempt for detected stragglers (first wins).
    hedge: bool = True
    #: a task is a straggler when its slowdown vs the CostQuery estimate
    #: reaches this factor — same definition as runtime.StragglerMonitor.
    hedge_threshold: float = DEFAULT_STRAGGLER_THRESHOLD
    retry: RetryPolicy = field(default_factory=RetryPolicy)

    def __post_init__(self):
        for pool, mtbf in self.instance_mtbf_s.items():
            if mtbf <= 0:
                raise ValueError(f"MTBF for pool {pool!r} must be > 0")
        if self.instance_mtbf_s and self.repair_s <= 0:
            raise ValueError("repair_s must be > 0 when crashes are enabled "
                             "(permanent capacity loss can wedge a run)")
        if not 0.0 <= self.task_fail_p <= 1.0:
            raise ValueError("task_fail_p must be in [0, 1]")
        if not 0.0 <= self.straggler_p <= 1.0:
            raise ValueError("straggler_p must be in [0, 1]")
        if self.straggler_p and self.straggler_mult <= 1.0:
            raise ValueError("straggler_mult must be > 1")
        if self.hedge_threshold <= 1.0:
            raise ValueError("hedge_threshold must be > 1")

    # -- seeded streams ------------------------------------------------------

    def task_draws(self, wid: str, tid: str,
                   attempt: int) -> tuple[float, float, float]:
        """(u_fail, u_frac, u_straggle) for one task attempt.

        All three are always drawn so a profile change (say, enabling
        stragglers) never perturbs the failure stream.
        """
        rng = random.Random(f"{self.seed}:task:{wid}:{tid}:{attempt}")
        return rng.random(), rng.random(), rng.random()

    def retry_jitter(self, wid: str, tid: str, fails: int) -> float:
        """Seeded u in [0, 1) jittering the backoff after failure ``fails``."""
        return random.Random(
            f"{self.seed}:retry:{wid}:{tid}:{fails}").random()

    def pool_stream(self, pool: str) -> random.Random:
        """Fresh per-run crash-process generator for ``pool``."""
        return random.Random(f"{self.seed}:pool:{pool}")

    def validate_pools(self, pools) -> None:
        """Raise if ``instance_mtbf_s`` names a pool the cluster lacks."""
        unknown = sorted(set(self.instance_mtbf_s) - set(pools))
        if unknown:
            raise ValueError(f"FaultProfile names unknown pools: {unknown}")
