"""Constraint DSL: composable scheduling objectives (DESIGN.md §3).

The seed exposed one ``Constraint`` enum compared lexicographically. This
module generalizes it into composable objects the scheduler consumes:

- ``MinCost() / MinEnergy() / MinLatency() / MaxQuality()`` — atomic
  objectives over a candidate ``TaskConfig`` (lower value = better).
- ``Deadline(s=30)`` / ``Budget(usd=..., wh=...)`` — feasibility terms whose
  value is the *overrun* (0 when satisfied), so placing one ahead of an
  objective means "among configurations meeting it, optimize the rest".
  ``Scheduler.plan`` divides workflow-level deadlines/budgets across the
  DAG's tasks before per-task search: deadlines by critical-path-weighted
  latency share, budgets by cost share (DESIGN.md §6.1); ``per_task`` keeps
  the legacy even split.
- ``Weighted(terms)`` — a weighted blend of objectives into one scalar
  (weights carry the unit conversion, e.g. $/J).
- ``Lexicographic(a, b, ...)`` — explicit ordering; a bare sequence means
  the same thing.

Everything the seed accepted still works: ``MIN_COST``, the ``Constraint``
enum, and tuples of enum members normalize through ``as_spec``. All but the
last objective in an ordering compare in 5%-wide log bands so a secondary
objective breaks near-ties of the primary one (paper §3.3c).
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass


class Constraint(enum.Enum):
    """Seed-compatible shorthand for the atomic objectives."""

    MIN_COST = "min_cost"
    MIN_ENERGY = "min_energy"
    MIN_LATENCY = "min_latency"
    MAX_QUALITY = "max_quality"


MIN_COST = Constraint.MIN_COST
MIN_ENERGY = Constraint.MIN_ENERGY
MIN_LATENCY = Constraint.MIN_LATENCY
MAX_QUALITY = Constraint.MAX_QUALITY


class Objective:
    """One scalar scheduling objective; lower ``value`` is better."""

    def value(self, cfg) -> float:
        """Objective value of a candidate ``TaskConfig`` (lower = better)."""
        raise NotImplementedError

    def per_task(self, n_tasks: int) -> "Objective":
        """Workflow-level terms override this to split across tasks."""
        return self

    def scaled(self, lat_frac: float, cost_frac: float) -> "Objective":
        """Workflow-level terms override this to take a weighted share:
        ``lat_frac`` of a deadline, ``cost_frac`` of a budget."""
        return self

    @property
    def is_workflow_term(self) -> bool:
        """True for terms stated at workflow scope (deadlines, budgets) that
        must be divided across tasks before per-task search."""
        return False


@dataclass(frozen=True)
class MinCost(Objective):
    """Minimize estimated dollar spend."""

    def value(self, cfg) -> float:
        """The config's estimated $ cost."""
        return cfg.est_usd


@dataclass(frozen=True)
class MinEnergy(Objective):
    """Minimize estimated above-idle energy."""

    def value(self, cfg) -> float:
        """The config's estimated energy in joules."""
        return cfg.est_energy_j


@dataclass(frozen=True)
class MinLatency(Objective):
    """Minimize estimated task latency."""

    def value(self, cfg) -> float:
        """The config's estimated latency in seconds."""
        return cfg.est_latency_s


@dataclass(frozen=True)
class MaxQuality(Objective):
    """Maximize result quality (negated: lower value = better)."""

    def value(self, cfg) -> float:
        """Negated quality, so minimization maximizes quality."""
        return -cfg.quality


@dataclass(frozen=True)
class Deadline(Objective):
    """End-to-end latency target in seconds; value = overrun."""

    s: float

    def __post_init__(self):
        if self.s <= 0:
            raise ValueError(f"Deadline needs a positive target, got {self.s}")

    def value(self, cfg) -> float:
        """Seconds of overrun beyond the target (0 when met)."""
        return max(0.0, cfg.est_latency_s - self.s)

    def per_task(self, n_tasks: int) -> "Deadline":
        """Legacy even split of the deadline across tasks."""
        return Deadline(s=self.s / max(n_tasks, 1))

    def scaled(self, lat_frac: float, cost_frac: float) -> "Deadline":
        """One task's critical-path-weighted share of the deadline."""
        return Deadline(s=self.s * lat_frac)

    @property
    def is_workflow_term(self) -> bool:
        """Deadlines are stated at workflow scope."""
        return True


@dataclass(frozen=True)
class Budget(Objective):
    """Spend caps; value = summed normalized overrun fraction (0 if met)."""

    usd: float | None = None
    wh: float | None = None

    def __post_init__(self):
        if self.usd is None and self.wh is None:
            raise ValueError("Budget needs at least one of usd= / wh=")
        for name, cap in (("usd", self.usd), ("wh", self.wh)):
            if cap is not None and cap <= 0:
                raise ValueError(
                    f"Budget needs a positive {name} cap, got {cap}")

    def value(self, cfg) -> float:
        """Summed normalized overrun fraction across the caps (0 if met)."""
        over = 0.0
        if self.usd is not None:
            over += max(0.0, cfg.est_usd - self.usd) / self.usd
        if self.wh is not None:
            cap_j = self.wh * 3600.0
            over += max(0.0, cfg.est_energy_j - cap_j) / cap_j
        return over

    def per_task(self, n_tasks: int) -> "Budget":
        """Legacy even split of the caps across tasks."""
        n = max(n_tasks, 1)
        return Budget(usd=None if self.usd is None else self.usd / n,
                      wh=None if self.wh is None else self.wh / n)

    def scaled(self, lat_frac: float, cost_frac: float) -> "Budget":
        """One task's cost-weighted share of the caps."""
        return Budget(usd=None if self.usd is None else self.usd * cost_frac,
                      wh=None if self.wh is None else self.wh * cost_frac)

    @property
    def is_workflow_term(self) -> bool:
        """Budgets are stated at workflow scope."""
        return True


@dataclass(frozen=True)
class Weighted(Objective):
    """Blend: value = sum of weight * objective value."""

    terms: tuple[tuple[Objective, float], ...]

    def value(self, cfg) -> float:
        """The weighted sum over the blended objectives."""
        return sum(w * o.value(cfg) for o, w in self.terms)

    def per_task(self, n_tasks: int) -> "Weighted":
        """Split any workflow-scoped terms evenly across tasks."""
        return Weighted(tuple((o.per_task(n_tasks), w)
                              for o, w in self.terms))

    def scaled(self, lat_frac: float, cost_frac: float) -> "Weighted":
        """Scale any workflow-scoped terms by their per-task shares."""
        return Weighted(tuple((o.scaled(lat_frac, cost_frac), w)
                              for o, w in self.terms))

    @property
    def is_workflow_term(self) -> bool:
        """True when any blended term is workflow-scoped."""
        return any(o.is_workflow_term for o, _ in self.terms)

    @classmethod
    def of(cls, cost: float = 0.0, energy: float = 0.0, latency: float = 0.0,
           quality: float = 0.0) -> "Weighted":
        """Shorthand: blend the four atomic objectives by weight."""
        terms = [(MinCost(), cost), (MinEnergy(), energy),
                 (MinLatency(), latency), (MaxQuality(), quality)]
        return cls(tuple((o, w) for o, w in terms if w))


_ENUM_MAP = {
    Constraint.MIN_COST: MinCost(),
    Constraint.MIN_ENERGY: MinEnergy(),
    Constraint.MIN_LATENCY: MinLatency(),
    Constraint.MAX_QUALITY: MaxQuality(),
}

# atomic objective -> enum member, for seed-compatible accessors
_OBJECTIVE_ENUM = {v: k for k, v in _ENUM_MAP.items()}


def as_enum(obj: "Objective"):
    """The ``Constraint`` member for an atomic objective, else the objective
    itself (composite DSL terms have no enum spelling)."""
    return _OBJECTIVE_ENUM.get(obj, obj)


def _as_objective(x) -> Objective:
    if isinstance(x, Objective):
        return x
    if isinstance(x, Constraint):
        return _ENUM_MAP[x]
    raise TypeError(f"not a scheduling objective: {x!r}")


@dataclass(frozen=True)
class ConstraintSpec:
    """A fully-normalized lexicographic ordering of objectives."""

    objectives: tuple[Objective, ...]

    def __post_init__(self):
        if not self.objectives:
            raise ValueError("a ConstraintSpec needs >= 1 objective")

    @staticmethod
    def _band(v: float) -> tuple[int, float]:
        """5% multiplicative log band, monotone over all of R.

        Sign-classed so that any negative value (quality-style objectives)
        orders below zero, and zero (e.g. a met deadline/budget: overrun 0)
        orders below every positive overrun — a naive ``log(v)`` band would
        rank a sub-unit overrun (negative log) *better* than feasibility.
        """
        if v > 0:
            return (1, round(math.log(max(v, 1e-12), 1.05)))
        if v < 0:
            return (-1, -round(math.log(max(-v, 1e-12), 1.05)))
        return (0, 0.0)

    def key(self, cfg) -> tuple:
        """Comparison key: all but the last objective banded (5% log bands),
        then universal tie-breaks on latency and $."""
        key: list = []
        for i, obj in enumerate(self.objectives):
            v = obj.value(cfg)
            key.append(self._band(v) if i < len(self.objectives) - 1 else v)
        key += [cfg.est_latency_s, cfg.est_usd]
        return tuple(key)

    @property
    def seeks_quality(self) -> bool:
        """True when the primary objective maximizes quality (the scheduler
        unlocks quality-only levers: top-2 impls, execution paths)."""
        return isinstance(self.objectives[0], MaxQuality)

    def per_task(self, n_tasks: int) -> "ConstraintSpec":
        """Split workflow-level deadline/budget terms evenly across tasks."""
        return ConstraintSpec(tuple(o.per_task(n_tasks)
                                    for o in self.objectives))

    def for_share(self, lat_frac: float, cost_frac: float) \
            -> "ConstraintSpec":
        """One task's weighted share of the workflow-level terms: deadlines
        scale by ``lat_frac``, budgets by ``cost_frac`` (Scheduler computes
        the fractions from a pilot plan and the DAG's critical path)."""
        return ConstraintSpec(tuple(o.scaled(lat_frac, cost_frac)
                                    for o in self.objectives))

    @property
    def has_workflow_terms(self) -> bool:
        """True when any objective is a workflow-scoped deadline/budget."""
        return any(o.is_workflow_term for o in self.objectives)


def Lexicographic(*objectives) -> ConstraintSpec:
    """Explicit ordering of objectives; earlier terms dominate."""
    return ConstraintSpec(tuple(_as_objective(o) for o in objectives))


def as_spec(constraints) -> ConstraintSpec:
    """Normalize every accepted constraint form into a ``ConstraintSpec``.

    Accepts: a ``ConstraintSpec``; a ``Constraint`` enum member; an
    ``Objective``; or a sequence mixing the latter two.
    """
    if isinstance(constraints, ConstraintSpec):
        return constraints
    if isinstance(constraints, (Constraint, Objective)):
        return ConstraintSpec((_as_objective(constraints),))
    try:
        objs = tuple(_as_objective(c) for c in constraints)
    except TypeError:
        raise TypeError(
            f"cannot interpret constraints {constraints!r}; expected a "
            f"Constraint, an Objective, a sequence of them, or a "
            f"ConstraintSpec") from None
    return ConstraintSpec(objs)
