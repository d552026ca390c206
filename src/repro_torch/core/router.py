"""Learned routing: featurized, seeded bandit over implementation arms.

DESIGN.md §11. The :class:`Router` replaces the static keyword-vs-vector
retrieval lever (``configs/workflow_rag.py``) with a *learned* one: the
scheduler's level-1 implementation choice consults the router for covered
interfaces, and the router picks an arm from the quality-floor-passing
candidates by seeded epsilon-greedy over per-(interface, feature-bucket)
reward weights. Routing is a pure function of ``(seed, weights, task)`` —
no state mutates during planning or simulation — so identical (seed,
telemetry log) pairs yield byte-identical routing decisions and traces
stay replayable.

Learning happens *between* runs: the :class:`OfflineEvaluator` replays a
:class:`~repro_torch.core.telemetry.TelemetryStore` and returns a new router
whose weights are the per-bucket mean rewards (quality attainment minus a
cost penalty) — a pure function of the log. The same evaluator calibrates
measured per-impl quality back into the
:class:`~repro_torch.core.profiles.ProfileStore` quality column, closing the
loop for quality-aware *model selection* under a ``quality_floor``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from types import MappingProxyType
from typing import Mapping

from .telemetry import TelemetryStore, featurize_node

#: weight table: (interface, feature bucket) -> {arm -> mean reward}
Weights = dict[tuple[str, str], dict[str, float]]


@dataclass(frozen=True)
class Router:
    """Seeded epsilon-greedy policy over implementation arms.

    Frozen: updates build a *new* router (``with_weights``), bumping
    ``version`` so plan caches keyed on :meth:`fingerprint` invalidate.
    ``route`` draws its exploration coin from ``random.Random(str)`` keyed
    by ``(seed, task id, feature bucket)`` — independent of dispatch or
    planning order, stable across processes (SHA-512 string seeding).
    """

    interfaces: tuple[str, ...] = ("retrieve",)
    epsilon: float = 0.1
    seed: int = 0
    weights: Mapping[tuple[str, str], Mapping[str, float]] = \
        field(default_factory=dict)
    version: int = 0

    def __post_init__(self):
        if not 0.0 <= self.epsilon <= 1.0:
            raise ValueError(f"epsilon must be in [0, 1], "
                             f"got {self.epsilon}")
        # freeze the nested weight table so a shared router can't drift
        frozen = MappingProxyType({
            k: MappingProxyType(dict(v)) for k, v in dict(
                self.weights).items()})
        object.__setattr__(self, "weights", frozen)

    # -- identity ------------------------------------------------------------
    def covers(self, interface: str) -> bool:
        """True when this router decides the given interface's impl."""
        return interface in self.interfaces

    def fingerprint(self) -> tuple:
        """Hashable identity for plan-cache keys: any change to what the
        router would answer changes the fingerprint."""
        return (self.interfaces, self.epsilon, self.seed, self.version)

    # -- the decision --------------------------------------------------------
    def route(self, node, arms: list[str]) -> str | None:
        """Pick one arm for ``node`` from the floor-passing ``arms``.

        Exploit: the arm with the highest learned weight in the task's
        feature bucket (ties break lexicographically — deterministic).
        Explore: with probability ``epsilon`` (seeded coin keyed by task
        identity + bucket), a uniform seeded pick over ``arms``. Returns
        ``None`` when the bucket has no weights and no exploration fires —
        the scheduler then falls through to its constraint-preference
        choice, so an untrained router degrades to the static lever.
        """
        if not arms:
            return None
        bucket = featurize_node(node).bucket()
        rng = random.Random(f"{self.seed}:route:{node.id}:{bucket}")
        u = rng.random()
        if u < self.epsilon:
            return sorted(arms)[int(rng.random() * len(arms)) % len(arms)]
        table = self.weights.get((node.agent, bucket))
        if not table:
            return None
        known = [a for a in arms if a in table]
        if not known:
            return None
        return max(sorted(known), key=lambda a: table[a])

    # -- functional updates ---------------------------------------------------
    def with_weights(self, weights: Weights,
                     epsilon: float | None = None) -> "Router":
        """A new router carrying ``weights`` (and optionally a new
        exploration rate), with ``version`` bumped past this one's."""
        return Router(interfaces=self.interfaces,
                      epsilon=self.epsilon if epsilon is None else epsilon,
                      seed=self.seed, weights=weights,
                      version=self.version + 1)

    def weight_churn(self, other: "Router") -> int:
        """Number of (interface, bucket, arm) weights that differ between
        two routers — the neutral telemetry metric the bench reports."""
        mine = {(k, a): v for k, tbl in self.weights.items()
                for a, v in tbl.items()}
        theirs = {(k, a): v for k, tbl in other.weights.items()
                  for a, v in tbl.items()}
        keys = set(mine) | set(theirs)
        return sum(1 for k in keys if mine.get(k) != theirs.get(k))


class OfflineEvaluator:
    """Replays a telemetry log into routing weights and quality pins.

    The bandit update rule (DESIGN.md §11): per (interface, feature
    bucket, arm), weight = mean over the log's records of

        reward = min(quality / quality_target, 1)
                 - cost_weight * cost / mean_cost(interface)

    Quality saturates at the target — exceeding the bar buys nothing, so
    the cost term decides among arms that attain it, which is exactly the
    quality-floor semantics the planner enforces. Costs normalize by the
    interface's mean over the same log (self-scaling, no tuning constant
    carries units). Both passes are pure functions of the record list:
    the same log always produces the same weights.

    **Drift.** A plain lifetime mean never forgets: once an arm has
    accumulated enough history, a regression in its *current* behavior
    (quality drop after a model swap, a pool migration doubling cost) is
    averaged away by the stale majority, and the router keeps routing to
    it. ``half_life_s`` fixes this by exponentially decaying each record's
    weight with its age — ``0.5 ** (age / half_life_s)`` against the
    newest record in the log (sim-time, so replays stay deterministic) —
    in *both* passes: the cost normalizer and the reward means.
    ``window_s`` is the hard variant: records older than the window are
    dropped outright. Both default off, reproducing the lifetime mean
    exactly.
    """

    def __init__(self, quality_target: float = 0.85,
                 cost_weight: float = 0.2, cost_key: str = "energy_j",
                 half_life_s: float | None = None,
                 window_s: float | None = None):
        if not 0.0 < quality_target <= 1.0:
            raise ValueError("quality_target must be in (0, 1]")
        if cost_weight < 0.0:
            raise ValueError("cost_weight must be >= 0")
        if cost_key not in ("energy_j", "usd", "latency_s"):
            raise ValueError(f"unknown cost_key {cost_key!r}")
        if half_life_s is not None and half_life_s <= 0.0:
            raise ValueError("half_life_s must be > 0")
        if window_s is not None and window_s <= 0.0:
            raise ValueError("window_s must be > 0")
        self.quality_target = quality_target
        self.cost_weight = cost_weight
        self.cost_key = cost_key
        self.half_life_s = half_life_s
        self.window_s = window_s

    def _weights_of(self, records) -> "list[tuple]":
        """(record, age-weight) pairs under the decay/window policy.

        Ages are measured against the newest record's sim-time — a pure
        function of the log, unlike wall clocks — so the same store
        always yields the same weights.
        """
        if not records:
            return []
        now = max(r.t for r in records)
        rows = []
        for r in records:
            age = now - r.t
            if self.window_s is not None and age > self.window_s:
                continue
            w = 0.5 ** (age / self.half_life_s) \
                if self.half_life_s is not None else 1.0
            rows.append((r, w))
        return rows

    # -- the update rule ------------------------------------------------------
    def rewards(self, store: TelemetryStore) -> Weights:
        """Per-(interface, bucket, arm) mean rewards from the log
        (age-weighted means under ``half_life_s``/``window_s``)."""
        rows = self._weights_of(store.records)
        cost_of = {r: getattr(r, self.cost_key) for r, _ in rows}
        scale: dict[str, tuple[float, float]] = {}
        for r, w in rows:
            tot, n = scale.get(r.interface, (0.0, 0.0))
            scale[r.interface] = (tot + w * cost_of[r], n + w)
        mean_cost = {i: (tot / n if n and tot > 0 else 1.0)
                     for i, (tot, n) in scale.items()}
        acc: dict[tuple[str, str], dict[str, tuple[float, float]]] = {}
        for r, w in rows:
            reward = (min(r.quality / self.quality_target, 1.0)
                      - self.cost_weight * cost_of[r]
                      / mean_cost[r.interface])
            tbl = acc.setdefault((r.interface, r.features.bucket()), {})
            tot, n = tbl.get(r.impl, (0.0, 0.0))
            tbl[r.impl] = (tot + w * reward, n + w)
        return {key: {arm: tot / n for arm, (tot, n) in sorted(tbl.items())}
                for key, tbl in sorted(acc.items())}

    def update(self, router: Router, store: TelemetryStore,
               epsilon: float | None = None) -> Router:
        """A new router whose weights replay the log (pure function)."""
        return router.with_weights(self.rewards(store), epsilon=epsilon)

    # -- quality calibration (the model-selection half of the loop) -----------
    def calibrate_profiles(self, store: TelemetryStore, profiles,
                           min_count: int = 3) -> dict[str, float]:
        """Pin measured mean quality per impl into the profile store.

        Gives the planner's quality column (``ProfileStore.quality``) the
        telemetry-measured values, so ``quality_floor`` gating and the
        level-1 implementation choice run on *observed* quality instead of
        the declared ladder — an impl whose measured quality clears a
        floor its declared score missed becomes selectable (and vice
        versa). Returns the pins applied.
        """
        pins = store.mean_quality(min_count=min_count)
        for impl, q in pins.items():
            profiles.pin_quality(impl, q)
        return pins
