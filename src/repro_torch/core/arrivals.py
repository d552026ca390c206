"""Open-loop arrival processes for the serving engine (DESIGN.md §8).

The closed-loop benches replay a fixed tenant mix once; real compound-AI
serving is open-loop — requests keep arriving whether or not the cluster
has caught up, so queueing, SLO attainment and autoscaling behavior only
show up under a generated arrival stream. Three seeded processes:

- :class:`PoissonArrivals` — memoryless arrivals at a constant offered
  rate; the steady-state baseline every queueing result assumes.
- :class:`MMPPArrivals` — a 2-state Markov-modulated Poisson process
  (on/off bursts): exponential dwell times alternate between a burst rate
  and an idle/background rate. The standard bursty-traffic model; drives
  the autoscaler's scale-up-lag and cooldown behavior.
- :class:`TraceArrivals` — replay of a recorded schedule, round-tripping a
  JSONL file (one ``{"t": ..., "scenario": ..., "tenant": ...}`` object
  per line), so production traces can be fed straight into the engine.
- :class:`SessionArrivals` — multi-turn chat/agent sessions (DESIGN.md
  §9): Poisson session starts, geometric turn counts, exponential think
  time between turns. Each event carries the session id and turn index,
  so the engine can route turns to KV-cache-resident instances.

Every process yields :class:`ArrivalEvent` rows in non-decreasing time
order and is fully determined by its seed — two iterations of the same
process produce identical streams (a hypothesis property in
``tests/test_arrivals.py``). Scenario and tenant class are sampled per
arrival from weight maps, so one stream carries a heterogeneous mix.
"""
from __future__ import annotations

import heapq
import itertools
import json
import random
from dataclasses import dataclass, field
from typing import Callable, Iterator

from .admission import TENANT_CLASSES

# tenant-class mix used when a process is built without explicit shares:
# a small latency-sensitive slice, a standard majority, and a best-effort
# harvest tail (the mix the multitenant bench's scenarios assume)
DEFAULT_TENANT_SHARES = {"priority": 0.2, "standard": 0.5, "harvest": 0.3}


@dataclass(frozen=True)
class ArrivalEvent:
    """One workflow arrival: when, which scenario, which tenant class.

    ``session``/``turn`` identify multi-turn serving sessions (empty /
    0 for the stateless processes — the wire format omits them then, so
    pre-session traces round-trip unchanged).
    """

    t: float
    scenario: str
    tenant: str = "standard"
    session: str = ""
    turn: int = 0


def _normalize(weights: dict[str, float], what: str) -> list[tuple[str, float]]:
    """Cumulative distribution rows [(key, cum_prob)] from a weight map."""
    if not weights:
        raise ValueError(f"empty {what} mix")
    total = sum(weights.values())
    if total <= 0:
        raise ValueError(f"{what} weights must sum > 0: {weights}")
    rows, acc = [], 0.0
    for key in sorted(weights):
        acc += weights[key] / total
        rows.append((key, acc))
    rows[-1] = (rows[-1][0], 1.0)     # guard float drift at the top bin
    return rows


def _pick(rows: list[tuple[str, float]], u: float) -> str:
    for key, cum in rows:
        if u <= cum:
            return key
    return rows[-1][0]


class ArrivalProcess:
    """Base: a seeded, replayable stream of :class:`ArrivalEvent`."""

    def events(self) -> Iterator[ArrivalEvent]:
        """Yield arrivals in non-decreasing time order (may be infinite)."""
        raise NotImplementedError

    # -- shared mix sampling -------------------------------------------------
    def _init_mix(self, mix: dict[str, float],
                  tenant_shares: dict[str, float] | None):
        shares = dict(tenant_shares or DEFAULT_TENANT_SHARES)
        for tenant in shares:
            if tenant not in TENANT_CLASSES:
                raise ValueError(f"unknown tenant class {tenant!r}; "
                                 f"one of {TENANT_CLASSES}")
        self._mix = _normalize(mix, "scenario")
        self._shares = _normalize(shares, "tenant")

    def _sample(self, rng: random.Random, t: float) -> ArrivalEvent:
        scenario = _pick(self._mix, rng.random())
        tenant = _pick(self._shares, rng.random())
        return ArrivalEvent(t, scenario, tenant)


class PoissonArrivals(ArrivalProcess):
    """Constant-rate memoryless arrivals (exponential inter-arrival gaps)."""

    def __init__(self, rate_per_s: float, mix: dict[str, float],
                 tenant_shares: dict[str, float] | None = None,
                 seed: int = 0):
        if rate_per_s <= 0:
            raise ValueError(f"rate_per_s must be > 0, got {rate_per_s}")
        self.rate_per_s = rate_per_s
        self.seed = seed
        self._init_mix(mix, tenant_shares)

    def events(self) -> Iterator[ArrivalEvent]:
        """Infinite exponential-gap stream at ``rate_per_s``."""
        rng = random.Random(self.seed)
        t = 0.0
        while True:
            t += rng.expovariate(self.rate_per_s)
            yield self._sample(rng, t)


class MMPPArrivals(ArrivalProcess):
    """2-state Markov-modulated Poisson process (on/off bursts).

    Dwell times in each state are exponential (``mean_on_s`` /
    ``mean_off_s``); arrivals within a state are Poisson at ``rate_on`` or
    ``rate_off``. ``rate_off=0`` models true idle gaps. The long-run
    offered rate is ``(rate_on * mean_on + rate_off * mean_off) /
    (mean_on + mean_off)`` — :meth:`mean_rate`.
    """

    def __init__(self, rate_on: float, rate_off: float, mean_on_s: float,
                 mean_off_s: float, mix: dict[str, float],
                 tenant_shares: dict[str, float] | None = None,
                 seed: int = 0):
        if rate_on <= 0:
            raise ValueError(f"rate_on must be > 0, got {rate_on}")
        if rate_off < 0:
            raise ValueError(f"rate_off must be >= 0, got {rate_off}")
        if mean_on_s <= 0 or mean_off_s <= 0:
            raise ValueError("state dwell means must be > 0")
        self.rate_on = rate_on
        self.rate_off = rate_off
        self.mean_on_s = mean_on_s
        self.mean_off_s = mean_off_s
        self.seed = seed
        self._init_mix(mix, tenant_shares)

    def mean_rate(self) -> float:
        """Long-run offered arrivals/s across on and off states."""
        return (self.rate_on * self.mean_on_s +
                self.rate_off * self.mean_off_s) / \
            (self.mean_on_s + self.mean_off_s)

    def events(self) -> Iterator[ArrivalEvent]:
        """Infinite on/off-modulated stream (starts in the burst state)."""
        rng = random.Random(self.seed)
        t = 0.0
        on = True                     # start in the burst state
        state_end = rng.expovariate(1.0 / self.mean_on_s)
        while True:
            rate = self.rate_on if on else self.rate_off
            gap = rng.expovariate(rate) if rate > 0 else float("inf")
            if t + gap > state_end:
                # no arrival before the state flips: jump to the boundary
                # (the exponential's memorylessness makes re-drawing the
                # gap in the next state statistically exact)
                t = state_end
                on = not on
                mean = self.mean_on_s if on else self.mean_off_s
                state_end = t + rng.expovariate(1.0 / mean)
                continue
            t += gap
            yield self._sample(rng, t)


class TraceArrivals(ArrivalProcess):
    """Replay of a recorded arrival schedule (JSONL round-trippable)."""

    def __init__(self, events: "list[ArrivalEvent]"):
        prev = 0.0
        for e in events:
            if e.t < prev:
                raise ValueError(f"trace not time-ordered at t={e.t} "
                                 f"(previous {prev})")
            prev = e.t
            if e.tenant not in TENANT_CLASSES:
                raise ValueError(f"unknown tenant class {e.tenant!r}")
        self._events = list(events)

    def events(self) -> Iterator[ArrivalEvent]:
        """The recorded schedule, verbatim."""
        return iter(self._events)

    def __len__(self) -> int:
        return len(self._events)

    # -- JSONL round trip ----------------------------------------------------
    def to_jsonl(self) -> str:
        """One JSON object per line: {"t", "scenario", "tenant"} plus
        {"session", "turn"} for session-carrying events only (the
        sessionless wire format is byte-stable across this addition)."""
        rows = []
        for e in self._events:
            row: dict = {"t": e.t, "scenario": e.scenario,
                         "tenant": e.tenant}
            if e.session:
                row["session"] = e.session
                row["turn"] = e.turn
            rows.append(json.dumps(row, sort_keys=True))
        return "\n".join(rows)

    @classmethod
    def from_jsonl(cls, text: str) -> "TraceArrivals":
        """Parse :meth:`to_jsonl` output (blank lines ignored)."""
        events = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            events.append(ArrivalEvent(float(row["t"]), row["scenario"],
                                       row.get("tenant", "standard"),
                                       row.get("session", ""),
                                       int(row.get("turn", 0))))
        return cls(events)

    @classmethod
    def record(cls, process: ArrivalProcess, horizon_s: float,
               max_events: int = 1_000_000) -> "TraceArrivals":
        """Materialize another process's stream up to ``horizon_s``."""
        events = []
        for e in process.events():
            if e.t > horizon_s or len(events) >= max_events:
                break
            events.append(e)
        return cls(events)


class SessionArrivals(ArrivalProcess):
    """Multi-turn serving sessions (chat/agent loops, DESIGN.md §9).

    Sessions start as a Poisson process at ``session_rate_per_s``. Each
    session samples its tenant class once, then emits turns: after turn
    ``k`` the session continues with probability ``1 - 1/mean_turns``
    (geometric turn counts with the given mean, hard-capped at
    ``max_turns``), and the next turn arrives after an exponential think
    gap of mean ``think_time_s``. Turns of concurrent sessions interleave
    in time order via a heap merge; a single seeded RNG drives every draw,
    so the stream replays exactly.
    """

    def __init__(self, session_rate_per_s: float, scenario: str = "chat",
                 mean_turns: float = 6.0, think_time_s: float = 45.0,
                 max_turns: int = 32,
                 tenant_shares: dict[str, float] | None = None,
                 seed: int = 0):
        if session_rate_per_s <= 0:
            raise ValueError(f"session_rate_per_s must be > 0, "
                             f"got {session_rate_per_s}")
        if mean_turns < 1:
            raise ValueError(f"mean_turns must be >= 1, got {mean_turns}")
        if think_time_s <= 0:
            raise ValueError(f"think_time_s must be > 0, "
                             f"got {think_time_s}")
        if max_turns < 1:
            raise ValueError(f"max_turns must be >= 1, got {max_turns}")
        self.session_rate_per_s = session_rate_per_s
        self.scenario = scenario
        self.mean_turns = mean_turns
        self.think_time_s = think_time_s
        self.max_turns = max_turns
        self.seed = seed
        self._init_mix({scenario: 1.0}, tenant_shares)

    def mean_rate(self) -> float:
        """Long-run offered turns/s (sessions/s x mean turns, pre-cap)."""
        return self.session_rate_per_s * self.mean_turns

    def events(self) -> Iterator[ArrivalEvent]:
        """Infinite time-ordered turn stream across concurrent sessions."""
        rng = random.Random(self.seed)
        cont = 1.0 - 1.0 / max(self.mean_turns, 1.0)
        seq = itertools.count()       # FIFO tiebreak for same-t events
        sessions = 0
        # heap rows: (t, seq, session_id | None, turn, tenant);
        # session_id None marks a pending session *start*
        heap: list = [(rng.expovariate(self.session_rate_per_s),
                       next(seq), None, 0, "")]
        while heap:
            t, _, sid, turn, tenant = heapq.heappop(heap)
            if sid is None:
                # a session starts now: name it, sample its tenant once,
                # and queue the start of the next session
                sid = f"s{sessions:06d}"
                sessions += 1
                tenant = _pick(self._shares, rng.random())
                heapq.heappush(
                    heap, (t + rng.expovariate(self.session_rate_per_s),
                           next(seq), None, 0, ""))
            if turn + 1 < self.max_turns and rng.random() < cont:
                gap = rng.expovariate(1.0 / self.think_time_s)
                heapq.heappush(heap, (t + gap, next(seq), sid,
                                      turn + 1, tenant))
            yield ArrivalEvent(t, self.scenario, tenant, sid, turn)


# ---------------------------------------------------------------------------
# Serving presets: scenario name -> job factory + SLO policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServingPreset:
    """How one scenario appears in an open-loop mix.

    ``make_job`` is the scenario's declarative job factory (the workflow
    configs register theirs at import — core stays config-agnostic);
    ``weight`` is its share of the default arrival mix; ``base_slo_s`` is
    the standard-class span SLO, scaled per tenant class by
    ``slo_class_mult`` (priority tighter, harvest looser).
    """

    scenario: str
    make_job: Callable
    weight: float = 1.0
    base_slo_s: float | None = None
    slo_class_mult: dict = field(default_factory=lambda: {
        "priority": 0.5, "standard": 1.0, "harvest": 4.0})
    constraints: tuple | None = None     # forwarded to make_job
    # session-aware factories take (session=..., turn=...) kwargs and
    # build turn-indexed jobs (token footprint grows with history); the
    # open-loop driver keys its lowering cache per turn for these
    session_aware: bool = False

    def slo_for(self, tenant: str) -> float | None:
        """The span SLO for one tenant class (None = best-effort)."""
        if self.base_slo_s is None:
            return None
        return self.base_slo_s * self.slo_class_mult.get(tenant, 1.0)


# scenario -> preset; the three workflow config modules register theirs at
# import time (``repro_torch.configs``), keeping core free of config imports
SERVING_PRESETS: dict[str, ServingPreset] = {}


def register_preset(preset: ServingPreset) -> ServingPreset:
    """Register (or replace) a scenario's serving preset."""
    SERVING_PRESETS[preset.scenario] = preset
    return preset


def default_mix() -> dict[str, float]:
    """Scenario weight map over every registered preset."""
    if not SERVING_PRESETS:
        raise RuntimeError(
            "no serving presets registered — import repro_torch.configs "
            "(workflow_video/rag/docingest) before building a mix")
    return {name: p.weight for name, p in SERVING_PRESETS.items()}
