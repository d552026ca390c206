"""Fault tolerance: the restart loop, straggler detection, elastic remesh.

Counterpart of ``repro.runtime.fault_tolerance``, as the port's own copy:

1. **Checkpoint/restart**: ``run_with_restarts`` wraps a step loop; on any
   step failure it restores the latest checkpoint (and the data-pipeline
   cursor) and replays. Failure injection hooks make this testable.
2. **Straggler mitigation**: ``StragglerMonitor`` tracks per-step,
   per-worker durations; workers beyond ``threshold x median`` are flagged,
   and the policy escalates from re-dispatching a shard to excluding it.
3. **Elastic remesh**: ``plan_remesh`` picks the largest valid mesh after
   losing devices; the train state then moves to it through a checkpoint
   (full tensors on disk, re-sharded to the new mesh's placements on
   restore).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from statistics import median
from typing import Callable

#: A worker or task running beyond ``DEFAULT_STRAGGLER_THRESHOLD x`` the
#: healthy median is a straggler (the reference's one definition).
DEFAULT_STRAGGLER_THRESHOLD = 1.5


@dataclass
class RestartPolicy:
    max_failures: int = 3
    backoff_s: float = 0.0


def run_with_restarts(*, num_steps: int, state, data_iter, step_fn,
                      ckpt_manager, save_every: int = 10,
                      policy: RestartPolicy | None = None,
                      fail_hook: Callable[[int], None] | None = None,
                      log: Callable[[str], None] = lambda s: None):
    """Run ``step_fn(state, batch) -> (state, metrics)`` with auto-restart.

    ``fail_hook(step)`` (tests) may raise to inject a failure at a step.
    Returns (state, metrics_history, failures_survived).
    """
    if policy is None:
        policy = RestartPolicy()
    failures = 0
    history = []
    step = int(state["step"])
    while step < num_steps:
        try:
            if fail_hook is not None:
                fail_hook(step)
            batch = next(data_iter)
            state, metrics = step_fn(state, batch)
            step = int(state["step"])
            history.append({k: float(v) for k, v in metrics.items()})
            if step % save_every == 0:
                ckpt_manager.save(step, {"state": state,
                                         "data": data_iter.state()})
        except KeyboardInterrupt:
            raise
        except Exception as e:  # node failure, preemption, injected fault
            failures += 1
            log(f"step {step} failed ({type(e).__name__}: {e}); "
                f"restart {failures}/{policy.max_failures}")
            if failures > policy.max_failures:
                raise
            if policy.backoff_s:
                time.sleep(policy.backoff_s)
            restored, at = ckpt_manager.restore(
                {"state": state, "data": data_iter.state()})
            if restored is None:
                raise RuntimeError("no checkpoint to restart from") from e
            state = restored["state"]
            data_iter.restore(restored["data"])
            step = int(state["step"])
    ckpt_manager.wait()
    return state, history, failures


@dataclass
class StragglerMonitor:
    """Flags workers whose step time exceeds threshold x median."""

    threshold: float = DEFAULT_STRAGGLER_THRESHOLD
    window: int = 20
    _durations: dict[str, list[float]] = field(default_factory=dict)

    def record(self, worker: str, duration_s: float):
        self._durations.setdefault(worker, []).append(duration_s)
        self._durations[worker] = self._durations[worker][-self.window:]

    def medians(self) -> dict[str, float]:
        return {w: median(d) for w, d in self._durations.items() if d}

    def stragglers(self) -> list[str]:
        meds = self.medians()
        if len(meds) < 2:
            return []
        overall = median(meds.values())
        return [w for w, m in meds.items() if m > self.threshold * overall]

    def action(self, worker: str) -> str:
        """Escalating mitigation: redispatch -> exclude, judged against the
        peer median as ``stragglers()`` is: a worker with no peers can never
        escalate to exclusion."""
        peers = [m for w, m in self.medians().items() if w != worker]
        if not peers:
            return "redispatch"
        overall = median(peers)
        n = len([d for d in self._durations.get(worker, [])
                 if d > self.threshold * overall])
        return "exclude" if n >= self.window // 2 else "redispatch"


# ---------------------------------------------------------------------------
# 3. Elastic remesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RemeshPlan:
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    devices_used: int
    devices_lost: int
    resharded_axes: tuple[str, ...]   # mesh axes whose size changed
    batch_scale: float                # keep global batch: per-device batch x


def plan_remesh(old_shape: tuple[int, ...], axis_names: tuple[str, ...],
                devices_available: int, *, model_axis: str = "model",
                min_model: int = 1) -> RemeshPlan:
    """Largest valid mesh after losing devices.

    Strategy (matches cluster-manager policy): keep the model axis if
    possible (resharding TP state is the expensive case), shrink data/pod
    axes first; fall back to halving the model axis.
    """
    old_total = math.prod(old_shape)
    sizes = dict(zip(axis_names, old_shape))
    model = sizes.get(model_axis, 1)
    best = None
    m = model
    while m >= min_model:
        rest = devices_available // m
        if rest == 0:            # model axis alone no longer fits
            m //= 2
            continue
        # distribute `rest` over the non-model axes, preferring powers of two
        others = [a for a in axis_names if a != model_axis]
        alloc = {}
        rem = rest
        for a in others[::-1]:          # shrink leading ('pod') axes last
            take = 1
            while take * 2 <= min(sizes[a], rem):
                take *= 2
            alloc[a] = take
            rem //= take
        new_shape = tuple(m if a == model_axis else alloc[a]
                          for a in axis_names)
        used = math.prod(new_shape)
        if best is None or used > best[0]:
            best = (used, new_shape)
        if used == devices_available:
            break
        m //= 2
    if best is None:             # fewer devices than any valid mesh
        best = (1, tuple(1 for _ in axis_names))
    used, new_shape = best
    resharded = tuple(a for a, o, n in
                      zip(axis_names, old_shape, new_shape) if o != n)
    return RemeshPlan(old_shape=tuple(old_shape), new_shape=new_shape,
                      axis_names=tuple(axis_names), devices_used=used,
                      devices_lost=old_total - devices_available,
                      resharded_axes=resharded,
                      batch_scale=old_total / used)
