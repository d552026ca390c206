"""Fault tolerance: the restart loop and straggler detection.

Counterpart of sections 1 and 2 of ``repro.runtime.fault_tolerance``, as the
port's own copy:

1. **Checkpoint/restart**: ``run_with_restarts`` wraps a step loop; on any
   step failure it restores the latest checkpoint (and the data-pipeline
   cursor) and replays. Failure injection hooks make this testable.
2. **Straggler mitigation**: ``StragglerMonitor`` tracks per-step,
   per-worker durations; workers beyond ``threshold x median`` are flagged,
   and the policy escalates from re-dispatching a shard to excluding it.

The elastic remesh (``RemeshPlan``, ``plan_remesh``) comes with the mesh
path (ROADMAP.md A11).
"""
from __future__ import annotations

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
