"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

A traced slice is opened and closed by the harness around whole program
calls, with the card synchronised at both ends; its wall time is the
host's clock between them. What is kept of the profiler's records is each
operation that ran on the device (kernels, copies and sets): its name, start
and end in microseconds.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    ops: list = field(default_factory=list)     # (name, start_us, end_us)
    window_s: float = 0.0

    def busy_s(self) -> float:
        """The union of the device operations' intervals, in seconds."""
        total, end = 0.0, None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def time_of(self, names) -> tuple[float, int]:
        """(seconds, launches) of the operations whose name holds one of
        ``names``."""
        hits = [(e - s) for n, s, e in self.ops if any(k in n for k in names)]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return sorted(([k[:120], v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with nothing on the device, each named by
        the operation that ended before it."""
        ops = sorted(self.ops, key=lambda o: o[1])
        gaps, end, last = [], None, "window start"
        for name, s, e in ops:
            if end is not None and s > end:
                gaps.append([f"after {last[:100]}", (s - end) / 1e6])
            if end is None or e > end:
                end, last = e, name
        return sorted(gaps, key=lambda g: -g[1])[:n]


def _device_ops(prof) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        start = ev.start_ns() / 1e3
        out.append((ev.name(), start, start + ev.duration_ns() / 1e3))
    return out


class Tracer:
    """Opens and closes one profiled slice; inactive when ``on`` is false."""

    def __init__(self, on: bool):
        self.on = on
        self.trace = Trace() if on else None
        self._prof = None
        self._t0 = 0.0

    @property
    def open(self) -> bool:
        return self._prof is not None

    def start(self):
        if not self.on or self._prof is not None or self.trace.window_s:
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        if self._prof is None:
            return
        torch.cuda.synchronize()
        self.trace.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.trace.ops = _device_ops(self._prof)
        self._prof = None
