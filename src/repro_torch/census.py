"""What the kernel wrappers and the collectives report to a running census.

``launch/op_cost.py`` counts one step's work on ``meta`` tensors (or on the
CPU) by a dispatch mode; this module is its narrow interface to the code it
watches, so that the kernels and ``collectives.py`` import nothing of
``launch/``. With no census active every function here is a no-op.

- ``kernel(name, cost)`` brackets one kernel call: the census records the
  call under ``name`` with ``cost()``, the call's (FLOPs, HBM bytes) from the
  kernel's own counts, and counts none of the ops inside it (it still tracks
  their memory). A call nested in another (a backward wrapper called from its
  autograd Function) is the outer one's.
- ``collective(op, tensors, group_size)`` records one collective by its
  result tensors, at the current site.
- ``at(path)`` names the site (a layer group, block or weight, e.g.
  ``groups/g0/attn/wo``) of what runs inside it; ``site()`` reads it, so that
  an autograd Function's backward can return to the site of its forward.
- ``plain_kernel`` runs a kernel's plain version on CPU tensors as the card
  runs the kernel, under a census only: one call of the forward and, in
  grad mode, an autograd Function whose backward is one call of the plain
  backward, each returning contiguous tensors as the kernels write them.
  Autograd through the plain version's own ops would put its steps, not
  the backward kernel, into the count; so a CPU run and a meta trace of one
  step count alike.

A second listener records **spans**, while ``torch.profiler`` is on
(``torch.autograd.profiler._is_profiler_enabled``), so that they come and
go with the device trace and cover its slice; with the profiler off
``span`` and ``kernel`` return a shared no-op. Recording sets no census
(``active()`` stays None, so the CPU paths stay off ``plain_kernel``) and
puts nothing into the profiler's trace.

- ``span(name, **attrs)`` brackets one stage of the program.
- ``kernel(name, cost)``, with no census active, brackets the call with a
  span named after the kernel that holds ``cost()``; a call nested in
  another kernel call is the outer one's.
- A span holds its name, attributes, id, the id of the span open on its
  thread when it opened (one stack per thread: autograd runs the backward
  on a thread of its own), the host's ``time.time_ns()`` at its start and
  end (the clock torch.profiler stamps its events with) and a device
  interval: a pair of CUDA events on the current stream, placed on that
  clock between two marks, one recorded on the drained stream when the
  recording's first span opens and one when ``spans()`` first resolves
  them. Without CUDA the device interval is the host's.
- A span opened while recording is kept when it closes after the profiler
  stops. ``spans()`` resolves the events (synchronise the card first) and
  returns the log; ``clear_spans()`` empties it.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_active = None          # the running census (launch/op_cost.py::OpCensus)
_site: tuple = ()       # the current site, one path segment each
_log: list = []         # the recorded spans, in the order they opened
_ids = itertools.count(1)
_threads = threading.local()    # .stack: the spans open on this thread
_anchors: dict = {}     # card index -> this recording's _Anchor


def active():
    """The running census, or None."""
    return _active


def set_active(census):
    """Make ``census`` (or None) the running one; returns the previous."""
    global _active
    prev, _active = _active, census
    return prev


_NO_CENSUS = contextlib.nullcontext()


def kernel(name: str, cost):
    """A context for one call of kernel ``name``; ``cost`` is a function
    giving its (FLOPs, HBM bytes), called only when a census is active or
    spans are recorded. (With neither it is a shared no-op: a one-row
    kernel call is host-bound.)"""
    if _active is not None:
        return _active.kernel(name, cost)
    if not _recording():
        return _NO_CENSUS
    stack = _stack()
    if stack and stack[-1].cost is not None:
        return _NO_CENSUS
    return Span(name, {}, cost())


def span(name: str, **attrs):
    """A context for one stage ``name`` of the program, recorded as a span
    with ``attrs`` while torch.profiler is on (else a shared no-op)."""
    return Span(name, attrs) if _recording() else _NO_CENSUS


def _recording() -> bool:
    if _profiler._is_profiler_enabled:
        return True
    if _anchors:            # a recording ended: the next one anchors anew
        _anchors.clear()
    return False


class Span:
    """One recorded stage or kernel call. ``host`` and ``device`` are
    (start, end) in ns on ``time.time_ns()``'s clock (``host``'s end None
    while open; ``device`` None until ``spans()`` resolves it); ``cost`` is
    a kernel call's (FLOPs, HBM bytes), None for a stage."""

    __slots__ = ("name", "attrs", "cost", "id", "parent", "thread", "host",
                 "device", "_events")

    def __init__(self, name: str, attrs: dict, cost=None):
        self.name, self.attrs, self.cost = name, attrs, cost
        self.id, self.thread = next(_ids), threading.get_ident()
        self.parent = self.host = self.device = self._events = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        _log.append(self)
        start = time.time_ns()
        if torch.cuda.is_initialized():
            stream = _current_stream()
            self._events = (_anchor(stream), torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), stream)
            self._events[1].record(stream)
        self.host = (start, None)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[2].record(self._events[3])
        self.host = (self.host[0], time.time_ns())
        _stack().pop()
        return False

    def _resolve(self):
        if self._events is None:
            self.device = self.host
            return
        anchor, start, end, _ = self._events
        self.device = (anchor.place(start), anchor.place(end))
        self._events = None


def _stack() -> list:
    try:
        return _threads.stack
    except AttributeError:
        _threads.stack = []
        return _threads.stack


def _current_stream():
    """The current card's current stream (``torch.cuda.current_stream()``
    builds a new object each call; this looks it up by its handle)."""
    index = torch.cuda.current_device()
    raw = torch._C._cuda_getCurrentRawStream(index)
    stream = _streams.get(raw)
    if stream is None:
        stream = _streams[raw] = torch.cuda.current_stream(index)
    return stream


_streams: dict = {}     # raw stream handle -> torch.cuda.Stream


class _Anchor:
    """Places a recording's CUDA events on the host's clock: a mark on the
    drained stream when the recording's first span opens, and one when its
    spans are resolved; between the two, time runs linearly (over seconds the
    events' clock drifts from the profiler's by µs to tens of µs)."""

    def __init__(self, stream):
        stream.synchronize()
        self.first, self.last = _mark(stream), None

    def place(self, event) -> int:
        if self.last is None:
            stream = _current_stream()
            stream.synchronize()
            self.last = _mark(stream)
            self.last[0].synchronize()
        (a, ta), (b, tb) = self.first, self.last
        return ta + round(a.elapsed_time(event) / a.elapsed_time(b) * (tb - ta))


def _mark(stream) -> tuple:
    """An event recorded on an idle ``stream`` and the host's clock as the
    record call returns (the card runs it a microsecond or two later)."""
    event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return event, time.time_ns()


def _anchor(stream) -> _Anchor:
    """This recording's anchor on ``stream``'s card."""
    got = _anchors.get(stream.device_index)
    if got is None:
        got = _anchors[stream.device_index] = _Anchor(stream)
    return got


def spans() -> list:
    """The recorded spans, in the order they opened, each closed one's
    device interval resolved; synchronise the card before calling."""
    for s in _log:
        if s.device is None and s.host[1] is not None:
            s._resolve()
    return list(_log)


def clear_spans() -> None:
    """Empty the log of spans."""
    _log.clear()
    _anchors.clear()


def collective(op: str, tensors, group_size: int) -> None:
    """One collective ``op`` over a group of ``group_size`` ranks, whose
    result is ``tensors`` (one tensor or several)."""
    if _active is not None:
        _active.collective(op, tensors, group_size, site())


def site() -> tuple:
    return _site


@contextlib.contextmanager
def at(path: tuple):
    """Run the body at the site ``path`` (a tuple of path segments)."""
    global _site
    if _active is None:
        yield
        return
    saved, _site = _site, tuple(path)
    try:
        yield
    finally:
        _site = saved


class _PlainKernel(torch.autograd.Function):
    """A kernel's plain forward and plain backward, each one call of a
    kernel under the census (``plain_kernel``)."""

    @staticmethod
    def forward(ctx, call, *inputs):
        name, cost, fwd, bwd, bwd_cost = call
        ctx.call, ctx.site = call, site()
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        with kernel(name, cost):
            return _contiguous(fwd(*inputs))

    @staticmethod
    def backward(ctx, *grads):
        name, _, _, bwd, bwd_cost = ctx.call
        with at(ctx.site), kernel(name + "_bwd", bwd_cost):
            return (None, *_contiguous(bwd(ctx.saved_tensors, grads)))


def _contiguous(out):
    if isinstance(out, tuple):
        return tuple(t.contiguous() for t in out)
    return out.contiguous()


def plain_kernel(name: str, cost, fwd, inputs, bwd, bwd_cost):
    """``fwd(*inputs)``, the plain version of kernel ``name`` on CPU tensors,
    as one call of it; when an input requires grad, through an autograd
    Function whose backward ``bwd(inputs, output_grads)`` (the plain
    backward; an unused output's gradient is None) is one call of
    ``name + "_bwd"`` with ``bwd_cost``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _PlainKernel.apply((name, cost, fwd, bwd, bwd_cost), *inputs)
    with kernel(name, cost):
        return _contiguous(fwd(*inputs))
