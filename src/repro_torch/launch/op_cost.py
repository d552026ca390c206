"""One step's cost, counted by running it: the port's counterpart of
``src/repro/launch/hlo_cost.py``.

The reference reads a step's cost from the optimized HLO of its production
lowering, scaling each while-loop body by its trip count. The port lowers
nothing: it runs the step eagerly (on ``meta`` tensors in the dry-run, as
one rank of a fake process group), and ``OpCensus``, a dispatch mode, counts
what the run does, op by op:

- FLOPs: each matmul-like op by ``torch.utils.flop_counter``'s formulas,
  plus each kernel call's own count (the kernel modules' ``*_cost``).
- Materialized bytes x2, as ``ScaledGraph.memory_traffic`` counts them
  (produced, then consumed): each storage an op creates, counted once.
  Views, aliasing ops and in-place updates create none, so they are free.
  The ops inside a kernel call (``census.kernel``: a wrapper's meta path or
  a plain version's steps) are never counted; the call's IO is, once, at
  its boundary (``kernel_io``). Meta tensors take the kernels' path, never
  the plain versions, whose step-by-step temporaries are not what the card
  runs.
- Collectives: each one ``collectives.py`` issues, with its group's size,
  its result's bytes and the on-link bytes of a ring over the group
  (``_traffic_factor``), and the site (layer group, block, weight) that
  issued it. The port issues every collective by hand, so this is what a
  real run of the step issues.
- Kernel calls, by kernel.
- Peak live bytes, by a storage-tracking mode of its own (the port's models
  are functions, not the ``nn.Module`` trees ``MemTracker`` follows): a
  storage counts from the op that creates it until it is freed, the step's
  arguments (``track``) from the start. On the card this is what
  ``torch.cuda.max_memory_allocated`` reads, less the allocator's rounding
  and the libraries' workspaces.

The reference's FLOPs come from XLA's ``cost_analysis()``, which counts
every op; these count the products (matmuls and kernels) alone.
"""
from __future__ import annotations

import collections
import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .. import census

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _traffic_factor(op: str, n: int) -> float:
    """On-link bytes per device as a fraction of the result size (ring)."""
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return (n - 1) / n
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op == "reduce-scatter":
        return float(n - 1)
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0   # collective-permute


def _site_now() -> str:
    """The census's site; in a backward pass outside every site, the
    autograd node that runs (e.g. ``backward:MmBackward0``)."""
    site = "/".join(census.site())
    if site:
        return site
    node = torch._C._current_autograd_node()
    return f"backward:{node.name()}" if node is not None else ""


def _plain(t) -> bool:
    return isinstance(t, torch.Tensor) and type(t) in (torch.Tensor,
                                                       torch.nn.Parameter)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if _plain(t)]


class OpCensus(TorchDispatchMode):
    """Counts the ops run while it is active (see the module's docstring).
    Allocations of at least ``big_bytes`` are listed in ``allocs`` with the
    op, shape and site that made them."""

    def __init__(self, big_bytes: float = 1e8):
        super().__init__()
        self.flops = 0              # matmul-like ops outside kernel calls
        self.bytes = 0              # materialized bytes x2 outside kernel calls
        self.kernel_calls = collections.Counter()
        self.kernel_flops = 0
        self.kernel_io = 0
        self.collectives: list[dict] = []
        self.allocs: list[dict] = []
        self.live = self.peak = 0
        self.big_bytes = big_bytes
        self._storages: dict[int, int] = {}
        self._depth = 0
        self._prev: list = []

    # -- memory ---------------------------------------------------------------
    def _add_storage(self, t) -> int:
        """Count ``t``'s storage as live if it is new; its bytes, or 0."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        nbytes = st.nbytes()
        self._storages[key] = nbytes
        weakref.finalize(st, self._release, key)
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        return nbytes

    def _release(self, key):
        self.live -= self._storages.pop(key, 0)

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (a step's arguments) as
        live; their bytes."""
        return sum(self._add_storage(t) for t in _tensors(tree))

    # -- what census.py reports -----------------------------------------------
    @contextlib.contextmanager
    def kernel(self, name: str, cost):
        if self._depth == 0:
            flops, nbytes = cost()
            self.kernel_calls[name] += 1
            self.kernel_flops += flops
            self.kernel_io += nbytes
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    def collective(self, op: str, tensors, group_size: int, site: tuple):
        ts = [tensors] if isinstance(tensors, torch.Tensor) else list(tensors)
        raw = sum(t.numel() * t.element_size() for t in ts)
        self.collectives.append({
            "op": op, "group": group_size, "bytes": raw,
            "link_bytes": raw * _traffic_factor(op, group_size),
            "shape": [list(t.shape) for t in ts] if len(ts) > 1
            else list(ts[0].shape),
            "dtype": str(ts[0].dtype).replace("torch.", ""),
            "site": "/".join(site)})

    # -- the mode -------------------------------------------------------------
    def __enter__(self):
        self._prev.append(census.set_active(self))
        return super().__enter__()

    def __exit__(self, *exc):
        census.set_active(self._prev.pop())
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t not in (torch.Tensor, torch.nn.Parameter) for t in types):
            return NotImplemented    # a subclass (DTensor) unwraps first
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry:
            # a composite op (matmul, einsum, reshape) reaches the mode
            # whole where autograd is off (inference mode): count its parts,
            # as autograd would have split it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        made = 0
        # a view or an in-place op writes no new buffer, whatever storage it
        # returns (a collective's backend may make one the mode never saw)
        aliases = any(r.alias_info is not None for r in func._schema.returns)
        for t in _tensors(out):
            nbytes = self._add_storage(t)
            if aliases:
                continue
            made += nbytes
            if nbytes >= self.big_bytes and self._depth == 0:
                self.allocs.append({"bytes": 2 * nbytes, "op": str(func),
                                    "shape": list(t.shape),
                                    "site": _site_now()})
        if self._depth == 0:
            self.bytes += 2 * made
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
        return out

    # -- results --------------------------------------------------------------
    def collective_totals(self) -> dict:
        """Per op ``{count, bytes (on-link), raw_bytes}``, as the
        reference's ``collective_traffic``, and ``total_bytes``."""
        out = {op: {"count": 0, "bytes": 0.0, "raw_bytes": 0}
               for op in COLLECTIVES}
        for c in self.collectives:
            rec = out[c["op"]]
            rec["count"] += 1
            rec["raw_bytes"] += c["bytes"]
            rec["bytes"] += c["link_bytes"]
        out["total_bytes"] = sum(v["bytes"] for v in out.values())
        return out

    def summary(self) -> dict:
        return {"flops": self.flops + self.kernel_flops,
                "op_flops": self.flops, "kernel_flops": self.kernel_flops,
                "bytes": self.bytes + self.kernel_io,
                "materialized_bytes": self.bytes, "kernel_io": self.kernel_io,
                "kernel_calls": dict(sorted(self.kernel_calls.items())),
                "collectives": self.collective_totals(),
                "peak_bytes": self.peak}
