"""Multi-tenant admission: tenant classes + dispatch-order policies.

The paper's adaptive-runtime claim (§5, "heavy traffic from millions of
users") needs a policy layer between declarative jobs and the cluster:
which tenant's ready work is dispatched first when capacity is scarce.
Production studies of compound AI deployments identify exactly this
tenant-aware admission/priority policy as the missing piece between
workflow orchestration and the cluster manager.

Three tenant classes (``Job.tenant_class``):

- ``priority``  — latency-sensitive; may *preempt* harvest-class leases
  (the simulator reclaims them via ``ClusterManager.preempt_harvest``).
- ``standard``  — the default; scheduled by policy order, never preempts.
- ``harvest``   — best-effort; its allocations are marked preemptible
  (spot semantics), so priority tenants can reclaim the devices mid-run.

Three policies (``POLICIES``): ``fcfs`` (arrival order, the legacy
behaviour), ``strict-priority`` (class rank, then arrival) and
``weighted-fair`` (classes served in proportion to configurable weights,
tracked as virtual time = device-seconds served / weight — the classic
WFQ approximation). A policy orders the *ready queue*; dispatch stays
work-conserving: lower classes still run when higher classes leave
capacity free.
"""
from __future__ import annotations

from dataclasses import dataclass, field

TENANT_CLASSES = ("priority", "standard", "harvest")
_RANK = {c: i for i, c in enumerate(TENANT_CLASSES)}


@dataclass(frozen=True)
class Admission:
    """One tenant's entry in the admission queue."""

    workflow: str
    tenant: str
    arrival: float


class AdmissionPolicy:
    """Orders ready work across tenants; subclasses define the key."""

    name = "base"
    # dynamic policies derive keys from state that moves between dispatch
    # passes (e.g. WFQ virtual time); static policies key on immutable
    # admission facts, so the event engine may sort each workflow once at
    # admission and keep it in a persistent heap (DESIGN.md §8)
    dynamic = False

    def key(self, adm: Admission, served: dict[str, float]) -> tuple:
        """Sort key for one admission; lower dispatches first."""
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class FCFS(AdmissionPolicy):
    """Arrival order, tenant-blind (the legacy ``execute_many`` order)."""

    name = "fcfs"

    def key(self, adm: Admission, served: dict[str, float]) -> tuple:
        """Arrival time, workflow id as the deterministic tie-break."""
        return (adm.arrival, adm.workflow)


class StrictPriority(AdmissionPolicy):
    """Class rank first (priority < standard < harvest), arrival second."""

    name = "strict-priority"

    def key(self, adm: Admission, served: dict[str, float]) -> tuple:
        """Tenant-class rank, then arrival order."""
        return (_RANK[adm.tenant], adm.arrival, adm.workflow)


class WeightedFair(AdmissionPolicy):
    """Serve classes in proportion to weights: the class with the lowest
    virtual time (device-seconds served / weight) goes first."""

    name = "weighted-fair"
    dynamic = True

    def __init__(self, weights: dict[str, float] | None = None):
        self.weights = dict(weights or
                            {"priority": 4.0, "standard": 2.0,
                             "harvest": 1.0})

    def key(self, adm: Admission, served: dict[str, float]) -> tuple:
        """Virtual time (served / weight), rank + arrival tie-breaks."""
        w = self.weights.get(adm.tenant, 1.0)
        vtime = served.get(adm.tenant, 0.0) / max(w, 1e-9)
        return (vtime, _RANK[adm.tenant], adm.arrival, adm.workflow)


POLICIES: dict[str, type[AdmissionPolicy]] = {
    FCFS.name: FCFS,
    StrictPriority.name: StrictPriority,
    WeightedFair.name: WeightedFair,
}


def get_policy(policy: "str | AdmissionPolicy | None") -> AdmissionPolicy:
    """Normalize a policy name or instance (None -> FCFS)."""
    if policy is None:
        return FCFS()
    if isinstance(policy, AdmissionPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown admission policy {policy!r}; "
                         f"one of {sorted(POLICIES)}") from None


def validate_tenant(tenant: str) -> str:
    """Reject unknown tenant classes; returns the class unchanged."""
    if tenant not in TENANT_CLASSES:
        raise ValueError(f"unknown tenant class {tenant!r}; "
                         f"one of {TENANT_CLASSES}")
    return tenant


@dataclass
class ServedLedger:
    """Device-seconds served per tenant class (feeds weighted-fair).

    Preemption refunds charge negative device-seconds. With work-item
    checkpoint/resume (DESIGN.md §6.4) the refund is step-granular: the
    victim keeps the charge for its completed batch steps and is refunded
    the rest, so a resumed task's served total across attempts equals one
    clean run — virtual time under ``weighted-fair`` is not distorted by
    preemption. A refund never exceeds the task's original charge, so
    class totals stay non-negative (a hypothesis property in
    ``tests/test_checkpoint_resume.py``).
    """

    served: dict[str, float] = field(default_factory=dict)

    def charge(self, tenant: str, device_seconds: float):
        """Accrue served device-seconds (negative on preemption refunds)."""
        self.served[tenant] = self.served.get(tenant, 0.0) + device_seconds
