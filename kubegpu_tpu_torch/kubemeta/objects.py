"""K8s-shaped object model — reference: ``types/types.go`` (SURVEY.md §3).
Copied from ``kubegpu_tpu/kubemeta/objects.py``.

The reference's ``NodeInfo{Capacity, Allocatable, Used}`` /
``PodInfo{DevRequests, AllocateFrom}`` become: Node objects carrying the
topology advertisement annotation, Pod objects carrying device requests
(``kubetpu.io/tpu-chips`` whole chips, ``kubetpu.io/millitpu`` fractional —
the reference's hierarchical ``alpha.gpu/...`` names flatten to these two
because the mesh is explicit, not path-encoded).
"""

from __future__ import annotations

import enum
import uuid
from dataclasses import dataclass, field

# Resource names (user surface, pod spec `resources`):
RES_TPU_CHIPS = "kubetpu.io/tpu-chips"     # whole chips per container
RES_MILLITPU = "kubetpu.io/millitpu"       # fractional chip, 1000 = 1 chip
RES_HBM_GIB = "kubetpu.io/hbm-gib"         # min HBM per allocated chip


class PodPhase(str, enum.Enum):
    PENDING = "Pending"
    SCHEDULED = "Scheduled"   # bound to a node, not yet started
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclass
class ObjectMeta:
    name: str
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    # globally unique, not a per-process counter: uids cross process
    # boundaries on the apiserver wire, and the uid-incarnation guards
    # (set_pod_phase expect_uid, NodeAgent.reconcile, CRI create) must
    # never confuse two processes' counters for the same incarnation
    uid: str = field(
        default_factory=lambda: f"uid-{uuid.uuid4().hex[:16]}")
    resource_version: int = 0

    def clone(self) -> "ObjectMeta":
        return ObjectMeta(name=self.name, namespace=self.namespace,
                          labels=dict(self.labels),
                          annotations=dict(self.annotations),
                          uid=self.uid,
                          resource_version=self.resource_version)


@dataclass
class ResourceRequests:
    """Per-container device ask — reference: ``ContainerInfo.DevRequests``."""

    tpu_chips: int = 0
    millitpu: int = 0  # fractional ask; mutually exclusive with tpu_chips
    # Minimum HBM (GiB) each allocated chip must advertise — the per-chip
    # capacity dimension beyond chip count (reference tracked per-device
    # memory in its capacity lists, SURVEY.md §3 NodeInfo{Capacity}).
    # 0 = no requirement.
    hbm_gib: float = 0.0

    def __post_init__(self) -> None:
        if self.tpu_chips and self.millitpu:
            raise ValueError("request either whole tpu-chips or millitpu, not both")
        if self.tpu_chips < 0 or self.millitpu < 0 or self.hbm_gib < 0:
            raise ValueError("negative device request")

    def to_dict(self) -> dict[str, float]:
        out: dict[str, float] = {}
        if self.tpu_chips:
            out[RES_TPU_CHIPS] = self.tpu_chips
        if self.millitpu:
            out[RES_MILLITPU] = self.millitpu
        if self.hbm_gib:
            out[RES_HBM_GIB] = self.hbm_gib
        return out

    @classmethod
    def from_dict(cls, d: dict[str, float]) -> "ResourceRequests":
        return cls(tpu_chips=int(d.get(RES_TPU_CHIPS, 0)),
                   millitpu=int(d.get(RES_MILLITPU, 0)),
                   hbm_gib=float(d.get(RES_HBM_GIB, 0.0)))


@dataclass
class ContainerSpec:
    name: str
    command: list[str] = field(default_factory=list)
    image: str = "kubetpu/runtime:latest"
    env: dict[str, str] = field(default_factory=dict)
    resources: ResourceRequests = field(default_factory=ResourceRequests)

    def clone(self) -> "ContainerSpec":
        return ContainerSpec(
            name=self.name, command=list(self.command), image=self.image,
            env=dict(self.env),
            resources=ResourceRequests(tpu_chips=self.resources.tpu_chips,
                                       millitpu=self.resources.millitpu,
                                       hbm_gib=self.resources.hbm_gib))


@dataclass
class GangSpec:
    """Gang (co-scheduling) membership — the BASELINE extension of the
    reference's per-pod group allocation to multi-pod jobs (SURVEY.md §1
    item 3): all ``size`` pods of ``name`` place atomically or not at all.
    """

    name: str
    size: int
    index: int  # this pod's rank in the gang (drives TPU_WORKER_ID)

    def __post_init__(self) -> None:
        if not 0 <= self.index < self.size:
            raise ValueError(f"gang index {self.index} not in [0,{self.size})")


@dataclass
class PodSpec:
    containers: list[ContainerSpec] = field(default_factory=list)
    node_name: str | None = None   # set at bind time
    scheduler_name: str = "kubetpu-scheduler"
    # k8s pod.spec.priority equivalent: higher schedules first and may
    # preempt committed lower-priority gangs (gang priority = max member)
    priority: int = 0

    @property
    def total_chips(self) -> int:
        return sum(c.resources.tpu_chips for c in self.containers)

    @property
    def total_millitpu(self) -> int:
        return sum(c.resources.millitpu for c in self.containers)

    @property
    def max_hbm_gib(self) -> float:
        """The pod's per-chip HBM floor: every allocated chip must
        advertise at least the strictest container's requirement."""
        return max((c.resources.hbm_gib for c in self.containers),
                   default=0.0)

    def clone(self) -> "PodSpec":
        return PodSpec(containers=[c.clone() for c in self.containers],
                       node_name=self.node_name,
                       scheduler_name=self.scheduler_name,
                       priority=self.priority)


@dataclass
class PodStatus:
    phase: PodPhase = PodPhase.PENDING
    message: str = ""
    exit_code: int | None = None


@dataclass
class Pod:
    metadata: ObjectMeta
    spec: PodSpec
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    def clone(self) -> "Pod":
        """Structural deep copy — hand-rolled because the fake apiserver
        copies on every read/notify and ``copy.deepcopy``'s generic memo
        machinery dominated the control-plane profile (87% of step())."""
        return Pod(metadata=self.metadata.clone(), spec=self.spec.clone(),
                   status=PodStatus(phase=self.status.phase,
                                    message=self.status.message,
                                    exit_code=self.status.exit_code))


@dataclass
class QuotaSpec:
    """Namespace device budget — k8s ResourceQuota parity for the two
    TPU resources.  ``None`` = unlimited for that resource."""
    tpu_chips: int | None = None
    millitpu: int | None = None


@dataclass
class Quota:
    """Namespaced quota object (one per namespace; the apiserver keys by
    namespace/name, conventionally name='quota')."""
    metadata: ObjectMeta
    spec: QuotaSpec = field(default_factory=QuotaSpec)

    @property
    def name(self) -> str:
        return self.metadata.name

    def clone(self) -> "Quota":
        return Quota(metadata=self.metadata.clone(),
                     spec=QuotaSpec(tpu_chips=self.spec.tpu_chips,
                                    millitpu=self.spec.millitpu))


@dataclass
class NodeStatus:
    ready: bool = True


@dataclass
class Node:
    metadata: ObjectMeta
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    def clone(self) -> "Node":
        return Node(metadata=self.metadata.clone(),
                    status=NodeStatus(ready=self.status.ready))
