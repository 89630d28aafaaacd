"""Annotation codec — reference: ``kubeinterface/kubeinterface.go``.
Copied from ``kubegpu_tpu/kubemeta/codec.py``; a node's advertisement also
carries the switched flag and each card's UUID, each written only where
set.  A reference slice is not switched, so its annotation is the
reference's but for each chip's ``uuid`` (the mock backend gives every
chip one).

Bidirectional conversion between internal structs and annotation JSON
(SURVEY.md §3: ``NodeInfoToAnnotation`` / ``AnnotationToNodeInfo`` /
``PodInfoToAnnotation``).  Annotation keys mirror the reference's
``node.alpha/DeviceInformation`` / ``pod.alpha/DeviceInformation`` naming.

Annotations — not in-memory state — are the source of truth: the scheduler
rebuilds its cache from them after restart (SURVEY.md §4.4 correctness
subtlety), so every field the scheduler needs must round-trip losslessly.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from kubegpu_tpu_torch.kubemeta.objects import GangSpec, Node, Pod
from kubegpu_tpu_torch.topology.mesh import Coord
from kubegpu_tpu_torch.tpuplugin.backend import ChipAdvertisement, NodeAdvertisement

DEVICE_INFO_KEY = "node.alpha.kubetpu/device-information"
ALLOCATE_FROM_KEY = "pod.alpha.kubetpu/allocate-from"
GANG_KEY = "pod.alpha.kubetpu/gang"
MESH_AXES_KEY = "pod.alpha.kubetpu/mesh-axes"
# workload kind ("training" default | "serving"): serving gangs carry
# a different traffic model — tp psums every decode step, dp replicas
# never talk — so the scheduler scores their slices with serving axis
# weights instead of the training defaults
WORKLOAD_KIND_KEY = "pod.alpha.kubetpu/workload-kind"
# serving role ("prefill" | "decode") on a DISAGGREGATED serving gang:
# prefill replicas are throughput-bound batch engines off the token
# feedback path, decode replicas are latency-bound — placement scores
# their slices with role-adjusted serving weights
SERVE_ROLE_KEY = "pod.alpha.kubetpu/serve-role"
MULTISLICE_KEY = "pod.alpha.kubetpu/multislice"
MIGRATABLE_KEY = "pod.alpha.kubetpu/migratable"
# original queue position of an evicted+requeued pod: eviction (fault,
# preemption, migration) must not cost a gang its FIFO seniority, or any
# equal-priority pending unit could steal the home a migration plan
# proved for it
QUEUED_AT_KEY = "pod.alpha.kubetpu/queued-at"
# a MIGRATED gang's reserved re-ask (serialized GangRequest): persisted
# on the requeued pods so a scheduler restart between migration-eviction
# and re-placement cannot drop the what-if home protection (annotation
# truth, like everything else); cleared when the gang re-places
MIGRATION_DEBT_KEY = "pod.alpha.kubetpu/migration-debt"


# ---------------------------------------------------------------------------
# Node advertisement ⇄ annotation
# ---------------------------------------------------------------------------

def node_advertisement_to_annotation(adv: NodeAdvertisement) -> str:
    doc = {
        "nodeName": adv.node_name,
        "sliceId": adv.slice_id,
        "sliceType": adv.slice_type,
        "hostId": adv.host_id,
        "meshShape": list(adv.mesh_shape),
        "wrap": list(adv.wrap),
        "hostBlock": list(adv.host_block),
        "internalIp": adv.internal_ip,
        "badLinks": [[list(a), list(b)] for a, b in adv.bad_links],
        "chips": [
            {
                "coord": list(c.coord),
                "localIndex": c.local_index,
                "millichips": c.millichips,
                "hbmGib": c.hbm_gib,
                "healthy": c.healthy,
                **({"uuid": c.uuid} if c.uuid else {}),
            }
            for c in adv.chips
        ],
    }
    if adv.switched:
        doc["switched"] = True
    return json.dumps(doc, sort_keys=True)


def node_advertisement_from_annotation(payload: str) -> NodeAdvertisement:
    d = json.loads(payload)
    return NodeAdvertisement(
        node_name=d["nodeName"],
        slice_id=d["sliceId"],
        slice_type=d["sliceType"],
        host_id=d["hostId"],
        mesh_shape=tuple(d["meshShape"]),
        wrap=tuple(bool(w) for w in d["wrap"]),
        host_block=tuple(d["hostBlock"]),
        internal_ip=d.get("internalIp", "127.0.0.1"),
        bad_links=tuple(
            (tuple(a), tuple(b)) for a, b in d.get("badLinks", [])),
        chips=tuple(
            ChipAdvertisement(
                coord=tuple(c["coord"]),
                local_index=c["localIndex"],
                millichips=c["millichips"],
                hbm_gib=c["hbmGib"],
                healthy=c.get("healthy", True),
                uuid=c.get("uuid", ""),
            )
            for c in d["chips"]
        ),
        switched=bool(d.get("switched", False)),
    )


def advertise_on_node(node: Node, adv: NodeAdvertisement) -> None:
    node.metadata.annotations[DEVICE_INFO_KEY] = \
        node_advertisement_to_annotation(adv)


def node_advertisement(node: Node) -> NodeAdvertisement | None:
    payload = node.metadata.annotations.get(DEVICE_INFO_KEY)
    return node_advertisement_from_annotation(payload) if payload else None


# ---------------------------------------------------------------------------
# Allocation (AllocateFrom) ⇄ pod annotation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AllocatedChip:
    coord: Coord
    local_index: int
    millichips: int  # how much of the chip this pod holds


@dataclass
class Allocation:
    """The scheduler's concrete decision for one pod — reference:
    ``ContainerInfo.AllocateFrom`` (requested resource → device path),
    written back as a pod annotation at bind time (SURVEY.md §4.2) and read
    by the crishim at container-create time (SURVEY.md §4.3).
    """

    node_name: str
    slice_id: str
    chips: list[AllocatedChip] = field(default_factory=list)
    worker_id: int = 0
    num_workers: int = 1
    coordinator_address: str = ""
    worker_hostnames: list[str] = field(default_factory=list)
    gang_name: str = ""


def allocation_to_annotation(alloc: Allocation) -> str:
    return json.dumps({
        "nodeName": alloc.node_name,
        "sliceId": alloc.slice_id,
        "chips": [
            {"coord": list(c.coord), "localIndex": c.local_index,
             "millichips": c.millichips}
            for c in alloc.chips
        ],
        "workerId": alloc.worker_id,
        "numWorkers": alloc.num_workers,
        "coordinatorAddress": alloc.coordinator_address,
        "workerHostnames": alloc.worker_hostnames,
        "gangName": alloc.gang_name,
    }, sort_keys=True)


def allocation_from_annotation(payload: str) -> Allocation:
    d = json.loads(payload)
    return Allocation(
        node_name=d["nodeName"],
        slice_id=d["sliceId"],
        chips=[
            AllocatedChip(coord=tuple(c["coord"]),
                          local_index=c["localIndex"],
                          millichips=c["millichips"])
            for c in d["chips"]
        ],
        worker_id=d["workerId"],
        num_workers=d["numWorkers"],
        coordinator_address=d.get("coordinatorAddress", ""),
        worker_hostnames=list(d.get("workerHostnames", [])),
        gang_name=d.get("gangName", ""),
    )


def set_pod_allocation(pod: Pod, alloc: Allocation) -> None:
    pod.metadata.annotations[ALLOCATE_FROM_KEY] = \
        allocation_to_annotation(alloc)


def pod_allocation(pod: Pod) -> Allocation | None:
    payload = pod.metadata.annotations.get(ALLOCATE_FROM_KEY)
    return allocation_from_annotation(payload) if payload else None


# ---------------------------------------------------------------------------
# Gang + mesh-axes pod annotations
# ---------------------------------------------------------------------------

def set_pod_gang(pod: Pod, gang: GangSpec) -> None:
    pod.metadata.annotations[GANG_KEY] = json.dumps(
        {"name": gang.name, "size": gang.size, "index": gang.index})


def pod_gang_spec(pod: Pod) -> GangSpec | None:
    payload = pod.metadata.annotations.get(GANG_KEY)
    if not payload:
        return None
    d = json.loads(payload)
    return GangSpec(name=d["name"], size=d["size"], index=d["index"])


def set_pod_mesh_axes(pod: Pod, axes: dict[str, int]) -> None:
    """Declares the workload's logical parallelism axes (ordered), e.g.
    ``{"dp": 4, "tp": 4}`` — the scheduler's topology-scoring derives the
    traffic model from this (SURVEY.md §8 "Honest locality measurement").
    """
    pod.metadata.annotations[MESH_AXES_KEY] = json.dumps(list(axes.items()))


def pod_mesh_axes(pod: Pod) -> dict[str, int] | None:
    payload = pod.metadata.annotations.get(MESH_AXES_KEY)
    if not payload:
        return None
    return dict((k, int(v)) for k, v in json.loads(payload))


def set_pod_workload_kind(pod: Pod, kind: str) -> None:
    """Declare the workload kind driving the traffic model ("training"
    is the implicit default; "serving" switches topology scoring to
    serving axis weights — tp hot, dp-replica hops nearly free)."""
    if kind not in ("training", "serving"):
        raise ValueError(f"unknown workload kind {kind!r}")
    pod.metadata.annotations[WORKLOAD_KIND_KEY] = kind


def pod_workload_kind(pod: Pod) -> str:
    return pod.metadata.annotations.get(WORKLOAD_KIND_KEY, "training")


def set_pod_serve_role(pod: Pod, role: str) -> None:
    """Annotate a serving pod with its disaggregated role: "prefill"
    replicas run chunked prefill and export KV page chains, "decode"
    replicas adopt them and stream tokens.  Placement reads the role
    through :func:`pod_serve_role` to pick role-aware axis weights."""
    if role not in ("prefill", "decode"):
        raise ValueError(f"unknown serve role {role!r}")
    pod.metadata.annotations[SERVE_ROLE_KEY] = role


def pod_serve_role(pod: Pod) -> str | None:
    """The pod's disaggregated serving role, or None on a symmetric
    (or non-serving) pod."""
    return pod.metadata.annotations.get(SERVE_ROLE_KEY)


def set_pod_migratable(pod: Pod, allowed: bool = True) -> None:
    """Mark the pod's gang as migratable: the scheduler may evict and
    requeue it (checkpoint/resume semantics, like fault recovery) to
    defragment space for an otherwise-unplaceable gang."""
    if allowed:
        pod.metadata.annotations[MIGRATABLE_KEY] = "true"
    else:
        pod.metadata.annotations.pop(MIGRATABLE_KEY, None)


def pod_migratable(pod: Pod) -> bool:
    return pod.metadata.annotations.get(MIGRATABLE_KEY) == "true"


def set_pod_multislice(pod: Pod, allowed: bool = True) -> None:
    """Opt the pod's gang into DCN-spanning placement: when no single
    slice fits, the outermost mesh axis may partition across slices."""
    if allowed:
        pod.metadata.annotations[MULTISLICE_KEY] = "true"
    else:
        pod.metadata.annotations.pop(MULTISLICE_KEY, None)


def pod_multislice(pod: Pod) -> bool:
    return pod.metadata.annotations.get(MULTISLICE_KEY) == "true"


def migration_debt_to_annotation(req: "GangRequest") -> str:
    """Serialize a migrated gang's reserved re-ask (``MIGRATION_DEBT_KEY``
    payload).  Lives here with every other annotation codec so the wire
    format has one home; ``GangRequest`` is imported lazily because the
    allocator itself imports this module."""
    return json.dumps({
        "numPods": req.num_pods,
        "chipsPerPod": req.chips_per_pod,
        "millitpuPerPod": req.millitpu_per_pod,
        "hbmGibPerChip": req.hbm_gib_per_chip,
        "meshAxes": (list(req.mesh_axes.items())
                     if req.mesh_axes else None),
        "allowMultislice": req.allow_multislice,
    }, sort_keys=True)


def migration_debt_from_annotation(gang_key: str,
                                   payload: str) -> "GangRequest | None":
    from kubegpu_tpu_torch.allocator.gang import GangRequest

    try:
        d = json.loads(payload)
        return GangRequest(
            gang_name=gang_key,
            num_pods=int(d["numPods"]),
            chips_per_pod=int(d["chipsPerPod"]),
            millitpu_per_pod=int(d.get("millitpuPerPod", 0)),
            hbm_gib_per_chip=float(d.get("hbmGibPerChip", 0.0)),
            mesh_axes=dict((k, int(v)) for k, v in d["meshAxes"])
            if d.get("meshAxes") else None,
            allow_multislice=bool(d.get("allowMultislice", False)))
    except (ValueError, KeyError, TypeError):
        return None   # malformed debt: drop the reservation, not the pod
