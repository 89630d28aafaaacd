"""Metadata transport — reference: ``kubeinterface`` + the k8s apiserver
(copied from ``kubegpu_tpu/kubemeta``).

Scheduler and node agent never talk directly: all coordination rides on
Node/Pod annotations through the apiserver.  ``objects`` are k8s-shaped
dataclasses, ``codec`` converts advertisement / request / allocation structs
⇄ annotation JSON, and ``controlplane`` is the in-process fake apiserver
(create/get/list/patch/delete/watch).  The reference's HTTP apiserver and
its wire serializer are not ported yet (ROADMAP: the daemons).
"""

from kubegpu_tpu_torch.kubemeta.objects import (
    ContainerSpec,
    GangSpec,
    Node,
    ObjectMeta,
    Pod,
    PodPhase,
    PodSpec,
    Quota,
    QuotaSpec,
    ResourceRequests,
)
from kubegpu_tpu_torch.kubemeta.codec import (
    ALLOCATE_FROM_KEY,
    DEVICE_INFO_KEY,
    GANG_KEY,
    MESH_AXES_KEY,
    AllocatedChip,
    Allocation,
    advertise_on_node,
    allocation_from_annotation,
    allocation_to_annotation,
    node_advertisement,
    node_advertisement_from_annotation,
    node_advertisement_to_annotation,
    pod_allocation,
    pod_gang_spec,
    pod_mesh_axes,
    pod_migratable,
    pod_multislice,
    set_pod_allocation,
    set_pod_gang,
    set_pod_mesh_axes,
    set_pod_migratable,
    set_pod_multislice,
)
from kubegpu_tpu_torch.kubemeta.controlplane import (
    Conflict,
    FakeApiServer,
    NotFound,
    WatchEvent,
)

__all__ = [
    "ContainerSpec", "GangSpec", "Node", "ObjectMeta", "Pod", "PodPhase",
    "PodSpec", "Quota", "QuotaSpec", "ResourceRequests",
    "ALLOCATE_FROM_KEY", "DEVICE_INFO_KEY", "GANG_KEY", "MESH_AXES_KEY",
    "AllocatedChip", "Allocation", "advertise_on_node",
    "allocation_from_annotation", "allocation_to_annotation",
    "node_advertisement", "node_advertisement_from_annotation",
    "node_advertisement_to_annotation", "pod_allocation", "pod_gang_spec",
    "pod_mesh_axes", "pod_migratable", "pod_multislice",
    "set_pod_allocation", "set_pod_migratable",
    "set_pod_gang", "set_pod_mesh_axes", "set_pod_multislice",
    "Conflict", "FakeApiServer", "NotFound", "WatchEvent",
]
