"""Metadata transport — reference: ``kubeinterface`` + the k8s apiserver
(copied from ``kubegpu_tpu/kubemeta``).

Scheduler and node agent never talk directly: all coordination rides on
Node/Pod annotations through the apiserver.  ``objects`` are k8s-shaped
dataclasses, ``codec`` converts advertisement / request / allocation structs
⇄ annotation JSON, and ``controlplane`` is the in-process fake apiserver
(create/get/list/patch/delete/watch).  On the wire: ``serialize`` turns the
objects into the reference's JSON documents, ``apiserver_http`` serves a
``FakeApiServer`` over HTTP (``ApiServerHTTP``) and reads it back with the
same method surface (``HttpApiClient``), ``apiserver_serve`` is that
server as its own process, and ``cache`` the scheduler's watch-fed read
cache.
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
from kubegpu_tpu_torch.kubemeta.apiserver_http import (
    ApiServerHTTP,
    HttpApiClient,
)
from kubegpu_tpu_torch.kubemeta.serialize import from_doc, to_doc

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
    "ApiServerHTTP", "HttpApiClient", "from_doc", "to_doc",
]
