"""Full-fidelity object ⇄ JSON-document codecs for the apiserver wire
(copied from ``kubegpu_tpu/kubemeta/serialize.py``: the same documents,
field for field).

The annotation codec (codec.py) converts *payloads* that ride on
objects; this module converts the OBJECTS themselves — Pod/Node/Quota
with uid, resourceVersion, status, and spec intact — so the HTTP
apiserver façade (apiserver_http.py) can ship them between processes
losslessly.  Document shape follows k8s convention
(metadata/spec/status); the webhook's ExtenderArgs pod documents are a
compatible subset (webhook.pod_from_doc reads scheduler-relevant fields
only, by design — kube-scheduler strips status anyway).
"""

from __future__ import annotations

from kubegpu_tpu_torch.kubemeta.objects import (
    ContainerSpec,
    Node,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodPhase,
    PodSpec,
    PodStatus,
    Quota,
    QuotaSpec,
    ResourceRequests,
)


def _meta_to_doc(m: ObjectMeta) -> dict:
    return {
        "name": m.name,
        "namespace": m.namespace,
        "labels": dict(m.labels),
        "annotations": dict(m.annotations),
        "uid": m.uid,
        "resourceVersion": m.resource_version,
    }


def _meta_from_doc(d: dict) -> ObjectMeta:
    meta = ObjectMeta(
        name=d["name"],
        namespace=d.get("namespace", "default"),
        labels=dict(d.get("labels") or {}),
        annotations=dict(d.get("annotations") or {}),
    )
    # uid/rv are server-assigned; present on the wire for reads, absent
    # (and freshly generated / zero) on creates
    if d.get("uid"):
        meta.uid = d["uid"]
    meta.resource_version = int(d.get("resourceVersion", 0))
    return meta


def pod_to_doc(pod: Pod) -> dict:
    return {
        "kind": "Pod",
        "metadata": _meta_to_doc(pod.metadata),
        "spec": {
            "nodeName": pod.spec.node_name,
            "schedulerName": pod.spec.scheduler_name,
            "priority": pod.spec.priority,
            "containers": [
                {
                    "name": c.name,
                    "image": c.image,
                    "command": list(c.command),
                    "env": [{"name": k, "value": v}
                            for k, v in c.env.items()],
                    "resources": {"requests": c.resources.to_dict()},
                }
                for c in pod.spec.containers
            ],
        },
        "status": {
            "phase": pod.status.phase.value,
            "message": pod.status.message,
            "exitCode": pod.status.exit_code,
        },
    }


def pod_from_doc(doc: dict) -> Pod:
    spec = doc.get("spec") or {}
    status = doc.get("status") or {}
    containers = []
    for c in spec.get("containers") or []:
        requests = (c.get("resources") or {}).get("requests") or {}
        containers.append(ContainerSpec(
            name=c.get("name", "main"),
            image=c.get("image", "kubetpu/runtime:latest"),
            command=[str(x) for x in c.get("command") or []],
            env={e["name"]: str(e.get("value", ""))
                 for e in c.get("env") or []},
            resources=ResourceRequests.from_dict(
                {k: float(v) for k, v in requests.items()}),
        ))
    return Pod(
        metadata=_meta_from_doc(doc.get("metadata") or {}),
        spec=PodSpec(
            containers=containers,
            node_name=spec.get("nodeName"),
            scheduler_name=spec.get("schedulerName", "kubetpu-scheduler"),
            priority=int(spec.get("priority", 0)),
        ),
        status=PodStatus(
            phase=PodPhase(status.get("phase", "Pending")),
            message=status.get("message", ""),
            exit_code=status.get("exitCode"),
        ),
    )


def node_to_doc(node: Node) -> dict:
    return {
        "kind": "Node",
        "metadata": _meta_to_doc(node.metadata),
        "status": {"ready": node.status.ready},
    }


def node_from_doc(doc: dict) -> Node:
    status = doc.get("status") or {}
    return Node(
        metadata=_meta_from_doc(doc.get("metadata") or {}),
        status=NodeStatus(ready=bool(status.get("ready", True))),
    )


def quota_to_doc(quota: Quota) -> dict:
    return {
        "kind": "Quota",
        "metadata": _meta_to_doc(quota.metadata),
        "spec": {
            "tpuChips": quota.spec.tpu_chips,
            "millitpu": quota.spec.millitpu,
        },
    }


def quota_from_doc(doc: dict) -> Quota:
    spec = doc.get("spec") or {}
    return Quota(
        metadata=_meta_from_doc(doc.get("metadata") or {}),
        spec=QuotaSpec(
            tpu_chips=spec.get("tpuChips"),
            millitpu=spec.get("millitpu"),
        ),
    )


TO_DOC = {"Pod": pod_to_doc, "Node": node_to_doc, "Quota": quota_to_doc}
FROM_DOC = {"Pod": pod_from_doc, "Node": node_from_doc,
            "Quota": quota_from_doc}


def to_doc(kind: str, obj) -> dict:
    return TO_DOC[kind](obj)


def from_doc(kind: str, doc: dict):
    return FROM_DOC[kind](doc)
