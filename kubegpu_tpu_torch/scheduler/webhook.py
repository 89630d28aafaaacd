"""HTTP scheduler-extender service — the wire-level parity piece (copied
from ``kubegpu_tpu/scheduler/webhook.py``: the same verbs and bodies).

The reference's device-scheduler is an HTTP webhook kube-scheduler calls
per pod via its policy config (SURVEY.md §3 "Scheduler extender service":
``/filter`` predicate, ``/prioritize`` 0-10 scores, bind-time allocation
write-back per §4.2; §6 config row: ``extenders: [{urlPrefix,
filterVerb, prioritizeVerb, bindVerb, weight}]``).  This module serves
that API over the in-process :class:`DeviceScheduler`, speaking the k8s
``ExtenderArgs``/``ExtenderFilterResult``/``ExtenderBindingArgs`` JSON
shapes.

Request/response wire format (k8s.io/kubernetes/pkg/scheduler/api):

    POST <prefix>/filter      {"Pod": {...}, "NodeNames": [...]}
      → {"NodeNames": [...], "FailedNodes": {node: reason}, "Error": ""}
    POST <prefix>/prioritize  {"Pod": {...}, "NodeNames": [...]}
      → [{"Host": node, "Score": 0-10}, ...]   (HostPriorityList)
    POST <prefix>/bind        {"PodName", "PodNamespace", "PodUID", "Node"}
      → {"Error": ""}        (fills AllocateFrom + PATCHes the pod
                              annotation + binds — SURVEY.md §4.2)

The Pod document carries the same fields the annotation codec uses
(metadata.annotations for gang/mesh-axes/multislice, spec container
resources) — :func:`pod_from_doc` rebuilds the internal Pod.

What the wire verbs guarantee vs the in-process loop
----------------------------------------------------
A real kube-scheduler driving filter→prioritize→bind gets: per-node
feasibility/scoring, bind-time allocation write-back, namespace quota
gating, and GANG atomicity via hold-and-assume (all members' /filter
fail with "gang waiting (k/n)" until the gang is complete — the
scheduler's retry loop is the arrival barrier, as in the coscheduling
plugin — then one whole-gang placement steers every member).  What needs
the in-process ``run_once()`` loop instead: cross-gang FIFO fairness +
queue-seniority, priority preemption, conservative backfill, migration
defragmentation, and fault-driven eviction (a vanilla kube-scheduler
owns preemption itself and offers the extender no hook).  An abandoned
wire assumption (members never bound) expires after the gang grace and
its unbound chips are released.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubegpu_tpu_torch.kubemeta.objects import (
    ContainerSpec,
    ObjectMeta,
    Pod,
    PodSpec,
    ResourceRequests,
)
from kubegpu_tpu_torch.kubemeta.apiserver_http import POLL_S
from kubegpu_tpu_torch.obs import get_logger
from kubegpu_tpu_torch.scheduler.extender import DeviceScheduler

log = get_logger("webhook")


def pod_from_doc(doc: dict) -> Pod:
    """k8s Pod JSON → internal Pod (the fields the scheduler reads)."""
    meta = doc.get("metadata") or {}
    spec = doc.get("spec") or {}
    containers = []
    for c in spec.get("containers") or []:
        requests = ((c.get("resources") or {}).get("requests")
                    or (c.get("resources") or {}).get("limits") or {})
        containers.append(ContainerSpec(
            name=c.get("name", "main"),
            command=[str(x) for x in c.get("command") or []],
            env={e["name"]: str(e.get("value", ""))
                 for e in c.get("env") or []},
            resources=ResourceRequests.from_dict(
                {k: float(v) for k, v in requests.items()
                 if k.startswith("kubetpu.io/")}),
        ))
    return Pod(
        metadata=ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            labels=dict(meta.get("labels") or {}),
            annotations=dict(meta.get("annotations") or {}),
        ),
        spec=PodSpec(containers=containers,
                     priority=int(spec.get("priority", 0))),
    )


def pod_to_doc(pod: Pod) -> dict:
    """Internal Pod → k8s Pod JSON (round-trip for tests/clients)."""
    return {
        "metadata": {
            "name": pod.metadata.name,
            "namespace": pod.metadata.namespace,
            "labels": dict(pod.metadata.labels),
            "annotations": dict(pod.metadata.annotations),
        },
        "spec": {
            "priority": pod.spec.priority,
            "containers": [
                {
                    "name": c.name,
                    "command": list(c.command),
                    "env": [{"name": k, "value": v}
                            for k, v in c.env.items()],
                    "resources": {"requests": {
                        k: str(v) for k, v in c.resources.to_dict().items()
                    }},
                }
                for c in pod.spec.containers
            ],
        },
    }


class ExtenderService:
    """The verb layer: ExtenderArgs JSON in, extender results out."""

    def __init__(self, scheduler: DeviceScheduler):
        self.scheduler = scheduler

    def filter(self, args: dict) -> dict:
        pod = pod_from_doc(args.get("Pod") or {})
        node_names = list(args.get("NodeNames") or [])
        feasible, reasons = self.scheduler.filter(pod, node_names)
        return {"NodeNames": feasible, "FailedNodes": reasons, "Error": ""}

    def prioritize(self, args: dict) -> list[dict]:
        pod = pod_from_doc(args.get("Pod") or {})
        node_names = list(args.get("NodeNames") or [])
        scores = self.scheduler.prioritize(pod, node_names)
        return [{"Host": n, "Score": int(round(scores.get(n, 0.0)))}
                for n in node_names]

    def bind(self, args: dict) -> dict:
        """ExtenderBindingArgs → ExtenderBindingResult."""
        err = self.scheduler.bind(
            str(args.get("PodName") or ""),
            str(args.get("Node") or ""),
            namespace=str(args.get("PodNamespace") or "default"))
        return {"Error": err or ""}


class ExtenderHTTPServer:
    """ThreadingHTTPServer wrapper: start() binds and serves in a daemon
    thread, close() shuts down.  ``prefix`` mirrors the kube-scheduler
    policy-config ``urlPrefix``."""

    def __init__(self, scheduler: DeviceScheduler, host: str = "127.0.0.1",
                 port: int = 0, prefix: str = "/kubetpu"):
        service = ExtenderService(scheduler)
        prefix = prefix.rstrip("/")

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet; we log structured below
                pass

            def do_GET(self) -> None:
                if self.path.split("?", 1)[0] != "/metrics":
                    self.send_error(404, f"unknown path {self.path}")
                    return
                # Prometheus scrape surface: the schedule-latency
                # summary here IS north-star metric #1
                reg = getattr(scheduler, "metrics", None)
                body = (reg.to_prometheus() if reg is not None
                        else "").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self) -> None:
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    args = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == f"{prefix}/filter":
                        out = service.filter(args)
                    elif self.path == f"{prefix}/prioritize":
                        out = service.prioritize(args)
                    elif self.path == f"{prefix}/bind":
                        out = service.bind(args)
                    else:
                        self.send_error(404, f"unknown verb {self.path}")
                        return
                except Exception as e:
                    log.error("verb_failed", path=self.path, error=str(e))
                    if self.path == f"{prefix}/filter":
                        # filter's contract carries an Error field
                        out = {"NodeNames": [], "FailedNodes": {},
                               "Error": str(e)}
                    elif self.path == f"{prefix}/bind":
                        out = {"Error": str(e)}
                    else:
                        # prioritize's contract is a bare HostPriorityList
                        # (no Error slot) — signal failure at HTTP level
                        self.send_error(500, str(e))
                        return
                body = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ExtenderHTTPServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, args=(POLL_S,), daemon=True)
        self._thread.start()
        log.info("listening", address=self.address)
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def policy_config(extender_url: str, weight: int = 10) -> dict:
    """The kube-scheduler policy-config stanza registering this extender
    (SURVEY.md §6 config row) — what a real deployment drops into
    ``--policy-config-file``."""
    return {
        "kind": "Policy",
        "apiVersion": "v1",
        "extenders": [{
            "urlPrefix": f"{extender_url}/kubetpu",
            "filterVerb": "filter",
            "prioritizeVerb": "prioritize",
            "bindVerb": "bind",
            "weight": weight,
            "enableHttps": False,
            # nodeCacheCapable=true ⇒ kube-scheduler sends/accepts
            # NodeNames (the forms this service speaks) instead of full
            # Node objects
            "nodeCacheCapable": True,
        }],
    }
