"""Node agent: advertiser + kubelet-ish pod lifecycle (copied from
``kubegpu_tpu/crishim/agent.py``).

Reference parity: the ``kubeadvertise`` loop PATCHing the Node object
(SURVEY.md §4.1) plus the kubelet role in §4.3 (seeing pods bound to this
node and calling the CRI).  One agent per (simulated) TPU host VM.
"""

from __future__ import annotations

import json
import math

from kubegpu_tpu_torch.crishim.runtime import ContainerHandle, ContainerRuntime
from kubegpu_tpu_torch.crishim.shim import CriError, CriShim
from kubegpu_tpu_torch.kubemeta import (
    FakeApiServer,
    Node,
    NotFound,
    ObjectMeta,
    PodPhase,
)
from kubegpu_tpu_torch.kubemeta.codec import (
    DEVICE_INFO_KEY,
    node_advertisement_to_annotation,
)
from kubegpu_tpu_torch.obs import MetricsRegistry, get_logger
from kubegpu_tpu_torch.tpuplugin.backend import DeviceBackend

log = get_logger("nodeagent")


def harvest_workload_metrics(stdout: str, metrics: MetricsRegistry,
                             pod_name: str = "") -> list[str]:
    """Scan a finished container's stdout for metric lines — any line
    that parses as JSON with numeric ``metric``/``value`` fields (the
    convention the workload programs print, e.g. the allreduce
    microbenchmark's ``allreduce_algo_bandwidth``) — and feed them into
    the cluster metrics registry as ``workload_<metric>`` observations
    + gauges.  This is how north-star metric #2 lands in
    ``metrics.snapshot()`` instead of dying in a process log."""
    seen: list[str] = []
    for line in stdout.splitlines():
        line = line.strip()
        if not (line.startswith("{") and '"metric"' in line):
            continue
        try:
            doc = json.loads(line)
            name = str(doc["metric"])
            value = float(doc["value"])
        except (ValueError, KeyError, TypeError):
            continue
        if not math.isfinite(value):
            continue   # a NaN would poison the whole histogram

        metrics.observe(f"workload_{name}", value)
        metrics.set_gauge(f"workload_{name}", value)
        seen.append(name)
    return seen


class NodeAgent:
    def __init__(self, api: FakeApiServer, backend: DeviceBackend,
                 runtime: ContainerRuntime,
                 metrics: MetricsRegistry | None = None,
                 shim=None):
        self.api = api
        self.backend = backend
        self.adv = backend.discover()
        self.node_name = self.adv.node_name
        self.runtime = runtime
        self.metrics = metrics
        # shim override: a RemoteCriShim here sends every container call
        # over the CRI unix socket (criserver.py) instead of in-process —
        # the kubelet→crishim transport of the reference (SURVEY.md §4.3)
        self.shim = shim if shim is not None else CriShim(
            api, backend, self.node_name, runtime)
        self.handles: dict[str, ContainerHandle] = {}  # pod name → handle
        self._uids: dict[str, str] = {}  # pod name → uid of the incarnation
        self._ns: dict[str, str] = {}    # pod name → namespace
        self.down = False  # host failure: agent stops heartbeating/acting

    # -- advertisement (SURVEY.md §4.1) ---------------------------------

    def register(self) -> None:
        """Create the Node object if needed, then advertise capacity +
        topology as an annotation."""
        try:
            self.api.get("Node", self.node_name)
        except NotFound:
            self.api.create("Node", Node(
                metadata=ObjectMeta(name=self.node_name)))
        self.advertise()

    def advertise(self) -> None:
        self.adv = self.backend.discover()  # re-enumerate (health may change)
        self.api.patch_annotations(
            "Node", self.node_name,
            {DEVICE_INFO_KEY: node_advertisement_to_annotation(self.adv)})

    # -- pod lifecycle (SURVEY.md §4.3) ---------------------------------

    # -- failure injection (simulated machine death) --------------------

    def fail(self) -> None:
        """The host dies: containers are gone, the agent stops acting.
        (The node controller flips Node.ready separately, as in k8s.)"""
        self.down = True
        for h in self.handles.values():
            h.kill()
        self.handles.clear()
        self._uids.clear()
        self._ns.clear()

    def restore(self) -> None:
        """Host comes back: re-register + re-advertise fresh health."""
        self.down = False
        self.register()

    # -- reconcile ------------------------------------------------------

    def reconcile(self) -> None:
        """Kill containers whose pod was deleted/evicted (kubelet's
        pod-worker teardown when the apiserver drops a pod it runs).
        Incarnations are matched by uid, not name: an evicted gang member
        recreated with the same name and re-bound to this node is a NEW
        pod — the old container (stale chip set/coordinator env) must die
        or the recovered gang can never form its jax.distributed barrier."""
        for pod_name in list(self.handles):
            try:
                pod = self.api.get("Pod", pod_name,
                                   namespace=self._ns.get(pod_name, "default"))
                gone = (pod.spec.node_name != self.node_name
                        or pod.metadata.uid != self._uids.get(pod_name))
            except NotFound:
                gone = True
            if gone:
                self.handles.pop(pod_name).kill()
                self._uids.pop(pod_name, None)
                self._ns.pop(pod_name, None)

    def run_once(self) -> list[ContainerHandle]:
        """Start containers for pods newly bound to this node."""
        if self.down:
            return []
        self.reconcile()
        started: list[ContainerHandle] = []
        for pod in self.api.list("Pod", node_name=self.node_name,
                                 phase=PodPhase.SCHEDULED):
            if pod.name not in self.handles:
                try:
                    handle = self.shim.create_container(pod)
                except CriError as e:
                    # over the CRI wire the server re-fetches the pod, so
                    # a delete/evict+recreate racing this pass surfaces
                    # here (pod gone / uid mismatch): skip this pod — the
                    # next pass sees the new incarnation — and never abort
                    # the other pods' starts (mirrors the NotFound catch
                    # on the phase write below).  Logged loudly because
                    # the same frame also carries non-transient server
                    # errors (e.g. wrong-node allocation): a pod stuck
                    # SCHEDULED shows why here instead of failing silently.
                    log.warning("create_container_failed", pod=pod.name,
                                node=self.node_name, error=str(e))
                    continue
                self.handles[pod.name] = handle
                self._uids[pod.name] = pod.metadata.uid
                self._ns[pod.name] = pod.metadata.namespace
                try:
                    self.api.set_pod_phase(pod.name, PodPhase.RUNNING,
                                           namespace=pod.metadata.namespace,
                                           expect_uid=pod.metadata.uid)
                except NotFound:
                    # pod deleted (or evicted+recreated) between our list
                    # and the phase write: this container must not outlive
                    # its incarnation
                    self.handles.pop(pod.name).kill()
                    self._uids.pop(pod.name, None)
                    self._ns.pop(pod.name, None)
                    continue
                started.append(handle)
        return started

    def reap(self, timeout: float | None = None) -> dict[str, int]:
        """Wait for running containers; report exit codes and update pod
        phases (Succeeded/Failed)."""
        results: dict[str, int] = {}
        if self.down:
            return results
        for pod_name, handle in list(self.handles.items()):
            code = handle.wait(timeout=timeout)
            if code is None:
                continue
            results[pod_name] = code
            phase = PodPhase.SUCCEEDED if code == 0 else PodPhase.FAILED
            ns = self._ns.get(pod_name, "default")
            if code == 0 and self.metrics is not None:
                harvest_workload_metrics(handle.stdout, self.metrics,
                                         pod_name=pod_name)
            try:
                # only report for the incarnation this container belongs to
                self.api.set_pod_phase(
                    pod_name, phase,
                    message=handle.stderr[-2000:] if code else "",
                    exit_code=code, namespace=ns,
                    expect_uid=self._uids.get(pod_name))
            except NotFound:
                pass
            del self.handles[pod_name]
            self._uids.pop(pod_name, None)
            self._ns.pop(pod_name, None)
        return results
