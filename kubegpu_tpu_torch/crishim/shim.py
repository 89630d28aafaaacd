"""The CreateContainer interposition — reference: SURVEY.md §4.3 (copied
from ``kubegpu_tpu/crishim/shim.py``).

Reference flow: kubelet → crishim → (read allocation annotation → device
manager → env/devices/mounts → rewrite ContainerConfig) → real runtime.
Identical here; the backend's env carries the reference's TPU keys and the
granted cards by UUID (``CUDA_VISIBLE_DEVICES``, ``NVIDIA_VISIBLE_DEVICES``).
"""

from __future__ import annotations

import json

from kubegpu_tpu_torch.crishim.runtime import ContainerHandle, ContainerRuntime
from kubegpu_tpu_torch.kubemeta import FakeApiServer, Pod
from kubegpu_tpu_torch.kubemeta.codec import pod_allocation, pod_mesh_axes
from kubegpu_tpu_torch.obs import get_logger
from kubegpu_tpu_torch.obs.spans import TRACE_ANNOTATION, TRACE_ENV, SpanContext
from kubegpu_tpu_torch.tpuplugin.backend import DeviceBackend

log = get_logger("crishim")


class CriError(RuntimeError):
    """A CRI verb refused: raised by the server's verbs and carried back
    over the wire (the reference's ``criserver.CriError``; defined here so
    the agent and the servers share it without an import cycle)."""


class CriShim:
    def __init__(self, api: FakeApiServer, backend: DeviceBackend,
                 node_name: str, runtime: ContainerRuntime,
                 tracer=None):
        self.api = api
        self.backend = backend
        self.node_name = node_name
        self.runtime = runtime
        # With a Tracer attached the shim records its env
        # injection as a span and re-parents the propagated token under
        # it, so engine spans hang off crishim.inject; without one the
        # annotation token passes through untouched
        self.tracer = tracer

    def _propagate_trace(self, pod: Pod, env: dict) -> None:
        """Copy the bind-time trace token from the pod annotation into
        the container env — the same road TPU_VISIBLE_CHIPS travels."""
        token = pod.metadata.annotations.get(TRACE_ANNOTATION)
        ctx = SpanContext.decode(token)
        if ctx is None:
            return
        if self.tracer is not None:
            with self.tracer.span(
                    "crishim.inject", parent=ctx,
                    attrs={"pod": pod.name,
                           "node": self.node_name}) as sp:
                token = sp.context.encode()
        env[TRACE_ENV] = token

    def create_container(self, pod: Pod,
                         container_index: int = 0) -> ContainerHandle:
        """Rewrite the container spec with the allocation's TPU env and
        forward to the runtime.  Pods with no allocation (0-device CPU
        fallback, BASELINE config 1) pass through with TPU visibility
        explicitly cleared: no TPU chip and no card."""
        spec = pod.spec.containers[container_index]
        alloc = pod_allocation(pod)
        env = dict(spec.env)
        if alloc is None or not alloc.chips:
            env["TPU_VISIBLE_CHIPS"] = ""
            env["CUDA_VISIBLE_DEVICES"] = ""
            env["JAX_PLATFORMS"] = env.get("JAX_PLATFORMS", "cpu")
        else:
            if alloc.node_name != self.node_name:
                raise ValueError(
                    f"pod {pod.name} allocated to {alloc.node_name}, "
                    f"but this shim serves {self.node_name}")
            adv = self.backend.discover()
            by_local = {c.local_index: c for c in adv.chips}
            chips = [by_local[c.local_index] for c in alloc.chips]
            env.update(self.backend.allocate_env(
                chips,
                worker_id=alloc.worker_id,
                num_workers=alloc.num_workers,
                coordinator_address=alloc.coordinator_address,
                worker_hostnames=alloc.worker_hostnames,
            ))
            millis = {c.millichips for c in alloc.chips}
            if millis != {1000}:
                # fractional co-tenancy: the workload self-limits HBM use
                env["KUBETPU_MILLITPU"] = str(sum(c.millichips
                                                 for c in alloc.chips))
            # advertised capacity flows to the workload: serving picks
            # its model scale from the allocation, not from guesswork
            # (fractional grants scale the figure by their chip share)
            env["KUBETPU_HBM_GIB"] = str(round(sum(
                by_local[c.local_index].hbm_gib * c.millichips / 1000
                for c in alloc.chips), 3))
            # slice identity: a multislice gang's workers learn which
            # ICI domain they sit in (dp spans slices over DCN; the
            # slice id is the boundary a MEGASCALE-style runtime needs)
            env["KUBETPU_SLICE_ID"] = alloc.slice_id
            axes = pod_mesh_axes(pod)
            if axes:
                # close the loop: the mesh the allocator optimized
                # placement for IS the mesh the workload builds
                env["KUBETPU_MESH_AXES"] = json.dumps(list(axes.items()))
        self._propagate_trace(pod, env)
        log.info("create_container", pod=pod.name, node=self.node_name,
                 chips=len(alloc.chips) if alloc else 0,
                 worker_id=alloc.worker_id if alloc else None)
        return self.runtime.create_container(
            pod.name, spec.name, spec.command, env)
