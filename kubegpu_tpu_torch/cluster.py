"""SimCluster: the in-process simulated control plane (SURVEY.md §5 (c);
copied from ``kubegpu_tpu/cluster.py``).

Wires fake apiserver + N node agents (one per host, mock backend) + the
device scheduler into one steppable cluster, so the example specs run
end-to-end through the real scheduling/injection code — only the
transports (gRPC/HTTP) are collapsed into function calls.  With the
``nvml`` backend the cluster is this node, one agent over
:class:`NvmlBackend`, and with real processes a pod runs on the cards its
grant names (the mock's made-up card UUIDs name no card CUDA knows).

Each tick runs the :class:`FaultRecoveryController` first: a card, host or
NVLink pair failed through ``fail_*`` (or read bad from NVML by
``NvmlBackend``) evicts and requeues the gangs it breaks.  With ``wire_cri``
(or ``config.runtime.wire_cri``) each node gets its own ``CriServer`` on a
unix socket, and its agent reaches the shim only through it.
"""

from __future__ import annotations

import itertools
import time

from kubegpu_tpu_torch.crishim import FakeRuntime, NodeAgent, SubprocessRuntime
from kubegpu_tpu_torch.kubemeta import (
    ContainerSpec,
    FakeApiServer,
    GangSpec,
    ObjectMeta,
    Pod,
    PodPhase,
    PodSpec,
    ResourceRequests,
    WatchEvent,
)
from kubegpu_tpu_torch.kubemeta.codec import (
    set_pod_gang,
    set_pod_mesh_axes,
    set_pod_migratable,
    set_pod_multislice,
)
from kubegpu_tpu_torch.obs import MetricsRegistry, ScheduleTrace
from kubegpu_tpu_torch.scheduler import (
    DeviceScheduler,
    FaultRecoveryController,
)
from kubegpu_tpu_torch.tpuplugin import DeviceBackend, mock_cluster

_port_counter = itertools.count(0)


def pick_coordinator_port() -> int:
    """Distinct ports per cluster so parallel tests' coordinators never
    collide."""
    return 8476 + (next(_port_counter) % 500)


def tpu_pod(name: str, chips: int = 0, millitpu: int = 0,
            gang: GangSpec | None = None,
            mesh_axes: dict[str, int] | None = None,
            command: list[str] | None = None,
            env: dict[str, str] | None = None,
            priority: int = 0,
            multislice: bool = False,
            namespace: str = "default",
            migratable: bool = False,
            hbm_gib: float = 0.0,
            workload: str | None = None) -> Pod:
    """Pod-spec builder — the user surface (reference: example/ YAML).
    ``workload="serving"`` annotates the traffic model: the scheduler
    scores the gang's slice with serving axis weights (tp hot on every
    decode step, dp-replica hops nearly free)."""
    pod = Pod(
        metadata=ObjectMeta(name=name, namespace=namespace),
        spec=PodSpec(containers=[ContainerSpec(
            name="main",
            command=command or [],
            env=env or {},
            resources=ResourceRequests(tpu_chips=chips, millitpu=millitpu,
                                       hbm_gib=hbm_gib),
        )], priority=priority),
    )
    if gang is not None:
        set_pod_gang(pod, gang)
    if mesh_axes is not None:
        set_pod_mesh_axes(pod, mesh_axes)
    if multislice:
        set_pod_multislice(pod)
    if migratable:
        set_pod_migratable(pod)
    if workload is not None:
        from kubegpu_tpu_torch.kubemeta.codec import set_pod_workload_kind
        set_pod_workload_kind(pod, workload)
    return pod


class SimCluster:
    def __init__(self, slice_types: list[str], real_processes: bool = False,
                 extra_env: dict[str, str] | None = None,
                 config: "KubeTpuConfig | None" = None,
                 wire_cri: bool = False,
                 backends: list[DeviceBackend] | None = None):
        """One node agent per backend of ``backends``, or per host of
        ``mock_cluster(slice_types)`` where it is None."""
        from kubegpu_tpu_torch.allocator import GangAllocator
        from kubegpu_tpu_torch.config import KubeTpuConfig

        cfg = config or KubeTpuConfig()
        self.config = cfg
        self.api = FakeApiServer()
        self.metrics = MetricsRegistry()
        self.trace = ScheduleTrace(capacity=cfg.obs.trace_capacity)
        if real_processes or cfg.runtime.real_processes:
            merged_env = {**cfg.runtime.extra_env, **(extra_env or {})}
            self.runtime = SubprocessRuntime(extra_env=merged_env)
        else:
            self.runtime = FakeRuntime()
        self.cri_servers: list["CriServer"] = []
        self.agents = []
        for b in (mock_cluster(slice_types) if backends is None
                  else backends):
            shim = None
            if wire_cri or cfg.runtime.wire_cri:
                # per-node CRI unix socket between agent (kubelet role)
                # and shim, as in the reference deployment (SURVEY §4.3)
                from kubegpu_tpu_torch.crishim.criserver import (
                    CriServer,
                    RemoteCriShim,
                )
                server = CriServer(self.api, b, b.discover().node_name,
                                   self.runtime).start()
                self.cri_servers.append(server)
                shim = RemoteCriShim(server.socket_path)
            self.agents.append(NodeAgent(self.api, b, self.runtime,
                                         metrics=self.metrics, shim=shim))
        for a in self.agents:
            a.register()
        sc = cfg.scheduler
        self.scheduler = DeviceScheduler(
            self.api,
            allocator=GangAllocator(
                max_placements_per_shape=sc.max_placements_per_shape,
                locality_weight=sc.locality_weight,
                frag_weight=sc.frag_weight,
                fill_weight=sc.fill_weight),
            metrics=self.metrics, trace=self.trace,
            # explicit config port wins; 0 = auto, rotating per cluster so
            # parallel tests' coordinators never collide
            coordinator_port=sc.coordinator_port or pick_coordinator_port(),
            gang_grace_s=sc.gang_grace_s)
        self.recovery = FaultRecoveryController(
            self.api, self.scheduler, metrics=self.metrics, trace=self.trace)
        self._unsub = self.api.watch(self._on_event)

    @classmethod
    def from_config(cls, cfg: "KubeTpuConfig") -> "SimCluster":
        """Build a cluster entirely from the config tree (SURVEY.md §6
        config row: backend selection is a config field, mirroring the
        reference's plugin seam).  ``nvml`` makes the cluster this node as
        NVML finds it, ignoring ``slice_types``; without NVML or a card it
        raises (no mock stands in)."""
        if cfg.obs.json_logs:
            import logging

            from kubegpu_tpu_torch.obs import configure_logging
            configure_logging(getattr(logging, cfg.obs.log_level.upper(),
                                      logging.INFO))
        if cfg.backend.type == "nvml":
            from kubegpu_tpu_torch.tpuplugin import NvmlBackend
            return cls([], config=cfg, backends=[NvmlBackend()])
        return cls(list(cfg.backend.slice_types), config=cfg)

    # -- lifecycle events: free resources when pods finish/disappear -----

    def _on_event(self, ev: WatchEvent) -> None:
        if ev.kind != "Pod":
            return
        pod = ev.obj
        if ev.type == "DELETED" or (
                ev.type == "MODIFIED"
                and pod.status.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED)):
            self.scheduler.return_pod_resources(pod.name,
                                                pod.metadata.namespace)

    # -- driving ---------------------------------------------------------

    def submit(self, *pods: Pod) -> None:
        for p in pods:
            self.api.create("Pod", p)

    def set_quota(self, namespace: str, chips: int | None = None,
                  millitpu: int | None = None, name: str = "quota") -> None:
        """Create/replace a device quota object (k8s ResourceQuota
        parity — the scheduler denies asks that would exceed it).
        Several quota objects may coexist in one namespace; each enforces
        independently, so the tightest limit wins."""
        from kubegpu_tpu_torch.kubemeta import NotFound, Quota, QuotaSpec

        try:
            self.api.delete("Quota", name, namespace=namespace)
        except NotFound:
            pass
        self.api.create("Quota", Quota(
            metadata=ObjectMeta(name=name, namespace=namespace),
            spec=QuotaSpec(tpu_chips=chips, millitpu=millitpu)))

    def step(self):
        """One control-plane tick: recover from faults, schedule pending,
        start bound pods."""
        self.recovery.run_once()
        result = self.scheduler.run_once()
        started = []
        for a in self.agents:
            started.extend(a.run_once())
        return result, started

    # -- fault injection (SURVEY.md §6: kill a host mid-gang, flap a
    #    link/chip — drives the elastic-recovery tests; on a card node the
    #    chip is a card and the link an NVLink pair) ----------------------

    def agent_for(self, node_name: str) -> NodeAgent:
        for a in self.agents:
            if a.node_name == node_name:
                return a
        raise KeyError(f"no agent for node {node_name}")

    def fail_host(self, node_name: str) -> None:
        """Machine death: containers die, node goes NotReady."""
        self.agent_for(node_name).fail()
        self.api.set_node_ready(node_name, False)

    def restore_host(self, node_name: str) -> None:
        self.agent_for(node_name).restore()
        self.api.set_node_ready(node_name, True)

    def fail_chip(self, node_name: str, local_index: int) -> None:
        a = self.agent_for(node_name)
        a.backend.fail_chip(local_index)
        a.advertise()

    def heal_chip(self, node_name: str, local_index: int) -> None:
        a = self.agent_for(node_name)
        a.backend.heal_chip(local_index)
        a.advertise()

    def fail_link(self, coord_a, coord_b, slice_id: str | None = None) -> None:
        """Flap a link: every live agent owning an endpoint advertises
        the failure (both sides of a cross-host link report it).  Coords are
        slice-local, so with multiple slices of the same shape the link is
        ambiguous — ``slice_id`` is required then."""
        candidates = []
        for a in self.agents:
            if slice_id is not None and a.backend.slice_id != slice_id:
                continue
            topo = a.backend.topo
            if (topo.has_coord(tuple(coord_a))
                    and topo.has_coord(tuple(coord_b))):
                candidates.append(a)
        owning_slices = {a.backend.slice_id for a in candidates}
        if len(owning_slices) > 1:
            raise ValueError(
                f"link {coord_a}–{coord_b} exists in slices "
                f"{sorted(owning_slices)}; pass slice_id")
        owned = False
        for a in candidates:
            if not a.down and a.backend.fail_link(coord_a, coord_b):
                a.advertise()
                owned = True
        if not owned:
            raise ValueError(f"no live agent owns link {coord_a}–{coord_b}")

    def heal_link(self, coord_a, coord_b, slice_id: str | None = None) -> None:
        pair = (min(tuple(coord_a), tuple(coord_b)),
                max(tuple(coord_a), tuple(coord_b)))
        owners = [a for a in self.agents
                  if (slice_id is None or a.backend.slice_id == slice_id)
                  and pair in a.backend.bad_links]
        owning_slices = {a.backend.slice_id for a in owners}
        if len(owning_slices) > 1:  # symmetric with fail_link's ambiguity rule
            raise ValueError(
                f"link {coord_a}–{coord_b} is bad in slices "
                f"{sorted(owning_slices)}; pass slice_id")
        if not owners:
            raise ValueError(
                f"link {coord_a}–{coord_b} was not marked bad on any agent")
        for a in owners:
            a.backend.heal_link(coord_a, coord_b)
            if not a.down:
                a.advertise()

    def reap(self, timeout: float | None = None) -> dict[str, int]:
        codes: dict[str, int] = {}
        for a in self.agents:
            codes.update(a.reap(timeout=timeout))
        return codes

    def run_to_completion(self, timeout_s: float = 120.0,
                          tick_s: float = 0.02) -> dict[str, int]:
        """Step until every pod is terminal (or unschedulable pods remain
        and nothing is running).  Returns pod → exit code."""
        deadline = time.monotonic() + timeout_s
        exit_codes: dict[str, int] = {}
        while time.monotonic() < deadline:
            self.step()
            exit_codes.update(self.reap(timeout=tick_s))
            pods = self.api.list("Pod")
            if all(p.status.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED)
                   for p in pods):
                return exit_codes
            running = any(p.status.phase == PodPhase.RUNNING for p in pods)
            pending = [p for p in pods if p.status.phase == PodPhase.PENDING]
            if pending and not running:
                # give held gangs a chance; bail only if truly stuck
                r, _ = self.step()
                if not r.scheduled and not running and not r.held:
                    break
            time.sleep(0 if running else tick_s)
        return exit_codes

    def pod_phase(self, name: str) -> PodPhase:
        return self.api.get("Pod", name).status.phase

    def close(self) -> None:
        self._unsub()
        self.recovery.close()
        for a in self.agents:
            for h in a.handles.values():
                h.kill()
            if hasattr(a.shim, "close"):
                a.shim.close()
            close = getattr(a.backend, "close", None)
            if close is not None:       # NvmlBackend's event set
                close()
        for s in self.cri_servers:
            s.close()
