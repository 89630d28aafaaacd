"""The device scheduler: extender verbs + gang queue + annotation truth
(copied from ``kubegpu_tpu/scheduler/extender.py``).

Reference call stack parity (SURVEY.md §4.2):
  kube-scheduler → /filter → /prioritize → bind
  device-scheduler: fill AllocateFrom, TakePodResources, PATCH annotations
Here the same phases run in-process: ``run_once()`` plays the vanilla
scheduler picking pods off the queue; filter/prioritize/allocate are the
extender webhook verbs (exposed for API parity and used internally); the
allocation annotation write-back + bind complete the path.

Gang atomicity (SURVEY.md §8 hard part): the extender pattern sees one pod
at a time, so gang state lives here — pods of a gang are *held* (never
partially placed) until every member has arrived and a whole-gang
assignment exists; then all members are committed/bound in one step.
No partial placement ⇒ no gang-vs-gang deadlock; FIFO with skip ⇒ no
head-of-line blocking.

Queue policy (k8s scheduler semantics, TPU-gang flavored):
- **priority**: units order by (priority desc, arrival); a unit with
  higher priority than an in-grace incomplete gang bypasses its barrier;
- **preemption**: a gang that doesn't fit may evict committed gangs of
  strictly lower priority — planned on cloned slice states (greedy evict
  lowest-priority-first, then minimized so no needless victim), victims
  requeued whole (gang semantics: members must restart together);
- **backfill**: while an incomplete gang holds the barrier, a later unit
  may still schedule if a what-if trial shows the barrier gang's
  projected request STILL fits after the unit is placed (conservative
  backfill — the blocked gang never loses its spot).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from kubegpu_tpu_torch.allocator import GangAllocator, GangRequest, SliceState
from kubegpu_tpu_torch.allocator.gang import GangAssignment, PodAssignment
from kubegpu_tpu_torch.kubemeta import (
    FakeApiServer,
    Pod,
    PodPhase,
    pod_allocation,
    pod_gang_spec,
    pod_mesh_axes,
    pod_migratable,
    pod_multislice,
)
from kubegpu_tpu_torch.kubemeta.codec import (
    ALLOCATE_FROM_KEY,
    MIGRATION_DEBT_KEY,
    migration_debt_from_annotation,
    migration_debt_to_annotation,
    allocation_to_annotation,
    node_advertisement,
    pod_workload_kind,
)
from kubegpu_tpu_torch.kubemeta.objects import GangSpec
from kubegpu_tpu_torch.obs import MetricsRegistry, ScheduleTrace, get_logger
from kubegpu_tpu_torch.obs.spans import TRACE_ANNOTATION
from kubegpu_tpu_torch.tpuplugin.backend import NodeAdvertisement

log = get_logger("scheduler")


@dataclass
class ScheduleResult:
    scheduled: list[str] = field(default_factory=list)   # pod names bound
    held: list[str] = field(default_factory=list)        # gang-waiting pods
    unschedulable: list[str] = field(default_factory=list)


@dataclass
class _PendingGang:
    spec: GangSpec
    pods: dict[int, Pod] = field(default_factory=dict)   # index → pod

    def complete(self) -> bool:
        return len(self.pods) == self.spec.size

    @property
    def priority(self) -> int:
        return max((p.spec.priority for p in self.pods.values()), default=0)


class DeviceScheduler:
    def __init__(self, api: FakeApiServer,
                 allocator: GangAllocator | None = None,
                 metrics: MetricsRegistry | None = None,
                 trace: ScheduleTrace | None = None,
                 coordinator_port: int = 8476,
                 gang_grace_s: float = 30.0,
                 max_planning_victims: int = 16,
                 bind_retries: int = 3,
                 tracer=None):
        self.api = api
        self.allocator = allocator or GangAllocator()
        self.metrics = metrics or MetricsRegistry()
        # request tracing: when a Tracer is attached, each
        # gang decision roots a trace whose propagation token rides the
        # bind annotation into the crishim env (the TPU_VISIBLE_CHIPS
        # road); a default-constructed ScheduleTrace shares the tracer
        # so decision events join request traces by gang id
        self.tracer = tracer
        self.trace = trace or ScheduleTrace(tracer=tracer)
        self.coordinator_port = coordinator_port
        # How long an INCOMPLETE gang at the head of the queue blocks
        # later-arrived units (the arrival grace; cf. Volcano/coscheduling
        # gang timeouts).  Expires → work conservation resumes, so two
        # half-arrived gangs can never deadlock the queue.
        self.gang_grace_s = gang_grace_s
        # Latency budget for what-if planning: a preemption/migration
        # plan tries at most this many victim evictions (each costs a
        # find_assignment) before declaring the request unplaceable —
        # bounds the p99 tail of failing decisions.
        self.max_planning_victims = max_planning_victims
        # Bounded retry budget for apiserver write CONFLICTS on the
        # bind path (a lost optimistic-concurrency race with another
        # writer bumping the pod's resourceVersion).  Today's behavior
        # without it: the race surfaces as a hard bind failure and the
        # whole decision is thrown away.  Retries back off with
        # jitter; exhaustion requeues (the extender verb returns an
        # error so kube-scheduler's retry loop re-runs the pod).
        self.bind_retries = bind_retries
        import random as _random
        self._bind_rng = _random.Random(0x5eed)
        self.slices: dict[str, SliceState] = {}
        self._committed: dict[str, GangAssignment] = {}  # gang → assignment
        self._pod_gang: dict[str, str] = {}              # pod name → gang
        self._gang_priority: dict[str, int] = {}         # committed gangs
        self._gang_migratable: dict[str, bool] = {}      # committed gangs
        self._gang_first_seen: dict[str, float] = {}     # incomplete gangs
        # migration debts: a migrated gang's re-ask stays protected (same
        # what-if machinery as the barrier) until it re-places, so no
        # other unit — same pass or later — can take its proven home
        self._migration_debts: dict[str, GangRequest] = {}
        # Wire-path (webhook) gang assumption state: gkey → per-pod
        # (node, Allocation) decisions computed when the LAST member
        # arrived at /filter; occupancy is committed ("assumed") at that
        # moment so later wire/in-process decisions see it.  In-memory
        # only — sync() drops unfulfilled assumptions (unbound chips are
        # absent from annotation truth, so they free automatically).
        self._wire_assumed: dict[str, dict[str, tuple[str, object]]] = {}
        self._wire_assumed_at: dict[str, float] = {}
        self._wire_bound: dict[str, set[str]] = {}
        # One lock for every public entry point: the webhook's threaded
        # HTTP handlers, an embedded control loop, and advertiser ticks
        # may call in concurrently.  RLock because
        # entry points call each other (evict→return_pod_resources).
        self._lock = threading.RLock()
        self.sync()

    def warm_start(self) -> None:
        """Pay the one-time costs BEFORE the first real decision: run
        throwaway placements per known slice topology so the
        ring-orientation geometry memos start hot (the reference also
        loads its native core here, which the port does not have).
        Pure reads: ``find_assignment`` never commits."""
        with self._lock:
            for st in self.slices.values():
                n = len(st.topo.chips)
                for pods, chips in ((1, 1), (min(n, 4), 1)):
                    self.allocator.find_assignment([st], GangRequest(
                        gang_name="__warm__", num_pods=pods,
                        chips_per_pod=chips,
                        mesh_axes={"dp": pods} if pods > 1 else None))

    def serving_metrics(self) -> dict:
        """Serving-workload gauges the node agents harvested into this
        scheduler's registry (``harvest_workload_metrics`` stores every
        pod-printed metric line as ``workload_<name>``), keyed without
        the prefix: engine config echo, throughput, decode-stall
        percentiles — and, with the speculative serving engine, the
        pod's draft ACCEPTANCE (``serve_engine_spec_accept_rate``) and
        fused-tick token yield.  Acceptance is mirrored into the
        ``serving_spec_acceptance`` gauge so the extender's scrape
        surface (GET /metrics) carries it as a first-class scheduler
        signal: a slice whose pods accept ~0 is paying draft compute
        for nothing, which is a placement/config smell the operator
        should see next to schedule latency, not buried in pod logs.

        Fault-tolerance gauges ride the same harvest: the
        serve pod echoes ``serve_failover_total`` / ``serve_requests_
        retried`` / ``serve_slots_quarantined``, mirrored here into
        ``serving_failover_total`` etc. — a slice whose serving pods
        fail over repeatedly is a health signal the scheduler should
        surface next to gang evictions, not bury in pod stdout."""
        with self._lock:
            snap = self.metrics.snapshot()["gauges"]
        out = {k[len("workload_"):]: v for k, v in snap.items()
               if k.startswith("workload_serve_")}
        acc = out.get("serve_engine_spec_accept_rate")
        if acc is not None:
            self.metrics.set_gauge("serving_spec_acceptance", acc)
        # HBM accounting rides the same harvest: live/peak
        # pool bytes per pod, mirrored so capacity planning reads the
        # engine's real donation-era footprint off the scrape surface
        # overload signals ride it too: goodput-under-SLO
        # and shed/preempt/deadline pressure per pod — the scheduler
        # finally consumes load, so placement can react to a slice
        # that is shedding its paying tiers rather than just to one
        # that is dying
        for src, dst in (
                ("serve_failover_total", "serving_failover_total"),
                ("serve_requests_retried", "serving_requests_retried"),
                ("serve_slots_quarantined",
                 "serving_slots_quarantined"),
                ("serve_hbm_pool_bytes", "serving_hbm_pool_bytes"),
                ("serve_hbm_peak_bytes", "serving_hbm_peak_bytes"),
                ("serve_goodput_tokens_per_s",
                 "serving_goodput_tokens_per_s"),
                ("serve_slo_attainment", "serving_slo_attainment"),
                ("serve_requests_shed", "serving_requests_shed"),
                ("serve_requests_preempted",
                 "serving_requests_preempted"),
                ("serve_deadline_miss", "serving_deadline_miss"),
                # the closed loop: routing affinity and
                # autoscale state become first-class scheduler signals
                ("serve_replicas_active", "serving_replicas_active"),
                ("serve_autoscale_events",
                 "serving_autoscale_events"),
                ("serve_routing_affinity_hits",
                 "serving_routing_affinity_hits"),
                # kv compression & eviction: the scheduler
                # sees each pod's kv format, eviction pressure, and
                # the measured quality cost of running compressed
                ("serve_kv_bits", "serving_kv_bits"),
                ("serve_pages_evicted_total",
                 "serving_pages_evicted_total"),
                ("serve_kv_quality_delta",
                 "serving_kv_quality_delta"),
                # chip-tick spend: the pod's attributed
                # cost currency, so placement can weigh goodput per
                # chip-tick, not just goodput
                ("serve_chip_ticks_total",
                 "serving_chip_ticks_total")):
            v = out.get(src)
            if v is not None:
                self.metrics.set_gauge(dst, v)
        return out

    def _write_retrying(self, fn, *args, **kw):
        """Run one apiserver write, retrying resourceVersion conflicts
        with jittered exponential backoff (``bind_retries`` attempts).
        The final attempt propagates — callers map the surviving
        Conflict to their own requeue semantics (the wire verb returns
        an error string; run_once lets the daemon's control-plane
        retry loop absorb it)."""
        from kubegpu_tpu_torch.kubemeta.controlplane import Conflict
        delay = 0.002
        for _ in range(max(0, self.bind_retries)):
            try:
                return fn(*args, **kw)
            except Conflict:
                self.metrics.inc("bind_conflict_retries")
                time.sleep(delay * (0.5 + self._bind_rng.random()))
                delay = min(delay * 2, 0.05)
        return fn(*args, **kw)

    # ------------------------------------------------------------------
    # Identity: in-memory gang/pod keys are NAMESPACE-QUALIFIED so two
    # tenants may both run a gang called "train" (or a pod "worker-0")
    # without colliding in the scheduler's registries.  The wire format
    # (allocation annotations) keeps the bare gang name — namespace is
    # already carried by the Pod object itself.
    # ------------------------------------------------------------------

    @staticmethod
    def _gkey(namespace: str, name: str) -> str:
        return f"{namespace}/{name}"

    @staticmethod
    def _split_gkey(key: str) -> tuple[str, str]:
        ns, _, bare = key.partition("/")
        return ns, bare

    @staticmethod
    def _arrival(pod: Pod) -> int:
        """Queue position: the original arrival for requeued pods."""
        from kubegpu_tpu_torch.kubemeta.codec import QUEUED_AT_KEY
        stamped = pod.metadata.annotations.get(QUEUED_AT_KEY)
        return int(stamped) if stamped else pod.metadata.resource_version

    # ------------------------------------------------------------------
    # Cluster-state cache (annotation truth)
    # ------------------------------------------------------------------

    def sync(self) -> None:
        """Rebuild slice states from Node advertisements and re-apply every
        live pod's allocation — the restart-recovery path (SURVEY.md §4.4:
        annotations, not memory, are the source of truth).  Unfulfilled
        wire-path gang assumptions are dropped: their unbound chips exist
        nowhere in annotation truth, so they free here, and the external
        scheduler's next /filter re-assumes from live state."""
        with self._lock:
            self._sync_locked()

    def _sync_locked(self) -> None:
        self._wire_assumed.clear()
        self._wire_assumed_at.clear()
        self._wire_bound.clear()
        advs: dict[str, list[NodeAdvertisement]] = {}
        for node in self.api.list("Node"):
            if not node.status.ready:
                continue
            adv = node_advertisement(node)
            if adv is not None:
                advs.setdefault(adv.slice_id, []).append(adv)
        self.slices = {
            sid: SliceState.from_advertisements(a) for sid, a in advs.items()
        }
        self._committed.clear()
        self._pod_gang.clear()
        self._gang_priority.clear()
        self._gang_migratable.clear()
        gang_pods: dict[str, list] = {}
        for pod in self.api.list("Pod"):
            if pod.status.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
                continue
            alloc = pod_allocation(pod)
            if alloc is None:
                continue
            if alloc.slice_id in self.slices:
                self.slices[alloc.slice_id].take(alloc.chips)
            ns = pod.metadata.namespace
            gang = self._gkey(ns, alloc.gang_name or pod.name)
            self._pod_gang[self._gkey(ns, pod.name)] = gang
            self._gang_priority[gang] = max(
                self._gang_priority.get(gang, pod.spec.priority),
                pod.spec.priority)
            self._gang_migratable[gang] = (
                self._gang_migratable.get(gang, True)
                and pod_migratable(pod))
            gang_pods.setdefault(gang, []).append(alloc)
        # Rebuild committed assignments from annotation truth so later
        # completions release chips even across scheduler restarts/re-syncs.
        # Gangs whose slice vanished (all hosts down) are kept too — the
        # recovery controller must still see them to evict/requeue, else
        # they'd zombie as RUNNING pods bound to dead nodes.  Slice ids are
        # per-pod (a multislice gang spans several).
        # migration debts rebuild from annotation truth too: PENDING
        # requeued pods carry the serialized reservation, so a restart
        # between migration-eviction and re-placement keeps the mover's
        # proven home protected
        self._migration_debts.clear()
        for pod in self.api.list("Pod", phase=PodPhase.PENDING):
            payload = pod.metadata.annotations.get(MIGRATION_DEBT_KEY)
            if not payload:
                continue
            gs = pod_gang_spec(pod)
            gkey = self._gkey(pod.metadata.namespace,
                              gs.name if gs else pod.name)
            if gkey in self._migration_debts:
                continue   # every member carries the same debt
            req = migration_debt_from_annotation(gkey, payload)
            if req is not None:
                self._migration_debts[gkey] = req
        for gang, allocs in gang_pods.items():
            pods = []
            for a in sorted(allocs, key=lambda a: a.worker_id):
                st = self.slices.get(a.slice_id)
                pods.append(PodAssignment(
                    pod_index=a.worker_id,
                    node_name=a.node_name,
                    host_id=st.topo.chip_at(a.chips[0].coord).host_id
                    if st is not None and a.chips else 0,
                    chips=list(a.chips),
                    slice_id=a.slice_id))
            self._committed[gang] = GangAssignment(
                slice_id=allocs[0].slice_id, pods=pods,
                locality=0.0, score=0.0)
        self.trace.record("recover", detail={
            "slices": len(self.slices),
            "pods_with_allocations": len(self._pod_gang)})

    def observe_node_change(self) -> None:
        """Cheap re-sync on node add/remove/health events."""
        self.sync()

    # (sync/filter/prioritize/bind/run_once/return_pod_resources/
    # evict_gang all serialize on self._lock — the webhook's threaded
    # handlers and an embedded control loop may call in concurrently.)

    # ------------------------------------------------------------------
    # Extender verbs (webhook API parity — SURVEY.md §3 extender service)
    # ------------------------------------------------------------------

    def filter(self, pod: Pod, node_names: list[str]) -> tuple[list[str], dict[str, str]]:
        """Predicate: which candidate nodes could host this pod?
        Singles are judged against each node's *own* chips (a restricted
        slice view), matching the extender contract that /filter answers
        per-node.  GANG members go through hold-and-assume: until every
        member exists, all nodes fail with a "gang waiting" reason (the
        external scheduler's retry loop is the arrival barrier — the
        coscheduling-plugin pattern); once complete, one whole-gang
        assignment is computed and committed, and each member's /filter
        passes exactly its assigned node."""
        with self._lock:
            self._wire_expire()
            gspec = pod_gang_spec(pod)
            if gspec is not None:
                return self._filter_gang(pod, gspec, node_names)
            try:
                req = self._request_for_single(pod)
            except ValueError as e:
                return [], {n: f"invalid request: {e}" for n in node_names}
            quota_reason = self._quota_violation([pod], req)
            if quota_reason is not None:
                return [], {n: quota_reason for n in node_names}
            feasible: list[str] = []
            reasons: dict[str, str] = {}
            for name in node_names:
                st = self._slice_of_node(name)
                if req.total_chips == 0 and req.millitpu_per_pod == 0:
                    feasible.append(name)
                    continue
                if st is None:
                    reasons[name] = "node has no TPU advertisement"
                    continue
                asg = self.allocator.find_assignment(
                    [st.restricted_to_node(name)], req)
                if asg is not None:
                    feasible.append(name)
                else:
                    reasons[name] = \
                        "insufficient free contiguous chips on node"
            return feasible, reasons

    def _filter_gang(self, pod: Pod, gspec: GangSpec,
                     node_names: list[str]
                     ) -> tuple[list[str], dict[str, str]]:
        gkey = self._gkey(pod.metadata.namespace, gspec.name)
        if gkey not in self._wire_assumed:
            err = self._wire_assume(gkey, pod.metadata.namespace,
                                    gspec.name)
            if err is not None:
                return [], {n: err for n in node_names}
        entry = self._wire_assumed[gkey].get(pod.name)
        if entry is None:
            return [], {n: f"pod not a member of assumed gang "
                        f"{gspec.name}" for n in node_names}
        node, _ = entry
        if node in node_names:
            return [node], {n: f"gang {gspec.name} is assigned to {node}"
                            for n in node_names if n != node}
        return [], {n: f"gang {gspec.name} is assigned to {node}, not "
                    "offered as a candidate" for n in node_names}

    def prioritize(self, pod: Pod, node_names: list[str]) -> dict[str, float]:
        """0–10 score per node (extender /prioritize).  Singles are
        judged against the node's own chips; assumed gang members score
        10 on their assigned node and 0 elsewhere."""
        with self._lock:
            gspec = pod_gang_spec(pod)
            if gspec is not None:
                gkey = self._gkey(pod.metadata.namespace, gspec.name)
                entry = (self._wire_assumed.get(gkey) or {}).get(pod.name)
                node = entry[0] if entry else None
                return {n: 10.0 if n == node else 0.0 for n in node_names}
            try:
                req = self._request_for_single(pod)
            except ValueError:
                return {n: 0.0 for n in node_names}
            scores: dict[str, float] = {}
            for name in node_names:
                st = self._slice_of_node(name)
                if st is None or (req.total_chips == 0
                                  and req.millitpu_per_pod == 0):
                    scores[name] = 5.0 if st is None else 0.0
                    continue
                asg = self.allocator.find_assignment(
                    [st.restricted_to_node(name)], req)
                scores[name] = asg.score if asg is not None else 0.0
            return scores

    # ------------------------------------------------------------------
    # Wire-path bind (extender bindVerb) + gang assumption
    # ------------------------------------------------------------------

    def bind(self, pod_name: str, node_name: str,
             namespace: str = "default") -> str | None:
        """Extender ``bind`` verb — the allocation write-back the
        reference did at assume/bind time (SURVEY.md §4.2): fill
        AllocateFrom for the chosen node, PATCH it onto the pod as the
        allocation annotation, then bind.  Returns an error string (the
        ExtenderBindingResult.Error payload) or None on success.

        Singles allocate here, atomically under the lock, restricted to
        the chosen node.  Gang members consume the hold-and-assume
        decision made at /filter time (see :meth:`_wire_assume`); chips
        were committed then, so this only writes annotations + binding.

        Apiserver write CONFLICTS (a lost resourceVersion race) are
        retried ``bind_retries`` times with jittered backoff; if one
        survives anyway the verb returns an error — kube-scheduler's
        retry loop requeues the pod, and the next attempt re-reads
        fresh state.
        """
        from kubegpu_tpu_torch.kubemeta.controlplane import Conflict
        with self._lock:
            try:
                return self._bind_locked(pod_name, node_name, namespace)
            except Conflict as e:
                self.metrics.inc("bind_conflict_requeued")
                return (f"bind conflict persisted after "
                        f"{self.bind_retries} retries; pod requeued "
                        f"for re-scheduling: {e}")

    def _bind_locked(self, pod_name: str, node_name: str,
                     namespace: str) -> str | None:
        if True:
            t0 = time.perf_counter()
            self._wire_expire()
            from kubegpu_tpu_torch.kubemeta import NotFound

            try:
                pod = self.api.get("Pod", pod_name, namespace=namespace)
            except NotFound:
                return f"pod {namespace}/{pod_name} not found"
            alloc = pod_allocation(pod)
            if alloc is not None:
                # idempotent completion (retry after a half-applied bind)
                if alloc.node_name != node_name:
                    return (f"pod already allocated on {alloc.node_name}, "
                            f"refusing bind to {node_name}")
                self._write_retrying(self.api.bind_pod, pod_name,
                                     node_name, namespace=namespace)
                # a gang member retried here still counts toward its
                # assumption's completion — otherwise the assumption
                # never fulfills and expiry frees chips this pod OWNS
                # per its annotation
                gspec = pod_gang_spec(pod)
                if gspec is not None:
                    gkey = self._gkey(namespace, gspec.name)
                    if gkey in self._wire_assumed:
                        self._wire_note_bound(gkey, pod.name, t0)
                return None
            gspec = pod_gang_spec(pod)
            if gspec is not None:
                return self._bind_gang_member(pod, gspec, node_name, t0)
            return self._bind_single(pod, node_name, t0)

    def _bind_single(self, pod: Pod, node_name: str,
                     t0: float) -> str | None:
        ns = pod.metadata.namespace
        try:
            req = self._request_for_single(pod)
        except ValueError as e:
            return f"invalid request: {e}"
        quota_reason = self._quota_violation([pod], req)
        if quota_reason is not None:
            self.metrics.inc("schedule_quota_denied")
            return quota_reason
        gkey = self._gkey(ns, pod.name)
        if req.total_chips == 0 and req.millitpu_per_pod == 0:
            self._write_retrying(self.api.bind_pod, pod.name, node_name,
                                 namespace=ns)
            self._observe_latency(t0, gkey, scheduled=True)
            return None
        st = self._slice_of_node(node_name)
        if st is None:
            return f"node {node_name} has no TPU advertisement"
        asg = self.allocator.find_assignment(
            [st.restricted_to_node(node_name)], req)
        if asg is None:
            self._observe_latency(t0, gkey, scheduled=False)
            return (f"insufficient free contiguous chips on {node_name}")
        coordinator, hostnames = GangAllocator.coordinator_for(
            asg, self.slices, port=self.coordinator_port)
        allocations = asg.to_allocations(coordinator, hostnames)
        self.allocator.commit(self.slices, asg)
        self._committed[gkey] = asg
        self._gang_priority[gkey] = pod.spec.priority
        self._gang_migratable[gkey] = pod_migratable(pod)
        self._pod_gang[gkey] = gkey
        self._trace_schedule_root(gkey, t0, locality=asg.locality)
        self._write_retrying(
            self.api.patch_annotations, "Pod", pod.name,
            {ALLOCATE_FROM_KEY: allocation_to_annotation(allocations[0]),
             MIGRATION_DEBT_KEY: None,   # repaid via the wire path too
             **self._trace_bind_annotation(gkey, pod.name, node_name)},
            namespace=ns)
        self._write_retrying(self.api.bind_pod, pod.name, node_name,
                             namespace=ns)
        self.metrics.observe("allocation_locality", asg.locality)
        self._observe_latency(t0, gkey, scheduled=True)
        self.trace.record("bind", gang=gkey, detail={
            "node": node_name, "locality": asg.locality})
        return None

    def _bind_gang_member(self, pod: Pod, gspec: GangSpec,
                          node_name: str, t0: float) -> str | None:
        ns = pod.metadata.namespace
        gkey = self._gkey(ns, gspec.name)
        if gkey not in self._wire_assumed:
            err = self._wire_assume(gkey, ns, gspec.name)
            if err is not None:
                return err
        entry = self._wire_assumed[gkey].get(pod.name)
        if entry is None:
            return f"pod is not a member of assumed gang {gspec.name}"
        node, alloc = entry
        if node != node_name:
            return (f"gang member is assigned to {node}, refusing bind "
                    f"to {node_name}")
        self._trace_schedule_root(gkey, t0, wire=True)
        self._write_retrying(
            self.api.patch_annotations, "Pod", pod.name,
            {ALLOCATE_FROM_KEY: allocation_to_annotation(alloc),
             MIGRATION_DEBT_KEY: None,   # repaid via the wire path too
             **self._trace_bind_annotation(gkey, pod.name, node_name)},
            namespace=ns)
        self._write_retrying(self.api.bind_pod, pod.name, node_name,
                             namespace=ns)
        self._wire_note_bound(gkey, pod.name, t0)
        return None

    def _wire_note_bound(self, gkey: str, pod_name: str,
                         t0: float) -> None:
        """Record one member's successful bind; on the last one the
        assumption is fulfilled and forgotten (annotations are now the
        whole truth)."""
        bound = self._wire_bound.setdefault(gkey, set())
        bound.add(pod_name)
        if bound == set(self._wire_assumed.get(gkey, ())):
            asg = self._committed.get(gkey)
            self._wire_assumed.pop(gkey, None)
            self._wire_assumed_at.pop(gkey, None)
            self._wire_bound.pop(gkey, None)
            if asg is not None:
                self.metrics.observe("allocation_locality", asg.locality)
            self._observe_latency(t0, gkey, scheduled=True)
            self.trace.record("bind", gang=gkey, detail={
                "pods": len(bound), "complete": True})

    def _wire_assume(self, gkey: str, ns: str, bare: str) -> str | None:
        """Hold-and-assume for a gang arriving over the webhook: when
        every member exists PENDING in the apiserver, compute one
        whole-gang assignment against full cluster state, COMMIT its
        occupancy now (so concurrent decisions see it), and cache each
        member's (node, Allocation) for its /filter and /bind calls.
        Returns the failure reason (served as every node's FailedNodes
        entry — the external scheduler's retry loop is the arrival
        barrier), or None once assumed."""
        members: dict[int, Pod] = {}
        placed = 0
        size = 0
        for p in self.api.list("Pod", namespace=ns):
            gs = pod_gang_spec(p)
            if gs is None or gs.name != bare:
                continue
            if p.status.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
                continue
            size = gs.size
            if pod_allocation(p) is not None:
                placed += 1
            elif p.status.phase == PodPhase.PENDING:
                members[gs.index] = p
        if placed and members:
            # Half-bound remnant of a LOST assumption (sync()/restart
            # between a gang's first and last bind): the pending members
            # can never re-assume (their siblings left PENDING), so the
            # gang would wedge forever.  Gang atomicity says members
            # restart together anyway — evict the whole gang; everyone
            # requeues PENDING and the external scheduler re-runs the
            # full flow from a clean slate.
            self._evict_gang_locked(
                gang=gkey,
                reason="partially-bound gang from a lost wire "
                "assumption; requeued whole for re-scheduling")
            return (f"gang {bare}: partially-applied assumption was "
                    "lost; members requeued, retry scheduling")
        if placed and not members:
            return f"gang {bare}: already fully bound"
        if not members:
            return f"gang {bare}: no pending members visible"
        if len(members) < size or set(members) != set(range(size)):
            return f"gang {bare} waiting ({len(members)}/{size})"
        pods = [members[i] for i in range(size)]
        try:
            req = self._request_for_gang(gkey, pods)
        except ValueError as e:
            return f"invalid gang request: {e}"
        quota_reason = self._quota_violation(pods, req)
        if quota_reason is not None:
            self.metrics.inc("schedule_quota_denied")
            return quota_reason
        asg = self.allocator.find_assignment(
            list(self.slices.values()), req)
        if asg is None:
            return (f"gang {bare}: no contiguous placement for "
                    f"{req.total_chips} chips")
        coordinator, hostnames = GangAllocator.coordinator_for(
            asg, self.slices, port=self.coordinator_port)
        allocations = asg.to_allocations(coordinator, hostnames)
        self.allocator.commit(self.slices, asg)
        self._committed[gkey] = asg
        self._gang_priority[gkey] = max(p.spec.priority for p in pods)
        self._gang_migratable[gkey] = all(pod_migratable(p) for p in pods)
        entry: dict[str, tuple[str, object]] = {}
        for p, alloc in zip(pods, allocations):
            alloc.gang_name = bare
            self._pod_gang[self._gkey(ns, p.name)] = gkey
            entry[p.name] = (alloc.node_name, alloc)
        self._wire_assumed[gkey] = entry
        self._wire_assumed_at[gkey] = time.monotonic()
        self._wire_bound[gkey] = set()
        self.trace.record("wire-assume", gang=gkey, detail={
            "pods": size, "locality": asg.locality,
            "nodes": sorted({n for n, _ in entry.values()})})
        return None

    def _wire_expire(self) -> None:
        """Roll back assumptions the external scheduler abandoned (no
        bind within the gang grace): release the UNBOUND members' chips,
        shrink the committed assignment to the bound members (their
        allocations are annotation truth already), and forget the
        assumption so the next /filter re-assumes from live state."""
        now = time.monotonic()
        stale = [g for g, t in self._wire_assumed_at.items()
                 if now - t > self.gang_grace_s]
        for g in stale:
            entry = self._wire_assumed.pop(g)
            self._wire_assumed_at.pop(g, None)
            bound = self._wire_bound.pop(g, set())
            asg = self._committed.get(g)
            ns = self._split_gkey(g)[0]
            for name, (_, alloc) in entry.items():
                if name in bound:
                    continue
                st = self.slices.get(alloc.slice_id)
                if st is not None:
                    st.release(alloc.chips)
                self._pod_gang.pop(self._gkey(ns, name), None)
            if asg is None:
                continue
            if not bound:
                self._committed.pop(g, None)
                self._gang_priority.pop(g, None)
                self._gang_migratable.pop(g, None)
            else:
                bound_ids = {entry[n][1].worker_id for n in bound}
                self._committed[g] = GangAssignment(
                    slice_id=asg.slice_id,
                    pods=[p for p in asg.pods
                          if p.pod_index in bound_ids],
                    locality=asg.locality, score=asg.score)
            self.trace.record("wire-expire", gang=g, detail={
                "bound": len(bound), "assumed": len(entry)})

    # ------------------------------------------------------------------
    # Scheduling loop
    # ------------------------------------------------------------------

    def run_once(self) -> ScheduleResult:
        with self._lock:
            self._wire_expire()
            return self._run_once_locked()

    def _run_once_locked(self) -> ScheduleResult:
        """One pass over pending pods: group into gangs, place complete
        gangs atomically, write allocation annotations, bind.

        Units (singles and complete gangs) are scheduled in (priority
        desc, FIFO arrival) order — a gang's place in line is its FIRST
        member's arrival — so a late single can't grab the chip that
        blocks a gang which was queued ahead of it (fractional pods
        fragmenting a slice ahead of a whole-slice gang was the observed
        failure).  An INCOMPLETE gang at the head additionally blocks
        later units of its priority and below for ``gang_grace_s`` after
        its first member arrived — unless a what-if trial shows the unit
        can be *backfilled* without hurting ANY earlier-queued held
        unit's fit (in-grace gangs and backfill-denied units alike);
        when the grace expires, later units flow unconditionally again
        (deadlock-free work conservation)."""
        result = ScheduleResult()
        now = time.monotonic()
        pending = [p for p in self.api.list("Pod", phase=PodPhase.PENDING)
                   if p.spec.node_name is None]
        # FIFO by ORIGINAL arrival: an evicted+requeued pod carries its
        # first queue position (QUEUED_AT_KEY), so eviction never costs a
        # gang its seniority — without this, an equal-priority pending
        # unit could take the home a migration plan proved for a mover
        pending.sort(key=self._arrival)
        gangs: dict[str, _PendingGang] = {}
        units: list[tuple[str, object]] = []  # FIFO by first member
        for pod in pending:
            gspec = pod_gang_spec(pod)
            if gspec is None:
                units.append(("single", pod))
            else:
                gkey = self._gkey(pod.metadata.namespace, gspec.name)
                pg = gangs.get(gkey)
                if pg is None:
                    pg = gangs[gkey] = _PendingGang(spec=gspec)
                    units.append(("gang", gkey))
                pg.pods[gspec.index] = pod
        # forget incomplete-gang arrival times for gangs no longer pending
        self._gang_first_seen = {
            g: t for g, t in self._gang_first_seen.items() if g in gangs}
        # start every incomplete gang's grace clock at first-member
        # ARRIVAL, even while it waits behind a barrier — otherwise N
        # trickling gangs serve their graces serially (N·grace head-of-
        # line blocking instead of the documented per-gang bound)
        for gname, pg in gangs.items():
            if not pg.complete():
                self._gang_first_seen.setdefault(gname, now)

        def unit_priority(kind: str, unit) -> int:
            return (unit.spec.priority if kind == "single"
                    else gangs[unit].priority)

        def unit_key(kind: str, unit) -> str:
            return (self._gkey(unit.metadata.namespace, unit.name)
                    if kind == "single" else unit)

        # stable sort: priority desc, FIFO within equal priority
        units.sort(key=lambda ku: -unit_priority(*ku))

        # drop debts whose gang is gone entirely (user deleted the pods)
        present = {unit_key(k, u) for k, u in units}
        self._migration_debts = {
            g: r for g, r in self._migration_debts.items() if g in present}

        barrier: str | None = None  # incomplete gang blocking later units
        protected: list[GangRequest] = []  # held units' asks, queue order
        for kind, unit in units:
            if kind == "gang" and unit in self._wire_assumed:
                # mid-bind by an external scheduler over the webhook —
                # chips are already committed; don't double-place
                result.held.extend(
                    p.name for p in gangs[unit].pods.values())
                continue
            if kind == "gang" and not gangs[unit].complete():
                gname, pg = unit, gangs[unit]
                result.held.extend(p.name for p in pg.pods.values())
                first = self._gang_first_seen.get(gname, now)
                in_grace = now - first < self.gang_grace_s
                self.trace.record("hold", gang=gname, detail={
                    "have": len(pg.pods), "want": pg.spec.size,
                    "blocking": in_grace and barrier is None})
                if in_grace:
                    # in-grace gangs (head barrier AND later ones) keep
                    # their claim: later units must not steal their fit
                    if barrier is None:
                        barrier = gname
                    preq = self._projected_request(pg)
                    if preq is not None:
                        protected.append(preq)
                continue
            precomputed = None
            ukey = unit_key(kind, unit)
            # a debtor may take its own reserved home; everyone else must
            # prove the debts still fit after their placement
            debts = [r for g, r in self._migration_debts.items()
                     if g != ukey]
            if barrier is not None or debts:
                allowed, ureq, precomputed = self._may_backfill(
                    kind, unit, gangs, protected + debts)
                if not allowed:
                    names = ([unit.name] if kind == "single" else
                             [p.name for p in gangs[unit].pods.values()])
                    result.held.extend(names)
                    if ureq is not None:
                        # a held unit's ask is protected from LATER
                        # backfillers too — queue order is preserved
                        protected.append(ureq)
                    self.trace.record("defer", gang=unit if kind == "gang"
                                      else unit.name,
                                      detail={"behind": barrier
                                              or "migration-debt"})
                    continue
                if barrier is not None:
                    self.trace.record("backfill",
                                      gang=unit if kind == "gang"
                                      else unit.name,
                                      detail={"past": barrier})
            if kind == "single":
                pod = unit
                try:
                    req = self._request_for_single(pod)
                except ValueError as e:
                    self._reject(pod.name, [pod], str(e), result)
                    continue
                self._schedule_gang(
                    self._gkey(pod.metadata.namespace, pod.name),
                    [pod], req, result, priority=pod.spec.priority,
                    precomputed=precomputed)
                continue
            gkey = unit
            pg = gangs[gkey]
            self._gang_first_seen.pop(gkey, None)
            members = [pg.pods[i] for i in range(pg.spec.size)]
            try:
                req = self._request_for_gang(pg.spec.name, members)
            except ValueError as e:
                self._reject(gkey, members, str(e), result)
                continue
            self._schedule_gang(gkey, members, req, result,
                                priority=pg.priority,
                                precomputed=precomputed)
        return result

    # ------------------------------------------------------------------
    # Backfill (what-if trials on cloned slice states)
    # ------------------------------------------------------------------

    def _projected_request(self, pg: _PendingGang) -> GangRequest | None:
        """The request an incomplete gang WILL make once complete, shaped
        from its arrived members (gangs are homogeneous by contract)."""
        member = next(iter(pg.pods.values()))
        chips = member.spec.total_chips
        try:
            axes = self._sane_axes(pod_mesh_axes(member),
                                   pg.spec.size * chips)
            return GangRequest(
                gang_name=pg.spec.name,
                num_pods=pg.spec.size,
                chips_per_pod=chips,
                millitpu_per_pod=member.spec.total_millitpu,
                hbm_gib_per_chip=member.spec.max_hbm_gib,
                mesh_axes=axes,
                axis_weights=self._serving_weights(member, axes))
        except ValueError:
            return None

    def _may_backfill(self, kind: str, unit, gangs: dict,
                      protected: list[GangRequest]
                      ) -> tuple[bool, GangRequest | None,
                                 "GangAssignment | None"]:
        """Conservative backfill past the in-grace barrier: the unit may
        schedule iff a what-if trial shows every EARLIER-QUEUED held
        unit's request that fits today still fits after the unit is
        placed (requests are committed sequentially in queue order on
        both sides of the comparison).  Returns (allowed, request,
        assignment): the request comes back only when the unit is denied
        (so the caller can protect it from later backfillers); the probe
        assignment comes back on success so ``_schedule_gang`` doesn't
        repeat the placement search.  0-device units always pass (no TPU
        contention)."""
        try:
            if kind == "single":
                req = self._request_for_single(unit)
            else:
                pg = gangs[unit]
                req = self._request_for_gang(
                    unit, [pg.pods[i] for i in range(pg.spec.size)])
        except ValueError:
            return True, None, None  # rejected downstream; no resource risk
        if req.total_chips == 0 and req.millitpu_per_pod == 0:
            return True, None, None
        # find_assignment is read-only, so probe placement on the real
        # state first and clone only if the what-if comparison is needed
        asg = self.allocator.find_assignment(list(self.slices.values()), req)
        if asg is None:
            return False, req, None  # can't place now; held (not failed),
            #                          and protected against leapfrogging
        if not protected:
            return True, None, asg
        after = {sid: st.clone() for sid, st in self.slices.items()}
        self.allocator.commit(after, asg)
        before = {sid: st.clone() for sid, st in self.slices.items()}
        for preq in protected:
            a_before = self.allocator.find_assignment(
                list(before.values()), preq)
            if a_before is None:
                continue   # doesn't fit today anyway; can't be hurt
            self.allocator.commit(before, a_before)
            a_after = self.allocator.find_assignment(
                list(after.values()), preq)
            if a_after is None:
                return False, req, None
            self.allocator.commit(after, a_after)
        return True, None, asg

    def _reject(self, gang: str, members: list[Pod], reason: str,
                result: ScheduleResult) -> None:
        """Malformed requests must not abort the scheduling pass
        (one bad pod cannot starve the queue)."""
        result.unschedulable.extend(p.name for p in members)
        self.metrics.inc("schedule_invalid")
        self.trace.record("invalid", gang=gang, detail={"reason": reason})
        self._observe_latency(time.perf_counter(), gang, scheduled=False)

    def _effective_quota(self, ns: str):
        """Combined namespace budget — k8s ResourceQuota parity: EVERY
        quota object in the namespace enforces independently, so the
        effective limit per resource is the MINIMUM across the objects
        that specify it.  Returns a QuotaSpec, or None when the
        namespace has no quota objects (unlimited)."""
        from kubegpu_tpu_torch.kubemeta import QuotaSpec

        quotas = self.api.list("Quota", namespace=ns)
        if not quotas:
            return None
        chips = [q.spec.tpu_chips for q in quotas
                 if q.spec.tpu_chips is not None]
        milli = [q.spec.millitpu for q in quotas
                 if q.spec.millitpu is not None]
        return QuotaSpec(tpu_chips=min(chips) if chips else None,
                         millitpu=min(milli) if milli else None)

    def _quota_violation(self, members: list[Pod],
                         req: GangRequest) -> str | None:
        """Namespace ResourceQuota check (k8s parity): would admitting
        this gang push the namespace's LIVE device usage past its
        combined quota?  Usage is computed from annotation truth, so it
        survives scheduler restarts like everything else.  Returns the
        human reason, or None when within budget."""
        ns = members[0].metadata.namespace
        quota = self._effective_quota(ns)
        if quota is None:
            return None   # no quota objects → unlimited
        ask_chips = req.total_chips
        ask_milli = req.num_pods * req.millitpu_per_pod
        used_chips, used_milli, _ = self._namespace_usage(ns)
        limit_c = quota.tpu_chips
        limit_m = quota.millitpu
        if limit_c is not None and used_chips + ask_chips > limit_c:
            return (f"namespace {ns} chip quota: {used_chips} used + "
                    f"{ask_chips} requested > {limit_c}")
        if limit_m is not None and used_milli + ask_milli > limit_m:
            return (f"namespace {ns} millitpu quota: {used_milli} used + "
                    f"{ask_milli} requested > {limit_m}")
        return None

    def _namespace_usage(self, ns: str) -> tuple[int, int, dict]:
        """(used_chips, used_millitpu, per-gang {gkey: (chips, milli)})
        over LIVE allocations in the namespace — annotation truth, shared
        by the quota gate and the quota-preemption planner.  Allocations
        only exist on bound/running pods, so the field selectors keep the
        apiserver from cloning the whole cluster."""
        used_c = used_m = 0
        per_gang: dict[str, tuple[int, int]] = {}
        for pod in self.api.list("Pod", namespace=ns,
                                 phase=(PodPhase.SCHEDULED,
                                        PodPhase.RUNNING)):
            alloc = pod_allocation(pod)
            if alloc is None:
                continue
            gkey = self._gkey(ns, alloc.gang_name or pod.name)
            c = sum(1 for ch in alloc.chips if ch.millichips >= 1000)
            m = sum(ch.millichips for ch in alloc.chips
                    if ch.millichips < 1000)
            used_c += c
            used_m += m
            gc, gm = per_gang.get(gkey, (0, 0))
            per_gang[gkey] = (gc + c, gm + m)
        return used_c, used_m, per_gang

    def _schedule_gang(self, gang_name: str, members: list[Pod],
                       req: GangRequest, result: ScheduleResult,
                       priority: int = 0,
                       precomputed: GangAssignment | None = None) -> None:
        """``gang_name`` is the namespace-qualified gang key."""
        t0 = time.perf_counter()
        # per-decision phase attribution: the
        # expensive search phases are timed separately so the bench
        # can bucket what the slowest 1% of decisions spent their time
        # on — enumeration (incl. ordering), the multislice split
        # search, preemption planning, migration planning
        phases = {"enumerate": 0.0, "multislice_split": 0.0,
                  "preemption_plan": 0.0, "migration_plan": 0.0}

        def absorb():
            for k, v in getattr(self.allocator, "last_phase_ms",
                                {}).items():
                phases[k] = phases.get(k, 0.0) + v

        quota_reason = self._quota_violation(members, req)
        if quota_reason is not None \
                and any(p < priority for p in self._gang_priority.values()):
            # intra-tenant priority: evict the namespace's own
            # lower-priority gangs to free quota room (capacity preemption
            # alone never fires here — the quota gate precedes placement)
            victims = self._plan_quota_preemption(
                members[0].metadata.namespace, req, priority)
            if victims:
                for victim in victims:
                    self.metrics.inc("gangs_preempted")
                    self.evict_gang(
                        victim,
                        f"quota-preempted by {gang_name} (priority "
                        f"{priority} > "
                        f"{self._gang_priority.get(victim, 0)})")
                quota_reason = self._quota_violation(members, req)
        if quota_reason is not None:
            result.unschedulable.extend(p.name for p in members)
            self.metrics.inc("schedule_quota_denied")
            self.trace.record("quota", gang=gang_name,
                              detail={"reason": quota_reason})
            log.warning("quota_denied", gang=gang_name,
                        reason=quota_reason)
            self._observe_latency(t0, gang_name, scheduled=False)
            return
        # 0-device pods (CPU fallback, BASELINE config 1): bind to any
        # ready node, TPU-bearing or not.
        if req.total_chips == 0 and req.millitpu_per_pod == 0:
            nodes = [n for n in self.api.list("Node") if n.status.ready]
            if not nodes:
                result.unschedulable.extend(p.name for p in members)
                self._observe_latency(t0, gang_name, scheduled=False)
                return
            target = min(nodes, key=lambda n: n.name)
            for pod in members:
                self._write_retrying(self.api.bind_pod, pod.name,
                                     target.name,
                                     namespace=pod.metadata.namespace)
                result.scheduled.append(pod.name)
            self._observe_latency(t0, gang_name, scheduled=True)
            return

        # the backfill probe may have found the placement already (same
        # slice state — nothing mutates between probe and here)
        if precomputed is not None:
            asg = precomputed
        else:
            asg = self.allocator.find_assignment(
                list(self.slices.values()), req)
            absorb()
        preemptible = any(p < priority for p in self._gang_priority.values())
        if asg is None and preemptible:
            t_pre = time.perf_counter()
            victims = self._plan_preemption(req, priority)
            phases["preemption_plan"] += \
                (time.perf_counter() - t_pre) * 1e3
            if victims:
                for victim in victims:
                    self.metrics.inc("gangs_preempted")
                    self.evict_gang(
                        victim,
                        f"preempted by {gang_name} "
                        f"(priority {priority} > "
                        f"{self._gang_priority.get(victim, 0)})")
                asg = self.allocator.find_assignment(
                    list(self.slices.values()), req)
                absorb()
        if asg is None and any(self._gang_migratable.values()):
            # defragmentation: migrate MIGRATABLE gangs (checkpointed
            # workloads that tolerate a restart) to compact space — only
            # under a joint plan proving the requester fits AND every
            # migrated gang re-places afterwards
            t_mig = time.perf_counter()
            movers = self._plan_migration(req, priority)
            phases["migration_plan"] += \
                (time.perf_counter() - t_mig) * 1e3
            if movers:
                for victim in movers:
                    # record the mover's re-ask as a debt BEFORE evicting
                    # (the request needs the still-committed assignment)
                    vreq = self._request_for_committed(victim)
                    self.metrics.inc("gangs_migrated")
                    requeued = self.evict_gang(
                        victim,
                        f"migrated to defragment for {gang_name}")
                    if vreq is not None:
                        self._migration_debts[victim] = vreq
                        # persist on the requeued pods: a scheduler
                        # restart must not drop the home reservation
                        # (annotation truth)
                        vns = self._split_gkey(victim)[0]
                        payload = migration_debt_to_annotation(vreq)
                        from kubegpu_tpu_torch.kubemeta import NotFound
                        for pname in requeued:
                            try:
                                self.api.patch_annotations(
                                    "Pod", pname,
                                    {MIGRATION_DEBT_KEY: payload},
                                    namespace=vns)
                            except NotFound:
                                pass
                asg = self.allocator.find_assignment(
                    list(self.slices.values()), req)
                absorb()
        if asg is None:
            result.unschedulable.extend(p.name for p in members)
            self.metrics.inc("schedule_unschedulable")
            self.trace.record("fail", gang=gang_name, detail={
                "pods": len(members), "chips": req.total_chips,
                "millitpu": req.millitpu_per_pod,
                "total_ms": (time.perf_counter() - t0) * 1e3,
                "phase_ms": dict(phases)})
            # failed decisions are decisions: the MOST expensive paths
            # (full shape search + preemption + migration planning, all
            # failing) must land in the p50/p99 histogram, or the
            # headline number only measures the easy successes
            self._observe_latency(t0, gang_name, scheduled=False)
            return

        coordinator, hostnames = GangAllocator.coordinator_for(
            asg, self.slices, port=self.coordinator_port)
        allocations = asg.to_allocations(coordinator, hostnames)
        self.allocator.commit(self.slices, asg)
        self._committed[gang_name] = asg
        self._gang_priority[gang_name] = priority
        self._gang_migratable[gang_name] = all(
            pod_migratable(p) for p in members)
        self._migration_debts.pop(gang_name, None)   # debt repaid
        bare_gang = self._split_gkey(gang_name)[1]
        self._trace_schedule_root(gang_name, t0, slice=asg.slice_id,
                                  locality=asg.locality,
                                  score=asg.score)
        for pod, alloc in zip(members, allocations):
            alloc.gang_name = bare_gang   # wire format: bare name
            self._pod_gang[self._gkey(pod.metadata.namespace,
                                      pod.name)] = gang_name
            self.api.patch_annotations(
                "Pod", pod.name,
                {ALLOCATE_FROM_KEY: allocation_to_annotation(alloc),
                 # debt repaid: drop the persisted home reservation
                 MIGRATION_DEBT_KEY: None,
                 **self._trace_bind_annotation(
                     gang_name, pod.name, alloc.node_name)},
                namespace=pod.metadata.namespace)
            self._write_retrying(self.api.bind_pod, pod.name,
                                  alloc.node_name,
                                  namespace=pod.metadata.namespace)
            result.scheduled.append(pod.name)
        self.metrics.set_gauge("last_allocation_locality", asg.locality)
        self.metrics.observe("allocation_locality", asg.locality)
        self._observe_latency(t0, gang_name, scheduled=True)
        self.trace.record("schedule", gang=gang_name, detail={
            "slice": asg.slice_id, "locality": asg.locality,
            "score": asg.score,
            "nodes": sorted({p.node_name for p in asg.pods}),
            "total_ms": (time.perf_counter() - t0) * 1e3,
            "phase_ms": dict(phases)})
        log.info("schedule", gang=gang_name, slices=asg.slice_ids,
                 pods=len(members), locality=round(asg.locality, 4),
                 priority=priority)

    def _observe_latency(self, t0: float, gang: str, scheduled: bool) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        self.metrics.observe("schedule_latency_ms", ms)
        self.metrics.inc("gangs_scheduled" if scheduled else "gangs_failed")

    # ------------------------------------------------------------------
    # Request tracing: root span per gang decision + a bind
    # span per pod whose context is THE propagation token
    # ------------------------------------------------------------------

    def _trace_schedule_root(self, gkey: str, t0: float, **attrs) -> None:
        """Root a trace for this gang's decision (backdated to t0) and
        link the gang id, so subsequent ScheduleTrace events and every
        downstream layer (crishim, engine) join the same trace.
        Idempotent: a gang already linked keeps its root."""
        if self.tracer is None or self.tracer.gang_context(gkey):
            return
        sp = self.tracer.start_span(
            "sched.schedule", attrs={"gang": gkey, **attrs})
        sp.t0 = t0
        self.tracer.link_gang(gkey, sp)
        sp.end()

    def _trace_bind_annotation(self, gkey: str, pod_name: str,
                               node: str) -> dict:
        """Record one pod's bind span and return the annotation
        fragment carrying its propagation token ({} when tracing is
        off — the patch stays byte-identical to the untraced build)."""
        if self.tracer is None:
            return {}
        with self.tracer.span("sched.bind",
                              parent=self.tracer.gang_context(gkey),
                              attrs={"gang": gkey, "pod": pod_name,
                                     "node": node}) as sp:
            token = sp.context.encode()
        return {TRACE_ANNOTATION: token}

    # ------------------------------------------------------------------
    # Pod lifecycle: return resources on completion/deletion (§4.4)
    # ------------------------------------------------------------------

    def return_pod_resources(self, pod_name: str, namespace: str) -> None:
        """Namespace is REQUIRED: pod identity is namespace-qualified,
        and a defaulted wrong namespace would silently no-op and leak the
        gang's chips until the next full sync."""
        with self._lock:
            gang = self._pod_gang.pop(self._gkey(namespace, pod_name),
                                      None)
            if gang is None:
                return
            # release only when the last member of the gang is gone
            if any(g == gang for g in self._pod_gang.values()):
                return
            self._gang_priority.pop(gang, None)
            self._gang_migratable.pop(gang, None)
            self._wire_assumed.pop(gang, None)
            self._wire_assumed_at.pop(gang, None)
            self._wire_bound.pop(gang, None)
            asg = self._committed.pop(gang, None)
            if asg is not None:
                # rollback skips vanished slices (multislice: free the rest)
                self.allocator.rollback(self.slices, asg)
                self.trace.record("release", gang=gang,
                                  detail={"slices": asg.slice_ids})

    # ------------------------------------------------------------------
    # Preemption + eviction (shared with the fault-recovery controller)
    # ------------------------------------------------------------------

    def _eviction_could_help(self, req: GangRequest) -> bool:
        """Exact necessary condition for ANY eviction plan to succeed:
        some slice (or, multislice, the union) must have enough chips
        that are healthy, advertised, and HBM-sufficient — occupancy
        aside, since eviction can only free occupancy.  O(chips); run
        before cloning slices and trial-evicting (p99 bound)."""
        if req.total_chips == 0:
            return True
        usable_total = 0
        for st in self.slices.values():
            if req.chips_per_pod > st.spec.chips_per_host:
                continue
            usable = sum(
                1 for c in st.available
                if c not in st.unhealthy
                and (req.hbm_gib_per_chip <= 0
                     or st.hbm_gib.get(c, 0.0) >= req.hbm_gib_per_chip))
            if usable >= req.total_chips:
                return True
            usable_total += usable
        return req.allow_multislice and usable_total >= req.total_chips

    def _greedy_evict_plan(self, order: list[str], req: GangRequest
                           ) -> tuple[list[str], dict] | None:
        """Shared planner skeleton (capacity preemption AND migration):
        on cloned slice states, roll victims back in ``order`` until
        ``req`` places, then a minimization pass re-admits any victim the
        fit doesn't actually need.  Returns (chosen victims, trial state
        with survivors committed and victims freed), or None when no set
        works (then nobody is evicted — no pointless thrash).

        Bounded: at most ``max_planning_victims`` evictions are tried
        (each costs a find_assignment); a plan needing more is treated
        as infeasible this pass, keeping the failing-decision latency
        tail flat under bin-packing pressure."""
        if not order or not self._eviction_could_help(req):
            return None
        order = order[:self.max_planning_victims]
        trial = {sid: st.clone() for sid, st in self.slices.items()}
        chosen: list[str] = []
        fits = False
        for victim in order:
            asg = self._committed[victim]
            if not any(sid in trial for sid in asg.slice_ids):
                continue   # every slice gone; eviction frees nothing
            self.allocator.rollback(trial, asg)
            chosen.append(victim)
            if self.allocator.find_assignment(
                    list(trial.values()), req) is not None:
                fits = True
                break
        if not fits:
            return None
        # minimize: re-admit victims the placement doesn't actually need
        for victim in list(chosen):
            asg = self._committed[victim]
            self.allocator.commit(trial, asg)
            if self.allocator.find_assignment(
                    list(trial.values()), req) is None:
                self.allocator.rollback(trial, asg)   # still required
            else:
                chosen.remove(victim)
        return chosen, trial

    def _plan_preemption(self, req: GangRequest,
                         priority: int) -> list[str] | None:
        """Victim gangs (strictly lower priority) whose eviction lets
        ``req`` fit.  Greedy lowest-priority first (newest commit breaks
        ties, k8s-style 'youngest victim'), minimized."""
        idx = {g: i for i, g in enumerate(self._committed)}
        order = sorted(
            (g for g in self._committed
             if self._gang_priority.get(g, 0) < priority),
            key=lambda g: (self._gang_priority.get(g, 0), -idx[g]))
        plan = self._greedy_evict_plan(order, req)
        return plan[0] if plan else None

    def _plan_quota_preemption(self, ns: str, req: GangRequest,
                               priority: int) -> list[str] | None:
        """Victims (strictly lower priority, SAME namespace — per-gang
        usage is namespace-scoped) whose eviction brings the namespace's
        usage plus ``req`` back under its Quota.  Greedy
        lowest-priority-first with newest-commit tie-break, then a
        minimization pass re-admits victims the budget doesn't need, then
        a PLACEMENT feasibility trial on cloned slice states (the evicted
        chips must actually let ``req`` place, counting a follow-up
        capacity preemption) — no eviction set is returned unless the
        whole plan succeeds, so quota pressure never thrash-kills gangs
        it cannot benefit from."""
        quota = self._effective_quota(ns)
        if quota is None:
            return None
        idx = {g: i for i, g in enumerate(self._committed)}
        order = sorted(
            (g for g in self._committed
             if self._gang_priority.get(g, 0) < priority),
            key=lambda g: (self._gang_priority.get(g, 0), -idx[g]))
        need_c = req.total_chips
        need_m = req.num_pods * req.millitpu_per_pod
        used_c, used_m, gang_usage = self._namespace_usage(ns)

        def fits(c: int, m: int) -> bool:
            if quota.tpu_chips is not None \
                    and c + need_c > quota.tpu_chips:
                return False
            if quota.millitpu is not None \
                    and m + need_m > quota.millitpu:
                return False
            return True

        chosen: list[str] = []
        for victim in order:
            if fits(used_c, used_m):
                break
            vc, vm = gang_usage.get(victim, (0, 0))
            if vc == 0 and vm == 0:
                continue   # other-namespace gang; frees no quota here
            used_c -= vc
            used_m -= vm
            chosen.append(victim)
        if not (fits(used_c, used_m) and chosen):
            return None
        # minimize: re-admit victims the budget doesn't actually need
        for victim in list(chosen):
            vc, vm = gang_usage.get(victim, (0, 0))
            if fits(used_c + vc, used_m + vm):
                used_c += vc
                used_m += vm
                chosen.remove(victim)
        # placement feasibility: with the victims' chips freed (plus any
        # follow-up capacity preemption of remaining lower-priority
        # gangs), must req actually place?  Otherwise evicting buys
        # nothing and the victims would thrash.
        if not self._eviction_could_help(req):
            return None
        trial = {sid: st.clone() for sid, st in self.slices.items()}
        for victim in chosen:
            asg = self._committed[victim]
            self.allocator.rollback(trial, asg)
        if self.allocator.find_assignment(
                list(trial.values()), req) is None:
            placed = False
            for victim in order[:self.max_planning_victims]:
                if victim in chosen:
                    continue
                asg = self._committed[victim]
                if not any(sid in trial for sid in asg.slice_ids):
                    continue
                self.allocator.rollback(trial, asg)
                if self.allocator.find_assignment(
                        list(trial.values()), req) is not None:
                    placed = True
                    break
            if not placed:
                return None
        return chosen

    def _request_for_committed(self, gang: str) -> GangRequest | None:
        """Rebuild a committed gang's request from its assignment +
        member annotations (the shape a migrated gang will re-ask for)."""
        asg = self._committed.get(gang)
        if asg is None or not asg.pods or not asg.pods[0].chips:
            return None
        chips_per_pod = len(asg.pods[0].chips)
        if asg.pods[0].chips[0].millichips < 1000:
            return None   # fractional singles aren't worth migrating
        members = self.gang_member_pods(gang)
        axes = pod_mesh_axes(members[0]) if members else None
        try:
            sane = self._sane_axes(axes, len(asg.pods) * chips_per_pod)
            return GangRequest(
                gang_name=gang, num_pods=len(asg.pods),
                chips_per_pod=chips_per_pod,
                # max across members — must match _request_for_gang's
                # floor or a migration plan could 'close' on chips the
                # real re-schedule then rejects (stranding the mover)
                hbm_gib_per_chip=max(
                    (p.spec.max_hbm_gib for p in members), default=0.0),
                mesh_axes=sane,
                axis_weights=(self._serving_weights(members[0], sane)
                              if members else None),
                allow_multislice=bool(members)
                and pod_multislice(members[0]))
        except ValueError:
            return None

    def _plan_migration(self, req: GangRequest,
                        priority: int) -> list[str] | None:
        """Defragmentation plan: the FEWEST MIGRATABLE committed gangs
        (priority <= requester — migration must never disturb more
        important work) whose eviction lets ``req`` place, under a JOINT
        feasibility trial: after placing ``req`` on the cloned state,
        every migrated gang's own request must re-place too (it was
        running; the plan must leave it a home, not strand it pending —
        and queue seniority preservation in evict_gang keeps pending
        units from stealing that home).  Returns None unless the whole
        plan closes."""
        idx = {g: i for i, g in enumerate(self._committed)}
        # largest-footprint first: each eviction frees the most space, so
        # the greedy loop disturbs the fewest gangs (minimization prunes
        # any leftovers); victims' re-ask requests are built LAZILY only
        # for the chosen few (each build lists the namespace's pods)
        order = sorted(
            (g for g in self._committed
             if self._gang_migratable.get(g, False)
             and self._gang_priority.get(g, 0) <= priority
             and self._committed[g].pods
             and self._committed[g].pods[0].chips
             and self._committed[g].pods[0].chips[0].millichips >= 1000),
            key=lambda g: (-sum(len(p.chips)
                                for p in self._committed[g].pods),
                           self._gang_priority.get(g, 0), -idx[g]))
        plan = self._greedy_evict_plan(order, req)
        if plan is None:
            return None
        chosen, trial = plan
        # joint closure: place req, then every mover must re-place
        req_asg = self.allocator.find_assignment(list(trial.values()), req)
        if req_asg is None:
            return None
        self.allocator.commit(trial, req_asg)
        for victim in chosen:
            vreq = self._request_for_committed(victim)
            if vreq is None:
                return None   # re-ask can't be rebuilt → no guarantee
            v_asg = self.allocator.find_assignment(
                list(trial.values()), vreq)
            if v_asg is None:
                return None   # would strand the migrated gang
            self.allocator.commit(trial, v_asg)
        return chosen

    def gang_member_pods(self, gang: str) -> list[Pod]:
        """LIVE members of a namespace-qualified gang key, identified by
        namespace + their allocation's gang name (annotation truth).
        Terminal pods are excluded: a completed member keeps its
        allocation annotation, and evicting it would silently resurrect
        and re-run a finished workload."""
        from kubegpu_tpu_torch.kubemeta import pod_allocation

        ns, bare = self._split_gkey(gang)
        out = []
        for p in self.api.list("Pod", namespace=ns):
            if p.status.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
                continue
            alloc = pod_allocation(p)
            if alloc is not None and (alloc.gang_name or p.name) == bare:
                out.append(p)
        return out

    def evict_gang(self, gang: str, reason: str,
                   requeue: bool = True) -> list[str]:
        """Whole-gang eviction + requeue (used by preemption here and by
        the fault-recovery controller): delete every live member (kills
        containers via node-agent reconcile, frees chips via the
        return-resources path), then recreate identical PENDING pods —
        same name/spec/gang, no binding, no allocation annotation — so the
        next pass schedules the gang fresh.  Returns requeued pod names.

        ``requeue=False`` is the SCALE-DOWN variant: the
        gang's capacity is being retired on purpose, so members are
        deleted but never recreated — the delete still flows to every
        watcher (the serving pool's health watch sees it), chips still
        free, and nothing re-enters the queue."""
        with self._lock:
            return self._evict_gang_locked(gang, reason, requeue)

    def _evict_gang_locked(self, gang: str, reason: str,
                           requeue: bool = True) -> list[str]:
        from kubegpu_tpu_torch.kubemeta import NotFound
        from kubegpu_tpu_torch.kubemeta.objects import ObjectMeta, PodStatus

        pods = self.gang_member_pods(gang)
        self.trace.record("evict", gang=gang, detail={
            "reason": reason, "pods": sorted(p.name for p in pods)})
        log.warning("evict", gang=gang, reason=reason, pods=len(pods))
        for pod in pods:
            try:
                self.api.delete("Pod", pod.name,
                                namespace=pod.metadata.namespace)
            except NotFound:
                pass
            # Belt-and-braces: free chips even when no lifecycle wiring
            # (e.g. scheduler used standalone in tests) — idempotent, the
            # first call pops the pod from the gang map.
            self.return_pod_resources(pod.name, pod.metadata.namespace)
        if not requeue:
            return [pod.name for pod in pods]
        from kubegpu_tpu_torch.kubemeta.codec import QUEUED_AT_KEY

        requeued: list[str] = []
        for pod in pods:
            annotations = {k: v for k, v in pod.metadata.annotations.items()
                           if k != ALLOCATE_FROM_KEY}
            # preserve queue seniority across (repeated) evictions
            annotations.setdefault(QUEUED_AT_KEY,
                                   str(self._arrival(pod)))
            fresh = Pod(
                metadata=ObjectMeta(
                    name=pod.metadata.name,
                    namespace=pod.metadata.namespace,
                    labels=dict(pod.metadata.labels),
                    annotations=annotations),
                spec=pod.spec,
                status=PodStatus(phase=PodPhase.PENDING,
                                 message=f"requeued: {reason}"))
            fresh.spec.node_name = None
            self.api.create("Pod", fresh)
            requeued.append(fresh.name)
        return requeued

    def spawn_serving_gang(self, gang: str, size: int = 1,
                           chips: int = 1,
                           namespace: str = "default",
                           mesh_axes: dict[str, int] | None = None,
                           role: str | None = None) -> list[str]:
        """Scale-up half of the serving control loop:
        create ``size`` serving pods under gang ``gang`` and run one
        scheduling pass so they bind immediately — the SAME gang-
        scheduled path every hand-submitted serving pod takes (serving
        axis weights, role annotation and all), just driven by the
        autoscaler instead of an operator.  Returns the pod names;
        node agents start the containers on their next reconcile."""
        from kubegpu_tpu_torch.cluster import tpu_pod   # lazy: no cycle
        from kubegpu_tpu_torch.kubemeta import GangSpec
        from kubegpu_tpu_torch.kubemeta.codec import set_pod_serve_role

        names: list[str] = []
        for k in range(size):
            pod = tpu_pod(
                f"{gang}-{k}", chips=chips, workload="serving",
                gang=GangSpec(name=gang, size=size, index=k),
                mesh_axes={"tp": chips} if mesh_axes is None
                else mesh_axes,
                namespace=namespace, command=["noop"])
            if role is not None:
                set_pod_serve_role(pod, role)
            self.api.create("Pod", pod)
            names.append(pod.metadata.name)
        self.run_once()
        return names

    # ------------------------------------------------------------------
    # Request construction
    # ------------------------------------------------------------------

    @staticmethod
    def _sane_axes(axes: dict[str, int] | None,
                   total_chips: int) -> dict[str, int] | None:
        """Drop a mesh-axes hint whose product doesn't match the chip ask
        (hints degrade gracefully; they never make a pod unschedulable)."""
        if not axes or total_chips <= 0:
            return None
        prod = 1
        for v in axes.values():
            prod *= v
        return axes if prod == total_chips else None

    @staticmethod
    def _serving_weights(pod: Pod, axes: dict[str, int] | None
                         ) -> dict[str, float] | None:
        """Serving gangs score their slices with the SERVING traffic
        model (topology sees serving slices as what they are): tp
        psums ride every decode step while dp replicas never exchange
        a byte — so the allocator should spend its contiguous ICI on
        the tp rings and may scatter replicas freely.  A disaggregated
        gang's role annotation (``serve-role``: prefill | decode)
        further relaxes tp tightness for prefill specialists, whose
        collectives hide behind batch compute."""
        if axes is None or pod_workload_kind(pod) != "serving":
            return None
        from kubegpu_tpu_torch.kubemeta.codec import pod_serve_role
        from kubegpu_tpu_torch.topology.locality import serving_axis_weights
        return serving_axis_weights(axes, role=pod_serve_role(pod))

    def _request_for_single(self, pod: Pod) -> GangRequest:
        chips = pod.spec.total_chips
        axes = self._sane_axes(pod_mesh_axes(pod), chips)
        return GangRequest(
            gang_name=pod.name,
            num_pods=1,
            chips_per_pod=chips,
            millitpu_per_pod=pod.spec.total_millitpu,
            hbm_gib_per_chip=pod.spec.max_hbm_gib,
            mesh_axes=axes,
            axis_weights=self._serving_weights(pod, axes),
        )

    def _request_for_gang(self, gang_name: str,
                          members: list[Pod]) -> GangRequest:
        per_pod = {p.spec.total_chips for p in members}
        milli = {p.spec.total_millitpu for p in members}
        if len(per_pod) != 1 or len(milli) != 1:
            raise ValueError(f"gang {gang_name}: heterogeneous asks")
        chips = per_pod.pop()
        axes = self._sane_axes(pod_mesh_axes(members[0]),
                               len(members) * chips)
        return GangRequest(
            gang_name=gang_name,
            num_pods=len(members),
            chips_per_pod=chips,
            millitpu_per_pod=milli.pop(),
            hbm_gib_per_chip=max(p.spec.max_hbm_gib for p in members),
            mesh_axes=axes,
            axis_weights=self._serving_weights(members[0], axes),
            allow_multislice=pod_multislice(members[0]),
        )

    def _slice_of_node(self, node_name: str) -> SliceState | None:
        for st in self.slices.values():
            if node_name in st.node_of_host.values():
                return st
        return None
