"""Failure detection + elastic recovery (SURVEY.md §6; copied from
``kubegpu_tpu/scheduler/health.py``: on an H100 node a chip is a card, and
an ICI link an NVLink pair, which ``NvmlBackend`` advertises bad once NVML
stops reporting it).

The reference had no first-party failure handling — it leaned on
Kubernetes-native behavior (node NotReady eviction, pod restart policies)
and on its annotations-as-truth design making the scheduler restartable.
This controller is the TPU-native equivalent SURVEY.md §6 specifies: a
chip/link marked bad (or a host going NotReady) makes the slices containing
it infeasible, and any *committed gang* touching the fault is evicted and
requeued so the scheduler re-places it on a fresh healthy sub-mesh.

Gang semantics drive the whole-gang eviction: a multi-worker program is
all-or-nothing (its ``torch.distributed`` workers must restart together to
form a new process group; a survivor blocks in its collective until it is
killed), so losing one worker's chips means evicting every member — partial
recovery is impossible by construction.

Eviction here collapses two k8s actors into one step, the same way the rest
of the simulated control plane does: the *eviction* (delete) and the *Job /
StatefulSet controller* recreating an identical pending pod.  The recreated
pod keeps its name, spec, gang membership, and mesh-axes hint; it loses its
binding and allocation annotation, so the next scheduling pass treats the
gang as brand new.  Workload-side resume is the checkpoint story (the
reference's ``TrainCheckpointer``, ROADMAP item 9 in the port).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubegpu_tpu_torch.allocator.gang import GangAssignment, SliceState
from kubegpu_tpu_torch.kubemeta import FakeApiServer, Pod, PodPhase
from kubegpu_tpu_torch.kubemeta.controlplane import WatchEvent
from kubegpu_tpu_torch.obs import MetricsRegistry, ScheduleTrace
from kubegpu_tpu_torch.scheduler.extender import DeviceScheduler


@dataclass
class RecoveryResult:
    evicted_gangs: dict[str, str] = field(default_factory=dict)  # gang → why
    requeued_pods: list[str] = field(default_factory=list)


class FaultRecoveryController:
    """Watches Node health, detects broken committed gangs, evicts+requeues.

    Runs as part of the control-plane tick (SimCluster.step), before the
    scheduling pass, so a fault observed at tick T has its gangs back in the
    queue for the same tick's scheduling decision.
    """

    def __init__(self, api: FakeApiServer, scheduler: DeviceScheduler,
                 metrics: MetricsRegistry | None = None,
                 trace: ScheduleTrace | None = None):
        self.api = api
        self.scheduler = scheduler
        self.metrics = metrics or scheduler.metrics
        self.trace = trace or scheduler.trace
        self._dirty = True  # first pass always inspects
        self._degraded: set[str] = set()  # gangs left on a bad link
        self._unsub = api.watch(self._on_event)

    def close(self) -> None:
        self._unsub()

    def _on_event(self, ev: WatchEvent) -> None:
        # Any node change (readiness flip, re-advertisement after a fault
        # injection, node add/remove) can change slice health.  Pod churn
        # matters only while a degraded gang waits for capacity to free up
        # (a completing pod may open the better footprint it needs).
        if ev.kind == "Node" or (ev.kind == "Pod" and self._degraded):
            self._dirty = True

    # ------------------------------------------------------------------

    def run_once(self) -> RecoveryResult:
        result = RecoveryResult()
        if not self._dirty:
            return result
        self._dirty = False
        # Re-sync slice states from annotation truth: not-ready nodes drop
        # out (their coords leave `available`), re-advertised health lands
        # in `unhealthy`/`bad_links`.
        self.scheduler.sync()
        self._degraded.clear()
        for gang, asg in list(self.scheduler._committed.items()):
            broken = self._broken_reason(asg)
            if broken is None:
                continue
            reason, kind = broken
            if kind == "link" and not self._better_placement_exists(gang, asg):
                # The dead link degrades this gang, but every alternative is
                # the same footprint (or nothing) — evicting would thrash.
                # Tracked so pod churn re-triggers this evaluation.
                self._degraded.add(gang)
                self.trace.record("degraded", gang=gang,
                                  detail={"reason": reason})
                continue
            self._evict_gang(gang, reason, result)
        if result.evicted_gangs:
            # Eviction released chips; the queue sees the pods next pass.
            self.metrics.inc("gangs_evicted", len(result.evicted_gangs))
        return result

    # ------------------------------------------------------------------

    def _broken_reason(self, asg: GangAssignment) -> tuple[str, str] | None:
        """(human reason, kind) — kind 'hard' (chips gone) or 'link'
        (degraded: chips fine, an interior ICI link died).  Every slice
        the gang touches is inspected, and a 'hard' fault anywhere wins
        over a 'link' fault elsewhere — a multislice gang with one slice
        merely degraded and another DEAD must evict, not park."""
        link_found: tuple[str, str] | None = None
        for sid in asg.slice_ids:
            st = self.scheduler.slices.get(sid)
            if st is None:
                return f"slice {sid} disappeared (all hosts down)", "hard"
            coords = [ch.coord for p in asg.pods
                      if asg.pod_slice(p) == sid for ch in p.chips]
            coord_set = set(coords)
            for c in coords:
                if c not in st.available:
                    return (f"chip {c} no longer advertised (host down)",
                            "hard")
                if c in st.unhealthy:
                    return f"chip {c} marked unhealthy", "hard"
            # A dead ICI link strictly inside the allocation footprint
            # breaks the gang's collectives (rings detour → catastrophic
            # slowdown on a torus) — re-place if anywhere better exists.
            if link_found is None:
                for a, b in st.bad_links:
                    if a in coord_set and b in coord_set:
                        link_found = (
                            f"ICI link {a}–{b} failed inside allocation",
                            "link")
                        break
        return link_found

    def _better_placement_exists(self, gang: str,
                                 asg: GangAssignment) -> bool:
        """Trial re-placement with this gang's chips freed: is there an
        assignment on a different footprint?  (Scoring already penalizes
        bad links, so a different footprint means a better one.)

        The trial request is rebuilt from the committed assignment itself
        — not from live member pods — so partially-completed or
        already-garbage-collected members can't skew the shape."""
        from kubegpu_tpu_torch.allocator import GangRequest
        from kubegpu_tpu_torch.kubemeta import pod_mesh_axes, pod_multislice

        if not asg.pods or not asg.pods[0].chips:
            return False
        chips_per_pod = len(asg.pods[0].chips)
        members = self._gang_member_pods(gang)
        axes = pod_mesh_axes(members[0]) if members else None
        try:
            req = GangRequest(
                gang_name=gang, num_pods=len(asg.pods),
                chips_per_pod=chips_per_pod,
                # same HBM floor the real re-schedule will enforce — an
                # 'alternative' on low-HBM chips would evict toward a
                # placement _request_for_gang then rejects (stranding)
                hbm_gib_per_chip=max(
                    (p.spec.max_hbm_gib for p in members), default=0.0),
                mesh_axes=self.scheduler._sane_axes(
                    axes, len(asg.pods) * chips_per_pod),
                # a multislice gang's alternative may also be multislice
                allow_multislice=bool(members)
                and pod_multislice(members[0]))
        except ValueError:
            return False
        alloc = self.scheduler.allocator
        slices = self.scheduler.slices
        alloc.rollback(slices, asg)
        try:
            alt = alloc.find_assignment(list(slices.values()), req)
        finally:
            alloc.commit(slices, asg)
        if alt is None:
            return False
        # coords are slice-local, so compare (slice, coord) pairs — an
        # untagged union would conflate colliding coords across slices of
        # a multislice gang
        cur = {(asg.pod_slice(p), ch.coord)
               for p in asg.pods for ch in p.chips}
        new = {(alt.pod_slice(p), ch.coord)
               for p in alt.pods for ch in p.chips}
        return new != cur

    def _gang_member_pods(self, gang: str) -> list[Pod]:
        return self.scheduler.gang_member_pods(gang)

    def _evict_gang(self, gang: str, reason: str,
                    result: RecoveryResult) -> None:
        # Delete-first + recreate-pending lives on the scheduler (shared
        # with priority preemption).
        result.requeued_pods.extend(self.scheduler.evict_gang(gang, reason))
        result.evicted_gangs[gang] = reason
