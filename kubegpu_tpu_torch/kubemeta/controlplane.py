"""Fake apiserver — the in-process control plane all components talk through
(copied from ``kubegpu_tpu/kubemeta/controlplane.py``).

Reference parity (SURVEY.md §2 key property + §5): scheduler ↔ node agent
coordination flows exclusively through apiserver objects; tests run the real
scheduler/crishim code against this fake with identical semantics: objects
with resourceVersion bumps, strategic-merge-style annotation patches, list
with label selectors, and watch (delivered synchronously to subscribers —
the informer pattern without goroutines).

Thread-safe: the scheduler loop, advertiser ticks, and workload runtimes may
touch it from different threads (SURVEY.md §6 race-detection requirement —
stress-tested in tests/test_controlplane.py).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterator

from kubegpu_tpu_torch.kubemeta.objects import Node, Pod


@dataclass(frozen=True)
class WatchEvent:
    kind: str      # "Pod" | "Node"
    type: str      # "ADDED" | "MODIFIED" | "DELETED"
    obj: object    # deep copy — consumers cannot mutate server state


class Conflict(Exception):
    """resourceVersion mismatch on update — caller must re-read and retry."""


class NotFound(Exception):
    pass


@dataclass
class _Store:
    objects: dict[str, object] = field(default_factory=dict)


class FakeApiServer:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._stores: dict[str, _Store] = {
            "Pod": _Store(), "Node": _Store(), "Quota": _Store()}
        self._watchers: list[Callable[[WatchEvent], None]] = []
        self._rv = 0
        # Watch delivery happens OUTSIDE self._lock: a callback that
        # re-enters a component holding its own lock (the scheduler's)
        # while another thread holds that lock and calls into the
        # apiserver would otherwise ABBA-deadlock.  Events queue under
        # self._lock (FIFO order fixed by mutation order) and a single
        # drainer at a time delivers them; _drain never blocks on the
        # delivery lock, so a thread that queued while a drain is active
        # just leaves its event for the active drainer.
        self._delivery = threading.Lock()
        self._pending_events: deque[WatchEvent] = deque()

    # -- internals -------------------------------------------------------

    def _bump(self, obj) -> None:
        self._rv += 1
        obj.metadata.resource_version = self._rv

    def _notify(self, ev: WatchEvent) -> None:
        """Queue an event (called under self._lock); delivery is via
        :meth:`_drain` after the mutator releases the lock."""
        self._pending_events.append(ev)

    def _drain(self) -> None:
        if not self._delivery.acquire(blocking=False):
            return   # an active drainer will deliver our queued event
        try:
            while True:
                with self._lock:
                    if not self._pending_events:
                        return
                    ev = self._pending_events.popleft()
                    watchers = list(self._watchers)
                for w in watchers:
                    w(ev)
        finally:
            self._delivery.release()

    @staticmethod
    def _key(namespace: str, name: str) -> str:
        return f"{namespace}/{name}"

    # -- CRUD ------------------------------------------------------------

    def create(self, kind: str, obj) -> object:
        with self._lock:
            store = self._stores[kind]
            key = self._key(obj.metadata.namespace, obj.metadata.name)
            if key in store.objects:
                raise Conflict(f"{kind} {key} already exists")
            self._bump(obj)
            store.objects[key] = obj.clone()
            self._notify(WatchEvent(kind, "ADDED", obj.clone()))
            out = obj.clone()
        self._drain()
        return out

    def get(self, kind: str, name: str, namespace: str = "default"):
        with self._lock:
            store = self._stores[kind]
            key = self._key(namespace, name)
            if key not in store.objects:
                raise NotFound(f"{kind} {key}")
            return store.objects[key].clone()

    def list(self, kind: str, label_selector: dict[str, str] | None = None,
             *, node_name: str | None = None, phase=None,
             namespace: str | None = None):
        """``node_name``/``phase``/``namespace`` are field selectors (k8s
        ``spec.nodeName=...``/``status.phase=...``/namespace scoping):
        filtering happens BEFORE the per-object copy, so a node agent
        asking for its own scheduled pods doesn't pay for cloning the
        whole cluster.  ``phase`` accepts one PodPhase or a tuple of
        them.  node_name/phase are Pod-only selectors; namespace works
        for any kind."""
        if (node_name is not None or phase is not None) and kind != "Pod":
            raise ValueError(
                f"node_name/phase are Pod field selectors (kind={kind})")
        if phase is not None and not isinstance(phase, tuple):
            phase = (phase,)
        with self._lock:
            out = []
            for obj in self._stores[kind].objects.values():
                if label_selector and any(
                    obj.metadata.labels.get(k) != v
                    for k, v in label_selector.items()
                ):
                    continue
                if namespace is not None \
                        and obj.metadata.namespace != namespace:
                    continue
                if node_name is not None \
                        and obj.spec.node_name != node_name:
                    continue
                if phase is not None and obj.status.phase not in phase:
                    continue
                out.append(obj.clone())
            return out

    def update(self, kind: str, obj) -> object:
        """Optimistic-concurrency replace: resourceVersion must match."""
        with self._lock:
            store = self._stores[kind]
            key = self._key(obj.metadata.namespace, obj.metadata.name)
            if key not in store.objects:
                raise NotFound(f"{kind} {key}")
            current = store.objects[key]
            if obj.metadata.resource_version != current.metadata.resource_version:
                raise Conflict(
                    f"{kind} {key}: rv {obj.metadata.resource_version} != "
                    f"{current.metadata.resource_version}")
            self._bump(obj)
            store.objects[key] = obj.clone()
            self._notify(WatchEvent(kind, "MODIFIED", obj.clone()))
            out = obj.clone()
        self._drain()
        return out

    def patch_annotations(self, kind: str, name: str,
                          annotations: dict[str, str | None],
                          namespace: str = "default"):
        """Strategic-merge patch of annotations only — the reference's
        ``client-go Patch`` path used by the advertiser and the allocation
        write-back (SURVEY.md §4.1/§4.2).  Never conflicts.  A ``None``
        value DELETES the key (k8s strategic-merge null semantics).
        """
        with self._lock:
            store = self._stores[kind]
            key = self._key(namespace, name)
            if key not in store.objects:
                raise NotFound(f"{kind} {key}")
            obj = store.objects[key]
            for k, v in annotations.items():
                if v is None:
                    obj.metadata.annotations.pop(k, None)
                else:
                    obj.metadata.annotations[k] = v
            self._bump(obj)
            self._notify(WatchEvent(kind, "MODIFIED", obj.clone()))
            out = obj.clone()
        self._drain()
        return out

    def bind_pod(self, name: str, node_name: str,
                 namespace: str = "default") -> None:
        """The scheduler's bind verb (kube-scheduler posts a Binding)."""
        from kubegpu_tpu_torch.kubemeta.objects import PodPhase
        with self._lock:
            key = self._key(namespace, name)
            pod = self._stores["Pod"].objects.get(key)
            if pod is None:
                raise NotFound(f"Pod {key}")
            pod.spec.node_name = node_name
            pod.status.phase = PodPhase.SCHEDULED
            self._bump(pod)
            self._notify(WatchEvent("Pod", "MODIFIED", pod.clone()))
        self._drain()

    def set_pod_phase(self, name: str, phase, message: str = "",
                      exit_code: int | None = None,
                      namespace: str = "default",
                      expect_uid: str | None = None) -> None:
        """``expect_uid`` makes the write incarnation-safe: if the pod was
        deleted and recreated under the same name (gang eviction) between
        the caller's read and this write, the stale write is rejected as
        NotFound instead of stamping the new pod's phase."""
        with self._lock:
            key = self._key(namespace, name)
            pod = self._stores["Pod"].objects.get(key)
            if pod is None:
                raise NotFound(f"Pod {key}")
            if expect_uid is not None and pod.metadata.uid != expect_uid:
                raise NotFound(f"Pod {key} uid {pod.metadata.uid} != "
                               f"{expect_uid} (recreated)")
            pod.status.phase = phase
            pod.status.message = message
            if exit_code is not None:
                pod.status.exit_code = exit_code
            self._bump(pod)
            self._notify(WatchEvent("Pod", "MODIFIED", pod.clone()))
        self._drain()

    def set_node_ready(self, name: str, ready: bool,
                       namespace: str = "default") -> None:
        """Node-lifecycle verb (node controller marking NotReady on missed
        heartbeats — the k8s-native failure detection SURVEY.md §6 says the
        reference relied on)."""
        with self._lock:
            key = self._key(namespace, name)
            node = self._stores["Node"].objects.get(key)
            if node is None:
                raise NotFound(f"Node {key}")
            if node.status.ready == ready:
                return
            node.status.ready = ready
            self._bump(node)
            self._notify(WatchEvent("Node", "MODIFIED", node.clone()))
        self._drain()

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        with self._lock:
            store = self._stores[kind]
            key = self._key(namespace, name)
            if key not in store.objects:
                raise NotFound(f"{kind} {key}")
            obj = store.objects.pop(key)
            self._notify(WatchEvent(kind, "DELETED", obj.clone()))
        self._drain()

    # -- watch -----------------------------------------------------------

    def watch(self, callback: Callable[[WatchEvent], None]) -> Callable[[], None]:
        """Subscribe; returns an unsubscribe function.  Events fire inside
        the mutating call (synchronous informer) — callbacks must not
        re-enter the apiserver with blocking writes from another thread.
        """
        with self._lock:
            self._watchers.append(callback)
        def unsubscribe() -> None:
            with self._lock:
                if callback in self._watchers:
                    self._watchers.remove(callback)
        return unsubscribe

    # -- convenience -----------------------------------------------------

    def pods(self) -> Iterator[Pod]:
        yield from self.list("Pod")

    def nodes(self) -> Iterator[Node]:
        yield from self.list("Node")
