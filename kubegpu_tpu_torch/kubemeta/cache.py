"""Watch-fed read cache over an api client — the scheduler's reflector
(copied from ``kubegpu_tpu/kubemeta/cache.py``).

The reference scheduler never re-lists the cluster per decision: client-go
reflectors maintain a local store from ONE list + a watch stream, and the
scheduler reads that (SURVEY.md §2, §4.2).  This is that piece for the
HTTP wire: :class:`WatchCachedApiClient` exposes the same method surface
as ``FakeApiServer``/``HttpApiClient``, but ``list``/``get`` are served
from a local store fed by the watch, so a ``DeviceScheduler`` running in
its own process pays zero HTTP round trips per read — only writes cross
the wire.  Without this, every ``run_once`` pass over the wire costs
O(kinds) full-cluster lists at one RTT each.

Consistency rules (the part that must be exact, not fast):

- **Read-your-writes**: every mutating verb applies its effect to the
  local store immediately (the returned object where the verb returns
  one; a mirrored mutation for the void verbs ``bind_pod`` /
  ``set_pod_phase`` / ``set_node_ready``).  The scheduler binds a pod
  and must not see it PENDING on its next pass just because the watch
  echo is still in flight.
- **Strictly-newer wins**: watch events apply only when the event
  object's ``resource_version`` is strictly greater than the cached
  one.  The echo of a write we already applied (same rv) is a no-op,
  so a pre-write clone can never transiently roll back a local
  write-through.  Deletes are guarded the same way against
  delete/recreate races.
- **Reset ⇒ relist**: if the server's watch replay buffer evicted our
  position (k8s "resourceVersion too old"), the whole store is rebuilt
  from fresh lists — events were LOST, not merely delayed.

Subscribers via :meth:`watch` are notified AFTER the store has applied
the event, so a callback that reads back through the cache always sees
at-least-that-event state.
"""

from __future__ import annotations

import threading
from typing import Callable

from kubegpu_tpu_torch.kubemeta.controlplane import NotFound, WatchEvent
from kubegpu_tpu_torch.obs import get_logger

log = get_logger("apicache")

KINDS = ("Pod", "Node", "Quota")


class WatchCachedApiClient:
    """FakeApiServer-compatible surface; reads local, writes through."""

    def __init__(self, inner):
        self.inner = inner
        self._lock = threading.RLock()
        self._objs: dict[str, dict[str, object]] = {k: {} for k in KINDS}
        # local-delete tombstones: keys we deleted whose DELETED event
        # has not arrived yet — an in-flight MODIFIED echo (emitted
        # before our delete, same or lower rv) must not resurrect the
        # object in the window before its tombstone event lands
        self._tombstones: dict[str, set[str]] = {k: set() for k in KINDS}
        self._watchers: list[Callable[[WatchEvent], None]] = []
        # subscribe FIRST, then seed: anything created between the two
        # arrives as an event and the strict-rv guard resolves overlap
        # with the seed lists in either order
        try:
            self._unsub = inner.watch(self._on_event,
                                      on_reset=self._relist)
        except TypeError:   # FakeApiServer.watch has no on_reset (it
            self._unsub = inner.watch(self._on_event)   # never resets)
        self._relist()

    # -- store maintenance ----------------------------------------------

    @staticmethod
    def _key(obj) -> str:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    def _relist(self) -> None:
        """Rebuild the entire store from authoritative lists (initial
        seed + watch-reset recovery).  Objects the lists no longer
        contain are dropped — their DELETED events are gone forever."""
        with self._lock:
            for kind in KINDS:
                fresh = {}
                for obj in self.inner.list(kind):
                    fresh[self._key(obj)] = obj
                # keep cached entries that are NEWER than the list's
                # copy (a write-through that landed mid-relist)
                for key, cached in self._objs[kind].items():
                    lf = fresh.get(key)
                    if lf is not None and (cached.metadata.resource_version
                                           > lf.metadata.resource_version):
                        fresh[key] = cached
                self._objs[kind] = fresh
                # lists are authoritative AND the reset dropped every
                # in-flight event a tombstone was guarding against —
                # clear them all (a kept tombstone would wrongly block
                # a future recreation's ADDED)
                self._tombstones[kind] = set()
        log.info("relist", kinds=len(KINDS))

    def _apply(self, kind: str, obj, deleted: bool = False) -> None:
        """Newer-wins store update.  ADDED/MODIFIED apply only on a
        STRICTLY greater rv (the echo of a write we already hold, and
        any pre-write clone, must not roll back a void-verb
        write-through carrying the same rv).  DELETED applies on >=
        — the server deletes without bumping, so the tombstone arrives
        at the object's last rv; only a delete older than a local
        recreate is skipped."""
        key = self._key(obj)
        store = self._objs[kind]
        ts = self._tombstones[kind]
        if deleted:
            ts.discard(key)   # the tombstone's own event has landed
        elif key in ts:
            return   # pre-delete echo: the object is locally deleted
        cached = store.get(key)
        if cached is not None:
            rv, crv = (obj.metadata.resource_version,
                       cached.metadata.resource_version)
            if (rv < crv) or (rv == crv and not deleted):
                return
        if deleted:
            store.pop(key, None)
        else:
            store[key] = obj

    def _on_event(self, ev: WatchEvent) -> None:
        with self._lock:
            if ev.kind in self._objs:
                self._apply(ev.kind, ev.obj, deleted=ev.type == "DELETED")
            watchers = list(self._watchers)
        for w in watchers:
            w(ev)

    # -- reads (served locally) -----------------------------------------

    def get(self, kind: str, name: str, namespace: str = "default"):
        with self._lock:
            obj = self._objs.get(kind, {}).get(f"{namespace}/{name}")
            if obj is not None:
                return obj.clone()
        # miss: not necessarily absent — it may simply postdate our last
        # event; the inner client is authoritative
        return self.inner.get(kind, name, namespace=namespace)

    def list(self, kind: str, label_selector: dict[str, str] | None = None,
             *, node_name: str | None = None, phase=None,
             namespace: str | None = None):
        if (node_name is not None or phase is not None) and kind != "Pod":
            raise ValueError(
                f"node_name/phase are Pod field selectors (kind={kind})")
        if phase is not None and not isinstance(phase, tuple):
            phase = (phase,)
        with self._lock:
            out = []
            for obj in self._objs.get(kind, {}).values():
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

    # -- writes (forwarded + applied locally) ---------------------------

    def create(self, kind: str, obj):
        out = self.inner.create(kind, obj)
        if kind in self._objs:
            with self._lock:
                # delete-then-recreate: our create is authoritative —
                # the tombstone must not suppress the new incarnation
                self._tombstones[kind].discard(
                    f"{out.metadata.namespace}/{out.metadata.name}")
                self._apply(kind, out.clone())
        return out

    def update(self, kind: str, obj):
        out = self.inner.update(kind, obj)
        if kind in self._objs:
            with self._lock:
                self._apply(kind, out.clone())
        return out

    def patch_annotations(self, kind: str, name: str,
                          annotations: dict[str, str | None],
                          namespace: str = "default"):
        out = self.inner.patch_annotations(kind, name, annotations,
                                           namespace=namespace)
        if kind in self._objs:
            with self._lock:
                self._apply(kind, out.clone())
        return out

    def bind_pod(self, name: str, node_name: str,
                 namespace: str = "default") -> None:
        from kubegpu_tpu_torch.kubemeta.objects import PodPhase
        self.inner.bind_pod(name, node_name, namespace=namespace)
        with self._lock:
            pod = self._objs["Pod"].get(f"{namespace}/{name}")
            if pod is not None:
                pod.spec.node_name = node_name
                pod.status.phase = PodPhase.SCHEDULED

    def set_pod_phase(self, name: str, phase, message: str = "",
                      exit_code: int | None = None,
                      namespace: str = "default",
                      expect_uid: str | None = None) -> None:
        self.inner.set_pod_phase(name, phase, message=message,
                                 exit_code=exit_code, namespace=namespace,
                                 expect_uid=expect_uid)
        with self._lock:
            pod = self._objs["Pod"].get(f"{namespace}/{name}")
            if pod is not None and (expect_uid is None
                                    or pod.metadata.uid == expect_uid):
                pod.status.phase = phase
                pod.status.message = message
                if exit_code is not None:
                    pod.status.exit_code = exit_code

    def set_node_ready(self, name: str, ready: bool,
                       namespace: str = "default") -> None:
        self.inner.set_node_ready(name, ready, namespace=namespace)
        with self._lock:
            node = self._objs["Node"].get(f"{namespace}/{name}")
            if node is not None:
                node.status.ready = ready

    def delete(self, kind: str, name: str,
               namespace: str = "default") -> None:
        if kind not in self._objs:
            self.inner.delete(kind, name, namespace=namespace)
            return
        key = f"{namespace}/{name}"
        # tombstone BEFORE the server call: a synchronous inner
        # (FakeApiServer drains its DELETED event inside delete()) or a
        # fast poll thread can deliver the tombstone-clearing event
        # before this method resumes — adding afterwards would leak a
        # tombstone that permanently blinds the cache to any future
        # same-name object
        with self._lock:
            popped = self._objs[kind].pop(key, None)
            self._tombstones[kind].add(key)
        try:
            self.inner.delete(kind, name, namespace=namespace)
        except BaseException:
            with self._lock:
                if key in self._tombstones[kind]:
                    # our delete did not happen AND no DELETED event has
                    # landed: roll back.  (If a concurrent deleter's
                    # DELETED event already consumed the tombstone, the
                    # object IS gone server-side — restoring `popped`
                    # would plant a permanent ghost, since its only
                    # DELETED event was just spent.)
                    self._tombstones[kind].discard(key)
                    if popped is not None and key not in self._objs[kind]:
                        self._objs[kind][key] = popped
            raise

    # -- watch ----------------------------------------------------------

    def watch(self, callback: Callable[[WatchEvent], None]
              ) -> Callable[[], None]:
        """Subscribe to post-apply events: when the callback fires, a
        read through this cache reflects at least that event."""
        with self._lock:
            self._watchers.append(callback)

        def unsubscribe() -> None:
            with self._lock:
                if callback in self._watchers:
                    self._watchers.remove(callback)
        return unsubscribe

    def close(self) -> None:
        if getattr(self, "_unsub", None) is not None:
            self._unsub()
