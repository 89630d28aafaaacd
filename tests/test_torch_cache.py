"""The port's watch cache (``kubegpu_tpu_torch/kubemeta/cache.py``, the
scheduler's reflector) against the JAX package's: one scripted sequence of
writes, stale echoes, deletes and a reset gives the same cached state in
both.  Then the reference's own cases on the port: reads served locally,
read-your-writes, strictly-newer-wins, tombstones, relist on reset,
convergence under churn, and a scheduling pass over HTTP that issues zero
list requests."""

import threading
import time

import pytest

from kubegpu_tpu import cluster as rcluster
from kubegpu_tpu.kubemeta import cache as rcache
from kubegpu_tpu.kubemeta import controlplane as rcp
from kubegpu_tpu_torch import cluster as pcluster
from kubegpu_tpu_torch.cluster import tpu_pod
from kubegpu_tpu_torch.kubemeta import (
    Conflict,
    FakeApiServer,
    NotFound,
    PodPhase,
)
from kubegpu_tpu_torch.kubemeta import cache as pcache
from kubegpu_tpu_torch.kubemeta import controlplane as pcp
from kubegpu_tpu_torch.kubemeta.apiserver_http import (
    ApiServerHTTP,
    HttpApiClient,
)
from kubegpu_tpu_torch.kubemeta.cache import WatchCachedApiClient
from kubegpu_tpu_torch.kubemeta.controlplane import WatchEvent


class CountingApi(FakeApiServer):
    """FakeApiServer that counts ``list`` calls (the reads the cache must
    absorb)."""

    def __init__(self):
        super().__init__()
        self.list_calls = 0

    def list(self, *a, **kw):
        self.list_calls += 1
        return super().list(*a, **kw)


def _state(client):
    return sorted((p.metadata.namespace, p.name, p.metadata.resource_version,
                   p.status.phase.value, p.spec.node_name,
                   tuple(sorted(p.metadata.annotations.items())))
                  for p in client.list("Pod"))


def _script(cl, cp, cache_mod):
    """Writes through the cache and behind it, stale echoes, a delete's
    pre-delete echo, a recreate and a reset; the cache's state after each
    phase."""
    api = cp.FakeApiServer()
    cache = cache_mod.WatchCachedApiClient(api)
    snaps = []
    cache.create("Pod", cl.tpu_pod("a", chips=1, command=["x"]))
    api.create("Pod", cl.tpu_pod("b", chips=1, command=["x"]))
    before = api.get("Pod", "a")
    cache.patch_annotations("Pod", "a", {"k": "v"})
    cache._on_event(cp.WatchEvent("Pod", "MODIFIED", before))   # stale
    cache.bind_pod("a", "node-0")
    cache.set_pod_phase("a", type(before.status.phase)("Running"))
    api.bind_pod("b", "node-1")
    snaps.append(_state(cache))
    doomed = api.get("Pod", "b")
    cache.delete("Pod", "b")
    cache._on_event(cp.WatchEvent("Pod", "MODIFIED", doomed))   # pre-delete
    snaps.append((_state(cache), sorted(cache._tombstones["Pod"])))
    cache.create("Pod", cl.tpu_pod("b", chips=2, command=["y"]))
    api.patch_annotations("Pod", "b", {"n": "2"})
    snaps.append(_state(cache))
    cache._relist()
    snaps.append((_state(cache) == _state(api), _state(cache)))
    cache.close()
    return snaps


def test_scripted_state_equals_the_references():
    got = _script(pcluster, pcp, pcache)
    want = _script(rcluster, rcp, rcache)
    assert got == want
    assert got[1][1] == [] and got[-1][0]


def test_reads_served_locally_after_seed():
    api = CountingApi()
    api.create("Pod", tpu_pod("a", chips=1, command=["x"]))
    cache = WatchCachedApiClient(api)
    seeded = api.list_calls          # the 3 seed lists
    assert [p.name for p in cache.list("Pod")] == ["a"]
    cache.get("Pod", "a")
    cache.list("Pod", phase=PodPhase.PENDING)
    assert api.list_calls == seeded, "reads leaked to the inner api"


def test_watch_events_update_store():
    api = FakeApiServer()
    cache = WatchCachedApiClient(api)
    api.create("Pod", tpu_pod("late", chips=1, command=["x"]))
    assert [p.name for p in cache.list("Pod")] == ["late"]
    api.delete("Pod", "late")
    assert cache.list("Pod") == []


def test_field_selector_parity_with_server():
    api = FakeApiServer()
    cache = WatchCachedApiClient(api)
    api.create("Pod", tpu_pod("p1", chips=1, command=["x"]))
    api.create("Pod", tpu_pod("p2", chips=1, command=["x"]))
    api.bind_pod("p1", "node-a")
    for kw in ({"phase": PodPhase.PENDING}, {"node_name": "node-a"},
               {"phase": (PodPhase.PENDING, PodPhase.SCHEDULED)}):
        want = sorted(p.name for p in api.list("Pod", **kw))
        assert sorted(p.name for p in cache.list("Pod", **kw)) == want, kw
    with pytest.raises(ValueError, match="field selectors"):
        cache.list("Node", phase=PodPhase.PENDING)


def test_list_returns_clones():
    api = FakeApiServer()
    cache = WatchCachedApiClient(api)
    api.create("Pod", tpu_pod("p", chips=1, command=["x"]))
    cache.list("Pod")[0].metadata.annotations["mut"] = "ated"
    assert "mut" not in cache.list("Pod")[0].metadata.annotations


def test_read_your_writes_bind_and_patch():
    """A bind through the cache is visible to the next local read before
    the watch echo lands: a bound pod stays out of the next PENDING
    scan."""
    api = FakeApiServer()
    cache = WatchCachedApiClient(api)
    cache.create("Pod", tpu_pod("p", chips=1, command=["x"]))
    cache.bind_pod("p", "node-a")
    got = cache.get("Pod", "p")
    assert got.spec.node_name == "node-a"
    assert got.status.phase == PodPhase.SCHEDULED
    assert cache.list("Pod", phase=PodPhase.PENDING) == []
    cache.patch_annotations("Pod", "p", {"k": "v"})
    assert cache.get("Pod", "p").metadata.annotations["k"] == "v"


def test_stale_echo_cannot_roll_back():
    api = FakeApiServer()
    cache = WatchCachedApiClient(api)
    cache.create("Pod", tpu_pod("p", chips=1, command=["x"]))
    before = api.get("Pod", "p")
    cache.patch_annotations("Pod", "p", {"k": "v"})
    cache._on_event(WatchEvent("Pod", "MODIFIED", before))
    assert cache.get("Pod", "p").metadata.annotations.get("k") == "v"


def test_relist_keeps_newer_writethrough():
    api = FakeApiServer()
    cache = WatchCachedApiClient(api)
    cache.create("Pod", tpu_pod("p", chips=1, command=["x"]))
    stale_list = list(api.list("Pod"))
    cache.patch_annotations("Pod", "p", {"k": "v"})

    def stale(kind, *a, **kw):
        return list(stale_list) if kind == "Pod" else []
    cache.inner = type("I", (), {"list": staticmethod(stale)})()
    try:
        cache._relist()
    finally:
        cache.inner = api
    assert cache.get("Pod", "p").metadata.annotations.get("k") == "v"


def test_concurrent_writers_converge():
    """Threads churn one pool of names, half through the cache and half
    behind it, while readers list: after quiescence the cache is exactly
    the server (no ghosts, no losses, no stale rows, no tombstones)."""
    api = FakeApiServer()
    cache = WatchCachedApiClient(api)
    errs: list[Exception] = []

    def churn(tid: int, via_cache: bool):
        client = cache if via_cache else api
        try:
            for i in range(120):
                name = f"p{(i + tid) % 7}"
                op = (i + tid) % 5
                try:
                    if op == 0:
                        client.create("Pod", tpu_pod(name, chips=1,
                                                     command=["x"]))
                    elif op == 1:
                        client.patch_annotations("Pod", name, {"i": str(i)})
                    elif op == 2:
                        client.bind_pod(name, f"node-{tid}")
                    elif op == 3:
                        client.set_pod_phase(name, PodPhase.RUNNING)
                    else:
                        client.delete("Pod", name)
                except (NotFound, Conflict):
                    pass
                if i % 10 == 0:
                    cache.list("Pod", phase=PodPhase.PENDING)
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=churn, args=(t, t % 2 == 0))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    api.create("Pod", tpu_pod("flush", chips=0, command=["x"]))
    api.delete("Pod", "flush")
    assert _state(cache) == _state(api)
    assert not any(cache._tombstones.values()), "leaked tombstones"


def test_reset_over_http_relists():
    """The server evicts the cache's position from its replay buffer: the
    client's reset hook relists, and objects whose events were lost
    appear (and deleted ones go)."""
    from kubegpu_tpu_torch.kubemeta import apiserver_http as phttp
    api = FakeApiServer()
    srv = ApiServerHTTP(api).start()
    client = HttpApiClient(srv.address)
    cache = WatchCachedApiClient(client)
    try:
        api.create("Pod", tpu_pod("gone", chips=0, command=["x"]))
        deadline = time.monotonic() + 10
        while not cache.list("Pod") and time.monotonic() < deadline:
            time.sleep(0.02)
        with srv._cond:      # lose every event from here on
            srv._events = phttp.deque(maxlen=1)
            api.delete("Pod", "gone")
            for i in range(3):
                api.create("Pod", tpu_pod(f"new{i}", chips=0, command=["x"]))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                _state(cache) != _state(api):
            time.sleep(0.02)
        assert [p.name for p in cache.list("Pod")] == ["new0", "new1",
                                                       "new2"]
    finally:
        srv.close()
        cache.close()
        client.close()


def test_scheduler_reads_zero_http_lists():
    """``DeviceScheduler`` over the cache over ``HttpApiClient``: after the
    seed, a scheduling pass issues no HTTP list request, and its bind
    crosses the wire."""
    from kubegpu_tpu_torch.crishim.agent import NodeAgent
    from kubegpu_tpu_torch.crishim.runtime import FakeRuntime
    from kubegpu_tpu_torch.scheduler import DeviceScheduler
    from kubegpu_tpu_torch.tpuplugin import MockBackend

    api = FakeApiServer()
    srv = ApiServerHTTP(api).start()
    client = HttpApiClient(srv.address)
    cache = None
    try:
        NodeAgent(api, MockBackend("h100-sxm-8"), FakeRuntime()).register()
        cache = WatchCachedApiClient(client)
        calls = {"list": 0}
        real_call = client._call

        def counting_call(method, path, *a, **kw):
            if method == "GET" and path.startswith("/apis/") \
                    and "/" not in path[len("/apis/"):]:
                calls["list"] += 1
            return real_call(method, path, *a, **kw)
        client._call = counting_call

        sched = DeviceScheduler(cache)
        after_init = calls["list"]
        api.create("Pod", tpu_pod("job", chips=1, command=["x"]))
        # pass again until the watch has delivered what the pass needs
        deadline = time.monotonic() + 10
        res = sched.run_once()
        while not res.scheduled and time.monotonic() < deadline:
            time.sleep(0.02)
            res = sched.run_once()
        assert res.scheduled == ["job"]
        assert calls["list"] == after_init, \
            "run_once issued HTTP list calls despite the cache"
        assert api.get("Pod", "job").status.phase == PodPhase.SCHEDULED
    finally:
        srv.close()
        if cache is not None:
            cache.close()
        client.close()
