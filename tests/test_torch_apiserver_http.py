"""The port's HTTP apiserver (``kubegpu_tpu_torch/kubemeta/
apiserver_http.py``) and its object documents (``serialize.py``) against
the JAX package's: the same objects give the same documents, and one
request sequence sent to both servers gets the same status codes, bodies
and watch stream.  Then the reference's own cases on the port: the REST
surface, the long-poll watch, and the node agent in another process that
reaches the control plane only over HTTP and the CRI socket (frames and
gRPC)."""

import json
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from kubegpu_tpu import cluster as rcluster
from kubegpu_tpu import kubemeta as rkm
from kubegpu_tpu.kubemeta import apiserver_http as rhttp
from kubegpu_tpu.kubemeta import controlplane as rcp
from kubegpu_tpu.kubemeta import serialize as rser
from kubegpu_tpu_torch.cluster import tpu_pod
from kubegpu_tpu_torch.kubemeta import (
    Conflict,
    FakeApiServer,
    GangSpec,
    Node,
    NotFound,
    ObjectMeta,
    PodPhase,
    Quota,
    QuotaSpec,
)
from kubegpu_tpu_torch.kubemeta.apiserver_http import (
    ApiServerHTTP,
    HttpApiClient,
)
from kubegpu_tpu_torch.kubemeta.codec import pod_gang_spec
from kubegpu_tpu_torch.kubemeta.serialize import from_doc, to_doc
from kubegpu_tpu_torch.obs import MetricsRegistry, global_registry


def _wait(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture
def served():
    api = FakeApiServer()
    srv = ApiServerHTTP(api).start()
    client = HttpApiClient(srv.address)
    yield api, srv, client
    srv.close()      # first: it answers the client's pending long-poll
    client.close()


# -- documents ------------------------------------------------------------

def _pod_kw():
    return dict(chips=2, command=["python", "-m", "x"], env={"A": "1"},
                priority=3, namespace="team-a",
                gang=GangSpec(name="g", size=4, index=1),
                mesh_axes={"dp": 2, "tp": 2}, hbm_gib=8.0)


def test_pod_document_equals_the_references():
    pod = tpu_pod("p", **_pod_kw())
    kw = _pod_kw()
    kw["gang"] = rkm.GangSpec(name="g", size=4, index=1)
    rpod = rcluster.tpu_pod("p", **kw)
    for p in (pod, rpod):
        p.metadata.uid = "uid-0"
        p.spec.node_name = "node-0"
        p.status.phase = type(p.status.phase)("Running")
    doc = to_doc("Pod", pod)
    assert doc == rser.to_doc("Pod", rpod)
    assert to_doc("Pod", from_doc("Pod", doc)) == doc
    assert rser.to_doc("Pod", rser.from_doc("Pod", doc)) == doc


def test_pod_roundtrip():
    pod = tpu_pod("p", **_pod_kw())
    pod.spec.node_name = "node-0"
    pod.status.phase = PodPhase.RUNNING
    back = from_doc("Pod", to_doc("Pod", pod))
    assert back.metadata.name == "p" and back.metadata.namespace == "team-a"
    assert back.metadata.uid == pod.metadata.uid
    assert back.spec.node_name == "node-0" and back.spec.priority == 3
    assert back.status.phase == PodPhase.RUNNING
    c = back.spec.containers[0]
    assert c.resources.tpu_chips == 2 and c.resources.hbm_gib == 8.0
    assert c.command == ["python", "-m", "x"] and c.env == {"A": "1"}
    assert pod_gang_spec(back) == GangSpec(name="g", size=4, index=1)


def test_node_and_quota_documents_equal_the_references():
    node = Node(metadata=ObjectMeta(name="n0", annotations={"k": "v"},
                                    uid="u"))
    node.status.ready = False
    doc = to_doc("Node", node)
    assert doc == rser.to_doc("Node", rser.from_doc("Node", doc))
    back = from_doc("Node", doc)
    assert back.name == "n0" and back.status.ready is False
    assert back.metadata.annotations == {"k": "v"}
    q = Quota(metadata=ObjectMeta(name="quota", namespace="t", uid="u"),
              spec=QuotaSpec(tpu_chips=8, millitpu=None))
    doc = to_doc("Quota", q)
    assert doc == rser.to_doc("Quota", rser.from_doc("Quota", doc))
    back = from_doc("Quota", doc)
    assert back.spec.tpu_chips == 8 and back.spec.millitpu is None


# -- one request sequence against both servers ----------------------------

def _raw(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _sequence(base):
    """The same requests, bodies built once from the reference's objects
    (uids included, so the servers keep them)."""
    a = rcluster.tpu_pod("a", chips=1, command=["x"],
                         gang=rkm.GangSpec(name="g", size=1, index=0))
    b = rcluster.tpu_pod("b", chips=2, command=["y"], namespace="other")
    b.metadata.labels["team"] = "t"
    for i, p in enumerate((a, b)):
        p.metadata.uid = f"uid-{i}"
    node = rser.to_doc("Node", rkm.Node(
        metadata=rkm.ObjectMeta(name="n0", uid="uid-n")))
    a_doc, b_doc = rser.to_doc("Pod", a), rser.to_doc("Pod", b)
    out = [
        _raw(base, "POST", "/apis/Pod", a_doc),
        _raw(base, "POST", "/apis/Pod", b_doc),
        _raw(base, "POST", "/apis/Node", node),
        _raw(base, "POST", "/apis/Pod", a_doc),                  # 409
        _raw(base, "GET", "/apis/Pod"),
        _raw(base, "GET", "/apis/Pod?namespace=other"),
        _raw(base, "GET", "/apis/Pod?labelSelector=team%3Dt"),
        _raw(base, "POST", "/apis/Pod/default/a/binding", {"node": "n0"}),
        _raw(base, "GET", "/apis/Pod?nodeName=n0&phase=Scheduled"),
        _raw(base, "PATCH", "/apis/Pod/default/a",
             {"annotations": {"x": "1", "y": "2"}}),
        _raw(base, "PATCH", "/apis/Pod/default/a",
             {"annotations": {"x": None}}),
        _raw(base, "POST", "/apis/Pod/default/a/status",
             {"phase": "Running", "expectUid": "uid-0"}),
        _raw(base, "POST", "/apis/Pod/default/a/status",
             {"phase": "Failed", "expectUid": "uid-dead"}),       # 404
        _raw(base, "PUT", "/apis/Pod/default/a", a_doc),          # 409
        _raw(base, "POST", "/apis/Node/default/n0/ready", {"ready": False}),
        _raw(base, "GET", "/apis/Node/default/n0"),
        _raw(base, "GET", "/apis/Pod?phase=Bogus"),               # 400
        _raw(base, "DELETE", "/apis/Pod/other/b"),
        _raw(base, "GET", "/apis/Pod/other/b"),                   # 404
        _raw(base, "GET", "/nope"),                               # 404
        _raw(base, "PUT", "/apis/Pod"),                           # 400
    ]
    out.append(_raw(base, "GET", "/watch?since=0&timeout=0"))
    out.append(_raw(base, "GET", "/watch?tail=1"))
    return out


def test_request_sequence_and_watch_equal_the_references():
    port_srv = ApiServerHTTP(FakeApiServer()).start()
    ref_srv = rhttp.ApiServerHTTP(rcp.FakeApiServer()).start()
    try:
        got = _sequence(port_srv.address)
        want = _sequence(ref_srv.address)
    finally:
        port_srv.close()
        ref_srv.close()
    codes = [c for c, _ in got]
    assert codes == [200, 200, 200, 409, 200, 200, 200, 200, 200, 200, 200,
                     200, 404, 409, 200, 200, 400, 200, 404, 404, 400, 200,
                     200]
    assert got == want
    events = got[-2][1]["events"]
    assert [(e["type"], e["object"]["metadata"]["name"]) for e in events][:3]\
        == [("ADDED", "a"), ("ADDED", "b"), ("ADDED", "n0")]
    assert events[-1]["type"] == "DELETED"


def test_metrics_serves_the_global_registry():
    global_registry.set_gauge("apiserver_probe_gauge", 3.0)
    reg = MetricsRegistry()
    reg.inc("probe_total", 2)
    srv = ApiServerHTTP(FakeApiServer()).start()
    own = ApiServerHTTP(FakeApiServer(), metrics=reg).start()
    try:
        with urllib.request.urlopen(srv.address + "/metrics") as r:
            assert "apiserver_probe_gauge 3" in r.read().decode()
        with urllib.request.urlopen(own.address + "/metrics") as r:
            assert r.read().decode() == reg.to_prometheus()
    finally:
        srv.close()
        own.close()


# -- the REST surface through the client ----------------------------------

def test_crud_roundtrip(served):
    api, srv, client = served
    client.create("Pod", tpu_pod("p", chips=1, command=["x"]))
    got = client.get("Pod", "p")
    assert got.name == "p"
    assert api.get("Pod", "p").metadata.uid == got.metadata.uid
    with pytest.raises(Conflict):
        client.create("Pod", tpu_pod("p", chips=1, command=["x"]))
    client.delete("Pod", "p")
    with pytest.raises(NotFound):
        client.get("Pod", "p")


def test_field_selectors_over_wire(served):
    api, srv, client = served
    client.create("Pod", tpu_pod("a", chips=1, command=["x"]))
    client.create("Pod", tpu_pod("b", chips=1, command=["x"],
                                 namespace="other"))
    client.bind_pod("a", "node-0")
    assert [p.name for p in client.list(
        "Pod", node_name="node-0", phase=PodPhase.SCHEDULED)] == ["a"]
    assert [p.name for p in client.list("Pod", namespace="other")] == ["b"]
    assert client.list("Pod", node_name="nope") == []


def test_annotation_patch_with_null_delete(served):
    api, srv, client = served
    client.create("Pod", tpu_pod("p", chips=0, command=["x"]))
    client.patch_annotations("Pod", "p", {"x": "1", "y": "2"})
    client.patch_annotations("Pod", "p", {"x": None})
    assert client.get("Pod", "p").metadata.annotations.get("y") == "2"
    assert "x" not in client.get("Pod", "p").metadata.annotations


def test_status_subresource_incarnation_safe(served):
    api, srv, client = served
    client.create("Pod", tpu_pod("p", chips=0, command=["x"]))
    uid = client.get("Pod", "p").metadata.uid
    client.set_pod_phase("p", PodPhase.RUNNING, expect_uid=uid)
    assert client.get("Pod", "p").status.phase == PodPhase.RUNNING
    with pytest.raises(NotFound, match="recreated"):
        client.set_pod_phase("p", PodPhase.FAILED,
                             expect_uid="uid-of-the-dead")


def test_node_ready_subresource(served):
    api, srv, client = served
    client.create("Node", Node(metadata=ObjectMeta(name="n0")))
    client.set_node_ready("n0", False)
    assert api.get("Node", "n0").status.ready is False


def test_update_optimistic_concurrency(served):
    api, srv, client = served
    client.create("Pod", tpu_pod("p", chips=0, command=["x"]))
    pod = client.get("Pod", "p")
    pod.spec.priority = 9
    client.update("Pod", pod)
    pod.spec.priority = 1     # rv now behind
    with pytest.raises(Conflict):
        client.update("Pod", pod)


def test_watch_long_poll_no_history_replay(served):
    api, srv, client = served
    client.create("Pod", tpu_pod("old", chips=0, command=["x"]))
    seen: list[tuple[str, str]] = []
    done = threading.Event()

    def cb(ev):
        seen.append((ev.type, ev.obj.metadata.name))
        if ev.obj.metadata.name.startswith("fresh"):
            done.set()

    unsub = client.watch(cb)
    # create until one is seen, as the reference's test does
    for i in range(100):
        client.create("Pod", tpu_pod(f"fresh{i}", chips=0, command=["x"]))
        if done.wait(0.05):
            break
    assert done.is_set()
    unsub()
    assert all(name != "old" for _, name in seen)


def test_watch_resubscribe_after_full_unsubscribe(served):
    """A watcher registered while the old poll thread still winds down
    after the last unsubscribe gets events (a stop flag a generation)."""
    api, srv, client = served
    unsub1 = client.watch(lambda ev: None)
    unsub1()
    got = threading.Event()
    unsub2 = client.watch(lambda ev: got.set())
    for i in range(100):
        client.create("Pod", tpu_pod(f"after{i}", chips=0, command=["x"]))
        if got.wait(0.05):
            break
    assert got.is_set(), "re-subscribed watcher starved of events"
    unsub2()


@pytest.mark.parametrize("kind", ["Pod", "Node"])
def test_watch_sees_the_first_write_after_subscribing(served, kind):
    """``watch()`` takes its position before it returns, so the first
    write after it reaches the callback.  The reference's client takes it
    in its poll thread and drops such a write: the watch cache's seed list
    missed a Node's advertised cards that way, and its scheduler pended
    the pod for good."""
    api, srv, client = served
    names: list[str] = []
    got = threading.Event()

    def cb(ev):
        names.append(ev.obj.metadata.name)
        got.set()

    unsub = client.watch(cb)
    if kind == "Pod":
        api.create("Pod", tpu_pod("first", chips=0, command=["x"]))
    else:
        api.create("Node", Node(metadata=ObjectMeta(name="first")))
    assert got.wait(10), "the first write after watch() was dropped"
    unsub()
    assert names == ["first"]


def test_watch_reset_calls_the_relist_hook():
    """A watcher that lags past the replay buffer is told to reset, and
    the client runs its ``on_reset`` hooks (the reference's semantics)."""
    from kubegpu_tpu_torch.kubemeta import apiserver_http as phttp
    api = FakeApiServer()
    srv = ApiServerHTTP(api).start()
    srv._events = phttp.deque(maxlen=2)
    for i in range(4):
        api.create("Pod", tpu_pod(f"p{i}", chips=0, command=["x"]))
    try:
        status, out = _raw(srv.address, "GET", "/watch?since=0&timeout=0")
        assert status == 200 and out == {"reset": True, "next": 4,
                                         "events": []}
    finally:
        srv.close()


# -- the node agent out of process -----------------------------------------

def _cluster_with_remote_agent():
    from kubegpu_tpu_torch.allocator import GangAllocator
    from kubegpu_tpu_torch.crishim.agent import NodeAgent
    from kubegpu_tpu_torch.crishim.criserver import CriServer, RemoteCriShim
    from kubegpu_tpu_torch.crishim.runtime import FakeRuntime
    from kubegpu_tpu_torch.scheduler import DeviceScheduler
    from kubegpu_tpu_torch.tpuplugin import MockBackend

    api = FakeApiServer()
    srv = ApiServerHTTP(api).start()
    client = HttpApiClient(srv.address)
    backend = MockBackend("h100-sxm-8")
    runtime = FakeRuntime()
    cri = CriServer(client, backend, backend.discover().node_name,
                    runtime).start()
    agent = NodeAgent(client, backend, runtime,
                      shim=RemoteCriShim(cri.socket_path))
    agent.register()
    sched = DeviceScheduler(api, allocator=GangAllocator())
    return api, srv, client, cri, agent, sched


def test_full_path_over_http_and_socket():
    api, srv, client, cri, agent, sched = _cluster_with_remote_agent()
    try:
        assert api.get("Node", agent.node_name) is not None
        api.create("Pod", tpu_pod("job", chips=2, command=["x"]))
        assert sched.run_once().scheduled == ["job"]
        started = agent.run_once()   # HTTP list → CRI socket create
        assert len(started) == 1
        env = started[0].env
        assert len(env["TPU_VISIBLE_CHIPS"].split(",")) == 2
        # the port's grant: two cards by UUID, in PCI bus order
        cards = env["CUDA_VISIBLE_DEVICES"].split(",")
        assert len(cards) == 2 and all(c.startswith("GPU-") for c in cards)
        assert env["NVIDIA_VISIBLE_DEVICES"] == env["CUDA_VISIBLE_DEVICES"]
        assert env["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
        assert agent.reap(timeout=2) == {"job": 0}
        assert api.get("Pod", "job").status.phase == PodPhase.SUCCEEDED
    finally:
        client.close()
        cri.close()
        srv.close()


def test_daemon_builder(tmp_path):
    """``crishim/serve.py``'s ``build_agent`` wires the same topology from
    flags (the daemon's entry path, minus the forever-loop)."""
    import argparse

    from kubegpu_tpu_torch.crishim.serve import build_agent
    from kubegpu_tpu_torch.kubemeta.codec import (
        ALLOCATE_FROM_KEY,
        AllocatedChip,
        Allocation,
        allocation_to_annotation,
    )

    api = FakeApiServer()
    srv = ApiServerHTTP(api).start()
    args = argparse.Namespace(
        apiserver=srv.address, backend="mock", slice="v4-8", host_id=0,
        cri_socket=str(tmp_path / "cri.sock"), real_processes=False,
        env=None)
    client, cri, agent = build_agent(args)
    try:
        agent.register()
        assert api.get("Node", agent.node_name) is not None
        api.create("Pod", tpu_pod("p", chips=1, command=["x"]))
        api.bind_pod("p", agent.node_name)
        adv = agent.backend.discover()
        alloc = Allocation(
            node_name=agent.node_name, slice_id=adv.slice_id,
            chips=[AllocatedChip(local_index=adv.chips[0].local_index,
                                 coord=adv.chips[0].coord,
                                 millichips=1000)],
            worker_id=0, num_workers=1,
            coordinator_address="127.0.0.1:9999",
            worker_hostnames=["127.0.0.1"])
        api.patch_annotations(
            "Pod", "p", {ALLOCATE_FROM_KEY: allocation_to_annotation(alloc)})
        started = agent.run_once()
        assert len(started) == 1
        assert started[0].env["TPU_WORKER_ID"] == "0"
    finally:
        client.close()
        cri.close()
        srv.close()


def _spawn_node_daemon(url, tmp_path, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "kubegpu_tpu_torch.crishim.serve",
         "--apiserver", url, "--backend", "mock", "--slice", "v4-8",
         "--cri-socket", str(tmp_path / "cri.sock"), "--tick", "0.05",
         *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("transport", ["json", "grpc"])
def test_pod_runs_through_external_daemon(tmp_path, transport):
    """The node daemon as its own process: submit → schedule → bind →
    (HTTP) → daemon → (CRI socket or gRPC) → workload subprocess → reap
    → Succeeded, with no in-process shortcut."""
    from kubegpu_tpu_torch.allocator import GangAllocator
    from kubegpu_tpu_torch.scheduler import DeviceScheduler

    api = FakeApiServer()
    srv = ApiServerHTTP(api).start()
    proc = _spawn_node_daemon(srv.address, tmp_path, "--transport",
                              transport, "--real-processes",
                              "--advertise-interval", "1")
    try:
        def registered():
            assert proc.poll() is None, (
                "daemon died at startup:\n" + proc.stderr.read())
            return api.list("Node")
        _wait(registered, what="node registration")
        sched = DeviceScheduler(api, allocator=GangAllocator())
        api.create("Pod", tpu_pod(
            "hello", chips=1,
            command=[sys.executable, "-c", "print('ran in daemon')"]))
        assert sched.run_once().scheduled == ["hello"]
        _wait(lambda: api.get("Pod", "hello").status.phase
              == PodPhase.SUCCEEDED, what="pod completion")
    finally:
        _stop(proc)
        srv.close()


def test_daemon_survives_apiserver_restart(tmp_path):
    """Control-plane restart with wiped state: the daemon backs off,
    re-registers its Node and keeps serving (the kubelet contract)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    api1 = FakeApiServer()
    srv1 = ApiServerHTTP(api1, port=port).start()
    proc = _spawn_node_daemon(f"http://127.0.0.1:{port}", tmp_path,
                              "--advertise-interval", "0.2")
    try:
        _wait(lambda: proc.poll() is None and api1.list("Node"),
              what="registration")
        srv1.close()
        api2 = FakeApiServer()   # fresh state: the Node object is gone
        srv2 = ApiServerHTTP(api2, port=port).start()
        try:
            _wait(lambda: api2.list("Node"), what="re-registration")
            assert proc.poll() is None, "daemon died during the outage"
        finally:
            srv2.close()
    finally:
        _stop(proc)
