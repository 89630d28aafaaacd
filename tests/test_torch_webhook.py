"""The port's scheduler-extender webhook (``kubegpu_tpu_torch/scheduler/
webhook.py``) against the JAX package's: the reference's scenarios
(one pod through filter → prioritize → bind, an infeasible node, a gang
held until it is whole and then assumed, a bind to the wrong node, a
half-bound gang requeued whole, an abandoned assumption expiring after the
grace) give equal filter, prioritize and bind responses and equal
annotations in both.  Then the reference's cases over HTTP on the port,
on an H100 node type too, where the card ``AllocateFrom`` names maps to
its UUID through the node's advertisement."""

import json
import time
import urllib.error
import urllib.request

import pytest
import torch

from kubegpu_tpu import cluster as rcluster
from kubegpu_tpu import config as rconfig
from kubegpu_tpu.kubemeta import codec as rcodec
from kubegpu_tpu.scheduler import webhook as rhook
from kubegpu_tpu_torch import cluster as pcluster
from kubegpu_tpu_torch import config as pconfig
from kubegpu_tpu_torch.cluster import SimCluster, tpu_pod
from kubegpu_tpu_torch.kubemeta import (
    GangSpec,
    PodPhase,
    node_advertisement,
    pod_allocation,
)
from kubegpu_tpu_torch.kubemeta import codec as pcodec
from kubegpu_tpu_torch.kubemeta.codec import (
    ALLOCATE_FROM_KEY,
    QUEUED_AT_KEY,
    allocation_to_annotation,
)
from kubegpu_tpu_torch.obs import MetricsRegistry, parse_prometheus
from kubegpu_tpu_torch.scheduler import webhook as phook
from kubegpu_tpu_torch.scheduler.webhook import (
    ExtenderHTTPServer,
    pod_from_doc,
    pod_to_doc,
    policy_config,
)


@pytest.fixture(scope="module", autouse=True)
def python_paths():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUBETPU_NO_NATIVE", "1")
        yield
    torch.set_num_threads(threads)


def post(url: str, payload) -> object:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


@pytest.fixture()
def cluster_and_server():
    cl = SimCluster(["v5e-16"])
    srv = ExtenderHTTPServer(cl.scheduler).start()
    yield cl, srv
    srv.close()
    cl.close()


# -- the reference's scenarios through both packages -------------------------

def _used(cl):
    return sum(sum(st.used_millichips.values())
               for st in cl.scheduler.slices.values())


def _scenarios(cluster, config, hook, codec):
    """Every verb's response and the pods' annotations after each of the
    reference's webhook scenarios, on one package."""
    log = []

    def fresh():
        cfg = config.KubeTpuConfig()
        cfg.backend.slice_types = ["v5e-16"]
        cfg.scheduler.coordinator_port = 9476
        cl = cluster.SimCluster.from_config(cfg)
        return cl, hook.ExtenderService(cl.scheduler), \
            [n.name for n in cl.api.list("Node")]

    def gang(n, chips=4, **kw):
        return [cluster.tpu_pod(f"g-{i}", chips=chips, command=["x"],
                                gang=cluster.GangSpec(name="g", size=n,
                                                      index=i), **kw)
                for i in range(n)]

    def pods(cl):
        return {p.name: (p.spec.node_name, p.status.phase.value,
                         {k: v for k, v in p.metadata.annotations.items()
                          if k != QUEUED_AT_KEY})
                for p in cl.api.list("Pod")}

    def verb(svc, name, pod=None, nodes=None, bind=None):
        if name == "bind":
            out = svc.bind({"PodName": bind[0], "PodNamespace": "default",
                            "Node": bind[1]})
        else:
            out = getattr(svc, name)({"Pod": hook.pod_to_doc(pod),
                                      "NodeNames": nodes})
        log.append((name, out))
        return out

    # one pod: filter → prioritize → bind
    cl, svc, nodes = fresh()
    pod = cluster.tpu_pod("p", chips=4, mesh_axes={"dp": 1, "tp": 4},
                          command=["x"])
    cl.api.create("Pod", pod)
    ok = verb(svc, "filter", pod, nodes)["NodeNames"]
    scores = verb(svc, "prioritize", pod, ok)
    best = max(scores, key=lambda s: s["Score"])["Host"]
    verb(svc, "bind", bind=("p", best))
    # an infeasible node: the full host refuses a second 4-chip pod
    late = cluster.tpu_pod("q", chips=4, command=["x"])
    cl.api.create("Pod", late)
    verb(svc, "filter", late, nodes)
    verb(svc, "bind", bind=("q", best))
    log.append(("used", _used(cl), pods(cl)))
    cl.close()

    # a gang held until whole, then assumed and bound member by member
    cl, svc, nodes = fresh()
    g = gang(2, mesh_axes={"dp": 2, "tp": 4})
    cl.api.create("Pod", g[0])
    verb(svc, "filter", g[0], nodes)
    cl.api.create("Pod", g[1])
    assigned = {}
    for p in g:
        assigned[p.name] = verb(svc, "filter", p, nodes)["NodeNames"][0]
        verb(svc, "prioritize", p, nodes)
    wrong = next(n for n in nodes if n != assigned["g-0"])
    verb(svc, "bind", bind=("g-0", wrong))
    for p in g:
        verb(svc, "bind", bind=(p.name, assigned[p.name]))
    log.append(("used", _used(cl), pods(cl),
                cl.scheduler.run_once().scheduled))
    cl.close()

    # a half-bound gang whose assumption is lost is requeued whole
    cl, svc, nodes = fresh()
    g = gang(2)
    for p in g:
        cl.api.create("Pod", p)
    node0 = verb(svc, "filter", g[0], nodes)["NodeNames"][0]
    verb(svc, "bind", bind=("g-0", node0))
    cl.scheduler.sync()
    verb(svc, "filter", g[1], nodes)
    log.append(("used", _used(cl), pods(cl)))
    for name in ("g-0", "g-1"):
        p = cl.api.get("Pod", name)
        node = verb(svc, "filter", p, nodes)["NodeNames"][0]
        verb(svc, "bind", bind=(name, node))
    log.append(("used", _used(cl), pods(cl)))
    cl.close()

    # an idempotent bind retry still completes the assumption
    cl, svc, nodes = fresh()
    g = gang(2)
    for p in g:
        cl.api.create("Pod", p)
    verb(svc, "filter", g[0], nodes)
    entry = cl.scheduler._wire_assumed["default/g"]
    node1, alloc1 = entry["g-1"]
    cl.api.patch_annotations("Pod", "g-1", {
        codec.ALLOCATE_FROM_KEY: codec.allocation_to_annotation(alloc1)})
    verb(svc, "bind", bind=("g-1", node1))
    verb(svc, "bind", bind=("g-0", entry["g-0"][0]))
    log.append(("assumed", sorted(cl.scheduler._wire_assumed),
                sorted(cl.scheduler._wire_bound), _used(cl), pods(cl)))
    cl.close()

    # an abandoned assumption expires after the grace and frees its cards
    cl, svc, nodes = fresh()
    cl.scheduler.gang_grace_s = 0.05
    g = gang(2)
    for p in g:
        cl.api.create("Pod", p)
    verb(svc, "filter", g[0], nodes)
    held = (_used(cl), sorted(cl.scheduler._wire_assumed))
    time.sleep(0.1)
    solo = cluster.tpu_pod("s", chips=1, command=["x"])
    cl.api.create("Pod", solo)
    verb(svc, "filter", solo, nodes)      # expires the assumption first
    log.append(("expiry", held, _used(cl),
                sorted(cl.scheduler._wire_assumed)))
    cl.close()
    return log


def test_scenarios_equal_the_references():
    got = _scenarios(pcluster, pconfig, phook, pcodec)
    want = _scenarios(rcluster, rconfig, rhook, rcodec)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g[0])
    # the reference's expectations, on the port's responses
    verbs = [e for e in got if e[0] in ("filter", "prioritize", "bind")]
    assert verbs[2] == ("bind", {"Error": ""})
    assert "insufficient" in verbs[4][1]["Error"]
    assert "waiting (1/2)" in next(iter(verbs[5][1]["FailedNodes"].values()))
    assert "assigned to" in verbs[10][1]["Error"]


def test_pod_docs_equal_the_references():
    kw = dict(chips=4, mesh_axes={"dp": 2, "tp": 2}, priority=7,
              multislice=True, command=["x"], env={"A": "1"})
    pod = tpu_pod("p", gang=GangSpec(name="g", size=2, index=0), **kw)
    rpod = rcluster.tpu_pod("p", gang=rcluster.GangSpec(name="g", size=2,
                                                        index=0), **kw)
    doc = pod_to_doc(pod)
    assert doc == rhook.pod_to_doc(rpod)
    back = pod_from_doc(doc)
    assert back.name == "p" and back.spec.total_chips == 4
    assert back.spec.priority == 7
    assert back.metadata.annotations == pod.metadata.annotations
    assert pod_to_doc(back) == rhook.pod_to_doc(rhook.pod_from_doc(doc))


def test_policy_stanza_equals_the_references():
    cfg = policy_config("http://1.2.3.4:8900")
    assert cfg == rhook.policy_config("http://1.2.3.4:8900")
    ext = cfg["extenders"][0]
    assert ext["urlPrefix"] == "http://1.2.3.4:8900/kubetpu"
    assert (ext["filterVerb"], ext["prioritizeVerb"], ext["bindVerb"]) == \
        ("filter", "prioritize", "bind")


# -- the reference's cases over HTTP on the port -----------------------------

def test_filter_and_prioritize_over_http(cluster_and_server):
    cl, srv = cluster_and_server
    nodes = [n.name for n in cl.api.list("Node")]
    doc = pod_to_doc(tpu_pod("p", chips=4, command=["x"]))
    out = post(f"{srv.address}/kubetpu/filter",
               {"Pod": doc, "NodeNames": nodes})
    assert out["Error"] == "" and out["FailedNodes"] == {}
    assert set(out["NodeNames"]) == set(nodes)
    out = post(f"{srv.address}/kubetpu/prioritize",
               {"Pod": doc, "NodeNames": nodes})
    assert isinstance(out, list) and len(out) == len(nodes)
    assert all(e["Host"] in nodes and 0 <= e["Score"] <= 10 for e in out)


def test_filter_reports_infeasible_nodes(cluster_and_server):
    cl, srv = cluster_and_server
    cl.submit(tpu_pod("warm", chips=4, command=["x"]))
    cl.step()
    warm = cl.api.get("Pod", "warm").spec.node_name
    nodes = [n.name for n in cl.api.list("Node")]
    out = post(f"{srv.address}/kubetpu/filter",
               {"Pod": pod_to_doc(tpu_pod("p", chips=4, command=["x"])),
                "NodeNames": nodes})
    assert warm not in out["NodeNames"] and warm in out["FailedNodes"]


def test_http_errors(cluster_and_server):
    _, srv = cluster_and_server
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(urllib.request.Request(
            f"{srv.address}/kubetpu/nope", data=b"{}", method="POST"),
            timeout=10)
    assert ei.value.code == 404
    with urllib.request.urlopen(urllib.request.Request(
            f"{srv.address}/kubetpu/filter", data=b"not json",
            method="POST"), timeout=10) as resp:
        out = json.loads(resp.read())
    assert out["Error"] and out["NodeNames"] == []
    # prioritize has no Error slot: its failure is an HTTP 500
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(urllib.request.Request(
            f"{srv.address}/kubetpu/prioritize", data=b"not json",
            method="POST"), timeout=10)
    assert ei.value.code == 500
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"{srv.address}/nope", timeout=10)
    assert ei.value.code == 404


def test_single_pod_full_wire_flow_on_an_h100_node():
    """submit → filter → prioritize → bind over HTTP on a one-card H100
    node: the ``AllocateFrom`` the bind writes names the card by UUID."""
    cl = SimCluster(["h100-sxm-1"])
    srv = ExtenderHTTPServer(cl.scheduler).start()
    try:
        pod = tpu_pod("p", chips=1, command=["x"])
        cl.api.create("Pod", pod)
        nodes = [n.name for n in cl.api.list("Node")]
        out = post(f"{srv.address}/kubetpu/filter",
                   {"Pod": pod_to_doc(pod), "NodeNames": nodes})
        assert out["NodeNames"] == nodes
        scores = post(f"{srv.address}/kubetpu/prioritize",
                      {"Pod": pod_to_doc(pod), "NodeNames": nodes})
        best = max(scores, key=lambda s: s["Score"])["Host"]
        res = post(f"{srv.address}/kubetpu/bind",
                   {"PodName": "p", "PodNamespace": "default",
                    "PodUID": pod.metadata.uid, "Node": best})
        assert res["Error"] == ""
        bound = cl.api.get("Pod", "p")
        assert bound.spec.node_name == best
        alloc = pod_allocation(bound)
        assert ALLOCATE_FROM_KEY in bound.metadata.annotations
        # the reference's annotation names the card by its local index;
        # the node's advertisement, read back, maps it to the card's UUID
        adv = node_advertisement(cl.api.get("Node", best))
        uuids = {c.local_index: c.uuid for c in adv.chips}
        assert [uuids[c.local_index] for c in alloc.chips] == \
            [cl.agents[0].backend.discover().chips[0].uuid]
        assert _used(cl) == 1000
    finally:
        srv.close()
        cl.close()


def test_gang_hold_and_assume_over_wire(cluster_and_server):
    cl, srv = cluster_and_server
    nodes = [n.name for n in cl.api.list("Node")]
    g = [tpu_pod(f"g-{i}", chips=4, gang=GangSpec(name="g", size=2, index=i),
                 mesh_axes={"dp": 2, "tp": 4}, command=["x"])
         for i in range(2)]
    cl.api.create("Pod", g[0])
    out = post(f"{srv.address}/kubetpu/filter",
               {"Pod": pod_to_doc(g[0]), "NodeNames": nodes})
    assert out["NodeNames"] == []
    assert "waiting (1/2)" in next(iter(out["FailedNodes"].values()))
    cl.api.create("Pod", g[1])
    assigned = {}
    for pod in g:
        out = post(f"{srv.address}/kubetpu/filter",
                   {"Pod": pod_to_doc(pod), "NodeNames": nodes})
        assert len(out["NodeNames"]) == 1
        assigned[pod.name] = out["NodeNames"][0]
    # a loop pass does not place the assumed gang a second time
    assert cl.scheduler.run_once().scheduled == [] and _used(cl) == 8000
    for pod in g:
        res = post(f"{srv.address}/kubetpu/bind",
                   {"PodName": pod.name, "PodNamespace": "default",
                    "PodUID": pod.metadata.uid, "Node": assigned[pod.name]})
        assert res["Error"] == ""
    a0, a1 = (pod_allocation(cl.api.get("Pod", f"g-{i}")) for i in range(2))
    assert {a0.worker_id, a1.worker_id} == {0, 1}
    assert a0.coordinator_address == a1.coordinator_address
    assert a0.gang_name == a1.gang_name == "g"


def test_half_bound_gang_recovers_by_whole_requeue(cluster_and_server):
    cl, srv = cluster_and_server
    nodes = [n.name for n in cl.api.list("Node")]
    g = [tpu_pod(f"g-{i}", chips=4, gang=GangSpec(name="g", size=2, index=i),
                 command=["x"]) for i in range(2)]
    for p in g:
        cl.api.create("Pod", p)
    node0 = post(f"{srv.address}/kubetpu/filter",
                 {"Pod": pod_to_doc(g[0]), "NodeNames": nodes})["NodeNames"][0]
    assert post(f"{srv.address}/kubetpu/bind",
                {"PodName": "g-0", "PodNamespace": "default",
                 "Node": node0})["Error"] == ""
    cl.scheduler.sync()
    out = post(f"{srv.address}/kubetpu/filter",
               {"Pod": pod_to_doc(g[1]), "NodeNames": nodes})
    assert "requeued" in next(iter(out["FailedNodes"].values()))
    for i in range(2):
        p = cl.api.get("Pod", f"g-{i}")
        assert p.status.phase == PodPhase.PENDING
        assert ALLOCATE_FROM_KEY not in p.metadata.annotations
    assert _used(cl) == 0


def test_idempotent_bind_retry_still_completes_assumption(
        cluster_and_server):
    cl, srv = cluster_and_server
    nodes = [n.name for n in cl.api.list("Node")]
    g = [tpu_pod(f"g-{i}", chips=4, gang=GangSpec(name="g", size=2, index=i),
                 command=["x"]) for i in range(2)]
    for p in g:
        cl.api.create("Pod", p)
    post(f"{srv.address}/kubetpu/filter",
         {"Pod": pod_to_doc(g[0]), "NodeNames": nodes})
    entry = cl.scheduler._wire_assumed["default/g"]
    node1, alloc1 = entry["g-1"]
    cl.api.patch_annotations(
        "Pod", "g-1", {ALLOCATE_FROM_KEY: allocation_to_annotation(alloc1)})
    for name, node in (("g-1", node1), ("g-0", entry["g-0"][0])):
        assert post(f"{srv.address}/kubetpu/bind",
                    {"PodName": name, "PodNamespace": "default",
                     "Node": node})["Error"] == ""
    assert "default/g" not in cl.scheduler._wire_assumed
    assert "default/g" not in cl.scheduler._wire_bound
    assert _used(cl) == 8000


def test_abandoned_assumption_expires_and_frees():
    cl = SimCluster(["v5e-16"])
    cl.scheduler.gang_grace_s = 0.05
    srv = ExtenderHTTPServer(cl.scheduler).start()
    try:
        nodes = [n.name for n in cl.api.list("Node")]
        for i in range(2):
            cl.api.create("Pod", tpu_pod(
                f"g-{i}", chips=4, command=["x"],
                gang=GangSpec(name="g", size=2, index=i)))
        post(f"{srv.address}/kubetpu/filter",
             {"Pod": pod_to_doc(cl.api.get("Pod", "g-0")),
              "NodeNames": nodes})
        time.sleep(0.1)
        cl.scheduler.run_once()
        used = _used(cl)
        assert used in (0, 8000)
        if used == 8000:
            assert cl.scheduler._committed.get("default/g") is not None
    finally:
        srv.close()
        cl.close()


def test_prometheus_scrape(cluster_and_server):
    cl, srv = cluster_and_server
    cl.submit(tpu_pod("p", chips=1, command=["x"]))
    cl.step()
    with urllib.request.urlopen(f"{srv.address}/metrics",
                                timeout=10) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain")
        body = resp.read().decode()
    assert "# TYPE kubetpu_schedule_latency_ms histogram" in body
    assert 'kubetpu_schedule_latency_ms_bucket{le="+Inf"} 1' in body
    assert "kubetpu_schedule_latency_ms_count 1" in body
    assert parse_prometheus(body)["kubetpu_schedule_latency_ms"]["type"] \
        == "histogram"
    reg = MetricsRegistry()
    reg.observe("workload_bw", 12.5)
    reg.set_gauge("workload_bw", 12.5)
    families = [ln.split()[2] for ln in reg.to_prometheus().splitlines()
                if ln.startswith("# TYPE")]
    assert len(families) == len(set(families)), families
