"""The port's CRI wire (``kubegpu_tpu_torch/crishim/criserver.py`` and
``grpcserver.py``) against the JAX package's: one verb sequence over the
JSON frames, over gRPC with protobuf bodies and over gRPC with JSON bodies
returns the same results as the reference's server, with the reference's
env plus the port's three CUDA keys; ``SimCluster(wire_cri=True)`` gives
the scheduling log and annotations of the in-process cluster and of the
reference's wire cluster.  Then the reference's own cases on the port over
all three transports, and the gRPC transport refusing to start without
grpcio."""

import sys

import pytest
import torch

from kubegpu_tpu import cluster as rcluster
from kubegpu_tpu import config as rconfig
from kubegpu_tpu.crishim import criserver as rcri
from kubegpu_tpu.crishim import grpcserver as rgrpc
from kubegpu_tpu.kubemeta import controlplane as rcp
from kubegpu_tpu.tpuplugin import MockBackend as RMockBackend
from kubegpu_tpu_torch import cluster as pcluster
from kubegpu_tpu_torch import config as pconfig
from kubegpu_tpu_torch.cluster import SimCluster, tpu_pod
from kubegpu_tpu_torch.crishim import (
    CriClient,
    CriError,
    CriServer,
    FakeRuntime,
    RemoteCriShim,
)
from kubegpu_tpu_torch.crishim import criserver as pcri
from kubegpu_tpu_torch.crishim import grpcserver as pgrpc
from kubegpu_tpu_torch.crishim.criserver import (
    CONTAINER_EXITED,
    POD_NAME_LABEL,
    POD_NAMESPACE_LABEL,
    POD_UID_LABEL,
)
from kubegpu_tpu_torch.kubemeta import FakeApiServer, GangSpec, PodPhase
from kubegpu_tpu_torch.kubemeta import controlplane as pcp
from kubegpu_tpu_torch.kubemeta.codec import QUEUED_AT_KEY, pod_allocation
from kubegpu_tpu_torch.tpuplugin import MockBackend

TRANSPORTS = ["json", "grpc-proto", "grpc-json"]
CUDA_KEYS = {"CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
             "CUDA_DEVICE_ORDER"}


@pytest.fixture(scope="module", autouse=True)
def python_paths():
    """The reference's Python allocator paths, the ones the port copies,
    and one torch thread (nothing here computes with torch)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUBETPU_NO_NATIVE", "1")
        yield
    torch.set_num_threads(threads)


def _serve(cri, grpc_mod, transport, api, backend, runtime):
    """(server, client) of one package over one transport."""
    node = backend.discover().node_name
    if transport == "json":
        server = cri.CriServer(api, backend, node, runtime).start()
        return server, cri.CriClient(server.socket_path)
    codec = transport.split("-", 1)[1]
    server = grpc_mod.GrpcCriServer(api, backend, node, runtime,
                                    codec=codec).start()
    return server, grpc_mod.GrpcCriClient(server.socket_path, codec=codec)


@pytest.fixture(params=TRANSPORTS)
def served(request):
    """One H100 node's CRI server and a raw client, no scheduler."""
    api = FakeApiServer()
    backend = MockBackend("h100-sxm-8")
    runtime = FakeRuntime()
    server, client = _serve(pcri, pgrpc, request.param, api, backend,
                            runtime)
    yield api, backend, runtime, server, client
    client.close()
    server.close()


# -- one verb sequence against the reference --------------------------------

def _verbs(cri, grpc_mod, cp, cl, mock, transport):
    """The reference's verb sequence on one package; results with the
    container id, the timestamp and the env split out."""
    api = cp.FakeApiServer()
    backend = mock("v4-8")
    runtime = cl.FakeRuntime()
    server, client = _serve(cri, grpc_mod, transport, api, backend, runtime)
    out, envs = [], []

    def call(method, req=None):
        try:
            got = client.call(method, req)
        except Exception as e:    # each package's CriError
            # the frames carry "CriError: <msg>", gRPC the bare message
            got = {"error": type(e).__name__,
                   "msg": str(e).removeprefix("CriError: ")}
        out.append((method, got))
        return got
    try:
        pod = cl.tpu_pod("p", chips=2, command=["noop"])
        pod.metadata.uid = "uid-p"
        api.create("Pod", pod)
        cl.NodeAgent(api, backend, runtime).register()
        assert cl.DeviceScheduler(api, coordinator_port=9476).run_once(
        ).scheduled == ["p"]
        labels = {POD_NAME_LABEL: "p", POD_NAMESPACE_LABEL: "default",
                  POD_UID_LABEL: "uid-p"}
        image = pod.spec.containers[0].image
        call("Version")
        call("ExecSync")
        call("ContainerStatus", {"container_id": "nope"})
        call("CreateContainer", {"config": {"labels": {}}})
        call("CreateContainer", {"config": {"labels": {
            POD_NAME_LABEL: "p", POD_UID_LABEL: "uid-dead"}}})
        call("CreateContainer", {"config": {"labels": labels}})
        call("ImageStatus", {"image": {"image": image}})
        call("PullImage", {"image": {"image": image}})
        call("PullImage", {"image": {"image": "registry:5000/app@sha256:ab"}})
        call("ListImages", {"filter": {"image": {"image": image}}})
        fs = call("ImageFsInfo")
        fs["image_filesystems"][0].pop("timestamp")
        created = call("CreateContainer", {"config": {
            "metadata": {"name": "main"}, "image": {"image": image},
            "labels": labels}})
        cid = created.pop("container_id")
        envs.append(created["info"].pop("env"))
        created["info"].pop("pid")
        for c in call("ListContainers")["containers"]:
            assert c.pop("id") == cid
        status = call("ContainerStatus", {"container_id": cid})
        assert status["status"].pop("id") == cid
        call("StartContainer", {"container_id": cid})
        call("RemoveContainer", {"container_id": cid})
        call("ListContainers")
        call("RemoveImage", {"image": {"image": image}})
        call("ImageStatus", {"image": {"image": image}})
    finally:
        client.close()
        server.close()
    return out, envs[0]


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_verbs_equal_the_references(transport):
    got, env = _verbs(pcri, pgrpc, pcp, pcluster, MockBackend, transport)
    want, ref_env = _verbs(rcri, rgrpc, rcp, rcluster, RMockBackend,
                           transport)
    assert got == want
    # the reference's env, and the grant's two cards by UUID
    assert {k: v for k, v in env.items() if k not in CUDA_KEYS} == ref_env
    cards = env["CUDA_VISIBLE_DEVICES"].split(",")
    assert len(cards) == 2 and all(c.startswith("GPU-") for c in cards)
    assert env["NVIDIA_VISIBLE_DEVICES"] == env["CUDA_VISIBLE_DEVICES"]
    assert env["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"


def _set(x):
    """``x`` without the proto3 defaults a protobuf body materializes
    (the JSON bodies leave them out)."""
    if isinstance(x, dict):
        return {k: _set(v) for k, v in x.items()
                if v not in ("", 0, False, None, [], {})}
    if isinstance(x, (list, tuple)):
        return [_set(v) for v in x]
    return x


def test_transports_return_equal_results():
    runs = [_verbs(pcri, pgrpc, pcp, pcluster, MockBackend, t)
            for t in TRANSPORTS]
    assert runs[2] == runs[0]           # gRPC with JSON bodies
    assert _set(runs[1]) == _set(runs[0])


# -- SimCluster(wire_cri=True) ----------------------------------------------

def _untimed(detail):
    if not isinstance(detail, dict):
        return detail
    return {k: _untimed(v) for k, v in detail.items()
            if k not in ("total_ms", "phase_ms")}


def _wire_run(cluster, config, wire):
    cfg = config.KubeTpuConfig()
    cfg.backend.slice_types = ["v4-8", "v4-8"]
    cfg.scheduler.coordinator_port = 9476
    cfg.runtime.wire_cri = wire
    cl = cluster.SimCluster.from_config(cfg)
    try:
        cl.submit(cluster.tpu_pod("solo", chips=1, command=["noop"]))
        cl.submit(*[cluster.tpu_pod(f"dp-{i}", chips=2, command=["noop"],
                                    gang=cluster.GangSpec(name="dp", size=2,
                                                          index=i))
                    for i in range(2)])
        cl.submit(cluster.tpu_pod("big", chips=4, command=["noop"]))
        for _ in range(3):
            cl.step()
        codes = cl.reap(timeout=2)
        pods = sorted(cl.api.list("Pod"), key=lambda p: p.name)
        return {
            "codes": codes,
            "bindings": {p.name: (p.spec.node_name, p.status.phase.value)
                         for p in pods},
            "annotations": {p.name: {k: v for k, v in
                                     p.metadata.annotations.items()
                                     if k != QUEUED_AT_KEY} for p in pods},
            "trace": [(e.kind, e.gang, _untimed(e.detail))
                      for e in cl.trace.events()],
            "env": {h.pod_name: h.env for h in cl.runtime.containers()},
            "servers": len(cl.cri_servers),
        }
    finally:
        cl.close()


def test_wire_cluster_schedules_as_in_process_and_the_reference():
    wire = _wire_run(pcluster, pconfig, True)
    local = _wire_run(pcluster, pconfig, False)
    ref = _wire_run(rcluster, rconfig, True)
    assert wire["servers"] == 2 == ref["servers"] and local["servers"] == 0
    for key in ("codes", "bindings", "annotations", "trace", "env"):
        assert wire[key] == local[key], key
    for key in ("codes", "bindings", "annotations", "trace"):
        assert wire[key] == ref[key], key
    for name, env in wire["env"].items():
        assert {k: v for k, v in env.items() if k not in CUDA_KEYS} == \
            ref["env"][name], name
    assert wire["bindings"]["solo"][1] == "Succeeded"


# -- the reference's cases on the port ---------------------------------------

def test_version_handshake(served):
    _, backend, _, _, client = served
    out = client.call("Version")
    assert out["runtime_name"] == "kubetpu-crishim"
    assert out["runtime_api_version"] == "v1"
    assert out["node_name"] == backend.discover().node_name


def test_unknown_method_is_in_band_error(served):
    *_, client = served
    with pytest.raises(CriError, match="unknown method"):
        client.call("ExecSync")
    assert client.call("Version")["runtime_name"] == "kubetpu-crishim"


def test_create_refusals(served):
    api, *_, client = served
    with pytest.raises(CriError, match="no such container"):
        client.call("ContainerStatus", {"container_id": "nope"})
    with pytest.raises(CriError, match=POD_NAME_LABEL):
        client.call("CreateContainer", {"config": {"labels": {}}})
    with pytest.raises(CriError, match="not found"):
        client.call("CreateContainer", {"config": {"labels": {
            POD_NAME_LABEL: "ghost"}}})
    api.create("Pod", tpu_pod("p", chips=0, command=["noop"]))
    with pytest.raises(CriError, match="stale incarnation"):
        client.call("CreateContainer", {"config": {"labels": {
            POD_NAME_LABEL: "p", POD_NAMESPACE_LABEL: "default",
            POD_UID_LABEL: "uid-of-a-dead-incarnation"}}})


def test_create_status_list_remove_roundtrip(served):
    api, backend, runtime, server, client = served
    api.create("Pod", tpu_pod("p", chips=0, command=["noop"]))
    pod = api.get("Pod", "p")
    image = pod.spec.containers[0].image
    req = {"config": {"metadata": {"name": "main"},
                      "labels": {POD_NAME_LABEL: "p",
                                 POD_NAMESPACE_LABEL: "default",
                                 POD_UID_LABEL: pod.metadata.uid}}}
    with pytest.raises(CriError, match="not present"):
        client.call("CreateContainer", req)       # pull before create
    client.call("PullImage", {"image": {"image": image}})
    out = client.call("CreateContainer", req)
    cid = out["container_id"]
    # no grant, no card: the port clears the cards as the chips
    assert out["info"]["env"]["TPU_VISIBLE_CHIPS"] == ""
    assert out["info"]["env"]["CUDA_VISIBLE_DEVICES"] == ""
    assert [c["id"] for c in client.call("ListContainers")["containers"]] \
        == [cid]
    st = client.call("ContainerStatus", {"container_id": cid})
    assert st["status"]["state"] == CONTAINER_EXITED
    assert st["status"]["exit_code"] == 0
    client.call("RemoveContainer", {"container_id": cid})
    assert client.call("ListContainers")["containers"] == []


def test_image_service(served):
    *_, client = served
    ref = "kubetpu/runtime:latest"
    assert client.call("ImageStatus",
                       {"image": {"image": ref}})["image"] is None
    out = client.call("PullImage", {"image": {"image": ref}})
    assert out["image_ref"].startswith("sha256:")
    st = client.call("ImageStatus", {"image": {"image": ref}})["image"]
    assert st["id"] == out["image_ref"] and st["repo_tags"] == [ref]
    assert st["size"] > 0
    assert client.call("PullImage", {"image": {"image": ref}})[
        "image_ref"] == out["image_ref"]
    client.call("PullImage", {"image": {"image": "other:v1"}})
    assert len(client.call("ListImages")["images"]) == 2
    fs = client.call("ImageFsInfo")["image_filesystems"][0]
    assert fs["inodes_used"]["value"] == 2 and fs["used_bytes"]["value"] > 0
    client.call("RemoveImage", {"image": {"image": ref}})
    assert client.call("ImageStatus",
                       {"image": {"image": ref}})["image"] is None
    client.call("RemoveImage", {"image": {"image": ref}})   # idempotent


def test_injection_over_socket(served):
    """``RemoteCriShim.create_container`` has the in-process shim's
    semantics, with the grant's env crossing the wire."""
    api, backend, runtime, server, client = served
    shim = (RemoteCriShim(server.socket_path)
            if isinstance(server, CriServer) else
            pgrpc.GrpcRemoteCriShim(server.socket_path, codec=server.codec))
    try:
        api.create("Pod", tpu_pod("p", chips=0, command=["noop"]))
        h = shim.create_container(api.get("Pod", "p"))
        assert h.env["TPU_VISIBLE_CHIPS"] == ""
        assert h.wait(timeout=1) == 0
        assert [c.pod_name for c in runtime.created] == ["p"]
    finally:
        shim.close()


def test_gang_over_wire():
    cl = SimCluster(["h100-sxm-8"], wire_cri=True)
    try:
        for i in range(4):
            cl.submit(tpu_pod(f"dp-{i}", chips=2, command=["noop"],
                              gang=GangSpec(name="dp", size=4, index=i)))
        result, started = cl.step()
        assert len(result.scheduled) == 4
        envs = {h.pod_name: h.env for h in started}
        assert [envs[f"dp-{i}"]["TPU_WORKER_ID"] for i in range(4)] == \
            ["0", "1", "2", "3"]
        cards = [c for e in envs.values()
                 for c in e["CUDA_VISIBLE_DEVICES"].split(",")]
        assert len(set(cards)) == 8, "each card granted once"
        assert pod_allocation(cl.api.get("Pod", "dp-0")) is not None
        assert cl.reap(timeout=2) == {f"dp-{i}": 0 for i in range(4)}
    finally:
        cl.close()


def test_host_failure_kills_over_wire():
    """``fail_host`` stops the containers over the socket; recovery
    reschedules the pod on the other node."""
    cl = SimCluster(["h100-sxm-8", "h100-sxm-8"], wire_cri=True)
    try:
        cl.submit(tpu_pod("job", chips=1, command=["noop"]))
        cl.step()
        node = cl.api.get("Pod", "job").spec.node_name
        cl.fail_host(node)
        cl.step()
        assert cl.api.get("Pod", "job").spec.node_name not in (None, node)
    finally:
        cl.close()


def test_real_subprocess_metrics_harvested_over_wire():
    """A child's stdout metric line crosses the socket (ContainerStatus
    info) into the cluster's metrics."""
    cmd = [sys.executable, "-c",
           'print(\'{"metric": "allreduce_algo_bandwidth", '
           '"value": 21.0, "unit": "GB/s"}\')']
    cl = SimCluster(["h100-sxm-1"], wire_cri=True, real_processes=True)
    try:
        cl.submit(tpu_pod("bench", chips=0, command=cmd))
        cl.step()
        assert cl.reap(timeout=30) == {"bench": 0}
        snap = cl.metrics.snapshot()
        assert snap["gauges"]["workload_allreduce_algo_bandwidth"] == 21.0
        assert cl.pod_phase("bench") == PodPhase.SUCCEEDED
    finally:
        cl.close()


def test_grpc_transport_without_grpcio_raises(monkeypatch, tmp_path):
    """With ``grpc`` hidden, the gRPC server and client raise an
    ``ImportError`` naming grpcio; nothing falls back to the frames."""
    monkeypatch.setitem(sys.modules, "grpc", None)
    backend = MockBackend("h100-sxm-1")
    server = pgrpc.GrpcCriServer(FakeApiServer(), backend,
                                 backend.discover().node_name, FakeRuntime(),
                                 socket_path=str(tmp_path / "cri.sock"))
    with pytest.raises(ImportError, match="grpcio"):
        server.start()
    with pytest.raises(ImportError, match="grpcio"):
        pgrpc.GrpcCriClient(str(tmp_path / "cri.sock"))
    server.close()
    # the frames still work beside it
    frames = CriServer(FakeApiServer(), backend,
                       backend.discover().node_name, FakeRuntime()).start()
    try:
        assert CriClient(frames.socket_path).call("Version")[
            "runtime_name"] == "kubetpu-crishim"
    finally:
        frames.close()
