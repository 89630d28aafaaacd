"""The port's three daemons as processes: ``kubemeta.apiserver_serve``,
``scheduler.daemon`` and ``crishim.serve`` talk only over HTTP and the CRI
socket, run a ``python -c`` probe pod to Succeeded, and a restarted
scheduler rebuilds its occupancy from the pods' annotations (the
reference's ``TestThreeProcessControlPlane`` cases).  A node daemon that is
stopped stops its pods.  The extender service (``scheduler.serve``) prints
the reference's policy stanza and answers ``/filter``; the node daemon
refuses ``--transport grpc`` without grpcio and ``--backend nvml`` without
NVML."""

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from kubegpu_tpu.scheduler import webhook as rhook
from kubegpu_tpu_torch.cluster import tpu_pod
from kubegpu_tpu_torch.crishim.agent import NodeAgent
from kubegpu_tpu_torch.crishim.runtime import FakeRuntime
from kubegpu_tpu_torch.kubemeta import FakeApiServer, GangSpec, PodPhase
from kubegpu_tpu_torch.kubemeta.apiserver_http import (
    ApiServerHTTP,
    HttpApiClient,
)
from kubegpu_tpu_torch.tpuplugin import MockBackend, NvmlError
from kubegpu_tpu_torch.tpuplugin import nvml as nvml_mod


def _spawn(mod: str, *args: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", mod, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _stop(*procs: subprocess.Popen) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _wait(cond, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if cond():
                return
        except OSError:
            pass
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _line(proc, needle, timeout=60.0):
    """The first line of ``proc``'s stdout holding ``needle``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if needle in line:
            return line
        if not line and proc.poll() is not None:
            break
    raise AssertionError(f"no {needle!r} line: {proc.stderr.read()}")


def test_pod_e2e_three_processes():
    """submit → apiserver process → scheduler process (cached reads,
    wire binds) → node daemon process → workload subprocess → Succeeded,
    read back over HTTP; the scheduler's /metrics has the decision."""
    port, mport = _free_port(), _free_port()
    url = f"http://127.0.0.1:{port}"
    aps = _spawn("kubegpu_tpu_torch.kubemeta.apiserver_serve",
                 "--port", str(port))
    sch = _spawn("kubegpu_tpu_torch.scheduler.daemon", "--apiserver", url,
                 "--tick", "0.2", "--metrics-port", str(mport))
    nod = _spawn("kubegpu_tpu_torch.crishim.serve", "--apiserver", url,
                 "--backend", "mock", "--slice", "h100-sxm-8",
                 "--real-processes", "--tick", "0.05",
                 "--advertise-interval", "1")
    client = None
    try:
        assert _line(aps, "apiserver: listening on").strip().endswith(url)
        client = HttpApiClient(url)
        _wait(lambda: client.list("Node"), what="node registration")
        _line(sch, "scheduler: connected")
        client.create("Pod", tpu_pod(
            "hello", chips=1, command=[sys.executable, "-c", "print('ran')"]))
        _wait(lambda: client.get("Pod", "hello").status.phase
              == PodPhase.SUCCEEDED, what="pod completion")
        pod = client.get("Pod", "hello")
        assert pod.spec.node_name == client.list("Node")[0].name
        _wait(lambda: b"schedule_latency_ms" in urllib.request.urlopen(
            f"http://127.0.0.1:{mport}/metrics", timeout=5).read(),
            what="metrics endpoint")
        for p, name in ((aps, "apiserver"), (sch, "scheduler"),
                        (nod, "node daemon")):
            assert p.poll() is None, f"{name} died"
    finally:
        if client is not None:
            client.close()
        _stop(sch, nod, aps)


def test_scheduler_restart_rebuilds_occupancy():
    """Kill the scheduler daemon after it commits a node-filling gang: a
    fresh daemon rebuilds that occupancy from the annotations, so an extra
    pod pends until the gang's pods are deleted, then schedules."""
    api = FakeApiServer()
    srv = ApiServerHTTP(api).start()
    NodeAgent(api, MockBackend("h100-sxm-4"), FakeRuntime()).register()

    def gang_pod(name, idx):
        return tpu_pod(name, chips=2, command=["x"],
                       gang=GangSpec(name="g", size=2, index=idx))

    sch = _spawn("kubegpu_tpu_torch.scheduler.daemon",
                 "--apiserver", srv.address, "--tick", "0.2")
    try:
        api.create("Pod", gang_pod("g-0", 0))
        api.create("Pod", gang_pod("g-1", 1))
        _wait(lambda: all(api.get("Pod", n).status.phase
                          == PodPhase.SCHEDULED for n in ("g-0", "g-1")),
              what="gang bound")
        _stop(sch)
        api.create("Pod", tpu_pod("late", chips=1, command=["x"]))
        sch = _spawn("kubegpu_tpu_torch.scheduler.daemon",
                     "--apiserver", srv.address, "--tick", "0.2")
        _line(sch, "scheduler: connected")
        # a few passes of the restarted daemon: the node is full
        time.sleep(0.6)
        assert api.get("Pod", "late").status.phase == PodPhase.PENDING, \
            "restarted scheduler double-allocated a full node"
        api.delete("Pod", "g-0")
        api.delete("Pod", "g-1")
        _wait(lambda: api.get("Pod", "late").status.phase
              == PodPhase.SCHEDULED, what="late pod scheduled")
    finally:
        _stop(sch)
        srv.close()


def test_stopped_node_daemon_stops_its_pods(tmp_path):
    """SIGTERM to the node daemon stops the pods it launched: no workload
    process outlives it to hold a card."""
    from kubegpu_tpu_torch.allocator import GangAllocator
    from kubegpu_tpu_torch.scheduler import DeviceScheduler

    api = FakeApiServer()
    srv = ApiServerHTTP(api).start()
    nod = _spawn("kubegpu_tpu_torch.crishim.serve", "--apiserver",
                 srv.address, "--backend", "mock", "--slice", "h100-sxm-1",
                 "--real-processes", "--tick", "0.05")
    pidfile = tmp_path / "pid"
    try:
        # the readiness line follows the Node's create and its advertised
        # cards' PATCH: a Node listed before it may have no cards yet
        assert _line_err(nod, "registered")
        api.create("Pod", tpu_pod("sleeper", chips=1, command=[
            sys.executable, "-c",
            f"import os, time; open({str(pidfile)!r}, 'w')"
            ".write(str(os.getpid())); time.sleep(120)"]))
        assert DeviceScheduler(api, allocator=GangAllocator()).run_once(
        ).scheduled == ["sleeper"]
        _wait(lambda: pidfile.exists() and pidfile.read_text(),
              what="pod start")
        pid = int(pidfile.read_text())
        nod.send_signal(signal.SIGTERM)
        assert nod.wait(timeout=20) == 0
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    finally:
        _stop(nod)
        srv.close()


def test_extender_service_prints_the_references_stanza():
    """``python -m kubegpu_tpu_torch.scheduler.serve --port 0`` on the mock
    backend binds an ephemeral port, prints the reference's policy stanza
    for it and answers ``/filter``."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubegpu_tpu_torch.scheduler.serve",
         "--port", "0", "--slices", "h100-sxm-8"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        addr = _line_err(proc, "extender listening on").split()[-1]
        lines = [proc.stdout.readline()]
        while lines[-1] not in ("}\n", ""):
            lines.append(proc.stdout.readline())
        text = "".join(lines)
        assert text == json.dumps(rhook.policy_config(addr), indent=2) + "\n"
        doc = {"metadata": {"name": "p"}, "spec": {"containers": [
            {"name": "main", "resources": {"requests": {
                "kubetpu.io/tpu-chips": "1"}}}]}}
        node = "h100-sxm-8-slice-0-host-0"
        req = urllib.request.Request(
            f"{addr}/kubetpu/filter", method="POST",
            data=json.dumps({"Pod": doc, "NodeNames": [node, "nope"]})
            .encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            out = json.loads(resp.read())
        assert out["NodeNames"] == [node] and out["Error"] == ""
        assert list(out["FailedNodes"]) == ["nope"]
    finally:
        _stop(proc)


def _line_err(proc, needle, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if needle in line:
            return line.strip()
        if not line and proc.poll() is not None:
            break
    raise AssertionError(f"no {needle!r} line")


def _agent_args(tmp_path, url, **kw):
    base = dict(apiserver=url, backend="mock", slice="v4-8", host_id=0,
                cri_socket=str(tmp_path / "cri.sock"), real_processes=False,
                env=None, transport="json")
    base.update(kw)
    return argparse.Namespace(**base)


def test_node_daemon_refusals(tmp_path, monkeypatch):
    """``--transport grpc`` with grpcio hidden raises an ``ImportError``
    naming it, and ``--backend nvml`` without NVML raises (no mock stands
    in, as the reference's libtpu backend raises without libtpu)."""
    from kubegpu_tpu_torch.crishim.serve import build_agent, main

    srv = ApiServerHTTP(FakeApiServer()).start()
    try:
        with monkeypatch.context() as mp:
            mp.setitem(sys.modules, "grpc", None)
            with pytest.raises(ImportError, match="grpcio"):
                build_agent(_agent_args(tmp_path, srv.address,
                                        transport="grpc"))
        with monkeypatch.context() as mp:
            mp.setattr(nvml_mod, "LIBRARY", "libnvidia-ml-missing.so.1")
            with pytest.raises(NvmlError, match="cannot load"):
                build_agent(_agent_args(tmp_path, srv.address,
                                        backend="nvml"))
        with pytest.raises(SystemExit):
            main(["--apiserver", srv.address, "--backend", "libtpu"])
    finally:
        srv.close()


def test_build_scheduler_wires_cache():
    """``build_scheduler`` makes client → cache → scheduler → recovery; a
    pod scheduled through it binds on the server."""
    from kubegpu_tpu_torch.kubemeta.cache import WatchCachedApiClient
    from kubegpu_tpu_torch.scheduler.daemon import build_scheduler

    api = FakeApiServer()
    srv = ApiServerHTTP(api).start()
    NodeAgent(api, MockBackend("v4-8"), FakeRuntime()).register()
    client, cache, sched, recovery = build_scheduler(
        argparse.Namespace(apiserver=srv.address, gang_grace=30.0))
    try:
        assert isinstance(sched.api, WatchCachedApiClient)
        api.create("Pod", tpu_pod("p", chips=1, command=["x"]))
        _wait(lambda: cache.list("Pod"), timeout=5, what="watch delivery")
        recovery.run_once()
        assert sched.run_once().scheduled == ["p"]
        assert api.get("Pod", "p").status.phase == PodPhase.SCHEDULED
    finally:
        srv.close()
        recovery.close()
        cache.close()
        client.close()
