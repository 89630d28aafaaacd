"""The port's crishim: the env a grant injects (the reference's keys and the
cards by UUID), a pod without one sees no card, ``SubprocessRuntime`` hands
a real child that env in place of its parent's ``CUDA_VISIBLE_DEVICES``,
the node agent harvests a pod's metric lines as the reference's does, and a
one-card node runs its second pod after the first."""

import json
import os
import sys
from pathlib import Path

import pytest
import torch

import kubegpu_tpu.crishim as rcrishim
import kubegpu_tpu.kubemeta as rkubemeta
import kubegpu_tpu.obs as robs
import kubegpu_tpu.tpuplugin as rplugin
from kubegpu_tpu_torch.cluster import SimCluster, tpu_pod
from kubegpu_tpu_torch.crishim import (
    CriShim,
    FakeRuntime,
    NodeAgent,
    SubprocessRuntime,
    harvest_workload_metrics,
)
from kubegpu_tpu_torch.kubemeta import (
    AllocatedChip,
    Allocation,
    FakeApiServer,
    PodPhase,
    node_advertisement,
    set_pod_allocation,
)
from kubegpu_tpu_torch.obs import MetricsRegistry
from kubegpu_tpu_torch.tpuplugin import MockBackend

# a pod that writes its env to argv[1] and prints one metric line
PROBE = ("import json, os, sys; json.dump(dict(os.environ), "
         "open(sys.argv[1], 'w')); print(json.dumps({'metric': "
         "'probe_value', 'value': 2.5})); print('not a metric')")
STDOUT = "\n".join([
    json.dumps({"metric": "serve_decode_tokens_per_s", "value": 1234.5}),
    json.dumps({"metric": "bad", "value": "nan"}),
    json.dumps({"metric": "no_value"}),
    "{not json \"metric\"",
    json.dumps({"metric": "allreduce_algo_bandwidth", "value": 3})])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_pod_without_a_grant_sees_no_card():
    from kubegpu_tpu.cluster import tpu_pod as ref_pod

    ref_be, ref_rt = rplugin.MockBackend("v4-8"), rcrishim.FakeRuntime()
    rcrishim.CriShim(rkubemeta.FakeApiServer(), ref_be, ref_be.node_name,
                     ref_rt).create_container(
        ref_pod("cpu", command=["true"], env={"A": "1"}))
    be, rt = MockBackend("h100-sxm-8"), FakeRuntime()
    CriShim(FakeApiServer(), be, be.node_name, rt).create_container(
        tpu_pod("cpu", command=["true"], env={"A": "1"}))
    want, env = ref_rt.containers()[0].env, rt.containers()[0].env
    assert {k: env[k] for k in want} == want
    assert env["TPU_VISIBLE_CHIPS"] == env["CUDA_VISIBLE_DEVICES"] == ""
    assert set(env) == set(want) | {"CUDA_VISIBLE_DEVICES"}


def test_the_grant_injects_uuids_and_refuses_another_node():
    api, be, rt = FakeApiServer(), MockBackend("h100-sxm-8"), FakeRuntime()
    adv = be.discover()
    pod = tpu_pod("p", chips=2, command=["true"])
    set_pod_allocation(pod, Allocation(
        node_name=be.node_name, slice_id=be.slice_id,
        chips=[AllocatedChip(c.coord, c.local_index, 1000)
               for c in adv.chips[5:7]],
        coordinator_address="10.0.0.1:8476", worker_hostnames=["h"]))
    env = CriShim(api, be, be.node_name, rt).create_container(pod).env
    uuids = ",".join(c.uuid for c in adv.chips[5:7])
    assert env["CUDA_VISIBLE_DEVICES"] == env["NVIDIA_VISIBLE_DEVICES"] \
        == uuids
    assert env["TPU_VISIBLE_CHIPS"] == "5,6"
    assert env["KUBETPU_HBM_GIB"] == "160.0"
    assert env["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
    with pytest.raises(ValueError, match="but this shim serves"):
        CriShim(api, be, "other-node", rt).create_container(pod)


def test_harvest_equals_the_reference():
    from kubegpu_tpu.crishim.agent import harvest_workload_metrics as ref
    ours, theirs = MetricsRegistry(), robs.MetricsRegistry()
    assert harvest_workload_metrics(STDOUT, ours, "p") == \
        ref(STDOUT, theirs, "p") == ["serve_decode_tokens_per_s",
                                     "allreduce_algo_bandwidth"]
    assert ours.snapshot()["gauges"] == theirs.snapshot()["gauges"]


def test_a_program_reports_its_launches_where_the_pod_asks(monkeypatch,
                                                           capsys):
    """``run_program``: with ``KUBETPU_REPORT_LAUNCHES=1`` one
    ``launches_<kernel>`` line a kernel of the port after the program's own
    lines, which the agent harvests; without it nothing more."""
    from kubegpu_tpu_torch import kernels
    from kubegpu_tpu_torch.workloads.programs.distributed import run_program

    def program():
        print(json.dumps({"metric": "own", "value": 1}))
        return 3

    monkeypatch.delenv("KUBETPU_REPORT_LAUNCHES", raising=False)
    assert run_program(program) == 3
    assert capsys.readouterr().out.count('"metric"') == 1
    monkeypatch.setenv("KUBETPU_REPORT_LAUNCHES", "1")
    monkeypatch.setitem(kernels.launches, "paged_decode", 7)
    assert run_program(program) == 3
    metrics = MetricsRegistry()
    seen = harvest_workload_metrics(capsys.readouterr().out, metrics, "p")
    assert seen == ["own"] + [f"launches_{k}" for k in kernels.SIGNATURES]
    gauges = metrics.snapshot()["gauges"]
    assert gauges["workload_launches_paged_decode"] == 7
    assert gauges["workload_launches_flash_fwd"] == 0


def test_a_real_child_gets_the_grant_in_place_of_its_parents(
        tmp_path, monkeypatch):
    """``--real`` on the CPU: a probe pod through the whole path (schedule,
    annotate, bind, inject, launch, reap, harvest)."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "7")
    monkeypatch.setenv("LD_LIBRARY_PATH", "/opt/nvidia/lib")
    monkeypatch.setenv("SECRET_OF_THE_PARENT", "x")
    out = tmp_path / "env.json"
    cl = SimCluster(["h100-sxm-4"], real_processes=True)
    try:
        cl.submit(tpu_pod("probe", chips=2, mesh_axes={"tp": 2},
                          command=[sys.executable, "-c", PROBE, str(out)],
                          env={"KUBETPU_EXPECT_CHIPS": "2"}))
        assert cl.run_to_completion(timeout_s=60) == {"probe": 0}
        assert cl.pod_phase("probe") == PodPhase.SUCCEEDED
        env = json.loads(out.read_text())
        adv = cl.agents[0].backend.discover()
        granted = env["TPU_VISIBLE_CHIPS"].split(",")
        uuids = ",".join(adv.chips[int(i)].uuid for i in granted)
        assert len(granted) == 2
        assert env["CUDA_VISIBLE_DEVICES"] == uuids
        assert env["NVIDIA_VISIBLE_DEVICES"] == uuids
        assert env["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
        assert env["KUBETPU_MESH_AXES"] == json.dumps([["tp", 2]])
        assert env["KUBETPU_EXPECT_CHIPS"] == "2"
        assert "LD_LIBRARY_PATH" not in env
        assert "SECRET_OF_THE_PARENT" not in env
        assert "JAX_PLATFORMS" not in env
        gauges = cl.metrics.snapshot()["gauges"]
        assert gauges["workload_probe_value"] == 2.5
    finally:
        cl.close()


def test_a_one_card_node_runs_its_second_pod_after_the_first():
    cl = SimCluster(["h100-sxm-1"])
    try:
        cl.submit(tpu_pod("a", chips=1, command=["true"]),
                  tpu_pod("b", chips=1, command=["true"]))
        result, started = cl.step()
        assert result.scheduled == ["a"] and "b" in result.unschedulable
        assert cl.pod_phase("b") == PodPhase.PENDING
        assert cl.reap() == {"a": 0}
        result, started = cl.step()
        assert result.scheduled == ["b"]
        envs = {h.pod_name: h.env for h in cl.runtime.containers()}
        assert envs["a"]["CUDA_VISIBLE_DEVICES"] == \
            envs["b"]["CUDA_VISIBLE_DEVICES"]
    finally:
        cl.close()


def test_the_agent_advertises_its_uuids():
    api, rt = FakeApiServer(), FakeRuntime()
    agent = NodeAgent(api, MockBackend("h100-sxm-2", slice_id="n0"), rt)
    agent.register()
    adv = node_advertisement(api.get("Node", agent.node_name))
    assert adv.switched and len({c.uuid for c in adv.chips}) == 2
    assert all(c.uuid.startswith("GPU-") for c in adv.chips)


def test_subprocess_runtime_inherits_only_its_list(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/usr/local/cuda")
    monkeypatch.setenv("LANG", "C.UTF-8")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    out = tmp_path / "env.json"
    rt = SubprocessRuntime()
    h = rt.create_container("p", "main", [sys.executable, "-c", PROBE,
                                          str(out)],
                            {"CUDA_VISIBLE_DEVICES": ""})
    assert h.wait(timeout=60) == 0
    env = json.loads(out.read_text())
    assert env["CUDA_VISIBLE_DEVICES"] == "" and env["LANG"] == "C.UTF-8"
    assert "CUDA_HOME" not in env
    assert env["PYTHONPATH"].split(os.pathsep)[0] == str(
        Path(__file__).resolve().parent.parent)
