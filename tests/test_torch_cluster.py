"""The port's cluster layer against the reference's: the same example specs
through both ``SimCluster``s (``FakeRuntime``, one scheduling pass) give
equal bindings, allocation annotations, schedule-trace decisions and pod
tables, and the reference's env keys plus the three CUDA keys; the
allocator's and the topology's direct calls agree over the reference's
registry; and the switched H100 nodes behave as one NVLink hop a pair.

The reference runs its Python paths (``KUBETPU_NO_NATIVE=1``), the ones the
port copies; its ``test_native.py`` holds its native core equal to them."""

import io
import itertools
import json
import random
from pathlib import Path

import pytest
import torch
import yaml

import kubegpu_tpu.allocator as ralloc
import kubegpu_tpu.cli as rcli
import kubegpu_tpu.cluster as rcluster
import kubegpu_tpu.config as rconfig
import kubegpu_tpu.topology as rtopo
import kubegpu_tpu.tpuplugin as rplugin
import kubegpu_tpu_torch.allocator as palloc
import kubegpu_tpu_torch.cli as pcli
import kubegpu_tpu_torch.cluster as pcluster
import kubegpu_tpu_torch.config as pconfig
import kubegpu_tpu_torch.topology as ptopo
import kubegpu_tpu_torch.tpuplugin as pplugin
from kubegpu_tpu_torch.kubemeta.codec import (
    DEVICE_INFO_KEY,
    QUEUED_AT_KEY,
    pod_allocation,
)
from kubegpu_tpu_torch.tpuplugin import NvmlError
from kubegpu_tpu_torch.tpuplugin import nvml as nvml_mod
from kubegpu_tpu_torch.tpuplugin.mock import mock_uuid

ROOT = Path(__file__).resolve().parent.parent
SPECS = sorted((ROOT / "examples").glob("*.yaml"))
CUDA_KEYS = ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
             "CUDA_DEVICE_ORDER")
# the registry the reference ships (the port adds the h100-sxm-N nodes)
REF_TYPES = sorted(rtopo.TOPOLOGY_REGISTRY)


@pytest.fixture(scope="module", autouse=True)
def one_thread_python_paths():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUBETPU_NO_NATIVE", "1")
        yield
    torch.set_num_threads(threads)


def schedule(pkg, spec: dict):
    """One ``SimCluster`` of ``pkg`` ((cli, cluster, config) modules) built
    as ``apply --schedule-only`` builds it, with a pinned coordinator
    port; the spec submitted and one step run."""
    cli, cluster, config = pkg
    pods, slices = cli.pods_from_spec(spec)
    cfg = config.KubeTpuConfig()
    cfg.backend.slice_types = slices
    cfg.scheduler.coordinator_port = 9476
    cl = cluster.SimCluster.from_config(cfg)
    for ns, q in cli.quotas_from_spec(spec).items():
        cl.set_quota(ns, chips=q["chips"], millitpu=q["millitpu"])
    cl.submit(*pods)
    cl.step()
    return cl


REF = (rcli, rcluster, rconfig)
PORT = (pcli, pcluster, pconfig)


def untimed(detail):
    """A trace event's detail without its wall-clock fields."""
    if not isinstance(detail, dict):
        return detail
    return {k: untimed(v) for k, v in detail.items()
            if k not in ("total_ms", "phase_ms")}


def outcome(cli, cl) -> dict:
    pods = sorted(cl.api.list("Pod"), key=lambda p: p.name)
    table, top = io.StringIO(), io.StringIO()
    cli.render_pod_table(cl, out=table)
    cli.render_top(cl, out=top)
    return {
        "bindings": {p.name: (p.spec.node_name, p.status.phase.value)
                     for p in pods},
        "annotations": {p.name: {k: v for k, v in
                                 p.metadata.annotations.items()
                                 if k != QUEUED_AT_KEY} for p in pods},
        "trace": [(e.kind, e.gang, untimed(e.detail))
                  for e in cl.trace.events()],
        "table": table.getvalue(),
        "top": top.getvalue(),
        "env": {h.pod_name: h.env for h in cl.runtime.containers()},
        "nodes": {n.name: json.loads(n.metadata.annotations[DEVICE_INFO_KEY])
                  for n in cl.api.list("Node")},
    }


@pytest.mark.parametrize("path", SPECS, ids=[p.stem for p in SPECS])
def test_example_spec_schedules_as_the_reference(path):
    spec = yaml.safe_load(path.read_text())
    ref_cl, port_cl = schedule(REF, spec), schedule(PORT, spec)
    try:
        ref, port = outcome(rcli, ref_cl), outcome(pcli, port_cl)
        for key in ("bindings", "annotations", "trace", "table", "top"):
            assert port[key] == ref[key], key
        assert any(e[0] == "schedule" for e in ref["trace"]) or \
            not any(p.spec.containers[0].resources.tpu_chips
                    for p in ref_cl.api.list("Pod"))
        assert port["env"].keys() == ref["env"].keys()
        assert ref["env"], "no container was started"
        for name, ref_env in ref["env"].items():
            env = port["env"][name]
            assert {k: env.get(k) for k in ref_env} == ref_env, name
            alloc = pod_allocation(port_cl.api.get("Pod", name))
            if alloc is None or not alloc.chips:
                assert env["CUDA_VISIBLE_DEVICES"] == ""
                continue
            host = next(a.backend.host_id for a in port_cl.agents
                        if a.node_name == alloc.node_name)
            uuids = ",".join(mock_uuid(alloc.slice_id, host, c.local_index)
                             for c in alloc.chips)
            assert env["CUDA_VISIBLE_DEVICES"] == uuids
            assert env["NVIDIA_VISIBLE_DEVICES"] == uuids
            assert env["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
            assert set(env) == set(ref_env) | set(CUDA_KEYS)
        # node annotations: the reference's, each chip with its card UUID
        assert port["nodes"].keys() == ref["nodes"].keys()
        for name, doc in port["nodes"].items():
            uuids = [c.pop("uuid") for c in doc["chips"]]
            assert doc == ref["nodes"][name], name
            assert uuids == [mock_uuid(doc["sliceId"], doc["hostId"],
                                       c["localIndex"]) for c in doc["chips"]]
    finally:
        ref_cl.close()
        port_cl.close()


# -- direct calls over the reference's registry -----------------------------

def slice_states(plugin, alloc, slice_type: str, occupied: int, seed: int):
    """A slice of ``slice_type`` from the mock advertisements with
    ``occupied`` whole chips taken at seeded coords."""
    advs = [b.discover() for b in plugin.mock_cluster([slice_type])]
    st = alloc.SliceState.from_advertisements(advs)
    coords = sorted(st.available)
    for c in random.Random(seed).sample(coords, occupied):
        st.used_millichips[c] = 1000
    return st


def asg_view(a) -> tuple | None:
    if a is None:
        return None
    return (a.slice_id, a.locality, a.score, tuple(a.logical_order),
            tuple((p.pod_index, p.node_name, p.host_id, p.slice_id,
                   tuple((c.coord, c.local_index, c.millichips)
                         for c in p.chips)) for p in a.pods))


REQUESTS = [
    dict(num_pods=1, chips_per_pod=1),
    dict(num_pods=1, chips_per_pod=4),
    dict(num_pods=4, chips_per_pod=1, mesh_axes={"dp": 4}),
    dict(num_pods=2, chips_per_pod=4, mesh_axes={"dp": 2, "tp": 4}),
    dict(num_pods=4, chips_per_pod=4, mesh_axes={"dp": 4, "tp": 4}),
    dict(num_pods=1, chips_per_pod=3),
    dict(num_pods=1, millitpu_per_pod=500),
    dict(num_pods=2, chips_per_pod=2, mesh_axes={"dp": 2, "tp": 2},
         axis_weights={"dp": 0.05, "tp": 8.0}),
]


@pytest.mark.parametrize("slice_type", REF_TYPES)
def test_find_assignment_equals_the_reference(slice_type):
    n = rtopo.TOPOLOGY_REGISTRY[slice_type].num_chips
    for occupied, seed in ((0, 0), (n // 4, 1), (n // 2, 2)):
        rst = slice_states(rplugin, ralloc, slice_type, occupied, seed)
        pst = slice_states(pplugin, palloc, slice_type, occupied, seed)
        for kw in REQUESTS:
            got = palloc.GangAllocator().find_assignment(
                [pst], palloc.GangRequest(gang_name="g", **kw))
            want = ralloc.GangAllocator().find_assignment(
                [rst], ralloc.GangRequest(gang_name="g", **kw))
            assert asg_view(got) == asg_view(want), (occupied, kw)


def test_multislice_assignment_equals_the_reference():
    kw = dict(num_pods=8, chips_per_pod=2, mesh_axes={"dp": 8, "tp": 2},
              allow_multislice=True)
    views = []
    for plugin, alloc in ((rplugin, ralloc), (pplugin, palloc)):
        advs = [b.discover() for b in plugin.mock_cluster(["v4-8"] * 4)]
        sts = [alloc.SliceState.from_advertisements(
            [a for a in advs if a.slice_id == sid])
            for sid in sorted({a.slice_id for a in advs})]
        views.append(asg_view(alloc.GangAllocator().find_assignment(
            sts, alloc.GangRequest(gang_name="ms", **kw))))
    assert views[1] == views[0]
    assert len({pod[3] for pod in views[0][4]}) == 4


@pytest.mark.parametrize("slice_type", REF_TYPES)
def test_placements_orders_and_locality_equal_the_reference(slice_type):
    rt, pt = rtopo.get_topology(slice_type), ptopo.get_topology(slice_type)
    assert [(c.index, c.coord, c.host_id) for c in pt.chips] == \
        [(c.index, c.coord, c.host_id) for c in rt.chips]
    assert list(pt.links()) and [(a, b) for a, b, _ in pt.links()] == \
        [(a, b) for a, b, _ in rt.links()]
    n = rt.spec.num_chips
    for total in sorted({1, 2, 4, 8, n // 2, n} - {0}):
        for shape in rtopo.subslice_shapes(total, rt.spec.mesh_shape)[:3]:
            assert ptopo.subslice_shapes(total, pt.spec.mesh_shape)[:3] \
                == rtopo.subslice_shapes(total, rt.spec.mesh_shape)[:3]
            rp = rtopo.enumerate_placements(rt, shape)
            pp = ptopo.enumerate_placements(pt, shape)
            assert [(p.origin, p.shape, p.coords) for p in pp] == \
                [(p.origin, p.shape, p.coords) for p in rp]
            for rpl, ppl in list(zip(rp, pp))[:2]:
                for axes in (None, {"dp": total},
                             {"dp": total // 2, "tp": 2} if total > 1
                             else None):
                    r_order, r_loc = ralloc.best_logical_order(
                        rt, rpl, axes)
                    p_order, p_loc = palloc.best_logical_order(
                        pt, ppl, axes)
                    assert (p_order, p_loc) == (r_order, r_loc)
                    tm_r = rtopo.traffic_pairs_for_mesh_axes(
                        r_order, axes or {"dp": total})
                    tm_p = ptopo.traffic_pairs_for_mesh_axes(
                        p_order, axes or {"dp": total})
                    assert ptopo.ici_locality(pt, tm_p) == \
                        rtopo.ici_locality(rt, tm_r)


# -- the switched H100 nodes ------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_h100_nodes_are_one_hop_a_pair(n):
    topo = ptopo.get_topology(f"h100-sxm-{n}")
    spec = topo.spec
    assert spec.switched and spec.num_hosts == 1 and spec.num_chips == n
    assert spec.hbm_gib_per_chip == 80.0 and spec.mesh_shape == (n, 1, 1)
    coords = [c.coord for c in topo.chips]
    for a, b in itertools.combinations(coords, 2):
        assert topo.hop_distance(a, b) == 1
        assert topo.are_ici_adjacent(a, b) and topo.are_ici_adjacent(b, a)
    assert all(topo.hop_distance(c, c) == 0 for c in coords)
    assert not any(topo.are_ici_adjacent(c, c) for c in coords)
    assert len(list(topo.links())) == n * (n - 1) // 2
    for c in coords:
        assert sorted(topo.neighbors(c)) == sorted(set(coords) - {c})


def test_an_unswitched_line_keeps_the_torus_model():
    spec = ptopo.TopologySpec(name="line-8", generation="x",
                              mesh_shape=(8, 1, 1), host_block=(8, 1, 1))
    topo = ptopo.TpuTopology.build(spec)
    assert topo.hop_distance((0, 0, 0), (7, 0, 0)) == 7
    assert not topo.are_ici_adjacent((0, 0, 0), (2, 0, 0))
    assert len(list(topo.links())) == 7


def test_any_four_card_gang_in_a_node_has_locality_one():
    topo = ptopo.get_topology("h100-sxm-8")
    coords = [c.coord for c in topo.chips]
    for four in itertools.permutations(coords, 4):
        for axes in ({"dp": 4}, {"dp": 2, "tp": 2}):
            tm = ptopo.traffic_pairs_for_mesh_axes(list(four), axes)
            assert ptopo.ici_locality(topo, tm) == 1.0
    # the allocator on a node whose free cards are scattered
    advs = [b.discover() for b in pplugin.mock_cluster(["h100-sxm-8"])]
    st = palloc.SliceState.from_advertisements(advs)
    assert st.spec.switched
    for c in ((1, 0, 0), (3, 0, 0), (5, 0, 0)):
        st.used_millichips[c] = 1000
    for kw in (dict(num_pods=1, chips_per_pod=4),
               dict(num_pods=4, chips_per_pod=1, mesh_axes={"dp": 4}),
               dict(num_pods=2, chips_per_pod=2,
                    mesh_axes={"dp": 2, "tp": 2})):
        asg = palloc.GangAllocator().find_assignment(
            [st], palloc.GangRequest(gang_name="g", **kw))
        assert asg is not None and asg.locality == 1.0, kw
        taken = {c.coord for p in asg.pods for c in p.chips}
        assert len(taken) == 4 and not taken & {(1, 0, 0), (3, 0, 0),
                                                (5, 0, 0)}


def test_sixteen_card_multislice_gang_spans_two_nodes():
    spec = {"cluster": {"slices": ["h100-sxm-8", "h100-sxm-8"]},
            "pods": [{"name": "llama", "gang": 2, "chips": 8,
                      "mesh_axes": {"dp": 2, "tp": 8}, "multislice": True}]}
    cl = schedule(PORT, spec)
    try:
        allocs = [pod_allocation(p) for p in cl.api.list("Pod")]
        assert all(a is not None for a in allocs)
        assert len({a.slice_id for a in allocs}) == 2
        assert len({a.node_name for a in allocs}) == 2
        assert all(len(a.chips) == 8 for a in allocs)
        sched = [e for e in cl.trace.events("schedule")]
        # the tp rings ride each node's switch; dp's pairs cross nodes
        loc = sched[0].detail["detail"]["locality"]
        assert len(sched) == 1 and 0.0 < loc < 1.0
    finally:
        cl.close()
    # without the opt-in no node holds the gang
    spec["pods"][0]["multislice"] = False
    cl = schedule(PORT, spec)
    try:
        assert not any(pod_allocation(p) for p in cl.api.list("Pod"))
    finally:
        cl.close()


def test_gangs_stay_on_one_node_unless_multislice():
    """A seeded mix on four h100-sxm-8 nodes until nothing more fits, in
    one pass: every single-node gang sits on one node; a multislice
    gang spans nodes only where it must."""
    rng = random.Random(7)
    pods = []
    for g in range(24):
        size = rng.choice((1, 2, 4, 8, 16))
        multi = size == 16
        pods.append({"name": f"g{g}", "gang": 2 if multi else 1,
                     "chips": 8 if multi else size,
                     "mesh_axes": ({"dp": 2, "tp": 8} if multi
                                   else {"tp": size}),
                     "multislice": multi})
    cl = schedule(PORT, {"cluster": {"slices": ["h100-sxm-8"] * 4},
                         "pods": pods})
    try:
        by_gang: dict = {}
        for p in cl.api.list("Pod"):
            a = pod_allocation(p)
            if a is not None:
                by_gang.setdefault(a.gang_name, []).append(a)
        assert by_gang
        for gang, allocs in by_gang.items():
            nodes = {a.node_name for a in allocs}
            total = sum(len(a.chips) for a in allocs)
            assert len(nodes) == 1 or total > 8, gang
        used = sum(len(a.chips) for allocs in by_gang.values()
                   for a in allocs)
        assert 0 < used <= 32
    finally:
        cl.close()


def test_unported_knobs_raise_naming_their_item():
    # fault injection is ported (item 10c): a failed card evicts its gang,
    # which pends on a one-card node until the card heals
    cl = pcluster.SimCluster(["h100-sxm-1"])
    try:
        node = cl.agents[0].node_name
        cl.submit(pcluster.tpu_pod("p", chips=1, command=["noop"]))
        assert cl.step()[0].scheduled == ["p"]
        cl.fail_chip(node, 0)
        result, _ = cl.step()
        assert result.unschedulable == ["p"]
        assert cl.metrics.counter("gangs_evicted") == 1
        assert cl.pod_phase("p") == pcluster.PodPhase.PENDING
        cl.heal_chip(node, 0)
        assert cl.step()[0].scheduled == ["p"]
        with pytest.raises(KeyError, match="no agent"):
            cl.fail_host("x")
    finally:
        cl.close()
    # the CRI socket is ported (item 10d): a pod round-trips through it
    cl = pcluster.SimCluster(["h100-sxm-1"], wire_cri=True)
    try:
        assert len(cl.cri_servers) == 1
        cl.submit(pcluster.tpu_pod("w", chips=1, command=["noop"]))
        _, started = cl.step()
        assert started[0].env["CUDA_VISIBLE_DEVICES"].startswith("GPU-")
        assert cl.reap(timeout=2) == {"w": 0}
        assert cl.pod_phase("w") == pcluster.PodPhase.SUCCEEDED
    finally:
        cl.close()
    # the nvml backend is ported: without NVML it raises, no mock stands in
    cfg = pconfig.KubeTpuConfig()
    cfg.backend.type = "nvml"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nvml_mod, "LIBRARY", "libnvidia-ml-missing.so.1")
        with pytest.raises(NvmlError, match="cannot load"):
            pcluster.SimCluster.from_config(cfg)
    with pytest.raises(ValueError, match="unknown backend"):
        pconfig.KubeTpuConfig.load(overrides=["backend.type=libtpu"])
