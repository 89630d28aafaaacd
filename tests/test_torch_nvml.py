"""``NvmlBackend`` over a fake NVML function table: the calls, buffers and
structs it passes, ``CUDA_VISIBLE_DEVICES`` as indices or UUIDs, NVLink pairs
that make a node switched, the grant's env, and no fallback where the
library or a card is missing."""

import ctypes
import json
import sys

import pytest
import torch

from kubegpu_tpu_torch.allocator import SliceState
from kubegpu_tpu_torch.kubemeta.codec import (
    node_advertisement_from_annotation,
    node_advertisement_to_annotation,
)
from kubegpu_tpu_torch.topology import get_topology
from kubegpu_tpu_torch.tpuplugin import NvmlBackend, NvmlError
from kubegpu_tpu_torch.tpuplugin import nvml as nvml_mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_visible(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv("KUBETPU_SLICE_ID", raising=False)


class FakeNvml:
    """NVML's entry points as Python functions writing through the ctypes
    pointers and buffers the backend passes (as the C library would)."""

    def __init__(self, cards, nvlinked=None, fail=None, remapped=None):
        self.cards = cards       # [(name, uuid, memory bytes, bus id)]
        self.nvlinked = nvlinked if nvlinked is not None else set()
        self.fail = fail or {}   # entry point -> return code
        self.inits = self.shutdowns = 0
        # card index -> (corrected, uncorrected, pending, failure)
        self.remapped = remapped or {}
        self.events = []         # pending (card index, xid), oldest first
        self.registered = set()  # card indices on the event set
        self.sets = self.freed = 0

    def _rc(self, fn):
        return self.fail.get(fn, 0)

    def nvmlInit_v2(self):
        self.inits += 1
        return self._rc("nvmlInit_v2")

    def nvmlShutdown(self):
        self.shutdowns += 1
        return 0

    def nvmlErrorString(self, rc):
        return f"fake error {rc}".encode()

    def nvmlDeviceGetCount_v2(self, count):
        count._obj.value = len(self.cards)
        return self._rc("nvmlDeviceGetCount_v2")

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        assert isinstance(index, ctypes.c_uint)
        handle._obj.value = 0x1000 + index.value
        return self._rc("nvmlDeviceGetHandleByIndex_v2")

    def _card(self, handle):
        assert isinstance(handle, ctypes.c_void_p)
        return self.cards[handle.value - 0x1000]

    def nvmlDeviceGetName(self, handle, buf, length):
        assert length.value == len(buf) == 96
        buf.value = self._card(handle)[0].encode()
        return 0

    def nvmlDeviceGetUUID(self, handle, buf, length):
        assert length.value == len(buf) == 96
        buf.value = self._card(handle)[1].encode()
        return 0

    def nvmlDeviceGetMemoryInfo(self, handle, mem):
        assert isinstance(mem._obj, nvml_mod.NvmlMemory)
        mem._obj.total = self._card(handle)[2]
        mem._obj.used = 1 << 20
        mem._obj.free = mem._obj.total - mem._obj.used
        return self._rc("nvmlDeviceGetMemoryInfo")

    def nvmlDeviceGetPciInfo_v3(self, handle, pci):
        assert ctypes.sizeof(pci._obj) == 16 + 5 * 4 + 32
        pci._obj.busId = self._card(handle)[3].encode()
        return self._rc("nvmlDeviceGetPciInfo_v3")

    def nvmlDeviceGetP2PStatus(self, h1, h2, index, status):
        assert index.value == nvml_mod.NVML_P2P_CAPS_INDEX_NVLINK == 2
        pair = frozenset((h1.value - 0x1000, h2.value - 0x1000))
        status._obj.value = 0 if pair in self.nvlinked else 5
        return self._rc("nvmlDeviceGetP2PStatus")

    def nvmlDeviceGetRemappedRows(self, handle, corr, unc, pending, failure):
        rows = self.remapped.get(self._index(handle), (0, 0, 0, 0))
        for ptr, v in zip((corr, unc, pending, failure), rows):
            assert isinstance(ptr._obj, ctypes.c_uint)
            ptr._obj.value = v
        return self._rc("nvmlDeviceGetRemappedRows")

    def _index(self, handle):
        assert isinstance(handle, ctypes.c_void_p)
        return handle.value - 0x1000

    SET = 0x5E7

    def nvmlEventSetCreate(self, event_set):
        event_set._obj.value = self.SET
        self.sets += 1
        return self._rc("nvmlEventSetCreate")

    def nvmlDeviceRegisterEvents(self, handle, types, event_set):
        assert types.value == nvml_mod.NVML_EVENT_TYPE_XID_CRITICAL_ERROR \
            == 8 and event_set.value == self.SET
        rc = self._rc("nvmlDeviceRegisterEvents")
        if rc == 0:
            self.registered.add(self._index(handle))
        return rc

    def nvmlEventSetWait_v2(self, event_set, data, timeout):
        assert event_set.value == self.SET and timeout.value == 0
        assert isinstance(data._obj, nvml_mod.NvmlEventData)
        while self.events:
            index, xid = self.events.pop(0)
            if index in self.registered:
                data._obj.device = 0x1000 + index
                data._obj.eventType = 8
                data._obj.eventData = xid
                return 0
        return nvml_mod.NVML_ERROR_TIMEOUT

    def nvmlEventSetFree(self, event_set):
        assert event_set.value == self.SET
        self.freed += 1
        return 0


def h100s(n):
    return [("NVIDIA H100 80GB HBM3", f"GPU-{i:08x}-aaaa-bbbb-cccc-dddd",
             81559 << 20, f"00000000:{0x18 + i:02X}:00.0") for i in range(n)]


def all_pairs(n):
    return {frozenset((i, j)) for i in range(n) for j in range(i + 1, n)}


def test_structs_match_the_header_layout():
    assert ctypes.sizeof(nvml_mod.NvmlMemory) == 24
    assert ctypes.sizeof(nvml_mod.NvmlPciInfo) == 68
    assert nvml_mod.NvmlPciInfo.busId.offset == 36


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_an_nvswitch_node_is_an_h100_slice(n):
    lib = FakeNvml(h100s(n), all_pairs(n))
    be = NvmlBackend(node_name="node-a", lib=lib)
    adv = be.discover()
    # the XID event set holds one NVML reference until close()
    assert (lib.inits, lib.shutdowns, lib.sets) == (2, 1, 1)
    assert lib.registered == set(range(n))
    assert adv.slice_type == f"h100-sxm-{n}" and adv.switched
    assert adv.slice_id == "node-a-nvlink" and adv.node_name == "node-a"
    assert adv.mesh_shape == adv.host_block == (n, 1, 1)
    assert [c.uuid for c in adv.chips] == [c[1] for c in h100s(n)]
    assert [c.coord for c in adv.chips] == [(i, 0, 0) for i in range(n)]
    assert all(abs(c.hbm_gib - 81559 / 1024) < 1e-9 for c in adv.chips)
    # the advertisement round-trips the annotation and builds the slice
    back = node_advertisement_from_annotation(
        node_advertisement_to_annotation(adv))
    assert back == adv
    st = SliceState.from_advertisements([back])
    assert st.spec.switched and st.topo.hop_distance(
        (0, 0, 0), (n - 1, 0, 0)) == (1 if n > 1 else 0)
    assert st.spec.mesh_shape == get_topology(adv.slice_type).spec.mesh_shape
    be.discover()
    assert (lib.inits, lib.shutdowns, lib.sets) == (3, 2, 1)
    be.close()
    assert (lib.inits, lib.shutdowns, lib.freed) == (3, 3, 1)


def test_missing_nvlink_pairs_make_a_local_line():
    lib = FakeNvml(h100s(4), all_pairs(4) - {frozenset((0, 3))})
    adv = NvmlBackend(node_name="n", lib=lib).discover()
    assert adv.slice_type == "local-4card" and not adv.switched
    st = SliceState.from_advertisements([adv])
    assert not st.topo.are_ici_adjacent((0, 0, 0), (3, 0, 0))
    # all NVLinked, but not H100s: no registry slice either
    other = [("NVIDIA A100-SXM4-80GB",) + c[1:] for c in h100s(2)]
    adv = NvmlBackend(node_name="n", lib=FakeNvml(other, all_pairs(2))) \
        .discover()
    assert adv.slice_type == "local-2card" and not adv.switched


def test_unsupported_queries_leave_facts_unknown():
    """A virtualized card may not report its PCI bus id (the chip
    machine's returns NVML_ERROR_NOT_SUPPORTED): the card stays, its bus
    id unknown; an unsupported P2P query leaves the pair unlinked."""
    lib = FakeNvml(h100s(2), all_pairs(2),
                   fail={"nvmlDeviceGetPciInfo_v3": 3})
    be = NvmlBackend(node_name="n", lib=lib)
    cards, pairs = be.cards()
    assert [c["pci_bus_id"] for c in cards] == [None, None]
    assert pairs == [(0, 1)] and be.discover().slice_type == "h100-sxm-2"
    lib = FakeNvml(h100s(2), all_pairs(2),
                   fail={"nvmlDeviceGetP2PStatus": 3})
    adv = NvmlBackend(node_name="n", lib=lib).discover()
    assert adv.slice_type == "local-2card" and not adv.switched
    assert NvmlBackend(node_name="n", lib=FakeNvml(h100s(2), all_pairs(
        2))).cards()[0][1]["pci_bus_id"] == "00000000:19:00.0"


@pytest.mark.parametrize("visible,picked", [
    ("2,0", [2, 0]),
    ("GPU-00000003-aaaa-bbbb-cccc-dddd", [3]),
    ("GPU-00000001,3", [1, 3]),          # a unique UUID prefix
    ("1,9,2", [1]),                       # the list ends at a bad entry
    ("1,1", [1]),
])
def test_cuda_visible_devices_admits_cards(monkeypatch, visible, picked):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    lib = FakeNvml(h100s(4), all_pairs(4))
    be = NvmlBackend(node_name="n", lib=lib)
    cards, pairs = be.cards()
    assert [c["index"] for c in cards] == picked
    assert len(pairs) == len(picked) * (len(picked) - 1) // 2
    adv = be.discover()
    assert [c.uuid for c in adv.chips] == [h100s(4)[i][1] for i in picked]
    assert adv.slice_type == f"h100-sxm-{len(picked)}"


def test_the_grant_names_cards_by_uuid(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,1")
    lib = FakeNvml(h100s(4), all_pairs(4))
    be = NvmlBackend(node_name="n", lib=lib)
    adv = be.discover()
    env = be.allocate_env([adv.chips[1]], worker_id=0, num_workers=1,
                          coordinator_address="10.0.0.1:8476",
                          worker_hostnames=["n"])
    uuid = h100s(4)[1][1]
    assert env["CUDA_VISIBLE_DEVICES"] == env["NVIDIA_VISIBLE_DEVICES"] \
        == uuid
    assert env["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
    assert env["TPU_VISIBLE_CHIPS"] == "1" and env["TPU_WORKER_ID"] == "0"
    assert env["TPU_CHIPS_PER_HOST_BOUNDS"] == "2,1,1"
    assert env["JAX_COORDINATOR_ADDRESS"] == "10.0.0.1:8476"
    # the grant is made against the advertisement: NVML is not asked again
    # (the second reference is the XID event set's)
    assert (lib.inits, lib.shutdowns) == (2, 1)


def test_every_card_advertises_healthy():
    """A healthy node: no remapping failure or pending, no XID, every
    pair NVLinked."""
    be = NvmlBackend(node_name="n", lib=FakeNvml(h100s(2), all_pairs(2)))
    adv = be.discover()
    assert all(c.healthy for c in adv.chips) and adv.bad_links == ()
    cards, _ = be.cards()
    assert all(c["remapped_rows"] == dict.fromkeys(
        ("corrected", "uncorrected", "pending", "failure"), 0)
        and c["xid_watched"] and c["xid"] is None for c in cards)
    be.close()


def healthy(be):
    return [c.healthy for c in be.discover().chips]


@pytest.mark.parametrize("rows", [(0, 1, 0, 1), (0, 0, 1, 0), (3, 0, 0, 0)],
                         ids=["failure", "pending", "corrected-only"])
def test_remapped_rows_failure_or_pending_make_a_card_unhealthy(rows):
    lib = FakeNvml(h100s(4), all_pairs(4), remapped={2: rows})
    be = NvmlBackend(node_name="n", lib=lib)
    bad = bool(rows[2] or rows[3])
    assert healthy(be) == [True, True, not bad, True]
    cards, _ = be.cards()
    assert cards[2]["remapped_rows"] == dict(zip(
        ("corrected", "uncorrected", "pending", "failure"), rows))
    lib.remapped.clear()            # the card was reset: rows remapped
    assert healthy(be) == [True] * 4


@pytest.mark.parametrize("xid", sorted(nvml_mod.APPLICATION_XIDS)
                         + [48, 63, 74, 79, 94, 95])
def test_a_critical_xid_marks_its_card_until_healed(xid):
    lib = FakeNvml(h100s(4), all_pairs(4))
    be = NvmlBackend(node_name="n", lib=lib)
    assert healthy(be) == [True] * 4
    lib.events.append((1, xid))
    app = xid in nvml_mod.APPLICATION_XIDS
    assert healthy(be) == [True, app, True, True]
    assert be.xids == ({} if app else {h100s(4)[1][1]: xid})
    assert healthy(be) == [True, app, True, True]    # it stays marked
    cards, _ = be.cards()
    assert cards[1]["xid"] == (None if app else xid)
    assert all(c["xid_watched"] for c in cards)
    be.heal_chip(1)
    assert healthy(be) == [True] * 4 and not lib.events
    be.close()
    assert lib.freed == 1 and lib.inits == lib.shutdowns


def test_a_lost_nvlink_pair_is_a_bad_link_the_scheduler_sees():
    from kubegpu_tpu_torch.cluster import SimCluster
    lib = FakeNvml(h100s(4), all_pairs(4))
    be = NvmlBackend(node_name="n", lib=lib)
    cl = SimCluster([], backends=[be])
    try:
        sid = be.slice_id
        cl.step()
        assert cl.scheduler.slices[sid].bad_links == set()
        lib.nvlinked.discard(frozenset((1, 3)))
        cl.agents[0].advertise()
        cl.step()
        st = cl.scheduler.slices[sid]
        assert st.bad_links == {((1, 0, 0), (3, 0, 0))}
        # the node stays one switched slice; every card stays healthy
        assert st.spec.name == "h100-sxm-4" and st.spec.switched
        assert not st.unhealthy
        # heal_link accepts the loss; NVML's pair coming back re-arms it
        cl.heal_link((3, 0, 0), (1, 0, 0))
        cl.step()
        assert cl.scheduler.slices[sid].bad_links == set()
        lib.nvlinked.add(frozenset((1, 3)))
        cl.agents[0].advertise()
        lib.nvlinked.discard(frozenset((1, 3)))
        cl.agents[0].advertise()
        cl.step()
        assert cl.scheduler.slices[sid].bad_links == {((1, 0, 0),
                                                       (3, 0, 0))}
        # a reported link (fail_link) and a monitor's mark (fail_chip)
        cl.fail_link((0, 0, 0), (2, 0, 0))
        cl.fail_chip("n", 2)
        cl.step()
        st = cl.scheduler.slices[sid]
        assert ((0, 0, 0), (2, 0, 0)) in st.bad_links
        assert st.unhealthy == {(2, 0, 0)}
        cl.heal_chip("n", 2)
        cl.heal_link((0, 0, 0), (2, 0, 0))
        cl.step()
        st = cl.scheduler.slices[sid]
        assert not st.unhealthy and ((0, 0, 0), (2, 0, 0)) not in \
            st.bad_links
        with pytest.raises(ValueError, match="no local card"):
            cl.fail_chip("n", 4)
    finally:
        cl.close()
    assert lib.freed == 1 and lib.inits == lib.shutdowns


@pytest.mark.parametrize("fn", ["nvmlDeviceGetRemappedRows",
                                "nvmlEventSetCreate",
                                "nvmlDeviceRegisterEvents"])
def test_unsupported_health_queries_leave_the_card_healthy(fn):
    lib = FakeNvml(h100s(2), all_pairs(2), fail={fn: 3},
                   remapped={0: (0, 0, 1, 1)})
    be = NvmlBackend(node_name="n", lib=lib)
    lib.events.append((0, 79))
    cards, _ = be.cards()
    rows_known = fn != "nvmlDeviceGetRemappedRows"
    watched = fn == "nvmlDeviceGetRemappedRows"
    assert [c["xid_watched"] for c in cards] == [watched] * 2
    assert (cards[0]["remapped_rows"] is not None) == rows_known
    # what NVML does report still counts
    assert [c["healthy"] for c in cards] == [not (rows_known or watched),
                                             True]
    be.close()
    assert lib.inits == lib.shutdowns
    assert lib.freed == (fn != "nvmlEventSetCreate")


def test_other_health_failures_raise():
    for fn in ("nvmlDeviceGetRemappedRows", "nvmlEventSetCreate",
               "nvmlDeviceRegisterEvents"):
        lib = FakeNvml(h100s(2), all_pairs(2), fail={fn: 999})
        with pytest.raises(NvmlError, match=fn):
            NvmlBackend(node_name="n", lib=lib).discover()
    lib = FakeNvml(h100s(2), all_pairs(2))
    be = NvmlBackend(node_name="n", lib=lib)
    be.discover()
    lib.nvmlEventSetWait_v2 = lambda *a: 999
    with pytest.raises(NvmlError, match="nvmlEventSetWait_v2 returned 999"):
        be.discover()
    be.close()


def test_a_health_check_hook_and_a_monitor_mark_a_card():
    seen = []

    def check(li, handle):
        seen.append((li, handle.value))
        return li != 0
    lib = FakeNvml(h100s(2), all_pairs(2))
    be = NvmlBackend(node_name="n", lib=lib, health_check=check)
    assert healthy(be) == [False, True]
    assert seen == [(0, 0x1000), (1, 0x1001)]
    be.mark_chip_unhealthy(1)
    be.report_bad_link((1, 0, 0), (0, 0, 0))
    adv = be.discover()
    assert [c.healthy for c in adv.chips] == [False, False]
    assert adv.bad_links == (((0, 0, 0), (1, 0, 0)),)
    be.heal_chip(1)
    be.heal_link((0, 0, 0), (1, 0, 0))
    adv = be.discover()
    assert [c.healthy for c in adv.chips] == [False, True]
    assert adv.bad_links == ()
    be.close()


def test_no_library_no_card_no_fallback(monkeypatch):
    with pytest.raises(NvmlError, match="cannot load"):
        nvml_mod.load_library("libnvidia-ml-missing.so.1")
    monkeypatch.setattr(nvml_mod, "LIBRARY", "libnvidia-ml-missing.so.1")
    with pytest.raises(NvmlError, match="cannot load"):
        NvmlBackend(node_name="n")
    with pytest.raises(NvmlError, match="no NVIDIA card"):
        NvmlBackend(node_name="n", lib=FakeNvml([])).discover()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(NvmlError, match="no NVIDIA card"):
        NvmlBackend(node_name="n", lib=FakeNvml(h100s(2))).discover()
    lib = FakeNvml(h100s(2), fail={"nvmlDeviceGetMemoryInfo": 999})
    with pytest.raises(NvmlError, match="nvmlDeviceGetMemoryInfo returned "
                       "999 .fake error 999."):
        NvmlBackend(node_name="n", lib=lib).discover()
    assert lib.shutdowns == lib.inits == 1
    lib = FakeNvml(h100s(2), fail={"nvmlInit_v2": 9})
    with pytest.raises(NvmlError, match="nvmlInit_v2"):
        NvmlBackend(node_name="n", lib=lib).discover()


def test_apply_real_on_an_nvml_node_grants_the_tables_cards(
        monkeypatch, tmp_path, capsys):
    """``apply --real --set backend.type=nvml``: the cluster is the node
    NVML reports (the spec's slices ignored), and each probe pod is handed
    one of the table's cards by UUID, two pods two distinct cards."""
    from kubegpu_tpu_torch import cli

    monkeypatch.setattr(nvml_mod, "load_library",
                        lambda name=None: FakeNvml(h100s(2), all_pairs(2)))
    probe = ("import json, os, sys; json.dump(dict(os.environ), "
             "open(sys.argv[1], 'w'))")
    spec = tmp_path / "probes.json"
    spec.write_text(json.dumps({
        "cluster": {"slices": ["v4-8"]},
        "pods": [{"name": f"probe{i}", "chips": 1,
                  "command": [sys.executable, "-c", probe,
                              str(tmp_path / f"env{i}.json")]}
                 for i in range(2)]}))
    rc = cli.main(["apply", "-f", str(spec), "--real", "--top",
                   "--set", "backend.type=nvml", "--timeout", "60"])
    out = capsys.readouterr().out
    assert rc == 0 and out.count(" Succeeded ") == 2
    assert "-nvlink  (h100-sxm-2, 2x1x1" in out and "v4-8" not in out
    envs = [json.loads((tmp_path / f"env{i}.json").read_text())
            for i in range(2)]
    uuids = [e["CUDA_VISIBLE_DEVICES"] for e in envs]
    assert sorted(uuids) == [c[1] for c in h100s(2)]
    assert all(e["NVIDIA_VISIBLE_DEVICES"] == e["CUDA_VISIBLE_DEVICES"]
               and e["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
               and e["TPU_VISIBLE_CHIPS"] == str(uuids.index(
                   e["CUDA_VISIBLE_DEVICES"])) for e in envs)
