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

    def __init__(self, cards, nvlinked=None, fail=None):
        self.cards = cards       # [(name, uuid, memory bytes, bus id)]
        self.nvlinked = nvlinked if nvlinked is not None else set()
        self.fail = fail or {}   # entry point -> return code
        self.inits = self.shutdowns = 0

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
    assert (lib.inits, lib.shutdowns) == (1, 1)
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
    assert lib.inits == lib.shutdowns == 1


def test_every_card_advertises_healthy():
    adv = NvmlBackend(node_name="n", lib=FakeNvml(h100s(2), all_pairs(2))) \
        .discover()
    assert all(c.healthy for c in adv.chips) and adv.bad_links == ()


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
