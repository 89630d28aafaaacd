"""Real-hardware backend: enumerate this node's NVIDIA cards through NVML
(the port's counterpart of ``kubegpu_tpu/tpuplugin/libtpu.py``, and of
KubeGPU's ``nvidiagpuplugin``).

``libnvidia-ml.so.1`` is loaded with ``ctypes`` (there is no ``pynvml``).
The calls, their constants and the layouts of ``nvmlMemory_t`` and
``nvmlPciInfo_t`` are those of the CUDA 12.9 toolkit's ``nvml.h``:

- ``nvmlInit_v2``, ``nvmlShutdown``, ``nvmlErrorString``;
- ``nvmlDeviceGetCount_v2``, ``nvmlDeviceGetHandleByIndex_v2`` (indices in
  PCI bus order);
- ``nvmlDeviceGetName`` and ``nvmlDeviceGetUUID`` into buffers of
  ``NVML_DEVICE_NAME_V2_BUFFER_SIZE`` / ``NVML_DEVICE_UUID_V2_BUFFER_SIZE``
  (96) bytes;
- ``nvmlDeviceGetMemoryInfo`` (``total``, ``free``, ``used``: unsigned long
  long) and ``nvmlDeviceGetPciInfo_v3`` (``busIdLegacy[16]``, five unsigned
  ints, ``busId[32]``);
- ``nvmlDeviceGetP2PStatus(dev1, dev2, NVML_P2P_CAPS_INDEX_NVLINK = 2,
  &status)``, ``NVML_P2P_STATUS_OK = 0``.

``NVML_ERROR_NOT_SUPPORTED`` (3) from the PCI query leaves a card's bus id
unknown (a virtualized card may not expose it), and from the P2P query
counts the pair as not NVLinked; any other failure raises.

Discovery advertises only the cards that this process's
``CUDA_VISIBLE_DEVICES`` admits, whether it lists indices (taken in PCI
order, as under ``CUDA_DEVICE_ORDER=PCI_BUS_ID``) or UUIDs (or unique UUID
prefixes); as in the CUDA runtime, the list ends at its first entry that
names no card.  When every pair of the admitted cards is NVLinked (one card
trivially is) and they are H100s of a registered count, the node is one
``h100-sxm-<n>`` slice (switched: every pair one hop); otherwise a local
``local-<n>card`` line of the cards in PCI order, as
``LibtpuBackend._discover_local`` normalizes a standalone host.  There is
no fallback: a missing library, a failed call or no admitted card raises.
Health (XID errors, NVLink state) is not read yet: every card advertises
healthy (ROADMAP item 10c).
"""

from __future__ import annotations

import ctypes
import os
import socket

from kubegpu_tpu_torch.topology.mesh import TOPOLOGY_REGISTRY
from kubegpu_tpu_torch.tpuplugin.backend import (
    MILLICHIPS_PER_CHIP,
    ChipAdvertisement,
    DeviceBackend,
    NodeAdvertisement,
)
from kubegpu_tpu_torch.tpuplugin.mock import build_gpu_env

LIBRARY = "libnvidia-ml.so.1"
NVML_SUCCESS = 0
NVML_ERROR_NOT_SUPPORTED = 3
NVML_DEVICE_NAME_V2_BUFFER_SIZE = 96
NVML_DEVICE_UUID_V2_BUFFER_SIZE = 96
NVML_DEVICE_PCI_BUS_ID_BUFFER_SIZE = 32
NVML_DEVICE_PCI_BUS_ID_BUFFER_V2_SIZE = 16
NVML_P2P_CAPS_INDEX_NVLINK = 2
NVML_P2P_STATUS_OK = 0


class NvmlMemory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong),
                ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class NvmlPciInfo(ctypes.Structure):
    _fields_ = [("busIdLegacy",
                 ctypes.c_char * NVML_DEVICE_PCI_BUS_ID_BUFFER_V2_SIZE),
                ("domain", ctypes.c_uint),
                ("bus", ctypes.c_uint),
                ("device", ctypes.c_uint),
                ("pciDeviceId", ctypes.c_uint),
                ("pciSubSystemId", ctypes.c_uint),
                ("busId", ctypes.c_char * NVML_DEVICE_PCI_BUS_ID_BUFFER_SIZE)]


class NvmlError(RuntimeError):
    pass


def load_library(name: str | None = None):
    """``ctypes.CDLL`` of NVML (:data:`LIBRARY` by default); raises
    :class:`NvmlError` where it is missing (no mock stands in)."""
    name = name or LIBRARY
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise NvmlError(f"NvmlBackend: cannot load {name} ({e}); NVML "
                        "is not installed on this node") from e
    lib.nvmlErrorString.restype = ctypes.c_char_p
    return lib


def admitted(cards: list[dict], visible: str | None) -> list[dict]:
    """The cards a ``CUDA_VISIBLE_DEVICES`` value admits, in its order:
    all of them when it is unset; indices or UUIDs (a unique prefix
    suffices), the list ending at the first entry that names no card."""
    if visible is None:
        return list(cards)
    out: list[dict] = []
    for entry in (e.strip() for e in visible.split(",")):
        if entry.isdigit():
            k = int(entry)
            hit = cards[k] if k < len(cards) else None
        else:
            match = [c for c in cards if c["uuid"].startswith(entry)] \
                if entry.startswith("GPU-") else []
            hit = match[0] if len(match) == 1 else None
        if hit is None or hit in out:
            break
        out.append(hit)
    return out


class NvmlBackend(DeviceBackend):
    """Discover this node's NVIDIA cards through NVML."""

    def __init__(self, slice_id: str | None = None,
                 node_name: str | None = None, lib=None):
        self.node_name = node_name or os.environ.get(
            "HOSTNAME") or socket.gethostname()
        # every node is its own NVLink domain, so its own slice
        self.slice_id = slice_id or os.environ.get(
            "KUBETPU_SLICE_ID", f"{self.node_name}-nvlink")
        self.lib = lib if lib is not None else load_library()
        # the last advertisement's host block, which a grant's env names
        self._host_block: tuple[int, int, int] | None = None

    # -- NVML ------------------------------------------------------------

    def _call(self, fn: str, *args, unsupported_ok: bool = False) -> bool:
        """Call ``fn``; False where it is not supported and that is
        allowed, True on success, and raise otherwise."""
        rc = getattr(self.lib, fn)(*args)
        if rc == NVML_ERROR_NOT_SUPPORTED and unsupported_ok:
            return False
        if rc != NVML_SUCCESS:
            msg = self.lib.nvmlErrorString(rc)
            raise NvmlError(f"NvmlBackend: {fn} returned {rc} "
                            f"({msg.decode() if msg else '?'})")
        return True

    def _card(self, index: int) -> dict:
        handle = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", ctypes.c_uint(index),
                   ctypes.byref(handle))
        name = ctypes.create_string_buffer(NVML_DEVICE_NAME_V2_BUFFER_SIZE)
        self._call("nvmlDeviceGetName", handle, name,
                   ctypes.c_uint(len(name)))
        uuid = ctypes.create_string_buffer(NVML_DEVICE_UUID_V2_BUFFER_SIZE)
        self._call("nvmlDeviceGetUUID", handle, uuid,
                   ctypes.c_uint(len(uuid)))
        mem = NvmlMemory()
        self._call("nvmlDeviceGetMemoryInfo", handle, ctypes.byref(mem))
        pci = NvmlPciInfo()
        known = self._call("nvmlDeviceGetPciInfo_v3", handle,
                           ctypes.byref(pci), unsupported_ok=True)
        return {"index": index, "handle": handle,
                "name": name.value.decode(), "uuid": uuid.value.decode(),
                "memory_bytes": mem.total,
                "pci_bus_id": pci.busId.decode() if known else None}

    def _nvlinked(self, a: dict, b: dict) -> bool:
        status = ctypes.c_int(-1)
        return self._call("nvmlDeviceGetP2PStatus", a["handle"],
                          b["handle"], ctypes.c_int(NVML_P2P_CAPS_INDEX_NVLINK),
                          ctypes.byref(status), unsupported_ok=True) \
            and status.value == NVML_P2P_STATUS_OK

    def cards(self) -> tuple[list[dict], list[tuple[int, int]]]:
        """(admitted cards in local order, their NVLinked pairs by local
        index).  A card is ``{index, name, uuid, memory_bytes,
        pci_bus_id}``, ``index`` being NVML's (``pci_bus_id`` None where
        NVML does not report it)."""
        self._call("nvmlInit_v2")
        try:
            count = ctypes.c_uint(0)
            self._call("nvmlDeviceGetCount_v2", ctypes.byref(count))
            cards = admitted([self._card(i) for i in range(count.value)],
                             os.environ.get("CUDA_VISIBLE_DEVICES"))
            pairs = [(i, j) for i in range(len(cards))
                     for j in range(i + 1, len(cards))
                     if self._nvlinked(cards[i], cards[j])]
        finally:
            self.lib.nvmlShutdown()
        for c in cards:
            del c["handle"]
        return cards, pairs

    # -- discovery -------------------------------------------------------

    def discover(self) -> NodeAdvertisement:
        cards, pairs = self.cards()
        n = len(cards)
        if not n:
            raise NvmlError("NvmlBackend: no NVIDIA card visible (NVML "
                            "found none, or CUDA_VISIBLE_DEVICES admits none)")
        all_linked = len(pairs) == n * (n - 1) // 2
        name = f"h100-sxm-{n}"
        spec = (TOPOLOGY_REGISTRY[name] if all_linked
                and name in TOPOLOGY_REGISTRY
                and all("H100" in c["name"] for c in cards) else None)
        chips = tuple(ChipAdvertisement(
            coord=(li, 0, 0), local_index=li, millichips=MILLICHIPS_PER_CHIP,
            hbm_gib=card["memory_bytes"] / (1 << 30), uuid=card["uuid"])
            for li, card in enumerate(cards))
        self._host_block = (n, 1, 1)
        return NodeAdvertisement(
            node_name=self.node_name,
            slice_id=self.slice_id,
            slice_type=spec.name if spec else f"local-{n}card",
            host_id=0,
            mesh_shape=(n, 1, 1),
            wrap=(False, False, False),
            host_block=self._host_block,
            chips=chips,
            switched=spec is not None,
        )

    def allocate_env(self, chips, worker_id, num_workers,
                     coordinator_address, worker_hostnames):
        """The grant's env, against the last advertisement (the node agent
        discovers before it allocates; NVML is asked again only where
        nothing was discovered yet)."""
        host_block = self._host_block or self.discover().host_block
        return build_gpu_env(host_block, chips, worker_id, num_workers,
                             coordinator_address, worker_hostnames)
