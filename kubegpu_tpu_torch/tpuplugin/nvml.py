"""Real-hardware backend: enumerate this node's NVIDIA cards through NVML
(the port's counterpart of ``kubegpu_tpu/tpuplugin/libtpu.py``, and of
KubeGPU's ``nvidiagpuplugin``).

``libnvidia-ml.so.1`` is loaded with ``ctypes`` (there is no ``pynvml``).
The calls, their constants and the layouts of ``nvmlMemory_t``,
``nvmlPciInfo_t`` and ``nvmlEventData_t`` are those of the CUDA 12.9
toolkit's ``nvml.h``:

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
  &status)``, ``NVML_P2P_STATUS_OK = 0``;
- health: ``nvmlDeviceGetRemappedRows(dev, &corrRows, &uncRows,
  &isPending, &failureOccurred)`` (four unsigned ints);
  ``nvmlEventSetCreate(&set)``, ``nvmlDeviceRegisterEvents(dev,
  nvmlEventTypeXidCriticalError = 0x8, set)``, ``nvmlEventSetWait_v2(set,
  &data, timeoutms)`` (``NVML_ERROR_TIMEOUT`` = 10 when no event is
  pending) into ``nvmlEventData_t`` (``device``, ``eventType``,
  ``eventData``: the XID, ``gpuInstanceId``, ``computeInstanceId``) and
  ``nvmlEventSetFree``.

``NVML_ERROR_NOT_SUPPORTED`` (3) leaves a fact unknown and the card as it
was: from the PCI query the bus id (a virtualized card may not expose it),
from the P2P query the pair counts as not NVLinked, from the remapped-rows
query or the event registration that health fact; any other failure raises.

Discovery advertises only the cards that this process's
``CUDA_VISIBLE_DEVICES`` admits, whether it lists indices (taken in PCI
order, as under ``CUDA_DEVICE_ORDER=PCI_BUS_ID``) or UUIDs (or unique UUID
prefixes); as in the CUDA runtime, the list ends at its first entry that
names no card.  When every pair of the admitted cards is NVLinked at the
first discovery (one card trivially is) and they are H100s of a registered
count, the node is one ``h100-sxm-<n>`` slice (switched: every pair one
hop); otherwise a local ``local-<n>card`` line of the cards in PCI order, as
``LibtpuBackend._discover_local`` normalizes a standalone host.  There is
no fallback: a missing library, a failed call or no admitted card raises.

Health, read at every discovery (the reference's ``health_check`` hook and
fault hooks, ``LibtpuBackend``): a card is unhealthy when NVML reports a
row-remapping failure or a remapping pending a reset, after a critical XID
other than the application-level ones (:data:`APPLICATION_XIDS`, which
NVIDIA's Kubernetes device plugin also skips) until :meth:`heal_chip`, when
a node-local monitor marked it (:meth:`mark_chip_unhealthy`) or when the
optional ``health_check(local_index, handle)`` says so.  A pair that was
NVLinked and is not now is advertised as a bad link until it is back or
:meth:`heal_link` accepts it.  The XID event set is created once, with the
NVML reference it needs, read without waiting at each discovery and freed
by :meth:`close`.
"""

from __future__ import annotations

import ctypes
import os
import socket

from kubegpu_tpu_torch.topology.mesh import (
    TOPOLOGY_REGISTRY,
    TopologySpec,
    TpuTopology,
)
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
NVML_ERROR_TIMEOUT = 10
NVML_DEVICE_NAME_V2_BUFFER_SIZE = 96
NVML_DEVICE_UUID_V2_BUFFER_SIZE = 96
NVML_DEVICE_PCI_BUS_ID_BUFFER_SIZE = 32
NVML_DEVICE_PCI_BUS_ID_BUFFER_V2_SIZE = 16
NVML_P2P_CAPS_INDEX_NVLINK = 2
NVML_P2P_STATUS_OK = 0
NVML_EVENT_TYPE_XID_CRITICAL_ERROR = 0x8    # nvmlEventTypeXidCriticalError
# XIDs an application causes (graphics engine exception, MMU fault, reset
# channel, preemptive cleanup, video decoder exception, context switch
# timeout): they leave the card healthy, as NVIDIA/k8s-device-plugin's
# internal/rm/health.go skips them
APPLICATION_XIDS = frozenset({13, 31, 43, 45, 68, 109})


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


class NvmlEventData(ctypes.Structure):
    _fields_ = [("device", ctypes.c_void_p),
                ("eventType", ctypes.c_ulonglong),
                ("eventData", ctypes.c_ulonglong),
                ("gpuInstanceId", ctypes.c_uint),
                ("computeInstanceId", ctypes.c_uint)]


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


def _pair(a, b) -> tuple:
    a, b = tuple(a), tuple(b)
    return (min(a, b), max(a, b))


class NvmlBackend(DeviceBackend):
    """Discover this node's NVIDIA cards and their health through NVML."""

    def __init__(self, slice_id: str | None = None,
                 node_name: str | None = None, lib=None,
                 health_check=None):
        self.node_name = node_name or os.environ.get(
            "HOSTNAME") or socket.gethostname()
        # every node is its own NVLink domain, so its own slice
        self.slice_id = slice_id or os.environ.get(
            "KUBETPU_SLICE_ID", f"{self.node_name}-nvlink")
        self.lib = lib if lib is not None else load_library()
        # health_check(local_index, nvml handle) -> bool, beside NVML's
        # own reads; None adds nothing
        self.health_check = health_check
        self.unhealthy_chips: set[int] = set()   # marked by a monitor
        self._reported: set[tuple] = set()   # links reported bad
        self._lost: set[tuple] = set()   # pairs NVML lost, last discovery
        self.xids: dict[str, int] = {}   # card uuid -> critical XID seen
        self._events: ctypes.c_void_p | None = None   # the XID event set
        self._watched: dict[int, str] = {}   # handle value -> card uuid
        self._linked: set[frozenset] = set()   # uuid pairs NVLinked once
        self._spec: TopologySpec | None = None   # the first discovery's
        self._uuids: list[str] = []   # the last discovery's, local order
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
            raise self._error(fn, rc)
        return True

    def _error(self, fn: str, rc: int) -> NvmlError:
        msg = self.lib.nvmlErrorString(rc)
        return NvmlError(f"NvmlBackend: {fn} returned {rc} "
                         f"({msg.decode() if msg else '?'})")

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

    def _remapped_rows(self, card: dict) -> dict | None:
        """NVML's row-remapping counters of ``card``; None where the card
        does not report them."""
        rows = [ctypes.c_uint(0) for _ in range(4)]
        if not self._call("nvmlDeviceGetRemappedRows", card["handle"],
                          *map(ctypes.byref, rows), unsupported_ok=True):
            return None
        return dict(zip(("corrected", "uncorrected", "pending", "failure"),
                        (r.value for r in rows)))

    def _watch_xids(self, cards: list[dict]) -> None:
        """Create the XID event set (once) and register each card on it
        (a card whose NVML does not support it stays unwatched).  The set
        holds its own NVML reference until :meth:`close`."""
        events = ctypes.c_void_p()
        if not self._call("nvmlEventSetCreate", ctypes.byref(events),
                          unsupported_ok=True):
            self._events = ctypes.c_void_p()      # unsupported: no set
            return
        self._call("nvmlInit_v2")
        self._events = events
        for c in cards:
            if self._call("nvmlDeviceRegisterEvents", c["handle"],
                          ctypes.c_ulonglong(
                              NVML_EVENT_TYPE_XID_CRITICAL_ERROR),
                          events, unsupported_ok=True):
                self._watched[c["handle"].value] = c["uuid"]

    def _read_xids(self) -> None:
        """Drain the event set without waiting: each critical XID but the
        application-level ones marks its card until :meth:`heal_chip`."""
        if not self._events:
            return
        data = NvmlEventData()
        while True:
            rc = self.lib.nvmlEventSetWait_v2(self._events,
                                              ctypes.byref(data),
                                              ctypes.c_uint(0))
            if rc == NVML_ERROR_TIMEOUT:
                return
            if rc != NVML_SUCCESS:
                raise self._error("nvmlEventSetWait_v2", rc)
            uuid = self._watched.get(data.device)
            if (uuid is not None and data.eventType
                    & NVML_EVENT_TYPE_XID_CRITICAL_ERROR
                    and data.eventData not in APPLICATION_XIDS):
                self.xids[uuid] = int(data.eventData)

    def cards(self) -> tuple[list[dict], list[tuple[int, int]]]:
        """(admitted cards in local order, their NVLinked pairs by local
        index).  A card is ``{index, name, uuid, memory_bytes,
        pci_bus_id, remapped_rows, xid_watched, xid, healthy}``, ``index``
        being NVML's (``pci_bus_id`` and ``remapped_rows`` None where NVML
        does not report them, ``xid`` the critical XID that marks the card,
        else None)."""
        self._call("nvmlInit_v2")
        try:
            count = ctypes.c_uint(0)
            self._call("nvmlDeviceGetCount_v2", ctypes.byref(count))
            cards = admitted([self._card(i) for i in range(count.value)],
                             os.environ.get("CUDA_VISIBLE_DEVICES"))
            pairs = [(i, j) for i in range(len(cards))
                     for j in range(i + 1, len(cards))
                     if self._nvlinked(cards[i], cards[j])]
            if self._events is None:
                self._watch_xids(cards)
            self._read_xids()
            for li, c in enumerate(cards):
                c["remapped_rows"] = rows = self._remapped_rows(c)
                c["xid_watched"] = c["handle"].value in self._watched
                c["xid"] = self.xids.get(c["uuid"])
                c["healthy"] = (
                    li not in self.unhealthy_chips and c["xid"] is None
                    and not (rows and (rows["failure"] or rows["pending"]))
                    and (self.health_check is None
                         or bool(self.health_check(li, c["handle"]))))
        finally:
            self.lib.nvmlShutdown()
        for c in cards:
            del c["handle"]
        return cards, pairs

    def close(self) -> None:
        """Free the XID event set and its NVML reference."""
        if self._events:
            self.lib.nvmlEventSetFree(self._events)
            self.lib.nvmlShutdown()
        self._events = None
        self._watched.clear()

    # -- fault hooks (node-local monitors feed these; the advertiser's
    #    next tick picks them up), and the mock's injection calls ---------

    def mark_chip_unhealthy(self, local_index: int) -> None:
        self.unhealthy_chips.add(local_index)

    def heal_chip(self, local_index: int) -> None:
        """Clear a monitor's mark and the card's critical XID."""
        self.unhealthy_chips.discard(local_index)
        if 0 <= local_index < len(self._uuids):
            self.xids.pop(self._uuids[local_index], None)

    @property
    def bad_links(self) -> set[tuple]:
        """The links reported bad and the NVLink pairs the last discovery
        found lost, as normalized coord pairs."""
        return self._reported | self._lost

    def report_bad_link(self, a, b) -> None:
        self._reported.add(_pair(a, b))

    def heal_link(self, a, b) -> None:
        """Clear a reported link, and accept a pair NVML lost: it counts
        as lost again only after NVML reports it NVLinked once more."""
        pair = _pair(a, b)
        self._reported.discard(pair)
        self._lost.discard(pair)
        ids = [self._uuids[c[0]] for c in pair if c[0] < len(self._uuids)]
        self._linked.discard(frozenset(ids))

    def fail_chip(self, local_index: int) -> None:
        if not 0 <= local_index < len(self._uuids):
            raise ValueError(f"no local card {local_index}")
        self.mark_chip_unhealthy(local_index)

    def fail_link(self, a, b) -> bool:
        """Mark the NVLink pair a–b bad (every card of a node is local, so
        the node always owns it)."""
        a, b = tuple(a), tuple(b)
        if not self.topo.are_ici_adjacent(a, b):
            raise ValueError(f"{a}–{b} is not an NVLink pair")
        self.report_bad_link(a, b)
        return True

    @property
    def topo(self) -> TpuTopology:
        """The topology of the last advertisement's slice."""
        if self._spec is None:
            self.discover()
        return TpuTopology.build(self._spec)

    # -- discovery -------------------------------------------------------

    def discover(self) -> NodeAdvertisement:
        cards, pairs = self.cards()
        n = len(cards)
        if not n:
            raise NvmlError("NvmlBackend: no NVIDIA card visible (NVML "
                            "found none, or CUDA_VISIBLE_DEVICES admits none)")
        uuids = [c["uuid"] for c in cards]
        now = {frozenset((uuids[i], uuids[j])) for i, j in pairs}
        if self._spec is None or uuids != self._uuids:
            # the slice is what the first discovery of these cards finds
            name = f"h100-sxm-{n}"
            registered = (len(pairs) == n * (n - 1) // 2
                          and name in TOPOLOGY_REGISTRY
                          and all("H100" in c["name"] for c in cards))
            self._spec = (TOPOLOGY_REGISTRY[name] if registered else
                          TopologySpec(name=f"local-{n}card",
                                       generation="local",
                                       mesh_shape=(n, 1, 1),
                                       host_block=(n, 1, 1)))
            self._linked = set()
        self._uuids = uuids
        lost = self._linked - now
        self._linked |= now
        coord = {u: (li, 0, 0) for li, u in enumerate(uuids)}
        self._lost = {_pair(*(coord[u] for u in p)) for p in lost}
        local = set(coord.values())
        links = {p for p in self.bad_links if local & set(p)}
        chips = tuple(ChipAdvertisement(
            coord=(li, 0, 0), local_index=li, millichips=MILLICHIPS_PER_CHIP,
            hbm_gib=card["memory_bytes"] / (1 << 30), uuid=card["uuid"],
            healthy=card["healthy"])
            for li, card in enumerate(cards))
        self._host_block = (n, 1, 1)
        return NodeAdvertisement(
            node_name=self.node_name,
            slice_id=self.slice_id,
            slice_type=self._spec.name,
            host_id=0,
            mesh_shape=(n, 1, 1),
            wrap=(False, False, False),
            host_block=self._host_block,
            chips=chips,
            bad_links=tuple(sorted(links)),
            switched=self._spec.switched,
        )

    def allocate_env(self, chips, worker_id, num_workers,
                     coordinator_address, worker_hostnames):
        """The grant's env, against the last advertisement (the node agent
        discovers before it allocates; NVML is asked again only where
        nothing was discovered yet)."""
        host_block = self._host_block or self.discover().host_block
        return build_gpu_env(host_block, chips, worker_id, num_workers,
                             coordinator_address, worker_hostnames)
