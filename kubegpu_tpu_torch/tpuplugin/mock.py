"""Mock backend: deterministic coordinate tables for tests/simulation
(copied from ``kubegpu_tpu/tpuplugin/mock.py``; each chip also gets a
deterministic card UUID, and the grant the CUDA keys).

First-class citizen by design (SURVEY.md §5: the reference's NVML paths had
no automated coverage because they needed real GPUs — a gap this closes).
Ships the v4-8 / v5e-16 / v5e-64 tables BASELINE.json's configs need.
"""

from __future__ import annotations

import hashlib
import uuid

from kubegpu_tpu_torch.topology.mesh import TOPOLOGY_REGISTRY, TpuTopology
from kubegpu_tpu_torch.tpuplugin.backend import (
    MILLICHIPS_PER_CHIP,
    ChipAdvertisement,
    DeviceBackend,
    NodeAdvertisement,
)


class MockBackend(DeviceBackend):
    """Pretends to be host ``host_id`` of a ``slice_type`` slice.

    Carries mutable fault state (bad chips / bad incident ICI links) so
    tests and the SimCluster can inject faults mid-run and the advertiser
    re-enumeration picks them up — the fault-injection hooks SURVEY.md §6
    calls for (kill a chip, flap a link) driving recovery tests.
    """

    def __init__(self, slice_type: str, host_id: int = 0,
                 slice_id: str | None = None, node_name: str | None = None,
                 unhealthy_chips: set[int] | None = None):
        if slice_type not in TOPOLOGY_REGISTRY:
            raise KeyError(f"unknown slice type {slice_type!r}")
        self.spec = TOPOLOGY_REGISTRY[slice_type]
        if not 0 <= host_id < self.spec.num_hosts:
            raise ValueError(
                f"host_id {host_id} out of range for {slice_type} "
                f"({self.spec.num_hosts} hosts)")
        self.slice_type = slice_type
        self.host_id = host_id
        self.slice_id = slice_id or f"{slice_type}-slice-0"
        self.node_name = node_name or f"{self.slice_id}-host-{host_id}"
        self.unhealthy_chips: set[int] = set(unhealthy_chips or set())
        self.bad_links: set[tuple] = set()   # normalized coord pairs
        self.topo = TpuTopology.build(self.spec)

    # -- fault injection (mutable health state) -------------------------

    def _local_coords(self) -> set:
        host = self.topo.hosts[self.host_id]
        return {self.topo.chips[i].coord for i in host.chip_indices}

    def fail_chip(self, local_index: int) -> None:
        if not 0 <= local_index < self.spec.chips_per_host:
            raise ValueError(f"no local chip {local_index}")
        self.unhealthy_chips.add(local_index)

    def heal_chip(self, local_index: int) -> None:
        self.unhealthy_chips.discard(local_index)

    def fail_link(self, a, b) -> bool:
        """Mark the ICI link a↔b bad if one endpoint is local; returns
        whether this host owns (and therefore advertises) the link."""
        a, b = tuple(a), tuple(b)
        if not self.topo.are_ici_adjacent(a, b):
            raise ValueError(f"{a}–{b} is not an ICI link")
        if not ({a, b} & self._local_coords()):
            return False
        self.bad_links.add((min(a, b), max(a, b)))
        return True

    def heal_link(self, a, b) -> None:
        a, b = tuple(a), tuple(b)
        self.bad_links.discard((min(a, b), max(a, b)))

    def discover(self) -> NodeAdvertisement:
        topo = self.topo
        host = topo.hosts[self.host_id]
        chips = tuple(
            ChipAdvertisement(
                coord=topo.chips[idx].coord,
                local_index=li,
                millichips=MILLICHIPS_PER_CHIP,
                hbm_gib=self.spec.hbm_gib_per_chip,
                healthy=li not in self.unhealthy_chips,
                uuid=mock_uuid(self.slice_id, self.host_id, li),
            )
            for li, idx in enumerate(host.chip_indices)
        )
        return NodeAdvertisement(
            node_name=self.node_name,
            slice_id=self.slice_id,
            slice_type=self.slice_type,
            host_id=self.host_id,
            mesh_shape=self.spec.mesh_shape,
            wrap=self.spec.wrap,
            host_block=self.spec.host_block,
            chips=chips,
            bad_links=tuple(sorted(self.bad_links)),
            switched=self.spec.switched,
        )

    def allocate_env(self, chips, worker_id, num_workers,
                     coordinator_address, worker_hostnames):
        return build_gpu_env(self.spec.host_block, chips, worker_id,
                             num_workers, coordinator_address,
                             worker_hostnames)


def mock_uuid(slice_id: str, host_id: int, local_index: int) -> str:
    """A card UUID in NVML's form (``GPU-`` and a UUID), made from the
    slice, the host and the card's local index."""
    digest = hashlib.sha256(
        f"{slice_id}/{host_id}/{local_index}".encode()).digest()
    return f"GPU-{uuid.UUID(bytes=digest[:16])}"


def build_tpu_env(host_block, chips, worker_id, num_workers,
                  coordinator_address, worker_hostnames) -> dict[str, str]:
    """The injection payload — reference parity: the crishim's env rewrite
    set ``NVIDIA_VISIBLE_DEVICES=<uuids>`` (SURVEY.md §4.3); the TPU
    translation sets chip visibility + worker identity + the coordinator
    bootstrap ``jax.distributed.initialize`` consumes.
    """
    hb = host_block
    return {
        "TPU_VISIBLE_CHIPS": ",".join(str(c.local_index) for c in chips),
        "TPU_WORKER_ID": str(worker_id),
        "TPU_WORKER_HOSTNAMES": ",".join(worker_hostnames),
        "TPU_CHIPS_PER_HOST_BOUNDS": f"{hb[0]},{hb[1]},{hb[2]}",
        "JAX_COORDINATOR_ADDRESS": coordinator_address,
        "JAX_NUM_PROCESSES": str(num_workers),
        "JAX_PROCESS_ID": str(worker_id),
    }


def build_gpu_env(host_block, chips, worker_id, num_workers,
                  coordinator_address, worker_hostnames) -> dict[str, str]:
    """:func:`build_tpu_env`'s keys and the granted cards by UUID: KubeGPU's
    crishim injected ``NVIDIA_VISIBLE_DEVICES=<uuids>``; the CUDA runtime
    reads ``CUDA_VISIBLE_DEVICES``.  UUIDs name the cards whatever order
    NVML (PCI) and CUDA (fastest first) number them in, and whatever a
    parent process set; ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` makes the child's
    indices follow NVML's all the same."""
    uuids = ",".join(c.uuid for c in chips)
    return {**build_tpu_env(host_block, chips, worker_id, num_workers,
                            coordinator_address, worker_hostnames),
            "CUDA_VISIBLE_DEVICES": uuids,
            "NVIDIA_VISIBLE_DEVICES": uuids,
            "CUDA_DEVICE_ORDER": "PCI_BUS_ID"}


def mock_cluster(slice_types: list[str]) -> list[MockBackend]:
    """One backend per host for a cluster of slices.

    ``mock_cluster(["v5e-16", "v4-8"])`` → 4 + 1 = 5 node backends, each
    slice getting a distinct ``slice_id``.
    """
    backends: list[MockBackend] = []
    for i, st in enumerate(slice_types):
        spec = TOPOLOGY_REGISTRY[st]
        slice_id = f"{st}-slice-{i}"
        for hid in range(spec.num_hosts):
            backends.append(MockBackend(st, host_id=hid, slice_id=slice_id))
    return backends
