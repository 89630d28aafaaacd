"""Backend interface + advertisement payload types (copied from
``kubegpu_tpu/tpuplugin/backend.py``; the port adds a card's UUID and the
switched flag of an NVSwitch node).

Reference parity: ``types.DeviceManager`` (SURVEY.md §3 "Core types") —
``Start / Capacity / AllocateDevices``.  The advertisement payload here is
what the node advertiser patches onto the Node object (SURVEY.md §4.1),
replacing the reference's ``gpugrp`` hierarchical ResourceList with explicit
mesh metadata.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

from kubegpu_tpu_torch.topology.mesh import Coord

# A whole chip is 1000 millichips; fractional-chip co-tenancy (BASELINE
# config 5) bin-packs against this per-chip capacity vector (SURVEY.md §8
# "Fractional chips").
MILLICHIPS_PER_CHIP = 1000


@dataclass(frozen=True)
class ChipAdvertisement:
    """One local chip: its global mesh coordinate and capacity."""

    coord: Coord
    local_index: int  # index on this host (0..chips_per_host-1)
    millichips: int = MILLICHIPS_PER_CHIP
    hbm_gib: float = 16.0
    healthy: bool = True
    # the card's NVML UUID (``GPU-...``), the name the grant injects;
    # "" where the backend has none
    uuid: str = ""


@dataclass(frozen=True)
class NodeAdvertisement:
    """What one node (TPU host VM) advertises to the control plane.

    A multi-host slice is represented by N nodes sharing ``slice_id``; the
    scheduler reassembles the full mesh from their chips.  ``host_id`` is
    the host's deterministic rank within the slice — the source of
    TPU_WORKER_ID ordering (SURVEY.md §8 "Worker identity wiring").
    """

    node_name: str
    slice_id: str
    slice_type: str           # registry key, e.g. "v5e-16"
    host_id: int
    mesh_shape: Coord
    wrap: tuple[bool, bool, bool]
    host_block: Coord
    chips: tuple[ChipAdvertisement, ...] = field(default_factory=tuple)
    internal_ip: str = "127.0.0.1"
    # Failed ICI links incident to this host's chips, as normalized
    # (min(a,b), max(a,b)) coord pairs.  Both endpoints' hosts advertise a
    # shared link; the scheduler unions them per slice (SURVEY.md §6
    # failure-detection row: a bad link makes ring placements across it
    # score low and marks gangs straddling it for recovery).
    bad_links: tuple[tuple[Coord, Coord], ...] = field(default_factory=tuple)
    # every pair of this host's chips is one hop (an NVSwitch node);
    # the scheduler's slice spec carries it (``TopologySpec.switched``)
    switched: bool = False

    @property
    def num_chips(self) -> int:
        return len(self.chips)


class DeviceBackend(abc.ABC):
    """Vendor seam — the reference loaded this as ``nvidiagpuplugin.so``."""

    @abc.abstractmethod
    def discover(self) -> NodeAdvertisement:
        """Enumerate this host's chips + mesh position (NVML-equivalent)."""

    @abc.abstractmethod
    def allocate_env(
        self,
        chips: list[ChipAdvertisement],
        worker_id: int,
        num_workers: int,
        coordinator_address: str,
        worker_hostnames: list[str],
    ) -> dict[str, str]:
        """Environment to inject for a container granted ``chips``.

        The reference's keys (``TPU_VISIBLE_CHIPS``, ``TPU_WORKER_ID``,
        the coordinator bootstrap), which the port's programs read, and
        the cards by UUID: ``CUDA_VISIBLE_DEVICES`` and KubeGPU's
        ``NVIDIA_VISIBLE_DEVICES``, with ``CUDA_DEVICE_ORDER=PCI_BUS_ID``.
        """
