"""Device topology: chips, hosts, coordinates, ICI/DCN link graph (copied
from ``kubegpu_tpu/topology/mesh.py``, with switched nodes added).

Reference parity (SURVEY.md §2 L0/L1): where the reference's
``nvidiagpuplugin`` queried the NVML P2P/NVLink link matrix and encoded it as
a grouped-resource tree, KubeTPU declares topology explicitly: a TPU slice is
a (possibly wrapped) cartesian torus of chip coordinates, partitioned into
per-host blocks.  Everything downstream (allocator, scheduler scoring,
injection env) consumes this model.

Coordinates are ``(x, y, z)`` int tuples.  2D generations (v5e) use ``z=0``.

A GPU node is a *switched* spec: its cards sit on one NVSwitch, so every
pair of cards of one host is one NVLink hop apart (``TopologySpec.switched``).
Such a node is laid out as a line ``(n, 1, 1)`` whose geometry only orders
the cards; adjacency, links and hop distance come from the switch.  A GPU
cluster is a list of such nodes, each its own slice (one NVLink domain); a
gang across nodes takes the multislice road, its crossing pairs riding the
inter-node fabric (InfiniBand) as the reference's ride DCN.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Iterator

Coord = tuple[int, int, int]


class LinkTier(enum.Enum):
    """Two-tier link model: ICI (on-slice torus links) vs DCN (ethernet)."""

    ICI = "ici"
    DCN = "dcn"


@dataclass(frozen=True)
class TopologySpec:
    """Static description of a TPU slice type.

    ``mesh_shape`` is the chip grid; ``wrap`` marks per-axis torus wraparound
    (true only when the slice spans the full pod axis for that generation —
    e.g. a full v4 cube or full v5e 16x16 pod; small sub-slices are plain
    meshes).  ``host_block`` is the shape of the per-host chip block; hosts
    tile the mesh in row-major order of their block origins.
    """

    name: str
    generation: str  # "v4" | "v5e" | "v5p"
    mesh_shape: Coord
    wrap: tuple[bool, bool, bool] = (False, False, False)
    host_block: Coord = (2, 2, 1)
    hbm_gib_per_chip: float = 16.0
    ici_gbps_per_link: float = 100.0  # per-direction per-link
    dcn_gbps_per_host: float = 25.0
    # every pair of chips of one host is one hop (an NVSwitch node);
    # False keeps the torus model of the reference
    switched: bool = False

    @property
    def num_chips(self) -> int:
        x, y, z = self.mesh_shape
        return x * y * z

    @property
    def chips_per_host(self) -> int:
        a, b, c = self.host_block
        return a * b * c

    @property
    def num_hosts(self) -> int:
        return self.num_chips // self.chips_per_host

    def __post_init__(self) -> None:
        for m, h in zip(self.mesh_shape, self.host_block):
            if m % h != 0:
                raise ValueError(
                    f"{self.name}: host_block {self.host_block} does not tile "
                    f"mesh_shape {self.mesh_shape}"
                )


@dataclass(frozen=True)
class Chip:
    """One TPU chip: global index, torus coordinate, owning host."""

    index: int
    coord: Coord
    host_id: int


@dataclass(frozen=True)
class Host:
    """One TPU host (VM): owns a contiguous block of chips."""

    host_id: int
    block_origin: Coord
    chip_indices: tuple[int, ...]


@dataclass
class TpuTopology:
    """Instantiated topology for one slice: chips + hosts + adjacency.

    The per-node advertisement payload (SURVEY.md §4.1 ``kubeadvertise``)
    serializes this; the scheduler's allocator searches it.
    """

    spec: TopologySpec
    chips: list[Chip] = field(default_factory=list)
    hosts: list[Host] = field(default_factory=list)
    _coord_to_chip: dict[Coord, Chip] = field(default_factory=dict, repr=False)

    @classmethod
    def build(cls, spec: TopologySpec) -> "TpuTopology":
        topo = cls(spec=spec)
        hx, hy, hz = spec.host_block
        mx, my, mz = spec.mesh_shape
        # Host block origins in row-major (z fastest) order: deterministic
        # host ids are load-bearing — TPU_WORKER_ID assignment derives from
        # them (SURVEY.md §8 "Worker identity wiring").
        origins = [
            (ox, oy, oz)
            for ox in range(0, mx, hx)
            for oy in range(0, my, hy)
            for oz in range(0, mz, hz)
        ]
        host_of: dict[Coord, int] = {}
        for hid, (ox, oy, oz) in enumerate(origins):
            for dx, dy, dz in itertools.product(range(hx), range(hy), range(hz)):
                host_of[(ox + dx, oy + dy, oz + dz)] = hid
        coords = [
            (x, y, z)
            for x in range(mx)
            for y in range(my)
            for z in range(mz)
        ]
        host_chips: dict[int, list[int]] = {h: [] for h in range(len(origins))}
        for idx, c in enumerate(coords):
            chip = Chip(index=idx, coord=c, host_id=host_of[c])
            topo.chips.append(chip)
            topo._coord_to_chip[c] = chip
            host_chips[chip.host_id].append(idx)
        for hid, origin in enumerate(origins):
            topo.hosts.append(
                Host(host_id=hid, block_origin=origin,
                     chip_indices=tuple(host_chips[hid]))
            )
        return topo

    # -- lookups ---------------------------------------------------------

    def chip_at(self, coord: Coord) -> Chip:
        return self._coord_to_chip[coord]

    def has_coord(self, coord: Coord) -> bool:
        return coord in self._coord_to_chip

    # -- adjacency -------------------------------------------------------

    def _same_host(self, a: Coord, b: Coord) -> bool:
        ca, cb = self._coord_to_chip.get(a), self._coord_to_chip.get(b)
        return (ca is not None and cb is not None
                and ca.host_id == cb.host_id)

    def neighbors(self, coord: Coord) -> list[Coord]:
        """ICI neighbors of ``coord`` honoring per-axis wraparound; on a
        switched spec, every other chip of its host."""
        if self.spec.switched:
            host = self.hosts[self._coord_to_chip[coord].host_id]
            return [self.chips[i].coord for i in host.chip_indices
                    if self.chips[i].coord != coord]
        out: list[Coord] = []
        for axis in range(3):
            dim = self.spec.mesh_shape[axis]
            if dim == 1:
                continue
            for delta in (-1, 1):
                n = list(coord)
                n[axis] += delta
                if 0 <= n[axis] < dim:
                    out.append((n[0], n[1], n[2]))
                elif self.spec.wrap[axis] and dim > 2:
                    n[axis] %= dim
                    out.append((n[0], n[1], n[2]))
        return out

    def are_ici_adjacent(self, a: Coord, b: Coord) -> bool:
        if self.spec.switched:
            return a != b and self._same_host(a, b)
        return b in self.neighbors(a)

    def links(self) -> Iterator[tuple[Coord, Coord, LinkTier]]:
        """Every link once (canonical a<b order), tagged with its tier.

        ICI links are torus edges; a DCN path exists between any pair of
        hosts (modeled as host-level, not chip-level — callers that need
        inter-slice bandwidth use ``spec.dcn_gbps_per_host``).
        """
        seen: set[tuple[Coord, Coord]] = set()
        for chip in self.chips:
            for n in self.neighbors(chip.coord):
                key = (min(chip.coord, n), max(chip.coord, n))
                if key not in seen:
                    seen.add(key)
                    yield key[0], key[1], LinkTier.ICI

    def hop_distance(self, a: Coord, b: Coord) -> int:
        """Torus manhattan distance honoring wraparound; on a switched
        spec, one hop between any two chips of one host."""
        if self.spec.switched and self._same_host(a, b):
            return int(a != b)
        d = 0
        for axis in range(3):
            dim = self.spec.mesh_shape[axis]
            delta = abs(a[axis] - b[axis])
            if self.spec.wrap[axis] and dim > 2:
                delta = min(delta, dim - delta)
            d += delta
        return d


# ---------------------------------------------------------------------------
# Registry of known slice types (the mock backend's coordinate tables —
# SURVEY.md §8 step 2; the reference shipped no such tables because NVML
# discovered topology at runtime, but tests need deterministic fixtures).
# ---------------------------------------------------------------------------

TOPOLOGY_REGISTRY: dict[str, TopologySpec] = {}


def register_topology(spec: TopologySpec) -> TopologySpec:
    TOPOLOGY_REGISTRY[spec.name] = spec
    return spec


def get_topology(name: str) -> TpuTopology:
    if name not in TOPOLOGY_REGISTRY:
        raise KeyError(
            f"unknown topology {name!r}; known: {sorted(TOPOLOGY_REGISTRY)}"
        )
    return TpuTopology.build(TOPOLOGY_REGISTRY[name])


# v4: 3D torus, 4 chips/host in a 2x2x1 tray. "v4-8" = 8 TensorCores =
# 4 chips on one host (BASELINE.json config 3: "4-pod DP gang on one v4-8
# host, intra-host ICI").
register_topology(TopologySpec(
    name="v4-8", generation="v4", mesh_shape=(2, 2, 1),
    host_block=(2, 2, 1), hbm_gib_per_chip=32.0, ici_gbps_per_link=100.0,
))
register_topology(TopologySpec(
    name="v4-16", generation="v4", mesh_shape=(2, 2, 2),
    host_block=(2, 2, 1), hbm_gib_per_chip=32.0,
))
# v5e: 2D mesh, 4-chip hosts (2x2 blocks); full pod is 16x16 with wrap.
register_topology(TopologySpec(
    name="v5e-8", generation="v5e", mesh_shape=(4, 2, 1),
    host_block=(2, 2, 1), hbm_gib_per_chip=16.0,
))
register_topology(TopologySpec(
    name="v5e-16", generation="v5e", mesh_shape=(4, 4, 1),
    host_block=(2, 2, 1), hbm_gib_per_chip=16.0,
))
register_topology(TopologySpec(
    name="v5e-64", generation="v5e", mesh_shape=(8, 8, 1),
    host_block=(2, 2, 1), hbm_gib_per_chip=16.0,
))
register_topology(TopologySpec(
    name="v5e-256", generation="v5e", mesh_shape=(16, 16, 1),
    wrap=(True, True, False), host_block=(2, 2, 1), hbm_gib_per_chip=16.0,
))
# v5p: 3D torus, full cube wrap at scale.
register_topology(TopologySpec(
    name="v5p-128", generation="v5p", mesh_shape=(4, 4, 4),
    host_block=(2, 2, 1), hbm_gib_per_chip=95.0, ici_gbps_per_link=150.0,
))

# H100 SXM nodes: n cards on one NVSwitch, 80 GiB of HBM3 a card.  NVIDIA's
# H100 Tensor Core GPU datasheet gives the SXM part 900 GB/s of NVLink
# bandwidth (fourth-generation NVLink, both directions together), so
# 450 GB/s a direction between any two cards of a node through the switch.
for _n in (1, 2, 4, 8):
    register_topology(TopologySpec(
        name=f"h100-sxm-{_n}", generation="h100", mesh_shape=(_n, 1, 1),
        host_block=(_n, 1, 1), hbm_gib_per_chip=80.0,
        ici_gbps_per_link=450.0, switched=True,
    ))
del _n
