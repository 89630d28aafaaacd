"""Slice algebra: enumerate contiguous sub-tori and find free placements.

This is the TPU-native analogue of the reference's grouped-resource-tree
matching (SURVEY.md §3 ``grpalloc.PodFitsGroupConstraints``): where the
reference searched a hierarchy for a feasible group assignment, KubeTPU
searches the torus for a free contiguous sub-slice of the requested shape.
The reference also runs this search in a C++ core
(``kubegpu_tpu/allocator/csrc``); the port runs the Python paths only, which
the reference's tests hold equal to the core (ROADMAP: the native core).
"""

from __future__ import annotations

from dataclasses import dataclass

from kubegpu_tpu_torch.topology.mesh import Coord, TpuTopology


@dataclass(frozen=True)
class Placement:
    """A concrete contiguous sub-slice: origin + shape → set of coords.

    ``coords`` are in row-major order of the *local* offset (z fastest),
    which downstream code relies on for deterministic worker ordering.
    """

    origin: Coord
    shape: Coord
    coords: tuple[Coord, ...]

    @property
    def num_chips(self) -> int:
        # len(coords), not the shape product: connected-set (non-
        # rectangular) placements carry a degenerate shape.
        return len(self.coords)


def subslice_shapes(n: int, mesh_shape: Coord) -> list[Coord]:
    """All (a,b,c) factorizations of ``n`` that fit inside ``mesh_shape``.

    Ordered best-first for ICI locality: prefer compact (near-cubical /
    near-square) shapes over skinny ones, since compact sub-tori minimize
    the surface area collectives must cross.  Mirrors how TPU pod
    allocators enumerate candidate slice shapes.
    """
    mx, my, mz = mesh_shape
    shapes: list[Coord] = []
    for a in range(1, min(n, mx) + 1):
        if n % a:
            continue
        rest = n // a
        for b in range(1, min(rest, my) + 1):
            if rest % b:
                continue
            c = rest // b
            if c <= mz:
                shapes.append((a, b, c))
    # Compactness = low max-dimension, then low surface-to-volume.
    def badness(s: Coord) -> tuple:
        a, b, c = s
        surface = a * b + b * c + a * c
        return (max(s), surface, s)
    return sorted(shapes, key=badness)


def _axis_origins(dim: int, size: int, wrap: bool) -> range:
    if wrap and dim > 2 and size < dim:
        return range(dim)  # wrapped placements are legal on a torus axis
    return range(dim - size + 1)


def enumerate_placements(topo: TpuTopology, shape: Coord) -> list[Placement]:
    """Every contiguous placement of ``shape`` within the topology.

    On wrapped axes, placements may wrap around; coordinates are reduced
    modulo the axis dimension.  Duplicate coord-sets that arise from full-
    axis spans are canonicalized away.
    """
    mx, my, mz = topo.spec.mesh_shape
    sx, sy, sz = shape
    if sx > mx or sy > my or sz > mz:
        return []
    out: list[Placement] = []
    seen: set[frozenset[Coord]] = set()
    wraps = topo.spec.wrap
    for ox in _axis_origins(mx, sx, wraps[0]):
        for oy in _axis_origins(my, sy, wraps[1]):
            for oz in _axis_origins(mz, sz, wraps[2]):
                coords = tuple(
                    ((ox + dx) % mx, (oy + dy) % my, (oz + dz) % mz)
                    for dx in range(sx)
                    for dy in range(sy)
                    for dz in range(sz)
                )
                key = frozenset(coords)
                if key in seen:
                    continue
                seen.add(key)
                out.append(Placement(origin=(ox, oy, oz), shape=shape,
                                     coords=coords))
    return out


def find_free_placements(
    topo: TpuTopology,
    occupied: set[Coord],
    shape: Coord,
    limit: int | None = None,
) -> list[Placement]:
    """Free contiguous placements of ``shape`` given an occupancy set.

    This is the feasibility predicate behind the scheduler's ``/filter``
    verb (SURVEY.md §4.2).  ``limit`` caps the returned candidates so the
    prioritize step scores a bounded set.
    """
    out: list[Placement] = []
    for p in enumerate_placements(topo, shape):
        if not any(c in occupied for c in p.coords):
            out.append(p)
            if limit is not None and len(out) >= limit:
                break
    return out


def host_aligned(topo: TpuTopology, placement: Placement) -> bool:
    """True if the placement is a union of whole host blocks.

    Multi-host gangs want host-aligned slices so each pod maps to exactly
    one host's chips (TPU_WORKER_ID per host — SURVEY.md §8).
    """
    by_host: dict[int, int] = {}
    for c in placement.coords:
        hid = topo.chip_at(c).host_id
        by_host[hid] = by_host.get(hid, 0) + 1
    cph = topo.spec.chips_per_host
    return all(n == cph for n in by_host.values())


def partition_by_host(
    topo: TpuTopology, placement: Placement
) -> list[tuple[int, list[Coord]]]:
    """Group a placement's coords by owning host, ordered by host id.

    The ordering defines gang-member → host assignment and hence
    TPU_WORKER_ID: host order must match mesh-coordinate order or pjit
    layouts silently degrade (SURVEY.md §8 "Worker identity wiring").
    """
    by_host: dict[int, list[Coord]] = {}
    for c in placement.coords:
        by_host.setdefault(topo.chip_at(c).host_id, []).append(c)
    return sorted(by_host.items(), key=lambda kv: kv[0])


def fragmentation_score(topo: TpuTopology, occupied: set[Coord],
                        placement: Placement) -> float:
    """Packing heuristic: prefer placements hugging walls/occupied chips.

    Returns the fraction of the placement's *boundary* (neighbor slots
    outside the placement) that is either off-mesh or already occupied —
    higher means tighter packing, leaving larger free blocks for future
    gangs (the bin-packing pressure case, BASELINE config 5).
    """
    return _fragmentation_score_py(topo, occupied, placement)


def fragmentation_scorer(topo: TpuTopology, occupied: set[Coord]):
    """``placement -> score`` closure for scoring MANY placements
    against ONE occupancy set."""
    return lambda placement: _fragmentation_score_py(
        topo, occupied, placement)


def _fragmentation_score_py(topo: TpuTopology, occupied: set[Coord],
                            placement: Placement) -> float:
    pset = set(placement.coords)
    boundary = 0
    blocked = 0
    for c in placement.coords:
        x, y, z = c
        for axis in range(3):
            dim = topo.spec.mesh_shape[axis]
            for delta in (-1, 1):
                n = list(c)
                n[axis] += delta
                if not (0 <= n[axis] < dim):
                    if topo.spec.wrap[axis] and dim > 2:
                        n[axis] %= dim
                    else:
                        boundary += 1
                        blocked += 1  # mesh wall: counts as packed-against
                        continue
                nc = (n[0], n[1], n[2])
                if nc in pset:
                    continue
                boundary += 1
                if nc in occupied:
                    blocked += 1
    return blocked / boundary if boundary else 1.0
