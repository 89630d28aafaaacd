"""The gang allocator core — reference: ``grpalloc.PodFitsGroupConstraints``
+ ``ComputePodScore`` (SURVEY.md §3, §4.2 hot loop).  Copied from
``kubegpu_tpu/allocator/gang.py``, its Python paths only: the reference's
native core is not ported (ROADMAP), and its tests hold the core equal to
these paths.

Semantics (reference parity, TPU-translated):
- *Fit*: can this gang's total chip ask be satisfied by a free contiguous
  sub-torus of some slice, partitioned into per-pod chunks that never span
  a host?  (Reference: grouped requests must land in one locality group.)
- *Score*: 0–10, combining honest ICI locality of the best logical order,
  packing tightness, and slice fill (bin-packing pressure, BASELINE
  config 5).  (Reference: prefer fewest groups spanned.)
- *Atomicity*: the assignment covers every pod of the gang or ``None`` —
  the all-or-nothing group allocation BASELINE extends to multi-pod gangs.

Fractional requests (millitpu < 1000) bin-pack onto partially-used chips
(best-fit-decreasing) and never block whole-chip slices unnecessarily.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from kubegpu_tpu_torch.kubemeta.codec import AllocatedChip, Allocation
from kubegpu_tpu_torch.topology.mesh import Coord, TopologySpec, TpuTopology
from kubegpu_tpu_torch.topology.slices import (
    Placement,
    find_free_placements,
    fragmentation_score,
    fragmentation_scorer,
    subslice_shapes,
)
from kubegpu_tpu_torch.tpuplugin.backend import MILLICHIPS_PER_CHIP, NodeAdvertisement
from kubegpu_tpu_torch.allocator.ordering import candidate_orders, evaluate_order

COORDINATOR_PORT = 8476


@dataclass
class GangRequest:
    """One gang's ask: N pods × (whole chips | millitpu fraction) each."""

    gang_name: str
    num_pods: int = 1
    chips_per_pod: int = 0
    millitpu_per_pod: int = 0
    hbm_gib_per_chip: float = 0.0  # min advertised HBM per allocated chip
    mesh_axes: dict[str, int] | None = None       # logical axes, ordered
    axis_weights: dict[str, float] | None = None  # relative collective bytes
    # permit splitting the gang across slices when no single slice fits:
    # the FIRST mesh axis (outermost, dp by convention) partitions across
    # slices, its crossing pairs riding DCN (counted non-local)
    allow_multislice: bool = False

    @property
    def total_chips(self) -> int:
        return self.num_pods * self.chips_per_pod

    def __post_init__(self) -> None:
        if self.num_pods < 1:
            raise ValueError("num_pods must be >= 1")
        if self.chips_per_pod < 0 or self.millitpu_per_pod < 0:
            raise ValueError("negative device request")
        if self.chips_per_pod and self.millitpu_per_pod:
            raise ValueError("gang mixes whole-chip and fractional asks")
        if self.millitpu_per_pod and self.num_pods != 1:
            raise ValueError("fractional requests are single-pod")
        if self.millitpu_per_pod >= MILLICHIPS_PER_CHIP:
            raise ValueError("millitpu >= 1000 must be a whole-chip ask")
        if self.mesh_axes:
            prod = 1
            for v in self.mesh_axes.values():
                prod *= v
            if prod != self.total_chips:
                raise ValueError(
                    f"mesh_axes {self.mesh_axes} product {prod} != "
                    f"total chips {self.total_chips}")


@dataclass
class PodAssignment:
    pod_index: int       # gang index == TPU_WORKER_ID
    node_name: str
    host_id: int
    chips: list[AllocatedChip] = field(default_factory=list)
    slice_id: str = ""   # "" → the gang's primary slice (single-slice gang)


@dataclass
class GangAssignment:
    slice_id: str        # primary slice (pods may override — multislice)
    pods: list[PodAssignment]
    locality: float
    score: float
    placement: Placement | None = None
    logical_order: list[Coord] = field(default_factory=list)

    def pod_slice(self, p: PodAssignment) -> str:
        return p.slice_id or self.slice_id

    @property
    def slice_ids(self) -> list[str]:
        """All slices touched, primary first, stable order."""
        out: list[str] = []
        for p in self.pods:
            sid = self.pod_slice(p)
            if sid not in out:
                out.append(sid)
        return out or [self.slice_id]

    def to_allocations(self, coordinator_address: str,
                       worker_hostnames: list[str]) -> list[Allocation]:
        return [
            Allocation(
                node_name=p.node_name,
                slice_id=self.pod_slice(p),
                chips=list(p.chips),
                worker_id=p.pod_index,
                num_workers=len(self.pods),
                coordinator_address=coordinator_address,
                worker_hostnames=worker_hostnames,
            )
            for p in self.pods
        ]


class SliceState:
    """Mutable occupancy of one slice, assembled from node advertisements.

    Reference parity: ``NodeInfo{Capacity, Allocatable, Used}`` (SURVEY.md
    §3) — except a TPU "allocatable unit" is a coord in a mesh shared by
    many nodes (hosts), so occupancy is per-coord millichips.
    """

    def __init__(self, slice_id: str, spec: TopologySpec):
        self.slice_id = slice_id
        self.spec = spec
        self.topo = TpuTopology.build(spec)
        self.node_of_host: dict[int, str] = {}
        self.ip_of_host: dict[int, str] = {}
        self.available: set[Coord] = set()     # advertised by some node
        self.unhealthy: set[Coord] = set()
        self.bad_links: set[tuple[Coord, Coord]] = set()  # normalized pairs
        self.local_index: dict[Coord, int] = {}
        self.used_millichips: dict[Coord, int] = {}
        self.hbm_gib: dict[Coord, float] = {}  # advertised HBM per chip

    @classmethod
    def from_advertisements(
        cls, advs: list[NodeAdvertisement]
    ) -> "SliceState":
        if not advs:
            raise ValueError("no advertisements")
        first = advs[0]
        if len({a.slice_id for a in advs}) != 1:
            raise ValueError("advertisements span slices")
        spec = TopologySpec(
            name=first.slice_type, generation=first.slice_type.split("-")[0],
            mesh_shape=first.mesh_shape, wrap=first.wrap,
            host_block=first.host_block, switched=first.switched)
        st = cls(first.slice_id, spec)
        for a in advs:
            st.node_of_host[a.host_id] = a.node_name
            st.ip_of_host[a.host_id] = a.internal_ip
            for c in a.chips:
                st.available.add(c.coord)
                st.local_index[c.coord] = c.local_index
                st.hbm_gib[c.coord] = c.hbm_gib
                if not c.healthy:
                    st.unhealthy.add(c.coord)
            for pair in a.bad_links:
                st.bad_links.add((min(pair), max(pair)))
        return st

    def clone(self) -> "SliceState":
        """Copy for what-if planning (preemption/backfill trials): mutable
        occupancy/health is copied, immutable topo/spec shared."""
        st = SliceState.__new__(SliceState)
        st.slice_id = self.slice_id
        st.spec = self.spec
        st.topo = self.topo
        st.node_of_host = dict(self.node_of_host)
        st.ip_of_host = dict(self.ip_of_host)
        st.available = set(self.available)
        st.unhealthy = set(self.unhealthy)
        st.bad_links = set(self.bad_links)
        st.local_index = dict(self.local_index)
        st.used_millichips = dict(self.used_millichips)
        st.hbm_gib = dict(self.hbm_gib)
        return st

    # -- occupancy -------------------------------------------------------

    def blocked_for_whole(self, min_hbm_gib: float = 0.0) -> set[Coord]:
        """Coords unusable for whole-chip placement: any current use,
        unhealthy, not advertised (host missing), or — with
        ``min_hbm_gib`` — advertising less HBM than the request needs
        (a chip the model doesn't fit on is no chip at all)."""
        blocked = {c for c, u in self.used_millichips.items() if u > 0}
        blocked |= self.unhealthy
        all_coords = {ch.coord for ch in self.topo.chips}
        blocked |= all_coords - self.available
        if min_hbm_gib > 0:
            blocked |= {c for c in self.available
                        if self.hbm_gib.get(c, 0.0) < min_hbm_gib}
        return blocked

    def free_millichips(self, coord: Coord) -> int:
        if coord not in self.available or coord in self.unhealthy:
            return 0
        return MILLICHIPS_PER_CHIP - self.used_millichips.get(coord, 0)

    def take(self, chips: list[AllocatedChip]) -> None:
        for ch in chips:
            newu = self.used_millichips.get(ch.coord, 0) + ch.millichips
            if newu > MILLICHIPS_PER_CHIP:
                raise ValueError(f"chip {ch.coord} over-allocated: {newu}")
            self.used_millichips[ch.coord] = newu

    def release(self, chips: list[AllocatedChip]) -> None:
        for ch in chips:
            cur = self.used_millichips.get(ch.coord, 0) - ch.millichips
            if cur < 0:
                raise ValueError(f"chip {ch.coord} over-released")
            self.used_millichips[ch.coord] = cur

    def restricted_to_node(self, node_name: str) -> "SliceState":
        """A view of this slice where only ``node_name``'s chips are
        available — the per-node feasibility check the extender /filter
        verb needs (a candidate node can only contribute its own chips)."""
        host_ids = {h for h, n in self.node_of_host.items() if n == node_name}
        view = SliceState(self.slice_id, self.spec)
        view.node_of_host = dict(self.node_of_host)
        view.ip_of_host = dict(self.ip_of_host)
        node_coords = {self.topo.chips[i].coord
                       for h in host_ids
                       for i in self.topo.hosts[h].chip_indices}
        view.available = self.available & node_coords
        view.unhealthy = set(self.unhealthy)
        view.bad_links = set(self.bad_links)
        view.local_index = dict(self.local_index)
        view.used_millichips = dict(self.used_millichips)
        view.hbm_gib = dict(self.hbm_gib)
        return view

    def fill_fraction(self) -> float:
        cap = len(self.available) * MILLICHIPS_PER_CHIP
        if not cap:
            return 1.0
        return sum(self.used_millichips.values()) / cap

    def _alloc_chip(self, coord: Coord, millichips: int) -> AllocatedChip:
        return AllocatedChip(coord=coord,
                             local_index=self.local_index[coord],
                             millichips=millichips)


# ---------------------------------------------------------------------------
# Ordering helpers specific to gang chunking
# ---------------------------------------------------------------------------

def _gilbert2d(w: int, h: int):
    """Generalized Hilbert curve over a w×h grid: yields (x, y) visiting
    every cell with consecutive cells adjacent and strong locality at all
    scales — consecutive groups of blocks stay compact, which is what lets
    a tp ring spanning several host blocks close into a physical cycle."""
    def gen(x, y, ax, ay, bx, by):
        wl = abs(ax + ay)
        hl = abs(bx + by)
        dax, day = (ax > 0) - (ax < 0), (ay > 0) - (ay < 0)
        dbx, dby = (bx > 0) - (bx < 0), (by > 0) - (by < 0)
        if hl == 1:
            for _ in range(wl):
                yield (x, y)
                x, y = x + dax, y + day
            return
        if wl == 1:
            for _ in range(hl):
                yield (x, y)
                x, y = x + dbx, y + dby
            return
        ax2, ay2 = ax // 2, ay // 2
        bx2, by2 = bx // 2, by // 2
        w2 = abs(ax2 + ay2)
        h2 = abs(bx2 + by2)
        if 2 * wl > 3 * hl:
            if w2 % 2 and wl > 2:
                ax2, ay2 = ax2 + dax, ay2 + day
            yield from gen(x, y, ax2, ay2, bx, by)
            yield from gen(x + ax2, y + ay2, ax - ax2, ay - ay2, bx, by)
        else:
            if h2 % 2 and hl > 2:
                bx2, by2 = bx2 + dbx, by2 + dby
            yield from gen(x, y, bx2, by2, ax2, ay2)
            yield from gen(x + bx2, y + by2, ax, ay, bx - bx2, by - by2)
            yield from gen(x + (ax - dax) + (bx2 - dbx),
                           y + (ay - day) + (by2 - dby),
                           -bx2, -by2, -(ax - ax2), -(ay - ay2))
    if w >= h:
        yield from gen(0, 0, w, 0, 0, h)
    else:
        yield from gen(0, 0, 0, h, w, 0)


def _block_cycle_options(coords: list[Coord]) -> list[list[Coord]]:
    """All oriented Hamiltonian walks of one host block that downstream
    chunking may use (2x2 blocks: 4 rotations × 2 directions of the cycle)."""
    if len(coords) == 4:
        s = sorted(coords)
        base = [s[0], s[1], s[3], s[2]]  # the 2x2 cycle
        outs = []
        for rot in range(4):
            r = base[rot:] + base[:rot]
            outs.append(r)
            outs.append([r[0]] + list(reversed(r[1:])))
        return outs
    return [sorted(coords)]


def _dist(a: Coord, b: Coord) -> int:
    return sum(abs(a[i] - b[i]) for i in range(3))


def _orient_rings(blocks: list[list[Coord]], close: bool = False) -> list[Coord]:
    """Chain per-block chip cycles by dynamic programming: choose each
    block's orientation so entry chips sit next to the previous block's
    exit chip (Viterbi over ≤8 orientations/block).  With ``close``, also
    optimize the wrap transition last-exit → first-entry, turning the whole
    sequence into a physical cycle — what lets a collective ring spanning
    several host blocks run at 100% ICI locality on an unwrapped mesh."""
    options = [_block_cycle_options(b) for b in blocks]
    if len(blocks) == 1:
        return list(options[0][0])

    def trans_cost(prev_opt: list[Coord], nxt_opt: list[Coord]) -> int:
        d = _dist(prev_opt[-1], nxt_opt[0])
        return 0 if d == 1 else d

    best_total, best_path = None, None
    starts = options[0] if close else options[0][:1]
    for start in starts:
        # cost[j] = best cost ending with option j of current block
        cost = {0: 0}
        back: list[dict[int, int]] = []
        prev_opts = [start]
        for i in range(1, len(blocks)):
            ncost: dict[int, int] = {}
            nback: dict[int, int] = {}
            for j, opt in enumerate(options[i]):
                bestc, bestj = None, None
                for pj, pcost in cost.items():
                    c = pcost + trans_cost(prev_opts[pj], opt)
                    if bestc is None or c < bestc:
                        bestc, bestj = c, pj
                ncost[j] = bestc
                nback[j] = bestj
            back.append(nback)
            cost = ncost
            prev_opts = options[i]
        for j, c in cost.items():
            total = c
            if close:
                total += trans_cost(options[-1][j], start)
            if best_total is None or total < best_total:
                # backtrack
                path = [j]
                for nb in reversed(back):
                    path.append(nb[path[-1]])
                path.reverse()
                chosen = [start] + [options[i][path[i]]
                                    for i in range(1, len(blocks))]
                best_total, best_path = total, chosen
    out: list[Coord] = []
    for opt in best_path:
        out.extend(opt)
    return out


def _block_sequences(topo: TpuTopology,
                     placement: Placement) -> list[list[list[Coord]]]:
    """Orderings of the placement's host blocks: snake (two axes) and
    generalized-Hilbert traversals of the block grid."""
    by_host: dict[int, list[Coord]] = {}
    for c in placement.coords:
        by_host.setdefault(topo.chip_at(c).host_id, []).append(c)
    entries = [(topo.hosts[h].block_origin, coords)
               for h, coords in by_host.items()]
    seqs: list[list[list[Coord]]] = []
    for major in (0, 1):
        minor = 1 - major
        majors = sorted({o[major] for o, _ in entries})
        seq: list[list[Coord]] = []
        for i, m in enumerate(majors):
            line = [e for e in entries if e[0][major] == m]
            line.sort(key=lambda e: e[0][minor])
            if i % 2 == 1:
                line.reverse()
            seq.extend(blk for _, blk in line)
        seqs.append(seq)
    origins = sorted({o for o, _ in entries})
    bxs = sorted({o[0] for o in origins})
    bys = sorted({o[1] for o in origins})
    if len(origins) == len(bxs) * len(bys) and len(origins) > 2:
        by_origin = {o: blk for o, blk in entries}
        seq = []
        for gx, gy in _gilbert2d(len(bxs), len(bys)):
            key = (bxs[gx], bys[gy], origins[0][2])
            if key not in by_origin:
                seq = []
                break
            seq.append(by_origin[key])
        if seq:
            seqs.append(seq)
    return seqs


_block_orders_memo: dict = {}


def _block_orders(topo: TpuTopology, placement: Placement,
                  ring_span: int | None = None) -> list[list[Coord]]:
    """Memoizing wrapper over :func:`_block_orders_uncached` — pure
    geometry, so results are shared across slices of the same topology
    shape and across scheduling passes (the same placements recur
    constantly under churn).  Callers must not mutate the returned
    orders."""
    key = (topo.spec.name, topo.spec.mesh_shape, topo.spec.wrap,
           topo.spec.host_block, topo.spec.switched, placement, ring_span)
    hit = _block_orders_memo.get(key)
    if hit is None:
        hit = _block_orders_uncached(topo, placement, ring_span)
        if len(_block_orders_memo) >= 8192:
            _block_orders_memo.clear()
        _block_orders_memo[key] = hit
    return hit


def _block_orders_uncached(topo: TpuTopology, placement: Placement,
                           ring_span: int | None = None
                           ) -> list[list[Coord]]:
    """Chip orders built from block sequences.  With ``ring_span`` (chips
    in the workload's fastest logical axis), blocks are grouped so each
    ring's span of blocks is closed into a physical cycle — e.g. a tp=16
    ring over four 2x2 host blocks becomes a 16-chip ICI cycle."""
    orders: list[list[Coord]] = []
    seen: set[tuple] = set()

    def add(o: list[Coord] | None) -> None:
        if o is not None and tuple(o) not in seen:
            seen.add(tuple(o))
            orders.append(o)

    for seq in _block_sequences(topo, placement):
        add(_orient_rings(seq, close=len(seq) > 2))
        if not ring_span:
            continue
        cph = len(seq[0])
        if ring_span == cph and len(seq) >= 2:
            # fast axis = one host block: align the per-block cycles so
            # the NEXT axis's position-wise pairs ride ICI too
            add(_align_units([_block_cycle_options(b)[0] for b in seq],
                             step=1))
            continue
        span_blocks = ring_span // cph if ring_span % cph == 0 else 0
        if span_blocks > 1 and len(seq) % span_blocks == 0:
            # fast axis spans several blocks: close each group's ring once,
            # reuse the oriented groups both concatenated and aligned
            units = [_orient_rings(seq[g:g + span_blocks], close=True)
                     for g in range(0, len(seq), span_blocks)]
            add([c for u in units for c in u])
            if len(units) >= 2:
                add(_align_units(units, step=cph))
    return orders


def _cycle_variants(cycle: list[Coord], step: int) -> list[list[Coord]]:
    """Rotations (by multiples of ``step``, preserving chunk boundaries)
    and reversals of a chip cycle — the orientation freedom of one ring."""
    n = len(cycle)
    outs = []
    for r in range(0, n, max(step, 1)):
        rot = cycle[r:] + cycle[:r]
        outs.append(rot)
        outs.append(list(reversed(rot)))
    return outs


def _align_units(units: list[list[Coord]], step: int) -> list[Coord] | None:
    """Choose an orientation per ring so POSITION-WISE pairs between
    consecutive rings (and last→first) maximize ICI adjacency.

    This is the second-axis problem the global-ring orders can't solve:
    with pods pinned to host blocks, the fastest logical axis rides each
    block's internal cycle, while the next axis pairs chip *i* of ring k
    with chip *i* of ring k+1 — a dp/fsdp gradient ring across blocks.
    Viterbi over ≤2n orientations per ring; unit 0 is fixed to identity or
    reversal WLOG (a global rotation applied to every ring preserves all
    pairwise gains, intra-ring rings, and chunk boundaries).
    """
    if len(units) < 2 or len({len(u) for u in units}) != 1:
        return None
    options = [_cycle_variants(u, step) for u in units]

    def gain(a: list[Coord], b: list[Coord]) -> int:
        return sum(1 for p, q in zip(a, b) if _dist(p, q) == 1)

    best_total, best_seq = -1, None
    for start in options[0][:2]:  # identity + reversal (see docstring)
        score = {j: gain(start, opt) for j, opt in enumerate(options[1])}
        back: list[dict[int, int]] = []
        for i in range(2, len(units)):
            nscore: dict[int, int] = {}
            nback: dict[int, int] = {}
            for j, opt in enumerate(options[i]):
                bj, bs = None, -1
                for pj, ps in score.items():
                    s = ps + gain(options[i - 1][pj], opt)
                    if s > bs:
                        bs, bj = s, pj
                nscore[j] = bs
                nback[j] = bj
            back.append(nback)
            score = nscore
        for j, s in score.items():
            total = s + gain(options[-1][j], start)  # close the loop
            if total > best_total:
                path = [j]
                for nb in reversed(back):
                    path.append(nb[path[-1]])
                path.reverse()
                seq = list(start)
                for i, pj in enumerate(path, start=1):
                    seq.extend(options[i][pj])
                best_total, best_seq = total, seq
    return best_seq


def _multislice_locality(parts: list[tuple[SliceState, list[Coord]]],
                         axes: dict[str, int],
                         axis_weights: dict[str, float] | None) -> float:
    """Weighted ICI locality of a multislice logical order: ring pairs
    inside one part score against that part's torus (bad links included);
    pairs spanning parts ride DCN and count non-local.  Coord spaces
    collide across slices, so coords are disambiguated with a part tag
    and the shared ring enumeration is reused."""
    from kubegpu_tpu_torch.topology.locality import traffic_pairs_for_mesh_axes

    tagged = [(pi,) + c for pi, (_, o) in enumerate(parts) for c in o]
    tm = traffic_pairs_for_mesh_axes(tagged, axes, axis_weights)
    total_w = local_w = 0.0
    for (a, b), w in tm.pairs.items():
        total_w += w
        if a[0] != b[0]:
            continue   # DCN crossing
        st, _ = parts[a[0]]
        ca, cb = a[1:], b[1:]
        if (st.topo.are_ici_adjacent(ca, cb)
                and (min(ca, cb), max(ca, cb)) not in st.bad_links):
            local_w += w
    return local_w / total_w if total_w else 1.0


def _chunks_host_local(topo: TpuTopology, order: list[Coord], c: int) -> bool:
    for i in range(0, len(order), c):
        hosts = {topo.chip_at(x).host_id for x in order[i:i + c]}
        if len(hosts) != 1:
            return False
    return True


# ---------------------------------------------------------------------------
# The allocator
# ---------------------------------------------------------------------------

@dataclass
class _Candidate:
    slice_state: SliceState
    placement: Placement
    order: list[Coord]
    locality: float
    score: float


class GangAllocator:
    """Pure-function fit/score/assign over SliceStates (no I/O) — the same
    testability property the reference's allocator had (SURVEY.md §5)."""

    def __init__(self, max_placements_per_shape: int = 64,
                 max_scored_per_shape: int = 8,
                 locality_weight: float = 0.6, frag_weight: float = 0.25,
                 fill_weight: float = 0.15):
        self.max_placements_per_shape = max_placements_per_shape
        self.max_scored_per_shape = max_scored_per_shape
        self.locality_weight = locality_weight
        self.frag_weight = frag_weight
        self.fill_weight = fill_weight

    # -- public API ------------------------------------------------------

    def find_assignment(self, slices: list[SliceState],
                        req: GangRequest) -> GangAssignment | None:
        import time as _time

        # per-call phase attribution: enumeration (per-slice shape ×
        # placement × ordering search) vs the multislice split search.
        # The extender folds these into its per-decision trace so the
        # bench can bucket the p99 tail.  Overwritten every call; read
        # it before the next one.
        t0 = _time.perf_counter()
        self.last_phase_ms = {"enumerate": 0.0, "multislice_split": 0.0}
        if req.millitpu_per_pod:
            out = self._find_fractional(slices, req)
            self.last_phase_ms["enumerate"] = \
                (_time.perf_counter() - t0) * 1e3
            return out
        best: GangAssignment | None = None
        for st in slices:
            # threading the incumbent lets a later slice's whole search
            # stop at the bound check before any ordering work when it
            # provably cannot beat an earlier slice's candidate
            cand = self._best_candidate_in_slice(
                st, req, incumbent=best.score if best else None)
            if cand and (best is None or cand.score > best.score):
                best = cand
        self.last_phase_ms["enumerate"] = \
            (_time.perf_counter() - t0) * 1e3
        if best is None and req.allow_multislice and req.num_pods > 1 \
                and req.chips_per_pod and len(slices) > 1:
            t1 = _time.perf_counter()
            best = self._multislice_candidate(slices, req)
            self.last_phase_ms["multislice_split"] = \
                (_time.perf_counter() - t1) * 1e3
        return best

    def commit(self, slices: dict[str, SliceState],
               assignment: GangAssignment) -> None:
        """TakePodResources (SURVEY.md §4.2): mutate occupancy atomically.
        Skips slices that vanished, symmetric with rollback — a multislice
        gang re-committed in a what-if trial (recovery's rollback→find→
        commit) may have lost one slice while another lives on."""
        for p in assignment.pods:
            st = slices.get(assignment.pod_slice(p))
            if st is not None:
                st.take(p.chips)

    def rollback(self, slices: dict[str, SliceState],
                 assignment: GangAssignment) -> None:
        """ReturnPodResources (SURVEY.md §4.4).  A slice that vanished
        (all hosts down) has nothing to release — skip it, free the rest
        (multislice gangs can lose one slice and keep another)."""
        for p in assignment.pods:
            st = slices.get(assignment.pod_slice(p))
            if st is not None:
                st.release(p.chips)

    # -- whole-chip path -------------------------------------------------

    def _best_candidate_in_slice(self, st: SliceState,
                                 req: GangRequest,
                                 incumbent: float | None = None
                                 ) -> GangAssignment | None:
        total = req.total_chips
        if total == 0 or total > len(st.available):
            return None
        cph = st.spec.chips_per_host
        if req.chips_per_pod > cph:
            return None  # a pod cannot span hosts
        blocked = st.blocked_for_whole(req.hbm_gib_per_chip)
        # Exact necessary condition, O(chips): fewer FREE chips than the
        # ask means no shape can ever place — skip the whole shape ×
        # placement × ordering search.  This is the failing-decision hot
        # path (the p99 tail is made of infeasible searches).
        if total > len(st.available - blocked):
            return None
        fill = st.fill_fraction()
        axes = req.mesh_axes or {"dp": total}
        # Branch-and-bound over placements: the ordering search (the
        # expensive part of scoring) is bounded above by locality=1.0,
        # so computing the CHEAP fragmentation term for every placement
        # first and visiting in descending-frag order lets us stop the
        # moment no remaining placement's bound can beat the incumbent.
        # Exact: the winner is the same as scoring everything (ties may
        # resolve to an equal-scored placement).  This is what keeps the
        # empty-cluster small-gang case (many placements) off the p99.
        ranked: list[tuple[float, int, Placement]] = []
        fscore = fragmentation_scorer(st.topo, blocked)
        # Bound the ordering work, not just the candidate count: a
        # 256-chip placement's ring search costs ~16x a 16-chip one's,
        # and origin matters even less for big placements (fewer
        # distinct origins, homogeneous torus) — so the per-shape
        # scored-candidate budget shrinks as the ask grows, keeping
        # decision cost ~flat across gang sizes (the 1024-chip p99
        # was made of full-slice placements scoring 8 candidates each).
        k_scored = max(2, min(self.max_scored_per_shape,
                              (64 * self.max_scored_per_shape)
                              // max(total, 1)))
        for si, shape in enumerate(subslice_shapes(
                total, st.spec.mesh_shape)):
            # Only the top-frag few per shape get the expensive ordering
            # search: on a homogeneous torus, locality depends on the
            # shape far more than the origin, so the frag ranking is the
            # score ranking to within ties — every shape stays
            # represented, and the global bound below still applies.
            shape_ranked = [
                (fscore(pl), si, pl)
                for pl in find_free_placements(
                    st.topo, blocked, shape,
                    limit=self.max_placements_per_shape)]
            shape_ranked.sort(key=lambda t: -t[0])
            ranked.extend(shape_ranked[:k_scored])
        # stable: frag desc, then the shape-compactness preference order
        ranked.sort(key=lambda t: (-t[0], t[1]))
        best: _Candidate | None = None
        # Bounding out at <= is exact for the RECTANGULAR search: a tie
        # against the cross-slice incumbent also loses (strict > in
        # find_assignment).
        floor = incumbent if incumbent is not None else float("-inf")
        # `rect_scored` settles connected-fallback eligibility: it flips
        # the moment ANY rectangular placement passes _score_placement.
        # While it is still False the loop keeps scoring BELOW the
        # incumbent floor (candidates there can't beat the incumbent —
        # score <= bound <= floor — so this only settles eligibility,
        # never changes the winner), which makes eligibility a pure
        # function of (slice occupancy, request), independent of the
        # cross-slice incumbent and hence of slice iteration order (a
        # `not ranked` gate would declare a slice unschedulable when
        # rectangles enumerated but every ordering failed the
        # host-chunking filter).
        rect_scored = False
        for frag, _, pl in ranked:
            bound = 10.0 * (self.locality_weight
                            + self.frag_weight * frag
                            + self.fill_weight * fill)
            if best is not None and bound <= best.score:
                break
            if bound <= floor:
                if rect_scored:
                    break
                # Below the incumbent floor a candidate can't win
                # (score <= bound <= floor, strict > cross-slice), so
                # settle eligibility with the cheap host-chunking probe
                # instead of the full ordering-locality search — the
                # losing-slice hot path stays cheap.
                if self._rect_feasible(st, pl, req, axes):
                    rect_scored = True
                    break
                continue
            cand = self._score_placement(st, pl, req, axes, blocked, fill,
                                         frag=frag)
            if cand:
                rect_scored = True
                if best is None or cand.score > best.score:
                    best = cand
        if not rect_scored:   # also covers `not ranked` (loop never ran)
            # Non-rectangular totals (e.g. 3 chips in a 2x2 mesh) — or
            # slices where every rectangular ordering fails the
            # host-chunking filter — fall back to a connected free set;
            # the reference's group allocator had the same flexibility
            # since groups weren't geometric.
            cand = self._connected_candidate(st, req, blocked, axes)
            if cand is not None:
                best = cand
        if best is None:
            return None
        return self._to_assignment(best, req)

    def _connected_candidate(self, st: SliceState, req: GangRequest,
                             blocked: set[Coord],
                             axes: dict[str, int]) -> _Candidate | None:
        """BFS-grow a connected set of free chips, chunked host-locally."""
        total = req.total_chips
        c = req.chips_per_pod
        free = sorted({ch.coord for ch in st.topo.chips} - blocked)
        for start in free:
            seen = {start}
            frontier = [start]
            region: list[Coord] = []
            # min-heap pop == the old frontier.sort(); pop(0) order
            # (smallest coord each iteration) at O(log n) per pop —
            # the native port's sorted-frontier BFS matches this too
            while frontier and len(region) + len(frontier) <= len(free):
                nxt = heapq.heappop(frontier)
                region.append(nxt)
                if len(region) >= total:
                    break
                for nb in st.topo.neighbors(nxt):
                    if nb not in seen and nb not in blocked:
                        seen.add(nb)
                        heapq.heappush(frontier, nb)
            if len(region) < total:
                continue
            # chunk host-locally: pods take chips host by host
            by_host: dict[int, list[Coord]] = {}
            for x in region:
                by_host.setdefault(st.topo.chip_at(x).host_id, []).append(x)
            order: list[Coord] = []
            chunks_formed = 0
            for hid in sorted(by_host):
                chips = sorted(by_host[hid])
                usable = (len(chips) // c) * c
                take = min(usable, total - len(order))
                order.extend(chips[:take])
                chunks_formed += take // c
                if len(order) >= total:
                    break
            if len(order) != total or chunks_formed != req.num_pods:
                continue
            loc = evaluate_order(st.topo, order, axes, req.axis_weights,
                                 st.bad_links)
            pl = Placement(origin=min(order), shape=(0, 0, 0),
                           coords=tuple(order))
            frag = fragmentation_score(st.topo, blocked, pl)
            score = 10.0 * (self.locality_weight * loc
                            + self.frag_weight * frag
                            + self.fill_weight * st.fill_fraction())
            return _Candidate(slice_state=st, placement=pl, order=order,
                              locality=loc, score=score)
        return None

    def _feasible_orders(self, st: SliceState, pl: Placement,
                         req: GangRequest,
                         axes: dict[str, int]):
        """Candidate orderings of ``pl`` that chunk host-locally — THE
        order set both the scorer and the below-floor eligibility probe
        consume (one generator, so the probe can never drift from
        ``_score_placement(...) is not None``).  Lazy: the probe stops
        at the first hit without paying ``evaluate_order``."""
        c = req.chips_per_pod
        ring_span = list(axes.values())[-1] if axes else None
        for o in candidate_orders(pl):
            if _chunks_host_local(st.topo, o, c):
                yield o
        for o in _block_orders(st.topo, pl, ring_span):
            if _chunks_host_local(st.topo, o, c):
                yield o

    def _rect_feasible(self, st: SliceState, pl: Placement,
                       req: GangRequest, axes: dict[str, int]) -> bool:
        return next(
            iter(self._feasible_orders(st, pl, req, axes)), None) is not None

    def _score_placement(self, st: SliceState, pl: Placement,
                         req: GangRequest, axes: dict[str, int],
                         blocked: set[Coord],
                         fill: float,
                         frag: float | None = None) -> _Candidate | None:
        orders = list(self._feasible_orders(st, pl, req, axes))
        if not orders:
            return None
        best_order, best_loc = None, -1.0
        for o in orders:
            loc = evaluate_order(st.topo, o, axes, req.axis_weights,
                                 st.bad_links)
            if loc > best_loc:
                best_order, best_loc = o, loc
        if frag is None:
            frag = fragmentation_score(st.topo, blocked, pl)
        score = 10.0 * (self.locality_weight * best_loc
                        + self.frag_weight * frag
                        + self.fill_weight * fill)
        return _Candidate(slice_state=st, placement=pl, order=best_order,
                          locality=best_loc, score=score)

    def _to_assignment(self, cand: _Candidate,
                       req: GangRequest) -> GangAssignment:
        st = cand.slice_state
        c = req.chips_per_pod
        pods: list[PodAssignment] = []
        for k in range(req.num_pods):
            chunk = cand.order[k * c:(k + 1) * c]
            host_id = st.topo.chip_at(chunk[0]).host_id
            pods.append(PodAssignment(
                pod_index=k,
                node_name=st.node_of_host.get(host_id, f"host-{host_id}"),
                host_id=host_id,
                chips=[st._alloc_chip(x, MILLICHIPS_PER_CHIP)
                       for x in chunk]))
        return GangAssignment(
            slice_id=st.slice_id, pods=pods, locality=cand.locality,
            score=cand.score, placement=cand.placement,
            logical_order=cand.order)

    # -- multislice path (DCN-spanning gangs) -----------------------------

    def _multislice_candidate(self, slices: list[SliceState],
                              req: GangRequest) -> GangAssignment | None:
        """Split the gang across slices when no single slice fits
        (SURVEY.md §6 comm-backend row: collectives ride ICI intra-slice,
        DCN across slices — the Cloud-TPU-multislice shape).

        The FIRST (outermost) mesh axis partitions: n_parts contiguous
        worker groups land on n_parts distinct slices, so only that axis's
        rings cross slices.  Fewest parts wins (fewest DCN crossings);
        reported locality counts every cross-slice traffic pair as
        non-local — the honest number the ≥90% north-star is judged on.
        """
        axes = req.mesh_axes or {"dp": req.total_chips}
        outer_name = next(iter(axes))
        outer = axes[outer_name]
        by_id = {st.slice_id: st for st in slices}
        max_parts = min(outer, len(slices), req.num_pods)
        for n_parts in range(2, max_parts + 1):
            if outer % n_parts or req.num_pods % n_parts:
                continue
            sub_axes = dict(axes)
            sub_axes[outer_name] = outer // n_parts
            sub_req = GangRequest(
                gang_name=req.gang_name,
                num_pods=req.num_pods // n_parts,
                chips_per_pod=req.chips_per_pod,
                hbm_gib_per_chip=req.hbm_gib_per_chip,
                mesh_axes=sub_axes,
                axis_weights=req.axis_weights)
            cands = []
            for st in slices:
                c = self._best_candidate_in_slice(st, sub_req)
                if c is not None:
                    cands.append(c)
            if len(cands) < n_parts:
                continue
            cands.sort(key=lambda a: (-a.score, a.slice_id))
            parts = cands[:n_parts]
            m = req.num_pods // n_parts
            pods: list[PodAssignment] = []
            for k, pa in enumerate(parts):
                for p in pa.pods:
                    pods.append(PodAssignment(
                        pod_index=k * m + p.pod_index,
                        node_name=p.node_name,
                        host_id=p.host_id,
                        chips=p.chips,
                        slice_id=pa.slice_id))
            loc = _multislice_locality(
                [(by_id[pa.slice_id], pa.logical_order) for pa in parts],
                axes, req.axis_weights)
            # parts' scores blend their (closed-subring) locality; swap in
            # the honest global figure, keep their frag/fill terms
            score = (10.0 * self.locality_weight * loc
                     + sum(pa.score - 10.0 * self.locality_weight
                           * pa.locality for pa in parts) / n_parts)
            return GangAssignment(
                slice_id=parts[0].slice_id, pods=pods, locality=loc,
                score=score, placement=None,
                logical_order=[c for pa in parts
                               for c in pa.logical_order])
        return None

    # -- fractional path -------------------------------------------------

    def _find_fractional(self, slices: list[SliceState],
                         req: GangRequest) -> GangAssignment | None:
        """Best-fit-decreasing: prefer the most-used chip that still fits,
        keeping whole chips free for slice placements (BASELINE config 5).

        Tie-breaks (in order) minimize damage to future *gang* placements:
        pick the smallest slice (keep big contiguous meshes whole), then a
        corner chip (fragment an edge, not the middle), then stable coord.
        """
        need = req.millitpu_per_pod
        best: tuple[tuple, SliceState, Coord] | None = None
        for st in slices:
            mx, my, mz = st.spec.mesh_shape
            for coord in st.available:  # key's coord tie-break = determinism
                free = st.free_millichips(coord)
                used = st.used_millichips.get(coord, 0)
                if free < need:
                    continue
                if req.hbm_gib_per_chip > 0 and \
                        st.hbm_gib.get(coord, 0.0) < req.hbm_gib_per_chip:
                    continue
                corner_dist = (min(coord[0], mx - 1 - coord[0])
                               + min(coord[1], my - 1 - coord[1])
                               + min(coord[2], mz - 1 - coord[2]))
                key = (-used, len(st.available), corner_dist, coord)
                if best is None or key < best[0]:
                    best = (key, st, coord)
        if best is None:
            return None
        _, st, coord = best
        used = st.used_millichips.get(coord, 0)
        host_id = st.topo.chip_at(coord).host_id
        pod = PodAssignment(
            pod_index=0,
            node_name=st.node_of_host.get(host_id, f"host-{host_id}"),
            host_id=host_id,
            chips=[st._alloc_chip(coord, need)])
        return GangAssignment(
            slice_id=st.slice_id, pods=[pod], locality=1.0,
            score=5.0 + 5.0 * (used / MILLICHIPS_PER_CHIP))

    # -- helpers for the scheduler --------------------------------------

    @staticmethod
    def coordinator_for(assignment: GangAssignment,
                        slices: dict[str, SliceState],
                        port: int = COORDINATOR_PORT) -> tuple[str, list[str]]:
        """(coordinator address, worker hostnames in worker order).  Each
        pod resolves against its own slice (multislice gangs span
        several); the coordinator is worker 0's host."""
        names = []
        for p in assignment.pods:
            st = slices[assignment.pod_slice(p)]
            names.append(st.node_of_host.get(p.host_id,
                                             f"host-{p.host_id}"))
        st0 = slices[assignment.pod_slice(assignment.pods[0])]
        ip0 = st0.ip_of_host.get(assignment.pods[0].host_id, "127.0.0.1")
        return f"{ip0}:{port}", names
