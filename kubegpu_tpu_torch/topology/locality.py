"""ICI-link locality scoring: the ≥90% north-star metric (copied from
``kubegpu_tpu/topology/locality.py``; on a switched node every pair of a
host's chips is adjacent, so any placement there scores 1.0).

The reference scored allocations by how few NVLink groups they spanned
(SURVEY.md §3 ``gpuschedulerplugin`` "topology-scoring": prefer fewest
groups / most NVLink-adjacent).  The honest TPU equivalent (SURVEY.md §8
"Honest locality measurement") scores the *actual collective traffic* a
workload's sharding implies: we derive the chip-pair traffic set from the
logical mesh axes (dp/fsdp/tp/sp rings) mapped onto the allocated physical
coords, then measure the fraction of traffic pairs that ride ICI links
rather than multi-hop or DCN paths.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubegpu_tpu_torch.topology.mesh import Coord, TpuTopology

# Default relative collective volume per parallelism axis, used when the
# workload doesn't declare weights.  Proportional to bytes moved per
# training step in a sharded transformer: tp allreduces activations every
# layer (dominant); sp/cp ring-exchange KV blocks every layer; fsdp
# all-gathers params per layer; ep all-to-alls per MoE layer; dp syncs
# grads once per step.  This is what makes the locality figure "honest"
# (SURVEY.md §8): a dead dp hop costs far less than a dead tp hop, and the
# score reflects that.
DEFAULT_AXIS_WEIGHTS = {
    "tp": 8.0,
    "sp": 4.0,
    "cp": 4.0,
    "ep": 2.0,
    "fsdp": 2.0,
    "dp": 1.0,
}

# SERVING traffic is a different shape from training: a tensor-parallel
# decode engine psums activations over tp on EVERY layer of EVERY
# stride-amortized decode step (latency-critical — it sits on the
# token feedback path), while serving "dp" is independent engine
# replicas behind one admission queue — NO collective ever crosses a
# replica boundary, so a dp hop over a dead link or even DCN costs
# (almost) nothing.  Near-zero rather than zero: keeping replicas near
# each other still helps prefix-cache-affinity routing and shared
# model-load traffic, and a zero weight would make the locality score
# 0/0-degenerate for dp-only serving gangs.
SERVING_AXIS_WEIGHTS = {
    "tp": 8.0,
    "dp": 0.05,
}

# Role-split (disaggregated) serving: a PREFILL replica is a
# throughput-bound batch engine off the token feedback path — its tp
# collective rides large prefill activations where link time hides
# behind compute, so tight tp placement matters less than for a
# DECODE replica, whose per-token psum latency IS the user-visible
# token time.  Decode keeps the default serving weights.
PREFILL_ROLE_TP_WEIGHT = 4.0


def serving_axis_weights(axis_sizes: dict[str, int],
                         role: str | None = None) -> dict[str, float]:
    """Axis weights for a SERVING gang (see SERVING_AXIS_WEIGHTS):
    tp collectives dominate, replica axes are nearly free.  ``role``
    ("prefill" | "decode" | None) adjusts the tp weight for
    disaggregated gangs — prefill tolerates looser tp placement."""
    w = {k: SERVING_AXIS_WEIGHTS.get(k, 1.0) for k in axis_sizes}
    if role == "prefill" and "tp" in w:
        w["tp"] = PREFILL_ROLE_TP_WEIGHT
    return w


def resolve_axis_weights(
    axis_sizes: dict[str, int],
    axis_weights: dict[str, float] | None,
) -> dict[str, float]:
    """Explicit weights win; otherwise look up by conventional axis name
    (unknown names weigh 1.0)."""
    if axis_weights is not None:
        return axis_weights
    return {k: DEFAULT_AXIS_WEIGHTS.get(k, 1.0) for k in axis_sizes}


@dataclass
class TrafficModel:
    """Chip-pair traffic implied by a workload's parallelism strategy.

    ``pairs`` maps (chip_a, chip_b) → relative traffic weight.  XLA lowers
    allreduce/reduce-scatter/all-gather on a mesh axis to ring collectives
    over that axis, so each parallel axis contributes ring-neighbor pairs;
    ring attention / context parallelism contributes the same ring pairs on
    the sequence axis (ppermute neighbor exchange).
    """

    pairs: dict[tuple[Coord, Coord], float] = field(default_factory=dict)

    def add(self, a: Coord, b: Coord, weight: float = 1.0) -> None:
        if a == b:
            return
        key = (min(a, b), max(a, b))
        self.pairs[key] = self.pairs.get(key, 0.0) + weight


def ring_order_for_axis(coords: list[Coord], axis_size: int) -> list[list[Coord]]:
    """Split an ordered coord list into rings of ``axis_size``.

    ``coords`` must be in the logical-device order the workload uses
    (row-major placement order, matching mesh axis layout): consecutive
    chunks of ``axis_size`` form the fastest-varying logical axis.
    """
    assert len(coords) % axis_size == 0
    return [coords[i:i + axis_size] for i in range(0, len(coords), axis_size)]


def traffic_pairs_for_mesh_axes(
    coords: list[Coord],
    axis_sizes: dict[str, int],
    axis_weights: dict[str, float] | None = None,
) -> TrafficModel:
    """Traffic pairs for a logical mesh over ``coords``.

    ``axis_sizes`` is ordered (python dicts preserve order): the *last* axis
    varies fastest over ``coords`` — matching ``jax.sharding.Mesh`` device
    array semantics where ``mesh.devices.reshape(sizes)`` is row-major.
    Each axis of size s contributes ring pairs (i, i+1 mod s) within every
    group that varies only along that axis.

    ``axis_weights`` lets callers weight axes by collective volume (e.g.
    tp allreduce per-layer traffic >> dp gradient sync) — defaults to 1.0.
    """
    sizes = list(axis_sizes.values())
    names = list(axis_sizes.keys())
    total = 1
    for s in sizes:
        total *= s
    if total != len(coords):
        raise ValueError(f"mesh axes {axis_sizes} ≠ {len(coords)} chips")
    weights = resolve_axis_weights(axis_sizes, axis_weights)
    tm = TrafficModel()
    # strides for row-major logical indexing
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]

    def logical_to_coord(idx: int) -> Coord:
        return coords[idx]

    for ax, (name, s) in enumerate(zip(names, sizes)):
        if s == 1:
            continue
        w = weights.get(name, 1.0)
        stride = strides[ax]
        # enumerate all groups varying only along axis `ax`
        for base in range(total):
            # base must have axis-ax digit 0
            if (base // stride) % s != 0:
                continue
            ring = [logical_to_coord(base + k * stride) for k in range(s)]
            for k in range(s):
                a, b = ring[k], ring[(k + 1) % s]
                if s == 2 and k == 1:
                    break  # 2-ring has one unique pair
                tm.add(a, b, w)
    return tm


def ici_locality(topo: TpuTopology, tm: TrafficModel,
                 bad_links: set[tuple[Coord, Coord]] | None = None) -> float:
    """Weighted fraction of traffic pairs that are single-hop ICI links.

    1.0 = every collective neighbor exchange rides a direct ICI link;
    the north-star demands ≥0.90 for the Llama-3-8B pjit gang on v5e-64
    (BASELINE.md).  Pairs between chips on different meshes (no coord in
    ``topo``) count as DCN (non-local).  A pair riding a link in
    ``bad_links`` (normalized (min,max) coord pairs) is non-local: traffic
    must detour around the dead link.
    """
    if not tm.pairs:
        return 1.0
    total = 0.0
    local = 0.0
    for (a, b), w in tm.pairs.items():
        total += w
        if (topo.has_coord(a) and topo.has_coord(b)
                and topo.are_ici_adjacent(a, b)
                and not (bad_links and (min(a, b), max(a, b)) in bad_links)):
            local += w
    return local / total


def mean_hop_distance(topo: TpuTopology, tm: TrafficModel) -> float:
    """Average torus hop distance per unit traffic — a finer-grained tie-
    breaker than the binary locality fraction (1.0 is optimal)."""
    if not tm.pairs:
        return 0.0
    total_w = sum(tm.pairs.values())
    return sum(
        topo.hop_distance(a, b) * w for (a, b), w in tm.pairs.items()
    ) / total_w
