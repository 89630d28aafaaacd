"""ICI mesh topology model — the foundation layer (copied from
``kubegpu_tpu/topology``; the port adds switched GPU nodes, ``h100-sxm-N``).

The reference (SURVEY.md §3 "Core types", expected ``types/types.go``) models
device topology as a hierarchical grouped-resource tree of path strings
(``gpugrp1/0/gpugrp0/0/gpu/0/cards``) because NVLink cliques are naturally
hierarchical.  TPU ICI is not a hierarchy — it is an explicit torus mesh — so
this layer models it as one: chip coordinates, per-axis wraparound, host
blocks, and a two-tier link graph (ICI intra-slice, DCN inter-host/inter-
slice).  Slice algebra (contiguous sub-torus enumeration) and locality scoring
(the ≥90% ICI-link-locality north-star metric, BASELINE.md) live here too.
"""

from kubegpu_tpu_torch.topology.mesh import (
    Chip,
    Host,
    LinkTier,
    TopologySpec,
    TpuTopology,
    get_topology,
    register_topology,
    TOPOLOGY_REGISTRY,
)
from kubegpu_tpu_torch.topology.slices import (
    Placement,
    enumerate_placements,
    find_free_placements,
    subslice_shapes,
)
from kubegpu_tpu_torch.topology.locality import (
    TrafficModel,
    ici_locality,
    ring_order_for_axis,
    traffic_pairs_for_mesh_axes,
)

__all__ = [
    "Chip",
    "Host",
    "LinkTier",
    "TopologySpec",
    "TpuTopology",
    "get_topology",
    "register_topology",
    "TOPOLOGY_REGISTRY",
    "Placement",
    "enumerate_placements",
    "find_free_placements",
    "subslice_shapes",
    "TrafficModel",
    "ici_locality",
    "ring_order_for_axis",
    "traffic_pairs_for_mesh_axes",
]
