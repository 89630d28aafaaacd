"""Gang/slice allocator — reference: ``grpalloc`` + ``gpuschedulerplugin``.

The reference's hot loop (SURVEY.md §4.2 ``PodFitsGroupConstraints``)
matched grouped device requests against a hierarchical resource tree.  The
TPU-native equivalent: given cluster occupancy and a gang request
(N pods × chips each, optional logical mesh axes), find the best free
*contiguous sub-torus* atomically for the whole gang — all pods or none
(SURVEY.md §1 item 3) — scored by honest ICI locality + packing.

``ordering`` chooses the logical-device order (chip → worker/mesh position)
that maximizes ring locality — the seam where placement quality turns into
collective bandwidth.  Copied from ``kubegpu_tpu/allocator``, with its C++
core (``_native``, built by the host's compiler at first use), which
accelerates the placement search and knows switched nodes; ``gang`` and
``ordering`` keep the Python paths it is held equal to
(``KUBETPU_NO_NATIVE=1`` runs them).
"""

from kubegpu_tpu_torch.allocator.gang import (
    GangAllocator,
    GangAssignment,
    GangRequest,
    PodAssignment,
    SliceState,
)
from kubegpu_tpu_torch.allocator.ordering import best_logical_order, evaluate_order

__all__ = [
    "GangAllocator",
    "GangAssignment",
    "GangRequest",
    "PodAssignment",
    "SliceState",
    "best_logical_order",
    "evaluate_order",
]
