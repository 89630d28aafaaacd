"""Gang/slice allocator — reference: ``grpalloc`` + ``gpuschedulerplugin``.

The reference's hot loop (SURVEY.md §4.2 ``PodFitsGroupConstraints``)
matched grouped device requests against a hierarchical resource tree.  The
TPU-native equivalent: given cluster occupancy and a gang request
(N pods × chips each, optional logical mesh axes), find the best free
*contiguous sub-torus* atomically for the whole gang — all pods or none
(SURVEY.md §1 item 3) — scored by honest ICI locality + packing.

``ordering`` chooses the logical-device order (chip → worker/mesh position)
that maximizes ring locality — the seam where placement quality turns into
collective bandwidth.  Copied from ``kubegpu_tpu/allocator``: the reference's
C++ core (``_native``) is not ported, so ``gang`` and ``ordering`` run their
Python paths, which the reference's tests hold the core equal to.
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
