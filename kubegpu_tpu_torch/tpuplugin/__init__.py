"""Device advertiser backends — reference: ``plugins/nvidiagpuplugin``
(copied from ``kubegpu_tpu/tpuplugin``, with ``nvml`` in place of
``libtpu``).

A backend enumerates the host's devices and their mesh coordinates and
answers allocation with the env a granted container gets: the reference's
``TPU_VISIBLE_CHIPS``/``TPU_WORKER_ID``/coordinator keys, which the port's
programs read, and the cards by UUID (``CUDA_VISIBLE_DEVICES``, KubeGPU's
``NVIDIA_VISIBLE_DEVICES``).  ``mock`` serves tests and simulation;
``nvml`` a real node's NVIDIA cards.
"""

from kubegpu_tpu_torch.tpuplugin.backend import (
    ChipAdvertisement,
    DeviceBackend,
    NodeAdvertisement,
)
from kubegpu_tpu_torch.tpuplugin.mock import MockBackend, mock_cluster
from kubegpu_tpu_torch.tpuplugin.nvml import NvmlBackend, NvmlError

__all__ = [
    "ChipAdvertisement",
    "DeviceBackend",
    "NodeAdvertisement",
    "MockBackend",
    "mock_cluster",
    "NvmlBackend",
    "NvmlError",
]
