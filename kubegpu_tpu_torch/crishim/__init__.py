"""Runtime-injection layer — reference: ``crishim`` (copied from
``kubegpu_tpu/crishim``).

``CriShim.create_container`` reads the pod's allocation annotation, asks
the device backend for the env of the grant (the reference's
``TPU_VISIBLE_CHIPS``/``TPU_WORKER_ID``/coordinator keys and the cards by
UUID: ``CUDA_VISIBLE_DEVICES``, KubeGPU's ``NVIDIA_VISIBLE_DEVICES``),
rewrites the container spec, and forwards to a runtime.
``SubprocessRuntime`` launches workload processes with that env;
``FakeRuntime`` records calls for scheduler-side tests.  ``NodeAgent``
plays kubelet+advertiser.  On the wire: ``CriServer`` serves the CRI verbs
as length-prefixed JSON frames on a unix socket (``criserver``),
``GrpcCriServer`` as gRPC with ``runtime.v1`` protobuf bodies
(``grpcserver`` over ``protowire``; grpcio is imported only when one
starts), and ``RemoteCriShim`` gives the agent the shim's seam across
either; ``serve`` is the node daemon.
"""

from kubegpu_tpu_torch.crishim.runtime import (
    ContainerHandle,
    ContainerRuntime,
    FakeRuntime,
    SubprocessRuntime,
)
from kubegpu_tpu_torch.crishim.shim import CriError, CriShim
from kubegpu_tpu_torch.crishim.agent import NodeAgent, harvest_workload_metrics
from kubegpu_tpu_torch.crishim.criserver import (
    CriClient,
    CriServer,
    RemoteCriShim,
)

__all__ = [
    "ContainerHandle", "ContainerRuntime", "FakeRuntime",
    "SubprocessRuntime", "CriError", "CriShim", "NodeAgent",
    "harvest_workload_metrics", "CriServer", "CriClient", "RemoteCriShim",
]
