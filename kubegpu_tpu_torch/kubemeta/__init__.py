"""The pieces of ``kubegpu_tpu/kubemeta`` the serving pools read (copied):
the gang annotation of a pod (:mod:`.codec`)."""

from kubegpu_tpu_torch.kubemeta.codec import (  # noqa: F401
    GANG_KEY,
    GangSpec,
    pod_gang_spec,
)
