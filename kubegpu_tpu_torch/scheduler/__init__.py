"""The serving control loop of ``kubegpu_tpu/scheduler`` (copied): the
SLO-driven autoscaler over the port's replica pools (:mod:`.serve`)."""

from kubegpu_tpu_torch.scheduler.serve import (  # noqa: F401
    AutoscaleConfig,
    AutoscalePolicy,
    ServingAutoscaler,
)
