"""Cluster scheduler — reference: ``device-scheduler`` (copied from
``kubegpu_tpu/scheduler``): the gang-aware extender (:mod:`.extender`:
``filter``, ``prioritize``, ``bind`` and the scheduling loop that holds a
gang until it fits, then commits, annotates and binds it atomically) and
the SLO-driven autoscaler over the port's replica pools (:mod:`.serve`).
The fault-recovery controller and the daemons are not ported yet (ROADMAP
items 10c and 10d)."""

from kubegpu_tpu_torch.scheduler.extender import (  # noqa: F401
    DeviceScheduler,
    ScheduleResult,
)
from kubegpu_tpu_torch.scheduler.serve import (  # noqa: F401
    AutoscaleConfig,
    AutoscalePolicy,
    ServingAutoscaler,
)
