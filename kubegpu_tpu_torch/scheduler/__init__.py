"""Cluster scheduler — reference: ``device-scheduler`` (copied from
``kubegpu_tpu/scheduler``): the gang-aware extender (:mod:`.extender`:
``filter``, ``prioritize``, ``bind`` and the scheduling loop that holds a
gang until it fits, then commits, annotates and binds it atomically), the
fault-recovery controller (:mod:`.health`: a failed card, host or NVLink
pair evicts and requeues the gangs it breaks) and the SLO-driven
autoscaler over the port's replica pools (:mod:`.serve`).  The daemons
(``webhook.py``, ``daemon.py``) are not ported yet (ROADMAP item 10d)."""

from kubegpu_tpu_torch.scheduler.extender import (  # noqa: F401
    DeviceScheduler,
    ScheduleResult,
)
from kubegpu_tpu_torch.scheduler.health import (  # noqa: F401
    FaultRecoveryController,
    RecoveryResult,
)
from kubegpu_tpu_torch.scheduler.serve import (  # noqa: F401
    AutoscaleConfig,
    AutoscalePolicy,
    ServingAutoscaler,
)
