"""Cluster scheduler — reference: ``device-scheduler`` (copied from
``kubegpu_tpu/scheduler``): the gang-aware extender (:mod:`.extender`:
``filter``, ``prioritize``, ``bind`` and the scheduling loop that holds a
gang until it fits, then commits, annotates and binds it atomically), the
fault-recovery controller (:mod:`.health`: a failed card, host or NVLink
pair evicts and requeues the gangs it breaks), the SLO-driven autoscaler
over the port's replica pools (:mod:`.serve`, whose ``main`` is the
extender service), the extender webhook kube-scheduler calls over HTTP
(:mod:`.webhook`) and the scheduler daemon over the HTTP apiserver
(:mod:`.daemon`)."""

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
from kubegpu_tpu_torch.scheduler.webhook import (  # noqa: F401
    ExtenderHTTPServer,
    ExtenderService,
    policy_config,
)
