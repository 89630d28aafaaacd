"""Observability the serving engine and the workload programs read
(counterpart of ``kubegpu_tpu/obs``'s serving half): request tracing
(:mod:`.spans`), the chip-tick cost ledger (:mod:`.cost`), the metrics
registry with the engine's percentile summary and live-byte tracker
(:mod:`.metrics`, with the daemons' :data:`global_registry`), fault injection for one engine and for a fleet's
failure domains (:mod:`.chaos`), the tick-indexed series store
(:mod:`.tsdb`) and the burn-rate alerts over it (:mod:`.alerts`); and the
cluster layer's schedule trace (:mod:`.trace`) and JSON logs
(:mod:`.logging`)."""

from kubegpu_tpu_torch.obs.alerts import (  # noqa: F401
    Alert,
    AlertEngine,
    AlertRule,
    FlightRecorder,
    default_rules,
)
from kubegpu_tpu_torch.obs.chaos import (  # noqa: F401
    ChaosEvent,
    ChaosInjector,
    DispatchFailure,
    DomainChaosEvent,
    DomainChaosInjector,
    ReplicaDeadError,
    TickStallError,
)
from kubegpu_tpu_torch.obs.cost import CostLedger  # noqa: F401
from kubegpu_tpu_torch.obs.logging import (  # noqa: F401
    configure as configure_logging,
    get_logger,
)
from kubegpu_tpu_torch.obs.metrics import (  # noqa: F401
    LiveBytesTracker,
    MetricsRegistry,
    global_registry,
    parse_prometheus,
    percentiles,
)
from kubegpu_tpu_torch.obs.spans import (  # noqa: F401
    TRACE_ANNOTATION,
    TRACE_ENV,
    Span,
    SpanContext,
    Tracer,
    validate_chrome_trace,
)
from kubegpu_tpu_torch.obs.trace import ScheduleTrace, TraceEvent  # noqa: F401
from kubegpu_tpu_torch.obs.tsdb import SeriesStore  # noqa: F401
