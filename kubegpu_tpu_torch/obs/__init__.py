"""Observability the serving engine and the workload programs read
(counterpart of the parts of ``kubegpu_tpu/obs`` they use): request
tracing (:mod:`.spans`), the chip-tick cost ledger (:mod:`.cost`), the
metrics registry with the engine's percentile summary and live-byte
tracker (:mod:`.metrics`) and the engine's fault injection
(:mod:`.chaos`)."""

from kubegpu_tpu_torch.obs.chaos import (  # noqa: F401
    ChaosEvent,
    ChaosInjector,
    DispatchFailure,
    ReplicaDeadError,
    TickStallError,
)
from kubegpu_tpu_torch.obs.cost import CostLedger  # noqa: F401
from kubegpu_tpu_torch.obs.metrics import (  # noqa: F401
    LiveBytesTracker,
    MetricsRegistry,
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
