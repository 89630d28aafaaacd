"""Structured schedule trace: why each decision went the way it did (copied
from ``kubegpu_tpu/obs/trace.py``).

SURVEY.md §6 "Tracing": per-decision record of the candidates considered,
scores, the winner, and phase timings — the debuggability layer the
reference lacked.

Construct with ``tracer=`` to ALSO forward every recorded
decision into a :class:`~kubegpu_tpu_torch.obs.spans.Tracer` — decisions whose
gang the extender linked to a request trace (``Tracer.link_gang``)
become instant events on that trace, so control-plane scheduling and
engine ticks land on one Perfetto timeline.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field, asdict


@dataclass
class TraceEvent:
    ts: float
    kind: str                   # "schedule" | "fail" | "recover" | ...
    gang: str = ""
    detail: dict = field(default_factory=dict)


class ScheduleTrace:
    def __init__(self, capacity: int = 4096, tracer=None) -> None:
        self._lock = threading.Lock()
        # deque(maxlen=) evicts O(1); the old list.pop(0) shifted the
        # whole ring every record once full — O(capacity) per decision
        # in a long-lived daemon
        self._events: deque[TraceEvent] = deque(maxlen=capacity)
        self._tracer = tracer

    def record(self, kind: str, gang: str = "", **detail) -> None:
        with self._lock:
            self._events.append(
                TraceEvent(ts=time.time(), kind=kind, gang=gang,
                           detail=detail))
        if self._tracer is not None and gang:
            self._tracer.ingest_schedule_event(kind, gang, detail)

    def events(self, kind: str | None = None) -> list[TraceEvent]:
        with self._lock:
            return [e for e in self._events
                    if kind is None or e.kind == kind]

    def to_json(self) -> str:
        with self._lock:
            return json.dumps([asdict(e) for e in self._events])
