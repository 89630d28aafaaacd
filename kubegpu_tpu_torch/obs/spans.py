"""Cross-layer request tracing (counterpart of ``kubegpu_tpu/obs/spans.py``,
copied whole: it is pure Python).

One request, one trace: a :class:`Tracer` records parent/child spans whose
*propagation token* travels the same road as ``TPU_VISIBLE_CHIPS`` --
extender decision, gang bind (pod annotation), crishim env injection
(``KUBETPU_TRACE_CONTEXT``), the serve pod, the engine -- so a slow request
can be attributed phase by phase: queue wait, admission, each prefill
chunk, each decode or verify tick it rode, TTFT and per-output-token time
as span attributes.

- **Near-free when absent.**  Every instrumented component takes
  ``tracer=None`` and guards each record with a single ``is not None``
  check; tracing never touches device math, so tokens are equal with it
  on and off.
- **Process-local storage, wire-friendly identity.**  Spans live in a
  bounded in-process ring; only the ``trace_id:span_id`` token crosses
  process boundaries (annotation, then env var), like W3C
  ``traceparent``.  The token format is the reference's, so a token its
  :meth:`SpanContext.encode` wrote decodes here and the other way round.
- **Drop-in visualization.**  :meth:`Tracer.to_chrome_trace` exports the
  Chrome/Perfetto trace-event JSON format (``ph:"X"`` complete events in
  µs, instants for point events).

The extender registers each gang's trace root via :meth:`Tracer.link_gang`;
schedule decisions for a linked gang land on that gang's trace as instant
events (:meth:`Tracer.ingest_schedule_event`).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import uuid
from collections import deque

# The road the token travels: the extender writes the annotation at
# bind time (next to ALLOCATE_FROM_KEY), the crishim copies it into the
# container env (next to TPU_VISIBLE_CHIPS), the serve pod decodes the
# env var and parents its engine spans under it.
TRACE_ANNOTATION = "pod.alpha.kubetpu/trace-context"
TRACE_ENV = "KUBETPU_TRACE_CONTEXT"

_SPAN_CAPACITY = 65536
_GANG_LINK_CAP = 4096   # gang → trace-root links kept (FIFO evicted)


class SpanContext:
    """Immutable (trace_id, span_id) pair — the propagation token."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def encode(self) -> str:
        """Wire form, annotation/env-safe: ``trace_id:span_id``."""
        return f"{self.trace_id}:{self.span_id}"

    @classmethod
    def decode(cls, token: str | None) -> "SpanContext | None":
        """Parse a wire token; junk decodes to None (tracing simply
        stays off downstream rather than crashing the pod)."""
        if not token or ":" not in token:
            return None
        trace_id, _, span_id = token.partition(":")
        if not trace_id or not span_id:
            return None
        return cls(trace_id, span_id)

    def __eq__(self, other) -> bool:
        return (isinstance(other, SpanContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id)

    def __repr__(self) -> str:
        return f"SpanContext({self.encode()!r})"


class Span:
    """One timed operation.  Context-manager: ``with tracer.span(...)``
    ends it on exit; or call :meth:`end` explicitly for spans whose
    lifetime crosses function boundaries (request spans)."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "t0", "t1", "attrs", "tid")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: str, t0: float,
                 attrs: dict | None, tid: int):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: float | None = None
        self.attrs = dict(attrs) if attrs else {}
        self.tid = tid

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def end(self, t: float | None = None) -> None:
        if self.t1 is None:
            self.t1 = self._tracer._now() if t is None else t
            self._tracer._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class Tracer:
    """Thread-safe span recorder with bounded memory.

    ``capacity`` bounds BOTH finished spans and instant events (each a
    ``deque(maxlen=...)``) so a long-lived daemon can trace forever;
    eviction drops the oldest spans, which is the right bias for a
    profiler (recent window matters)."""

    def __init__(self, capacity: int = _SPAN_CAPACITY):
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque(maxlen=capacity)
        self._instants: deque[tuple] = deque(maxlen=capacity)
        self._gangs: dict[str, SpanContext] = {}
        # one uuid per tracer + a counter: unique ids at ~ns cost,
        # instead of a uuid4 per span (measurable at tick rate)
        self._prefix = uuid.uuid4().hex[:10]
        self._ctr = itertools.count(1)
        self._tids: dict[int, int] = {}
        # chrome trace ts is absolute µs; anchor perf_counter to wall
        # clock once so separate tracers' exports line up roughly
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()

    # -- time / ids -----------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter()

    def _new_id(self) -> str:
        return f"{self._prefix}{next(self._ctr):x}"

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            return self._tids.setdefault(ident, len(self._tids) + 1)

    # -- span API -------------------------------------------------------

    def start_span(self, name: str,
                   parent: "Span | SpanContext | None" = None,
                   attrs: dict | None = None) -> Span:
        """Start a span.  ``parent=None`` roots a NEW trace; a
        :class:`Span` or decoded :class:`SpanContext` parents into an
        existing one (possibly from another process via the token)."""
        if parent is None:
            trace_id, parent_id = self._new_id(), ""
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        return Span(self, name, trace_id, self._new_id(), parent_id,
                    self._now(), attrs, self._tid())

    def span(self, name: str,
             parent: "Span | SpanContext | None" = None,
             attrs: dict | None = None) -> Span:
        """Alias for :meth:`start_span`; reads naturally as
        ``with tracer.span("engine.tick"):``."""
        return self.start_span(name, parent, attrs)

    def add_span(self, name: str, t0: float, t1: float,
                 parent: "Span | SpanContext | None" = None,
                 attrs: dict | None = None) -> Span:
        """Record an ALREADY-TIMED operation as a finished span.  The
        engine's tick profiler reuses the phase timestamps it measures
        anyway (``t_adm``, stall, dispatch wall) rather than paying a
        context manager per phase per tick."""
        sp = self.start_span(name, parent, attrs)
        sp.t0 = t0
        sp.end(t1)
        return sp

    def instant(self, name: str,
                ctx: "Span | SpanContext | None" = None,
                attrs: dict | None = None) -> None:
        """Record a zero-duration point event (chrome ``ph:"i"``)."""
        trace_id = ctx.trace_id if ctx is not None else ""
        with self._lock:
            self._instants.append(
                (self._now(), name, trace_id,
                 dict(attrs) if attrs else {}, self._tid_locked()))

    def _tid_locked(self) -> int:
        return self._tids.setdefault(threading.get_ident(),
                                     len(self._tids) + 1)

    def _finish(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    # -- finished records across processes -----------------------------

    def take_finished(self) -> tuple[list, list]:
        """Pop every finished span (as a plain tuple) and instant event
        recorded so far: what a tracer in another process (a
        tensor-parallel rank's) hands to the tracer that keeps the
        timeline (:meth:`add_finished`)."""
        with self._lock:
            spans = [(s.name, s.trace_id, s.span_id, s.parent_id, s.t0,
                      s.t1, s.attrs, s.tid) for s in self._spans]
            instants = list(self._instants)
            self._spans.clear()
            self._instants.clear()
        return spans, instants

    def add_finished(self, spans: list, instants: list) -> None:
        """Land what :meth:`take_finished` popped elsewhere, ids, parents
        and times unchanged (``perf_counter`` is the host's monotonic
        clock, one for all its processes)."""
        for name, trace_id, span_id, parent_id, t0, t1, attrs, tid in spans:
            sp = Span(self, name, trace_id, span_id, parent_id, t0, attrs,
                      tid)
            sp.t1 = t1
            self._finish(sp)
        with self._lock:
            self._instants.extend(instants)

    # -- gang linkage (ScheduleTrace → request traces) ------------------

    def link_gang(self, gang: str, ctx: "Span | SpanContext") -> None:
        """Register gang → trace root, so later schedule-trace events
        for that gang land on the request trace."""
        if isinstance(ctx, Span):
            ctx = ctx.context
        with self._lock:
            self._gangs[gang] = ctx
            # bounded like the span deques: gangs churn forever in a
            # long-lived daemon; drop the oldest links past capacity
            while len(self._gangs) > _GANG_LINK_CAP:
                self._gangs.pop(next(iter(self._gangs)))

    def gang_context(self, gang: str) -> SpanContext | None:
        with self._lock:
            return self._gangs.get(gang)

    def ingest_schedule_event(self, kind: str, gang: str,
                              detail: dict) -> None:
        """Sink for :class:`ScheduleTrace` (constructed with
        ``tracer=``): decisions for a linked gang become instant events
        on that gang's trace; unlinked gangs are dropped (they have no
        request trace to join)."""
        ctx = self.gang_context(gang)
        if ctx is None:
            return
        self.instant(f"sched.{kind}", ctx,
                     {"gang": gang, **{k: v for k, v in detail.items()
                                       if isinstance(v, (int, float,
                                                         str, bool))}})

    # -- read side ------------------------------------------------------

    def spans(self, trace_id: str | None = None,
              name: str | None = None) -> list[Span]:
        """Snapshot of FINISHED spans, optionally filtered."""
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def count(self, name: str, trace_id: str | None = None) -> int:
        """Number of FINISHED spans with ``name`` (optionally within
        one trace) — the cheap cardinality check the fused-decode tests
        lean on (one ``engine.tick`` span per fused BLOCK, not per
        device tick) without materializing span lists."""
        with self._lock:
            return sum(1 for s in self._spans
                       if s.name == name
                       and (trace_id is None or s.trace_id == trace_id))

    def trace_ids(self) -> list[str]:
        with self._lock:
            seen: dict[str, None] = {}
            for s in self._spans:
                seen.setdefault(s.trace_id)
        return list(seen)

    def span_tree(self, trace_id: str) -> dict[str, list[Span]]:
        """parent span_id → children, for connectivity checks."""
        tree: dict[str, list[Span]] = {}
        for s in self.spans(trace_id):
            tree.setdefault(s.parent_id, []).append(s)
        return tree

    # -- export ---------------------------------------------------------

    def _ts_us(self, t_perf: float) -> float:
        return (self._wall0 + (t_perf - self._perf0)) * 1e6

    def to_chrome_trace(self, trace_id: str | None = None) -> str:
        """Chrome/Perfetto trace-event JSON: ``ph:"X"`` complete events
        for spans (ts/dur in µs), ``ph:"i"`` for instants; trace/span
        ids ride in ``args`` so the tree is reconstructible from the
        export alone.  Load in chrome://tracing or ui.perfetto.dev."""
        with self._lock:
            spans = list(self._spans)
            instants = list(self._instants)
        events: list[dict] = []
        for s in spans:
            if trace_id is not None and s.trace_id != trace_id:
                continue
            events.append({
                "ph": "X", "name": s.name, "cat": s.name.split(".")[0],
                "ts": self._ts_us(s.t0),
                "dur": max((s.t1 - s.t0) * 1e6, 0.0),
                "pid": 1, "tid": s.tid,
                "args": {"trace_id": s.trace_id, "span_id": s.span_id,
                         "parent_id": s.parent_id, **s.attrs},
            })
        for t, name, tid_trace, attrs, tid in instants:
            if trace_id is not None and tid_trace != trace_id:
                continue
            events.append({
                "ph": "i", "name": name, "cat": name.split(".")[0],
                "ts": self._ts_us(t), "s": "g", "pid": 1, "tid": tid,
                "args": {"trace_id": tid_trace, **attrs},
            })
        events.sort(key=lambda e: e["ts"])
        return json.dumps({"traceEvents": events,
                           "displayTimeUnit": "ms"})


def validate_chrome_trace(text: str) -> list[dict]:
    """Parse + shape-check a chrome trace export (the trace-smoke
    gate): returns the event list or raises ValueError."""
    doc = json.loads(text)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents missing or not a list")
    for e in events:
        if e.get("ph") not in ("X", "i", "B", "E", "M", "C"):
            raise ValueError(f"bad phase {e.get('ph')!r}")
        if not isinstance(e.get("ts"), (int, float)):
            raise ValueError(f"bad ts in {e.get('name')!r}")
        if e["ph"] == "X" and not isinstance(e.get("dur"),
                                             (int, float)):
            raise ValueError(f"X event without dur: {e.get('name')!r}")
        if e["ph"] == "C" and not isinstance(
                (e.get("args") or {}).get("value"), (int, float)):
            raise ValueError(
                f"C event without numeric value: {e.get('name')!r}")
    return events
