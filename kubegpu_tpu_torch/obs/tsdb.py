"""Bounded in-memory time-series store: the fleet's FLIGHT RECORDER
(counterpart of ``kubegpu_tpu/obs/tsdb.py``, copied: it is pure Python).

A ``MetricsRegistry`` snapshot holds the CURRENT counters and gauges, and
a ``Tracer`` export the span timeline; neither answers "what did
``serve_failover_total`` do over the last 8 ticks", which is the question
burn-rate alerting (:mod:`.alerts`) asks.  :class:`SeriesStore` does:

- :meth:`sample` snapshots a registry at an ENGINE TICK into
  fixed-capacity per-series rings: gauges verbatim, counters as PER-TICK
  DELTAS (so windowed sums are rates), histograms as their ``_p50``/
  ``_p99`` percentile tracks.  Tick-indexed and free of the wall clock:
  two runs of one seed give identical series.
- Windowed queries (:meth:`rate`, :meth:`avg`, :meth:`max` over the
  trailing ``window`` ticks) are what the alert engine evaluates.
- Series END with their instance: the store registers a gauge-delete hook
  on the registry, so when the pool's dead-replica harvest deletes
  ``serve_replica_queue_depth_r<i>`` the matching series is closed (no
  further points) instead of flat-lining at its last value.
- :meth:`merge_chrome_trace` exports every series as Perfetto COUNTER
  tracks (``ph:"C"``) merged into a ``Tracer.to_chrome_trace`` JSON, so
  one fleet run renders as a single flame and counter timeline.
"""
from __future__ import annotations

import json
from collections import deque

__all__ = ["SeriesStore"]

#: default ring capacity per series — at one sample per engine tick a
#: smoke run fits whole; a long-lived daemon keeps the trailing window
DEFAULT_CAPACITY = 4096


class SeriesStore:
    """Per-series bounded rings of ``(tick, value)`` keyed by metric
    name, fed by :meth:`sample` from one :class:`MetricsRegistry`."""

    def __init__(self, registry=None, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.registry = registry
        self.capacity = int(capacity)
        self._series: dict[str, deque] = {}
        self._last_counters: dict[str, float] = {}
        self._ended: set[str] = set()
        self.samples = 0
        if registry is not None and hasattr(registry,
                                            "add_gauge_delete_hook"):
            registry.add_gauge_delete_hook(self._on_gauge_delete)

    # -- ingest ---------------------------------------------------------

    def _on_gauge_delete(self, name: str) -> None:
        """Registry callback at the dead-instance choke point: the
        gauge is gone from the scrape surface, so its series is CLOSED
        — it keeps its history but takes no further points."""
        if name in self._series:
            self._ended.add(name)

    def _push(self, name: str, tick: int, value: float) -> None:
        if name in self._ended:
            return
        ring = self._series.get(name)
        if ring is None:
            ring = self._series[name] = deque(maxlen=self.capacity)
        ring.append((tick, float(value)))

    def sample(self, tick: int) -> None:
        """Snapshot the registry at ``tick``: gauges as-is, counters
        as deltas since the previous sample, histograms as p50/p99
        tracks.  Idempotence is NOT assumed — call once per tick.

        This is the recorder's per-tick hot path, so the push loop is
        inlined rather than routed through :meth:`_push`."""
        if self.registry is None:
            raise ValueError("SeriesStore built without a registry")
        tick = int(tick)
        snap = self.registry.snapshot()
        series, ended, cap = self._series, self._ended, self.capacity
        for name, v in snap["gauges"].items():
            if name in ended:
                continue
            ring = series.get(name)
            if ring is None:
                ring = series[name] = deque(maxlen=cap)
            ring.append((tick, float(v)))
        if snap["counters"]:
            last_c = self._last_counters
            for name, v in snap["counters"].items():
                last = last_c.get(name, 0.0)
                last_c[name] = v
                self._push(name, tick, v - last)
        for name, h in snap["histograms"].items():
            self._push(name + "_p50", tick, h["p50"])
            self._push(name + "_p99", tick, h["p99"])
        self.samples += 1

    # -- read side ------------------------------------------------------

    def names(self) -> list[str]:
        return sorted(self._series)

    def ended(self, name: str) -> bool:
        return name in self._ended

    def series(self, name: str) -> list[tuple[int, float]]:
        """Full retained ``(tick, value)`` history for one series."""
        return list(self._series.get(name, ()))

    def latest(self, name: str) -> float:
        ring = self._series.get(name)
        return ring[-1][1] if ring else 0.0

    def values(self, name: str, window: int,
               end_tick: int | None = None) -> list[float]:
        """Values in the trailing ``(end - window, end]`` tick window
        (``end`` defaults to the series' newest tick)."""
        ring = self._series.get(name)
        if not ring:
            return []
        end = ring[-1][0] if end_tick is None else int(end_tick)
        lo = end - int(window)
        # ticks are appended in increasing order, so walk from the
        # right and stop at the window edge — O(window), not O(ring)
        out = []
        for t, v in reversed(ring):
            if t > end:
                continue
            if t <= lo:
                break
            out.append(v)
        out.reverse()
        return out

    def rate(self, name: str, window: int,
             end_tick: int | None = None) -> float:
        """Windowed per-tick rate: sum over window / window.  On a
        counter series (stored as deltas) this is the counter's rate;
        on a gauge it is a windowed mean-ish flow."""
        w = max(1, int(window))
        return sum(self.values(name, w, end_tick)) / w

    def avg(self, name: str, window: int,
            end_tick: int | None = None) -> float:
        vals = self.values(name, window, end_tick)
        return sum(vals) / len(vals) if vals else 0.0

    def max(self, name: str, window: int,
            end_tick: int | None = None) -> float:
        vals = self.values(name, window, end_tick)
        return max(vals) if vals else 0.0

    # -- Perfetto export ------------------------------------------------

    def to_counter_events(self, anchor_us: float = 0.0,
                          tick_us: float = 1000.0,
                          pid: int = 1) -> list[dict]:
        """Every series as chrome/Perfetto ``ph:"C"`` counter events,
        one per sample, ticks mapped to ``anchor_us + tick*tick_us``."""
        events: list[dict] = []
        for name in sorted(self._series):
            for t, v in self._series[name]:
                events.append({
                    "ph": "C", "name": name, "pid": pid, "tid": 0,
                    "ts": anchor_us + t * tick_us,
                    "args": {"value": v},
                })
        return events

    def merge_chrome_trace(self, trace_json: str,
                           tick_us: float = 1000.0) -> str:
        """Merge the counter tracks into a ``Tracer.to_chrome_trace``
        export: counters anchor at the earliest span timestamp (so the
        flame and counter timelines line up), events re-sort by ts,
        and the result stays a valid chrome trace
        (``validate_chrome_trace`` accepts ``ph:"C"``)."""
        doc = json.loads(trace_json)
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("traceEvents missing or not a list")
        anchor = min((e["ts"] for e in events
                      if isinstance(e.get("ts"), (int, float))),
                     default=0.0)
        events.extend(self.to_counter_events(anchor_us=anchor,
                                             tick_us=tick_us))
        events.sort(key=lambda e: e.get("ts", 0.0))
        doc["traceEvents"] = events
        return json.dumps(doc)
