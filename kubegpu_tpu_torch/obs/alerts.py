"""Multi-window burn-rate alerting over the flight recorder (counterpart
of ``kubegpu_tpu/obs/alerts.py``, copied: it is pure Python).

The SRE-workbook shape, tick-denominated: an :class:`AlertRule` pairs a
FAST window (default 8 ticks: catches a cliff quickly) with a SLOW window
(default 64 ticks: suppresses blips), and fires only when BOTH breach,
with hysteresis (``hold_ticks`` consecutive breaching evaluations) and a
per-rule cooldown, so one sustained incident is one alert, not one per
tick.  Rules are evaluated each tick from a
:class:`~kubegpu_tpu_torch.obs.tsdb.SeriesStore`: METRICS ONLY, no peek
at the injector, so a ``DomainChaosInjector`` domain kill must be
detected from the series within a bounded tick count while the
fault-free twin fires no alert.

Determinism: windows, thresholds and series are all tick-indexed, so the
fired-alert list is a pure function of the seed: two runs of one trace
give identical ``(tick, rule)`` sequences.

ALERT TABLE (the default rule set):

======================  ====  ========================================
rule                    kind  fires when (fast AND slow windows)
======================  ====  ========================================
``alert_failover_burn``  rate  ``serve_failover_total`` deltas exceed
                               0.25/tick over 8 ticks and 0.02/tick
                               over 64: correlated replica loss
                               (a domain kill trips this in ~2 ticks)
``alert_shed_burn``      rate  ``serve_requests_shed`` deltas exceed
                               0.5/tick fast and 0.1/tick slow:
                               sustained admission-control pressure
``alert_slo_burn``       burn  ``serve_slo_attainment`` burn
                               (objective - windowed mean, objective
                               0.95) exceeds 0.35 fast and 0.15 slow:
                               the error budget is burning
======================  ====  ========================================

:class:`FlightRecorder` is the wiring: a ``controller(tick, stats)``
callable (the hook :func:`kubegpu_tpu_torch.loadgen.run_load` and
:func:`kubegpu_tpu_torch.fleet.run_fleet` expose) that refreshes the
attainment gauge, samples the store and evaluates the rules, so recording
and alerting bolt onto either run loop unchanged, and the outcomes are
the same with it on or off (it only READS the run).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

from kubegpu_tpu_torch.obs.tsdb import SeriesStore

__all__ = ["AlertRule", "Alert", "AlertEngine", "FlightRecorder",
           "default_rules"]

RATE = "rate"    # windowed per-tick rate of a (delta) series
BURN = "burn"    # objective minus windowed mean of a ratio series
KINDS = (RATE, BURN)


@dataclass(frozen=True)
class AlertRule:
    """One multi-window rule.  ``kind=RATE`` measures
    ``rate(series, window)`` (counter-delta series ⇒ events/tick);
    ``kind=BURN`` measures ``max(0, objective − avg(series, window))``
    — and an EMPTY window measures 0 (no data is not an incident)."""
    name: str
    series: str
    kind: str = RATE
    objective: float = 1.0          # BURN only
    fast_window: int = 8
    slow_window: int = 64
    fast_threshold: float = 0.25
    slow_threshold: float = 0.05
    hold_ticks: int = 2             # consecutive breaches before firing
    cooldown_ticks: int = 32        # re-fire lockout after an alert

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown alert kind {self.kind!r}")
        if self.fast_window < 1 or self.slow_window < self.fast_window:
            raise ValueError(
                f"windows must satisfy 1 <= fast <= slow, got "
                f"{self.fast_window}/{self.slow_window}")


@dataclass(frozen=True)
class Alert:
    """One fired alert — deterministic: (tick, rule) sequences are
    identical run to run for a fixed seed."""
    tick: int
    rule: str
    series: str
    fast: float
    slow: float


def default_rules() -> tuple[AlertRule, ...]:
    """The stock rule set of the ALERT TABLE above."""
    return (
        AlertRule(name="alert_failover_burn",
                  series="serve_failover_total", kind=RATE,
                  fast_threshold=0.25, slow_threshold=0.02),
        AlertRule(name="alert_shed_burn",
                  series="serve_requests_shed", kind=RATE,
                  fast_threshold=0.5, slow_threshold=0.1),
        AlertRule(name="alert_slo_burn",
                  series="serve_slo_attainment", kind=BURN,
                  objective=0.95,
                  fast_threshold=0.35, slow_threshold=0.15),
    )


class AlertEngine:
    """Evaluate a rule set each tick against a
    :class:`SeriesStore`; fired alerts append to :attr:`alerts`,
    count on ``serve_alerts_fired``, and mark the trace with an
    ``alert.fired`` instant so incidents land on the same timeline as
    the spans and counter tracks."""

    def __init__(self, store: SeriesStore, rules=None, metrics=None,
                 tracer=None, capacity: int = 4096):
        self.store = store
        self.rules = tuple(rules) if rules is not None \
            else default_rules()
        self.metrics = metrics
        self.tracer = tracer
        # cooldown bounds the fire RATE; capacity bounds the log in a
        # long-lived daemon (a smoke run never comes near either)
        self.alerts: deque[Alert] = deque(maxlen=int(capacity))
        self._streak: dict[str, int] = {}
        self._cooldown_until: dict[str, int] = {}

    def _measure(self, rule: AlertRule) -> tuple[float, float]:
        if rule.kind == RATE:
            return (self.store.rate(rule.series, rule.fast_window),
                    self.store.rate(rule.series, rule.slow_window))
        out = []
        for w in (rule.fast_window, rule.slow_window):
            vals = self.store.values(rule.series, w)
            out.append(max(0.0, rule.objective - sum(vals) / len(vals))
                       if vals else 0.0)
        return out[0], out[1]

    def evaluate(self, tick: int) -> list[Alert]:
        """One evaluation pass; returns the alerts fired THIS tick."""
        tick = int(tick)
        fired: list[Alert] = []
        for rule in self.rules:
            fast, slow = self._measure(rule)
            breach = (fast > rule.fast_threshold
                      and slow > rule.slow_threshold)
            streak = self._streak.get(rule.name, 0) + 1 if breach else 0
            self._streak[rule.name] = streak
            if not breach or streak < rule.hold_ticks:
                continue
            if tick < self._cooldown_until.get(rule.name, -1 << 62):
                continue
            alert = Alert(tick=tick, rule=rule.name,
                          series=rule.series, fast=fast, slow=slow)
            self.alerts.append(alert)
            fired.append(alert)
         
            self._cooldown_until[rule.name] = tick + rule.cooldown_ticks
            if self.metrics is not None:
                self.metrics.inc("serve_alerts_fired")
            if self.tracer is not None:
                self.tracer.instant("alert.fired", attrs={
                    "rule": rule.name, "series": rule.series,
                    "tick": tick, "fast": round(fast, 4),
                    "slow": round(slow, 4)})
        return fired


class FlightRecorder:
    """Controller-shaped recorder: ``recorder(tick, stats)`` plugs
    straight into ``run_load``/``run_fleet``'s ``controller=`` seam
    (chain an existing controller via ``inner=``).  Each tick it sets
    the running ``serve_slo_attainment`` gauge from the run loop's
    stats, samples the registry into the store, and evaluates the
    alert rules.  ``obs_wall_s`` accumulates the recorder's own wall
    cost (its overhead a tick: :attr:`overhead_per_tick_s`)."""

    def __init__(self, metrics, rules=None, tracer=None,
                 capacity: int = 4096, inner=None):
        self.metrics = metrics
        self.store = SeriesStore(metrics, capacity=capacity)
        self.alert_engine = AlertEngine(self.store, rules=rules,
                                        metrics=metrics, tracer=tracer,
                                        capacity=capacity)
        self.inner = inner
        self.ticks = 0
        self.obs_wall_s = 0.0

    @property
    def alerts(self) -> list[Alert]:
        return list(self.alert_engine.alerts)

    def alert_log(self) -> list[tuple[int, str]]:
        """The determinism digest two twin runs must agree on."""
        return [(a.tick, a.rule) for a in self.alerts]

    def __call__(self, tick: int, stats: dict) -> None:
        if self.inner is not None:
            self.inner(tick, stats)
        t0 = time.perf_counter()
        att = stats.get("attainment")
        if att is not None:
            self.metrics.set_gauge("serve_slo_attainment", float(att))
        self.store.sample(tick)
        self.alert_engine.evaluate(tick)
        self.ticks += 1
        self.obs_wall_s += time.perf_counter() - t0

    @property
    def overhead_per_tick_s(self) -> float:
        return self.obs_wall_s / self.ticks if self.ticks else 0.0

