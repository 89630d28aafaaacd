"""The port's flight recorder (``kubegpu_tpu_torch/obs/tsdb.py`` and
``obs/alerts.py``) against the JAX package's: a counterpart of each test
of ``tests/test_tsdb.py`` (ring semantics, windowed queries, a series
ENDING at the gauge-delete choke point, the Perfetto counter merge, which
the port's ``validate_chrome_trace`` must accept) and of
``tests/test_alerts.py`` (fast AND slow windows, hysteresis, cooldown,
determinism, the ``FlightRecorder`` controller), each run once through
each package's store, rules, registry and tracer, with the reference's
assertions held on both; what a test records (series, windowed values,
alerts) must be equal in the two packages."""

import json
import types

import pytest

import kubegpu_tpu.obs.alerts as jalerts
import kubegpu_tpu.obs.metrics as jmetrics
import kubegpu_tpu.obs.spans as jspans
import kubegpu_tpu.obs.tsdb as jtsdb
import kubegpu_tpu_torch.obs.alerts as talerts
import kubegpu_tpu_torch.obs.metrics as tmetrics
import kubegpu_tpu_torch.obs.spans as tspans
import kubegpu_tpu_torch.obs.tsdb as ttsdb

PORT = types.SimpleNamespace(alerts=talerts, metrics=tmetrics, spans=tspans,
                             tsdb=ttsdb)
REF = types.SimpleNamespace(alerts=jalerts, metrics=jmetrics, spans=jspans,
                            tsdb=jtsdb)


def _plain(x):
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "__dataclass_fields__"):
        return tuple(getattr(x, f) for f in x.__dataclass_fields__)
    return x


def both(fn):
    """``fn(PORT)`` and ``fn(REF)``: the port's result (alerts as their
    fields) equals the reference's."""
    got, want = fn(PORT), fn(REF)
    assert _plain(got) == _plain(want)
    return got


def store_of(m, **kw):
    reg = m.metrics.MetricsRegistry()
    return reg, m.tsdb.SeriesStore(reg, **kw)


# -- the series store (tests/test_tsdb.py) -------------------------------

def test_capacity_validates():
    def case(m):
        with pytest.raises(ValueError):
            m.tsdb.SeriesStore(m.metrics.MetricsRegistry(), capacity=0)
    both(case)


def test_gauges_sample_verbatim_counters_as_deltas():
    def case(m):
        reg, store = store_of(m)
        for t in range(5):
            reg.set_gauge("allocation_locality", 0.1 * t)
            reg.inc("gangs_scheduled", 2)
            store.sample(t)
        assert store.series("allocation_locality") == [
            (t, pytest.approx(0.1 * t)) for t in range(5)]
        assert store.series("gangs_scheduled") == [
            (t, 2.0) for t in range(5)]
        assert store.latest("gangs_scheduled") == 2.0
        return store.series("allocation_locality")
    both(case)


def test_histogram_percentile_tracks():
    def case(m):
        reg, store = store_of(m)
        for v in (1.0, 2.0, 100.0):
            reg.observe("serve_ttft_ms", v)
        store.sample(0)
        assert {"serve_ttft_ms_p50", "serve_ttft_ms_p99"} \
            <= set(store.names())
        assert store.latest("serve_ttft_ms_p99") >= store.latest(
            "serve_ttft_ms_p50")
        return store.names(), store.latest("serve_ttft_ms_p99")
    both(case)


def test_percentile_tracks_deterministic_at_scale():
    def case(m):
        def drive():
            reg, store = store_of(m)
            for t in range(20):
                for i in range(300):
                    reg.observe("serve_ttft_ms", float((t * 300 + i) % 997))
                store.sample(t)
            return (store.series("serve_ttft_ms_p50"),
                    store.series("serve_ttft_ms_p99"))
        a = drive()
        assert a == drive()
        return a
    both(case)


def test_ring_capacity_bounds_history():
    def case(m):
        reg, store = store_of(m, capacity=8)
        for t in range(100):
            reg.set_gauge("allocation_locality", float(t))
            store.sample(t)
        hist = store.series("allocation_locality")
        assert len(hist) == 8
        assert hist[0] == (92, 92.0) and hist[-1] == (99, 99.0)
        return hist
    both(case)


def test_windowed_queries():
    def case(m):
        reg, store = store_of(m)
        for t in range(10):
            reg.inc("gangs_scheduled", 4 if t >= 6 else 0)
            reg.set_gauge("allocation_locality", float(t))
            store.sample(t)
        got = [store.rate("gangs_scheduled", 8),
               store.rate("gangs_scheduled", 4),
               store.avg("allocation_locality", 4),
               store.max("allocation_locality", 4),
               store.rate("gangs_scheduled", 4, end_tick=5),
               store.max("allocation_locality", 3, end_tick=5)]
        assert got == [pytest.approx(16 / 8), pytest.approx(16 / 4),
                       pytest.approx(7.5), 9.0, 0.0, 5.0]
        assert store.values("nope", 8) == []
        assert store.rate("nope", 8) == store.avg("nope", 8) \
            == store.max("nope", 8) == 0.0
        return got
    both(case)


def test_series_ends_at_gauge_delete_choke_point():
    def case(m):
        reg, store = store_of(m)
        reg.set_gauge("serve_replica_queue_depth_r0", 3.0)
        store.sample(0)
        reg.delete_gauge("serve_replica_queue_depth_r0")
        assert store.ended("serve_replica_queue_depth_r0")
        reg.delete_gauge("serve_replica_queue_depth_r0")
        reg.set_gauge("serve_replica_queue_depth_r0", 99.0)
        store.sample(1)
        assert store.series("serve_replica_queue_depth_r0") == [(0, 3.0)]
    both(case)


def test_delete_of_unknown_gauge_does_not_end_future_series():
    def case(m):
        reg, store = store_of(m)
        reg.delete_gauge("serve_replica_queue_depth_r7")
        reg.set_gauge("serve_replica_queue_depth_r7", 1.0)
        store.sample(0)
        assert store.series("serve_replica_queue_depth_r7") == [(0, 1.0)]
    both(case)


def test_live_bytes_tracker_peak_series_matches_tracker():
    def case(m):
        reg, store = store_of(m)
        hbm = m.metrics.LiveBytesTracker(reg)
        for t, b in enumerate((100, 900, 400, 700)):
            hbm.sample(b)
            store.sample(t)
        peaks = [v for _, v in store.series("serve_hbm_peak_bytes")]
        assert peaks == [100.0, 900.0, 900.0, 900.0]
        assert store.latest("serve_hbm_peak_bytes") == hbm.peak
        assert store.max("serve_hbm_pool_bytes", 4) == 900.0
        return store.series("serve_hbm_pool_bytes")
    both(case)


def test_counter_events_merge_into_chrome_trace():
    def case(m):
        reg, store = store_of(m)
        for t in range(3):
            reg.set_gauge("allocation_locality", float(t))
            store.sample(t)
        tracer = m.spans.Tracer()
        with tracer.span("engine.tick"):
            pass
        merged = store.merge_chrome_trace(tracer.to_chrome_trace())
        events = m.spans.validate_chrome_trace(merged)
        cs = [e for e in events if e["ph"] == "C"]
        assert len(cs) == 3
        span_ts = min(e["ts"] for e in events if e["ph"] != "C")
        assert min(e["ts"] for e in cs) == span_ts
        ts = [e["ts"] for e in events]
        assert ts == sorted(ts)
        assert all(isinstance(e["args"]["value"], float) for e in cs)
        return [(e["name"], e["ts"] - span_ts, e["args"]) for e in cs]
    both(case)
    # the port's tracer export merged by the port's store passes both
    # packages' validators
    reg, store = store_of(PORT)
    reg.set_gauge("allocation_locality", 1.0)
    store.sample(0)
    tracer = tspans.Tracer()
    with tracer.span("engine.tick"):
        pass
    merged = store.merge_chrome_trace(tracer.to_chrome_trace())
    assert (tspans.validate_chrome_trace(merged)
            == jspans.validate_chrome_trace(merged))


def test_merge_rejects_bad_trace_doc():
    def case(m):
        store = m.tsdb.SeriesStore(m.metrics.MetricsRegistry())
        with pytest.raises(ValueError):
            store.merge_chrome_trace(json.dumps({"traceEvents": "nope"}))
    both(case)


def test_sample_without_registry_raises():
    def case(m):
        with pytest.raises(ValueError):
            m.tsdb.SeriesStore().sample(0)
    both(case)


# -- burn-rate alerts (tests/test_alerts.py) -----------------------------

def _drive(engine, reg, store, ticks, failovers=()):
    fired = []
    for t in range(ticks):
        if t in failovers:
            reg.inc("serve_failover_total", 16)
        store.sample(t)
        fired.extend(engine.evaluate(t))
    return fired


def _rule(m, **kw):
    kw.setdefault("name", "alert_failover_burn")
    kw.setdefault("series", "serve_failover_total")
    return m.alerts.AlertRule(**kw)


def test_rule_validation():
    def case(m):
        for kw in ({"kind": "bogus"}, {"fast_window": 64, "slow_window": 8},
                   {"fast_window": 0}):
            with pytest.raises(ValueError):
                m.alerts.AlertRule(name="x", series="s", **kw)
    both(case)


def test_healthy_run_fires_nothing():
    def case(m):
        reg, store = store_of(m)
        engine = m.alerts.AlertEngine(store, metrics=reg)
        assert _drive(engine, reg, store, 100) == []
        assert list(engine.alerts) == []
    both(case)


def test_failover_burst_pages_within_bound():
    def case(m):
        reg, store = store_of(m)
        engine = m.alerts.AlertEngine(store, metrics=reg)
        fired = _drive(engine, reg, store, 60, failovers={20})
        assert fired, "burst never paged"
        a = fired[0]
        assert a.rule == "alert_failover_burn" and a.tick - 20 <= 16
        assert a.fast > a.slow > 0
        assert reg.snapshot()["counters"]["serve_alerts_fired"] \
            == len(fired)
        return fired
    both(case)


def test_both_windows_must_breach():
    def case(m):
        reg, store = store_of(m)
        engine = m.alerts.AlertEngine(store, metrics=reg)
        assert _drive(engine, reg, store, 60) == []
        reg, store = store_of(m)
        engine = m.alerts.AlertEngine(store, metrics=reg)
        fired = []
        for t in range(60):
            if t == 20:
                reg.inc("serve_failover_total", 1)
            store.sample(t)
            fired.extend(engine.evaluate(t))
        assert fired == []
    both(case)


def test_hold_ticks_hysteresis():
    def case(m):
        rule = _rule(m, fast_window=2, slow_window=4, fast_threshold=4.0,
                     slow_threshold=0.5, hold_ticks=3)
        reg, store = store_of(m)
        engine = m.alerts.AlertEngine(store, rules=[rule], metrics=reg)
        fired = []
        for t in range(10):
            if t == 2:
                reg.inc("serve_failover_total", 10)
            store.sample(t)
            fired.extend(engine.evaluate(t))
        assert fired == []
    both(case)


def test_cooldown_suppresses_refires():
    def case(m):
        rule = _rule(m, fast_window=2, slow_window=4, fast_threshold=0.5,
                     slow_threshold=0.25, hold_ticks=1, cooldown_ticks=20)
        reg, store = store_of(m)
        engine = m.alerts.AlertEngine(store, rules=[rule], metrics=reg)
        fired = []
        for t in range(30):
            reg.inc("serve_failover_total", 5)
            store.sample(t)
            fired.extend(engine.evaluate(t))
        assert len(fired) == 2 and fired[1].tick - fired[0].tick >= 20
        return fired
    both(case)


def test_burn_rule_measures_objective_shortfall():
    def case(m):
        rule = _rule(m, name="alert_slo_burn",
                     series="serve_slo_attainment", kind=m.alerts.BURN,
                     objective=0.95, fast_window=4, slow_window=8,
                     fast_threshold=0.3, slow_threshold=0.2, hold_ticks=2)
        reg, store = store_of(m)
        engine = m.alerts.AlertEngine(store, rules=[rule], metrics=reg)
        fired = []
        for t in range(30):
            reg.set_gauge("serve_slo_attainment", 1.0 if t < 10 else 0.5)
            store.sample(t)
            fired.extend(engine.evaluate(t))
        assert fired and fired[0].rule == "alert_slo_burn"
        assert fired[0].tick >= 11
        empty = m.alerts.AlertEngine(
            m.tsdb.SeriesStore(m.metrics.MetricsRegistry()), rules=[rule])
        assert empty._measure(rule) == (0.0, 0.0)
        return fired
    both(case)


def test_alert_records_are_deterministic():
    def case(m):
        def once():
            reg, store = store_of(m)
            engine = m.alerts.AlertEngine(store, metrics=reg)
            return _drive(engine, reg, store, 80, failovers={20, 60})
        a = once()
        assert a == once()
        assert all(isinstance(x, m.alerts.Alert) for x in a)
        return a
    both(case)


def test_default_rules_cover_documented_names():
    def case(m):
        docs = m.metrics.documented_names()["metrics"]
        for rule in m.alerts.default_rules():
            assert rule.name in docs, rule.name
            assert rule.series in docs, rule.series
        return list(m.alerts.default_rules())
    both(case)


def test_alert_log_bounded():
    def case(m):
        rule = _rule(m, fast_window=1, slow_window=1, fast_threshold=0.5,
                     slow_threshold=0.5, hold_ticks=1, cooldown_ticks=0)
        reg, store = store_of(m)
        engine = m.alerts.AlertEngine(store, rules=[rule], metrics=reg,
                                      capacity=16)
        for t in range(100):
            reg.inc("serve_failover_total", 5)
            store.sample(t)
            engine.evaluate(t)
        assert len(engine.alerts) == 16
        return list(engine.alerts)
    both(case)


def test_flight_recorder_controller_contract():
    def case(m):
        reg = m.metrics.MetricsRegistry()
        tracer = m.spans.Tracer()
        inner_calls = []
        rec = m.alerts.FlightRecorder(
            reg, tracer=tracer, inner=lambda t, s: inner_calls.append(t))
        for t in range(40):
            if t == 20:
                reg.inc("serve_failover_total", 16)
            rec(t, {"attainment": 1.0})
        assert inner_calls == list(range(40))
        assert rec.alert_log() == [(21, "alert_failover_burn")]
        assert rec.ticks == 40 and rec.overhead_per_tick_s > 0.0
        assert reg.snapshot()["gauges"]["serve_slo_attainment"] == 1.0
        assert "alert.fired" in tracer.to_chrome_trace()
        m.spans.validate_chrome_trace(rec.store.merge_chrome_trace(
            tracer.to_chrome_trace()))
        return rec.alert_log(), rec.store.names()
    both(case)
