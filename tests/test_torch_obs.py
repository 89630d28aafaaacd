"""The port's observability copies (``kubegpu_tpu_torch.obs``,
``ops/strict.py``) against the JAX package's originals: ``percentiles`` on
seeded values, the cost ledger's largest-remainder apportionment, trace
tokens that cross between the two packages, the Chrome trace export, the
live-byte tracker and the strict-mode fence."""

import json

import numpy as np
import pytest

from kubegpu_tpu.obs import cost as jcost
from kubegpu_tpu.obs import metrics as jmetrics
from kubegpu_tpu.obs import spans as jspans
from kubegpu_tpu.ops import strict as jstrict
from kubegpu_tpu_torch.obs import cost as tcost
from kubegpu_tpu_torch.obs import metrics as tmetrics
from kubegpu_tpu_torch.obs import spans as tspans
from kubegpu_tpu_torch.ops import strict as tstrict


@pytest.mark.parametrize("n", [0, 1, 7, 100, 1024, 5000])
def test_percentiles_match_reference(n):
    rng = np.random.default_rng(n)
    vals = rng.lognormal(0.0, 2.0, n).tolist()
    ps = (50, 90, 99, 99.9)
    assert tmetrics.percentiles(vals, ps) == jmetrics.percentiles(vals, ps)


@pytest.mark.parametrize("seed", range(4))
def test_cost_ledger_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ours, ref = tcost.CostLedger(), jcost.CostLedger()
    for _ in range(50):
        n = int(rng.integers(0, 6))
        entries = [(f"t{int(rng.integers(0, 3))}", int(rng.integers(0, 2)),
                    int(rng.integers(0, 40)) * int(rng.integers(0, 2)))
                   for _ in range(n)]
        ticks = int(rng.integers(0, 9))
        ours.charge(entries, ticks)
        ref.charge(entries, ticks)
    assert ours.as_dict() == ref.as_dict()
    assert ours.busy_chip_ticks == ref.busy_chip_ticks
    assert ours.conserved and ref.conserved
    merged = tcost.CostLedger().merge(ours)
    assert merged.as_dict() == ours.as_dict()


def test_trace_tokens_cross_packages():
    for make, decode in ((jspans.Tracer, tspans.SpanContext.decode),
                         (tspans.Tracer, jspans.SpanContext.decode)):
        sp = make().start_span("crishim.inject")
        ctx = decode(sp.context.encode())
        assert (ctx.trace_id, ctx.span_id) == (sp.trace_id, sp.span_id)
    assert tspans.TRACE_ENV == jspans.TRACE_ENV
    assert tspans.TRACE_ANNOTATION == jspans.TRACE_ANNOTATION
    for junk in (None, "", "abc", ":x", "x:"):
        assert tspans.SpanContext.decode(junk) is None
        assert jspans.SpanContext.decode(junk) is None


def test_chrome_trace_passes_both_validators():
    tr = tspans.Tracer()
    root = tr.start_span("engine.start", attrs={"n_slots": 2})
    with tr.span("engine.tick", parent=root, attrs={"tick": 0}) as tick:
        tr.add_span("engine.collect", tick.t0, tick.t0 + 1e-4, parent=tick)
        tr.instant("request.admit", tick, attrs={"rid": 0, "how": "wave"})
    root.end()
    text = tr.to_chrome_trace()
    for validate in (tspans.validate_chrome_trace,
                     jspans.validate_chrome_trace):
        events = validate(text)
        assert sorted(e["name"] for e in events) == sorted(
            ["engine.start", "engine.tick", "engine.collect",
             "request.admit"])
    assert tr.count("engine.tick") == 1
    assert [s.name for s in tr.span_tree(root.trace_id)[root.span_id]] == [
        "engine.tick"]
    with pytest.raises(ValueError):
        tspans.validate_chrome_trace(json.dumps({"traceEvents": [
            {"ph": "X", "name": "x", "ts": 0}]}))


def test_live_bytes_tracker_matches_reference():
    ours, ref = tmetrics.LiveBytesTracker(), jmetrics.LiveBytesTracker()
    for b in (10, 30, 20, 30):
        ours.sample(b)
        ref.sample(b)
    assert (ours.live, ours.peak, ours.samples) == (ref.live, ref.peak,
                                                    ref.samples)
    # with a registry, both set the same two gauges
    regs = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    trackers = (tmetrics.LiveBytesTracker(regs[0]),
                jmetrics.LiveBytesTracker(regs[1]))
    for b in (10, 30, 20):
        for t in trackers:
            t.sample(b)
    assert regs[0].snapshot() == regs[1].snapshot() == {
        "counters": {}, "histograms": {},
        "gauges": {"serve_hbm_pool_bytes": 20, "serve_hbm_peak_bytes": 30}}


@pytest.mark.parametrize("flag", [None, "0", "1", "yes"])
def test_strict_fallback_matches_reference(monkeypatch, flag):
    assert tstrict.ENV_VAR == jstrict.ENV_VAR
    if flag is None:
        monkeypatch.delenv(tstrict.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(tstrict.ENV_VAR, flag)
    assert tstrict.require_pallas() == jstrict.require_pallas()
    if not jstrict.require_pallas():
        assert tstrict.fallback("p", "why") is None
        assert jstrict.fallback("p", "why") is None
        return
    with pytest.raises(tstrict.StrictFallbackError) as ours:
        tstrict.fallback("llama_serve.continuous", "bucket 100")
    with pytest.raises(jstrict.StrictFallbackError) as ref:
        jstrict.fallback("llama_serve.continuous", "bucket 100")
    assert str(ours.value) == str(ref.value)
