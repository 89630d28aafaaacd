"""The port's request tracing (``ContinuousBatcher(tracer=...,
trace_ctx=...)``) against the JAX package's engine on the same traffic:
the multiset of (span name, parent span name), the attribute keys of each
span and instant name, the instants, parenting under a context decoded
from a propagation token, and equal tokens with the tracer on and off.  The
JAX side runs its Pallas kernels in interpret mode."""

from collections import Counter

import jax
import numpy as np
import pytest

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models.serve import ContinuousBatcher as JaxBatcher
from kubegpu_tpu.obs import spans as jspans
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts
from kubegpu_tpu_torch.obs import spans as tspans

from test_torch_serve_acct import BASE, serve, traffic

CASES = {
    "dense": dict(paged=False),
    "prefix-chunked": dict(paged=True, prefix_cache=True,
                           chunked_prefill=True, prefill_chunk=8),
    "spec2-fused4": dict(paged=True, spec_gamma=2, draft_layers=1,
                         fused_ticks=4),
}


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny(n_heads=4, n_kv_heads=4, max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    cfg = tl.LlamaConfig.tiny(n_heads=4, n_kv_heads=4, max_seq_len=64)
    return cfg_j, params_j, cfg, params_t


def shape(tracer) -> dict:
    """What must match across the two engines: (span, parent span) names,
    each span name's attribute keys, the instants' names and keys."""
    spans = tracer.spans()
    by_id = {s.span_id: s.name for s in spans}
    # a parent outside the tracer is the injected context
    edges = Counter((s.name, by_id.get(s.parent_id,
                                       "ctx" if s.parent_id else None))
                    for s in spans)
    keys = {}
    for s in spans:
        keys.setdefault(s.name, set()).update(s.attrs)
    instants = Counter((name, tuple(sorted(attrs)))
                       for _, name, _, attrs, _ in tracer._instants)
    return {"edges": edges, "keys": keys, "instants": instants}


@pytest.mark.parametrize("case", list(CASES))
def test_spans_match_reference(tiny, case):
    cfg_j, params_j, cfg, params_t = tiny
    kw = dict(BASE, **CASES[case])
    prompts = traffic(cfg.vocab_size)
    # the crishim's token, written by the reference's tracer
    inject = jspans.Tracer().start_span("crishim.inject")
    token = inject.context.encode()
    ours, theirs = tspans.Tracer(), jspans.Tracer()
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", tracer=ours,
                               trace_ctx=tspans.SpanContext.decode(token),
                               **kw)
    ref = JaxBatcher(params_j, cfg_j, tracer=theirs,
                     trace_ctx=jspans.SpanContext.decode(token), **kw)
    got = serve(eng, prompts)
    assert got == serve(ref, prompts)
    # tokens are equal with the tracer off
    plain = ts.ContinuousBatcher(params_t, cfg, device="cpu", **kw)
    assert serve(plain, prompts) == got
    a, b = shape(ours), shape(theirs)
    assert a == b
    assert a["edges"][("request", "engine.start")] == len(prompts)
    assert a["edges"][("engine.start", "ctx")] == 1
    n_ticks = a["edges"][("engine.tick", "engine.start")]
    assert n_ticks == len(eng.stall_ms) > 0
    for child in ("engine.collect", "engine.admit"):
        assert a["edges"][(child, "engine.tick")] == n_ticks
    tick_kind = "engine.verify" if eng.spec_gamma else "engine.dispatch"
    assert a["edges"][(tick_kind, "engine.tick")] == n_ticks
    # every span of the engine lies in the injected trace, its root under
    # the injected span
    assert {s.trace_id for s in ours.spans()} == {inject.trace_id}
    (start,) = ours.spans(name="engine.start")
    assert start.parent_id == inject.span_id
    for req in ours.spans(name="request"):
        assert {"ttft_ms", "queue_wait_ms", "tokens"} <= set(req.attrs)
        assert req.attrs["tokens"] == len(got[req.attrs["rid"]])
    text = ours.to_chrome_trace()
    for validate in (tspans.validate_chrome_trace,
                     jspans.validate_chrome_trace):
        validate(text)
    # the engine's per-request trace state is released at retirement
    assert not (eng._req_spans or eng._submit_ts or eng._first_tok_ts)


def test_tracer_without_context_roots_its_own_trace(tiny):
    """A tracer without an inbound context roots a trace of its own."""
    _, _, cfg, params_t = tiny
    tr = tspans.Tracer()
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", tracer=tr,
                               **dict(BASE, paged=True))
    eng.submit([1, 2, 3], 4)
    eng.drain()
    (start,) = tr.spans(name="engine.start")
    assert start.parent_id == ""
    assert start.attrs == {"n_slots": 3, "paged": True, "tp": 1,
                           "spec_gamma": 0}
    assert tr.count("request") == 1


def test_metrics_registry_still_raises(tiny):
    """``metrics`` takes a registry (``kubegpu_tpu_torch.obs.metrics.
    MetricsRegistry``, ported: ``tests/test_torch_serve_pool.py`` holds
    what it is fed against the JAX engine's); anything else still raises,
    at construction.  A traced engine with a registry gets the request
    spans and the registry's time-to-first-token samples alike."""
    from kubegpu_tpu_torch.obs.metrics import MetricsRegistry
    _, _, cfg, params_t = tiny
    with pytest.raises(AttributeError, match="set_gauge"):
        ts.ContinuousBatcher(params_t, cfg, device="cpu", metrics=object(),
                             **dict(BASE, paged=True))
    tr, reg = tspans.Tracer(), MetricsRegistry()
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", tracer=tr,
                               metrics=reg, **dict(BASE, paged=True))
    for p in ([1, 2, 3], [4, 5, 6, 7]):
        eng.submit(p, 4)
    eng.drain()
    assert tr.count("request") == 2
    assert reg.histogram("serve_ttft_ms").count == 2
    assert reg.gauge("serve_kv_bits") == 16
    assert not (eng._req_spans or eng._submit_ts or eng._first_tok_ts)
