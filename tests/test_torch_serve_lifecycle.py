"""The port's single-engine request lifecycle against the JAX package's
engine, scenario by scenario (the single-engine cases of
``tests/test_serve_chaos.py``): dispatch failures retried in place, NaN
quarantine and its bit-exact replay (K = 1 and mid fused block), the retry
bound, replica death, the watchdog, deadlines (wall clock and ticks),
``cancel``, sheds, the drain diagnosis, tier preemption with its resume, the
tier-strict queue under seeded overload, and tenant quotas.

Each scenario runs on both engines with the same chaos schedule (each
package's own ``ChaosInjector``): the requests' tokens and errors, the
lifecycle counters and ``shed_by_reason`` must be EQUAL, and the tokens of
every request that did not fail must equal the port's solo
``greedy_generate``.  The JAX side runs its Pallas kernels in interpret
mode."""

import jax
import numpy as np
import pytest
import torch

from kubegpu_tpu.loadgen import LoadSpec, TierSpec, synth_trace
from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models.serve import ContinuousBatcher as JaxBatcher
from kubegpu_tpu.obs import chaos as jchaos
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts
from kubegpu_tpu_torch.obs import chaos as tchaos
from kubegpu_tpu_torch.obs.spans import Tracer

BASE = dict(n_slots=2, stride=2, prompt_buckets=(8, 16), paged=True,
            page_size=8)
COUNTERS = ("slots_quarantined", "requests_retried", "requests_shed",
            "dispatch_failures", "requests_preempted", "requests_resumed",
            "deadline_misses", "shed_by_reason")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the tier-1 run puts six test
    processes on the host's cores, and torch's default of a thread a core
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny(max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(max_seq_len=64), params_t


def solo(tiny, prompt, n):
    _, _, cfg, params_t = tiny
    return td.greedy_generate(params_t, np.asarray(prompt)[None], n, cfg,
                              device="cpu")[0].tolist()


def engines(tiny, events=(), **kw):
    """(the port's engine, the reference's), each with its own package's
    injector over the same ``(tick, kind, stall_s)`` events."""
    cfg_j, params_j, cfg, params_t = tiny
    kw = {**BASE, **kw}

    def inj(mod):
        return (mod.ChaosInjector([mod.ChaosEvent(tick=t, kind=k, stall_s=s)
                                   for t, k, s in events])
                if events else None)

    port = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                chaos=inj(tchaos), **kw)
    ref = JaxBatcher(params_j, cfg_j, chaos=inj(jchaos), **kw)
    return port, ref


def record(eng, done) -> dict:
    """What must agree: every returned request's tokens and error, in
    return order, and the lifecycle counters."""
    out = {"done": [(r.rid, list(r.tokens), r.error) for r in done]}
    out.update({c: getattr(eng, c) for c in COUNTERS})
    return out


def both(tiny, scenario, events=(), **kw):
    """Run ``scenario(engine, errors)`` on both engines (``errors``: the
    package's chaos module) and assert equal records; returns the port's
    record and engine."""
    port, ref = engines(tiny, events, **kw)
    got = scenario(port, tchaos)
    want = scenario(ref, jchaos)
    assert record(port, got) == record(ref, want)
    return {r.rid: r for r in got}, port


def prompts2(vocab):
    return [([(i * 3 + 1) % vocab for i in range(5)], 8),
            ([(i * 5 + 2) % vocab for i in range(7)], 8)]


def submit_drain(prompts, **sub):
    def scenario(eng, _):
        for p, n in prompts:
            eng.submit(p, n, **sub)
        return eng.drain()
    return scenario


def assert_solo(tiny, done, prompts):
    for rid, (p, n) in enumerate(prompts):
        assert done[rid].error is None, (rid, done[rid].error)
        assert done[rid].tokens == solo(tiny, p, n), rid


def test_dispatch_failure_retried_in_place(tiny):
    done, eng = both(tiny, submit_drain([([1, 2, 3], 6)]),
                     events=[(1, "fail_dispatch", 0.0)])
    assert_solo(tiny, done, [([1, 2, 3], 6)])
    assert eng.dispatch_failures == 1


@pytest.mark.parametrize("kw", [{}, dict(fused_ticks=4), dict(kv_bits=8),
                                dict(kv_bits=4), dict(paged=False)],
                         ids=["bf16", "fused4", "int8", "int4", "dense"])
def test_nan_quarantine_replays_bit_exact(tiny, kw):
    """A poisoned slot (its first decode page's ``k``, or ``k_scale`` on
    int8 and int4 pages; the dense engine's cache row) is quarantined and
    its request replayed to the fault-free run's tokens; the neighbour
    never notices.  Fused: the poison lands on an inner tick of a block of
    4 (20 new tokens a request, so several blocks run before the event).
    On int8 and int4 pages the replay's prefill quantizes the accepted
    tokens' K/V from prefill activations, not from the decode steps', so
    the replayed tokens may part from the fault-free run's: there the
    check is equality with the reference's replay (``both``)."""
    n = 20 if kw.get("fused_ticks") else 8
    prompts = [(p, n) for p, _ in prompts2(tiny[2].vocab_size)]
    done, eng = both(tiny, submit_drain(prompts),
                     events=[(2, "nan_logits", 0.0)], **kw)
    if not kw.get("kv_bits"):
        assert_solo(tiny, done, prompts)
    assert (eng.slots_quarantined, eng.requests_retried) == (1, 1)
    if kw.get("fused_ticks"):
        assert eng.fused_dispatches > 1
    eng.check_page_invariants()


def test_retry_bound_fails_gracefully(tiny):
    """``max_retries=0``: the first quarantine fails its request (partial
    tokens kept) and the engine serves the other to the end."""
    prompts = prompts2(tiny[2].vocab_size)
    done, _ = both(tiny, submit_drain(prompts), max_retries=0,
                   events=[(2, "nan_logits", 0.0)])
    failed = [r for r in done.values() if r.error is not None]
    exact = [r for r in done.values() if r.error is None]
    assert len(failed) == 1 and "retries" in failed[0].error
    assert len(exact) == 1
    assert exact[0].tokens == solo(tiny, *prompts[exact[0].rid])


def test_kill_marks_dead_and_reraises(tiny):
    def scenario(eng, errs):
        eng.submit([1, 2, 3], 6)
        with pytest.raises(errs.ReplicaDeadError):
            eng.drain()
        assert eng.dead is not None
        assert eng.slot_req or eng.queue    # kept for a failover
        with pytest.raises(errs.ReplicaDeadError):
            eng.step()
        return eng.take_orphans()

    both(tiny, scenario, events=[(1, "kill_replica", 0.0)])


def test_watchdog_declares_stall(tiny):
    def scenario(eng, errs):
        eng.warmup()
        eng.submit([1, 2, 3], 6)
        with pytest.raises(errs.TickStallError):
            eng.drain()
        assert "watchdog" in eng.dead
        return []

    both(tiny, scenario, tick_deadline_s=0.2,
         events=[(1, "stall_tick", 0.5)])


def test_deadline_cancels_with_partial_tokens(tiny):
    def scenario(eng, _):
        eng.submit([1, 2, 3], 6, deadline_s=0.0)
        eng.submit([4, 5, 6], 6)
        return eng.drain()

    done, eng = both(tiny, scenario)
    assert done[0].error == "deadline exceeded" and done[0].tokens == []
    assert done[1].error is None
    assert done[1].tokens == solo(tiny, [4, 5, 6], 6)
    assert eng.shed_by_reason == {"deadline": 1}


def test_cancel_api(tiny):
    def scenario(eng, _):
        r1 = eng.submit([1, 2, 3], 6)
        r2 = eng.submit([4, 5, 6], 6)    # queued behind the one slot
        eng.step()
        canceled = eng.cancel(r2, "user canceled")
        assert canceled is not None and canceled.error == "user canceled"
        assert eng.cancel(12345) is None
        done = eng.drain()
        assert [r.rid for r in done] == [r1]
        return [canceled] + done

    done, _ = both(tiny, scenario, n_slots=1)
    assert done[0].tokens == solo(tiny, [1, 2, 3], 6)
    assert done[1].tokens == []


def test_cancel_resident_and_chunk_prefilling(tiny):
    """Cancelling a decoding slot keeps its partial tokens and frees its
    pages; cancelling a slot in the middle of its chunked prefill drops
    its chunks; the survivor's tokens are the solo ones."""
    vocab = tiny[2].vocab_size
    long_p = [(i * 7 + 3) % vocab for i in range(14)]

    def scenario(eng, _):
        a = eng.submit([1, 2, 3], 9)
        b = eng.submit(long_p, 6)        # 14 > 8: two chunks
        c = eng.submit([4, 5, 6, 7], 5)
        eng.step()
        eng.step()
        out = [eng.cancel(a, "user canceled"), eng.cancel(b, "gone")]
        assert out[1].tokens == []
        out += eng.drain()
        eng.check_page_invariants()
        assert c in [r.rid for r in out]
        return out

    done, eng = both(tiny, scenario, n_slots=3, chunked_prefill=True,
                     prefill_chunk=8)
    assert 0 < len(done[0].tokens) < 9 and done[0].error == "user canceled"
    assert done[2].tokens == solo(tiny, [4, 5, 6, 7], 5)
    assert sorted(eng._free_pages) == list(range(1, eng.total_pages + 1))


def test_replay_exceeding_bucket_is_shed(tiny):
    """A replay whose prompt + accepted tokens pass the largest bucket
    fails loudly (a shed), never parks at the queue front."""
    done, eng = both(tiny, submit_drain([([1, 2, 3, 4, 5], 10)]),
                     prompt_buckets=(8,),
                     events=[(2, "nan_logits", 0.0)])
    assert "bucket" in done[0].error
    assert eng.requests_shed == 1


def test_drain_diagnostic_lists_stuck_work(tiny):
    def scenario(eng, _):
        eng.submit([1, 2, 3], 30)
        eng.submit([4, 5, 6], 30)
        with pytest.raises(RuntimeError) as ei:
            eng.drain(max_ticks=2)
        msg = str(ei.value)
        assert "stuck work" in msg and "slot 0" in msg and "rid=0" in msg
        assert "queued rid=1" in msg
        return [ts._Request(rid=-1, prompt_len=0, max_new_tokens=0,
                            error=msg)]

    both(tiny, scenario, n_slots=1)


def low_high(vocab):
    low = [([(i * 3 + j) % vocab for i in range(4 + j)], 8)
           for j in range(2)]
    return low, ([(i * 5 + 7) % vocab for i in range(5)], 6)


def test_preempt_resume_is_bit_exact(tiny):
    """Tier-2 requests decode; a tier-0 request arrives and preempts one;
    the parked request resumes through its replay with the tokens of an
    unpreempted run."""
    low, (p_hi, n_hi) = low_high(tiny[2].vocab_size)

    def scenario(eng, _):
        for p, n in low:
            eng.submit(p, n, tier=2)
        out = []
        for _ in range(3):
            out += eng.step()
        eng.submit(p_hi, n_hi, tier=0)
        return out + eng.drain()

    done, eng = both(tiny, scenario, total_pages=12)
    assert_solo(tiny, done, low + [(p_hi, n_hi)])
    assert eng.requests_preempted >= 1
    assert eng.requests_resumed == eng.requests_preempted


def test_preempt_resume_composes_with_nan_quarantine(tiny):
    low, (p_hi, n_hi) = low_high(tiny[2].vocab_size)

    def scenario(eng, _):
        for p, n in low:
            eng.submit(p, n, tier=2)
        for _ in range(3):
            eng.step()
        eng.submit(p_hi, n_hi, tier=0)
        return eng.drain()

    done, eng = both(tiny, scenario, total_pages=12,
                     events=[(5, "nan_logits", 0.0)])
    assert_solo(tiny, done, low + [(p_hi, n_hi)])
    assert eng.requests_preempted >= 1
    assert eng.requests_resumed == eng.requests_preempted
    assert eng.slots_quarantined >= 1


def test_sampled_requests_are_not_preempted(tiny):
    """Only greedy decoders are victims (a sampled resume would not be
    bit-exact): with every slot held by sampled tier-2 requests the
    tier-0 request waits for a slot."""
    low, (p_hi, n_hi) = low_high(tiny[2].vocab_size)

    def scenario(eng, _):
        for p, n in low:
            eng.submit(p, n, tier=2, temperature=0.9)
        for _ in range(3):
            eng.step()
        eng.submit(p_hi, n_hi, tier=0)
        return eng.drain()

    done, eng = both(tiny, scenario, total_pages=12, sampling=True,
                     top_k=8, seed=5)
    assert eng.requests_preempted == 0
    assert done[2].tokens == solo(tiny, p_hi, n_hi)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tier_ordering_never_inverted_under_overload(tiny, seed):
    """Seeded bursty overload: the engine never admits a lower tier while
    a higher one waits eligible in the queue, tick by tick, and both
    engines admit, preempt and finish alike."""
    cfg = tiny[2]
    tiers = tuple(TierSpec(f"t{k}", 10 ** 6, 10 ** 6.0, s)
                  for k, s in enumerate((0.3, 0.4, 0.3)))
    spec = LoadSpec(seed=seed, n_requests=24, mean_iat_ticks=0.7,
                    burst=True, prompt_len_max=8, out_len_min=2,
                    out_len_max=8, vocab=min(48, cfg.vocab_size),
                    tiers=tiers)
    trace = synth_trace(spec)

    def scenario(eng, _):
        out, i, max_queue = [], 0, 0
        for tick in range(600):
            while i < len(trace) and trace[i]["arrival_tick"] <= tick:
                item = trace[i]
                eng.submit(item["prompt"], item["max_new"],
                           tier=item["tier"])
                i += 1
            max_queue = max(max_queue, len(eng.queue))
            eligible = {r.rid: r.tier for r, _ in eng.queue
                        if r.not_before_tick <= eng._step_count}
            out += eng.step()
            still = {r.rid for r, _ in eng.queue}
            admitted = [t for rid, t in eligible.items() if rid not in still]
            waiting = [t for rid, t in eligible.items() if rid in still]
            if admitted and waiting:
                assert max(admitted) <= min(waiting), (tick, admitted,
                                                       waiting)
            if i >= len(trace) and not eng.queue and not eng.slot_req:
                break
        assert max_queue >= 3
        return out

    done, _ = both(tiny, scenario, total_pages=12)
    assert len(done) == len(trace)
    for rid, item in enumerate(trace):
        assert done[rid].error is None
        assert done[rid].tokens == solo(tiny, item["prompt"],
                                        item["max_new"])


def test_deadline_pruned_pre_prefill_lowest_tier_starves_first(tiny):
    vocab = tiny[2].vocab_size
    p_a = [(i * 3 + 1) % vocab for i in range(5)]
    p_b = [(i * 5 + 2) % vocab for i in range(6)]
    p_c = [(i * 7 + 3) % vocab for i in range(7)]

    def scenario(eng, _):
        eng.submit(p_a, 8, tier=0)               # holds the slot
        eng.submit(p_b, 6, tier=2, deadline_ticks=4)
        eng.submit(p_c, 6, tier=0)
        return eng.drain()

    done, eng = both(tiny, scenario, n_slots=1, total_pages=12)
    assert done[1].error == "deadline exceeded" and done[1].tokens == []
    assert done[0].tokens == solo(tiny, p_a, 8)
    assert done[2].tokens == solo(tiny, p_c, 6)
    assert eng.shed_by_reason == {"deadline": 1}
    assert eng.deadline_misses == 1


def test_tenant_quota_sheds_at_door_and_frees_on_finish(tiny):
    def scenario(eng, _):
        eng.submit([1, 2, 3], 5, tenant="acme")
        eng.submit([4, 5, 6], 5, tenant="acme")     # over quota: shed
        eng.submit([7, 8, 9], 5, tenant="other")
        done = eng.drain()
        assert not eng._tenant_load
        eng.submit([4, 5, 6], 5, tenant="acme")     # the slot freed
        return done + eng.drain()

    done, eng = both(tiny, scenario, total_pages=12,
                     tenant_quotas={"acme": 1})
    assert "quota" in done[1].error and done[1].tokens == []
    assert done[0].tokens == solo(tiny, [1, 2, 3], 5)
    assert done[2].tokens == solo(tiny, [7, 8, 9], 5)
    assert done[3].error is None
    assert done[3].tokens == solo(tiny, [4, 5, 6], 5)
    assert eng.shed_by_reason == {"quota": 1}


def test_tenant_and_tier_charge_the_cost_ledger(tiny):
    """The chip-tick ledger charges each request's (tenant, tier), and
    every charge adds up to the busy ticks."""
    def scenario(eng, _):
        eng.submit([1, 2, 3], 5, tenant="acme", tier=1)
        eng.submit([7, 8, 9], 5, tenant="other")
        return eng.drain()

    port, ref = engines(tiny)
    scenario(port, tchaos)
    scenario(ref, jchaos)
    assert port.cost.as_dict() == ref.cost.as_dict()
    assert "acme:t1" in port.cost.by_key
    assert set(port.cost.by_key) <= {"acme:t1", "other:t0"}
    assert port.cost.conserved
    assert port.cost.busy_chip_ticks == port.busy_ticks


def test_lifecycle_submit_validation(tiny):
    port, ref = engines(tiny)
    for kw, match in ((dict(tier=-1), "tier must be"),
                      (dict(deadline_ticks=0), "deadline_ticks must be"),
                      (dict(temperature=-1.0), "temperature must be"),
                      (dict(temperature=0.5), "sampling-enabled")):
        for eng in (port, ref):
            with pytest.raises(ValueError, match=match):
                eng.submit([1, 2, 3], 2, **kw)
        assert not port.queue


def test_lifecycle_trace_instants(tiny):
    """A traced engine records ``request.quarantine`` and
    ``request.replay`` for a poisoned slot, ``request.preempt`` and
    ``request.resume`` for a parked one, and closes a failed request's
    span with its error."""
    cfg_j, params_j, cfg, params_t = tiny
    low, (p_hi, n_hi) = low_high(cfg.vocab_size)
    tr = Tracer()
    eng = ts.ContinuousBatcher(
        params_t, cfg, device="cpu", tracer=tr, total_pages=12,
        chaos=tchaos.ChaosInjector([tchaos.ChaosEvent(5, "nan_logits")]),
        **BASE)
    for p, n in low:
        eng.submit(p, n, tier=2)
    for _ in range(3):
        eng.step()
    eng.submit(p_hi, n_hi, tier=0)
    eng.submit([1, 2], 3, deadline_s=0.0)
    done = {r.rid: r for r in eng.drain()}
    names = [name for _, name, _, _, _ in tr._instants]
    for name in ("request.quarantine", "request.replay", "request.preempt",
                 "request.resume"):
        assert name in names, name
    errors = [s.attrs.get("error") for s in tr.spans() if s.name == "request"]
    assert "deadline exceeded" in errors
    assert done[3].error == "deadline exceeded"


def test_recycled_nan_page_stays_out_of_the_plain_attention():
    """A quarantined slot's decode page goes back to the free list holding
    NaN in K and V (the poisoned block's flush) and, on int8 pages, in the
    scales.  Its next owner's masked positions must contribute nothing:
    the port's plain paged attention selects them out of the scores and
    of P.V (its kernels load a page's rows only up to the last valid
    key), so every output equals the clean pool's.  The reference's
    Pallas kernel multiplies a walked page whole, so there a NaN at a
    masked row of a partially valid page reaches o through a zero weight
    (ROADMAP.md queue 3's note); the engines differ only when a replay
    reads such a page, which the scenarios above never do."""
    import jax.numpy as jnp
    import torch

    from kubegpu_tpu.ops import paged_attention as jpa
    from kubegpu_tpu_torch.ops.paged_attention import paged_attention_ref

    rng = np.random.default_rng(0)
    n_layers, n_pages, hkv, page, dim = 2, 6, 2, 8, 16
    pk = rng.standard_normal((n_layers, n_pages, hkv, page, dim), np.float32)
    pv = rng.standard_normal((n_layers, n_pages, hkv, page, dim), np.float32)
    q = rng.standard_normal((2, 4, dim), np.float32)
    # row 0: prompt 5 in page 1, decode page 2 with 3 written; row 1: a
    # prompt of 16 over pages 3-4, no decode yet
    pt = np.array([[1, 2, 0], [3, 4, 0]], np.int32)
    t, tpad, d = (np.array(x, np.int32) for x in ([5, 16], [8, 16], [3, 0]))
    rec_k, rec_v = pk.copy(), pv.copy()
    for x in (rec_k, rec_v):
        x[:, 1, :, 5:] = np.nan      # row 0's prompt page past t
        x[:, 2, :, 3:] = np.nan      # row 0's decode page past d
        x[:, 5] = np.nan             # a free page no row holds

    def port(k, v):
        return paged_attention_ref(*map(torch.from_numpy, (q, k, v, pt)), 1,
                                   *map(torch.from_numpy, (t, tpad, d)))

    clean, rec = port(pk, pv), port(rec_k, rec_v)
    for a, b in zip(clean, rec):
        assert torch.isfinite(b).all()
        assert torch.equal(a, b)
    ref = jpa.paged_attention(jnp.asarray(q), jnp.asarray(rec_k),
                              jnp.asarray(rec_v), jnp.asarray(pt),
                              jnp.int32(1), jnp.asarray(t),
                              jnp.asarray(tpad), jnp.asarray(d),
                              interpret=True)
    o_ref = np.asarray(ref[0])
    assert not np.isfinite(o_ref[0]).all()   # the reference's 0 x NaN
    np.testing.assert_allclose(o_ref[1], rec[0][1].numpy(), atol=1e-5)
    # int8 pages: the NaN sits in the per-token scales
    kq = torch.from_numpy(rng.integers(-127, 128, pk.shape).astype(np.int8))
    vq = torch.from_numpy(rng.integers(-127, 128, pv.shape).astype(np.int8))
    ks = rng.uniform(0.01, 0.02, pk.shape[:-1]).astype(np.float32)
    vs = rng.uniform(0.01, 0.02, pv.shape[:-1]).astype(np.float32)
    rks, rvs = ks.copy(), vs.copy()
    for x in (rks, rvs):
        x[:, 1, :, 5:] = x[:, 2, :, 3:] = x[:, 5] = np.nan
    args = (torch.from_numpy(q), kq, vq, torch.from_numpy(pt), 1,
            *map(torch.from_numpy, (t, tpad, d)))
    clean = paged_attention_ref(*args, *map(torch.from_numpy, (ks, vs)))
    rec = paged_attention_ref(*args, *map(torch.from_numpy, (rks, rvs)))
    for a, b in zip(clean, rec):
        assert torch.isfinite(b).all()
        assert torch.equal(a, b)
