"""The port's replica pools against the JAX package's, on the same converted
f32 weights and seeded traffic: ``DataParallelServePool`` at tp = 1 (the
port's replicas on ``["cpu"] * n``, the reference's all on its first
virtual CPU device: its executables compile once a device mesh, so one
device keeps this file's compile time down) through the failover scenarios of
``tests/test_serve_chaos.py`` (seeded replica kills, the watchdog, every
replica dead, the replay bound, deadlines, a control-plane eviction through
the reference's ``SimCluster``, a kill under fused serving, preemption then
a kill, the queue-depth gauge of a dead replica) and
``DisaggServePool``; and the metrics registry each pool feeds, and each
single engine (dense, evicting, a degrading speculative one, fused under
chaos, tiers with quotas and deadlines).

Tokens, errors, routes and the failover counters must equal the JAX
pool's, and every greedy request that did not fail must equal the port's
solo ``greedy_generate``.  Metrics snapshots hold counters and the
schedule's gauges equal and each histogram's sample count; wall-clock
values (``serve_host_overhead_pct``, the ms histograms' values) and the
state bytes (the port's slot vectors are wider,
``tests/test_torch_serve_acct.py``) are the port's own."""

import jax
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models import serve as js
from kubegpu_tpu.obs import chaos as jchaos
from kubegpu_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts
from kubegpu_tpu_torch.obs import chaos as tchaos
from kubegpu_tpu_torch.obs import metrics as tmetrics

# tests/test_serve_chaos.py's pool
POOL = dict(n_slots=2, stride=2, prompt_buckets=(8, 16), page_size=8)
COUNTERS = ("failovers", "requests_retried", "requests_preempted",
            "requests_resumed", "slots_quarantined", "deadline_misses",
            "drains", "drain_replays", "emitted_tokens")
# gauges whose values are the port's own: a wall-clock share, state bytes
OWN_GAUGES = ("serve_host_overhead_pct", "serve_hbm_pool_bytes",
              "serve_hbm_peak_bytes")


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


def mixed_prompts(vocab, n=5):
    return [([(i * 3 + j) % vocab for i in range(4 + j)], 5 + j)
            for j in range(n)]


def inj(mod, events):
    """``{replica: ChaosInjector}`` of package ``mod`` from ``{replica:
    [(tick, kind, stall_s)]}``."""
    return {i: mod.ChaosInjector([mod.ChaosEvent(tick=t, kind=k, stall_s=s)
                                  for t, k, s in evs])
            for i, evs in events.items()}


def pools(tiny, dp=2, events=None, cls="DataParallelServePool", **kw):
    """(the port's pool, the reference's) with the same knobs, each with
    its own package's chaos and a registry of its own."""
    cfg_j, params_j, cfg, params_t = tiny
    kw = {**POOL, **kw}
    if cls == "DataParallelServePool":
        kw["dp"] = dp
    port = getattr(ts, cls)(params_t, cfg, devices=["cpu"] * dp,
                            metrics=tmetrics.MetricsRegistry(),
                            chaos=inj(tchaos, events or {}), **kw)
    ref = getattr(js, cls)(params_j, cfg_j, tp=1, metrics=JaxRegistry(),
                           devices=[jax.devices()[0]] * dp,
                           chaos=inj(jchaos, events or {}), **kw)
    return port, ref


def record(pool, done) -> dict:
    """What must agree: each request's tokens and error by pool rid (none
    returned twice), the routes, the dead replicas, the counters."""
    seen = {}
    for r in done:
        assert r.rid not in seen, f"rid {r.rid} completed twice"
        seen[r.rid] = (list(r.tokens), r.error)
    out = {"done": seen, "routes": [tuple(x) for x in pool.route_log],
           "dead": sorted(pool.dead_replicas)}
    out.update({c: getattr(pool, c) for c in COUNTERS})
    return out


def metric_record(reg) -> dict:
    snap = reg.snapshot()
    return {"counters": snap["counters"],
            "gauges": {k: v for k, v in snap["gauges"].items()
                       if k not in OWN_GAUGES},
            "gauge_names": sorted(snap["gauges"]),
            "hist_counts": {k: h["count"]
                            for k, h in snap["histograms"].items()}}


def both(tiny, scenario, **kw):
    """Run ``scenario(pool)`` (returns the finished requests) on both pools
    and assert equal records and metrics; returns the port's record and
    pool."""
    port, ref = pools(tiny, **kw)
    got, want = record(port, scenario(port)), record(ref, scenario(ref))
    assert got == want
    assert metric_record(port._metrics) == metric_record(ref._metrics)
    return got, port


def submit_drain(prompts, **sub):
    def scenario(pool):
        for p, n in prompts:
            pool.submit(p, n, **sub)
        return pool.drain()
    return scenario


def assert_solo(tiny, rec, prompts):
    for rid, (p, n) in enumerate(prompts):
        toks, err = rec["done"][rid]
        assert err is None, (rid, err)
        assert toks == solo(tiny, p, n), rid


def test_dp_pool_exact_parity(tiny):
    """dp replicas behind one queue: every request equals the solo run and
    the JAX pool's, routed alike (``tests/test_serve.py``'s parity case at
    tp = 1)."""
    prompts = mixed_prompts(tiny[2].vocab_size)
    rec, pool = both(tiny, submit_drain(prompts))
    assert_solo(tiny, rec, prompts)
    assert {rep for _, rep, _ in rec["routes"]} == {0, 1}
    for eng in pool.replicas:
        eng.check_page_invariants()
        assert len(eng._free_pages) == eng.total_pages


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_random_kill_exactly_once_bit_exact(tiny, seed):
    """A random replica killed at a random tick: nothing lost or returned
    twice, every stream equal to the solo run, one failover, and the
    failover metrics equal the JAX pool's."""
    rng = np.random.default_rng(seed)
    victim, tick = int(rng.integers(0, 2)), int(rng.integers(1, 6))
    prompts = mixed_prompts(tiny[2].vocab_size, n=6)
    rec, pool = both(tiny, submit_drain(prompts),
                     events={victim: [(tick, "kill_replica", 0.0)]})
    assert_solo(tiny, rec, prompts)
    assert pool.failovers == 1 and victim in pool.dead_replicas
    assert pool._metrics.counter("serve_failover_total") == 1
    assert pool._metrics.histogram("serve_replay_ms").count >= 1
    assert pool._metrics.counter("serve_replica_deaths") == 1


def test_stall_fails_over_via_watchdog(tiny):
    """A stalled tick on replica 1 trips its watchdog: it fails over and
    every request keeps its solo tokens (wall-clock driven, so held to the
    solo run, as the reference's test holds its pool).  Replica 0 runs
    without a watchdog, so a loaded host cannot trip a second one."""
    _, _, cfg, params_t = tiny
    pool = ts.DataParallelServePool(
        params_t, cfg, dp=2, devices=["cpu"] * 2, tick_deadline_s=0.5,
        chaos=inj(tchaos, {1: [(1, "stall_tick", 1.2)]}), **POOL)
    pool.replicas[0].tick_deadline_s = None
    pool.warmup()
    prompts = mixed_prompts(cfg.vocab_size)
    rec = record(pool, submit_drain(prompts)(pool))
    assert pool.failovers == 1 and "watchdog" in pool.dead_replicas[1]
    assert_solo(tiny, rec, prompts)


def test_all_replicas_dead_fails_requests_not_hangs(tiny):
    def scenario(pool):
        for p, n in mixed_prompts(tiny[2].vocab_size, n=4):
            pool.submit(p, n)
        done = pool.drain()
        with pytest.raises((ts.ReplicaDeadError, jchaos.ReplicaDeadError)):
            pool.submit([1, 2, 3], 4)
        return done

    rec, _ = both(tiny, scenario, events={0: [(1, "kill_replica", 0.0)],
                                          1: [(1, "kill_replica", 0.0)]})
    assert len(rec["done"]) == 4
    assert all(err is not None for _, err in rec["done"].values())


def test_failover_replay_bound(tiny):
    """``max_replays=0``: the kill's residents fail (partial tokens kept),
    the other replica's finish exactly."""
    prompts = mixed_prompts(tiny[2].vocab_size, n=6)
    rec, _ = both(tiny, submit_drain(prompts), max_replays=0,
                  events={0: [(1, "kill_replica", 0.0)]})
    errors = [err for _, err in rec["done"].values()]
    assert any(e is not None and "failover" in e for e in errors)
    for rid, (toks, err) in rec["done"].items():
        if err is None:
            assert toks == solo(tiny, *prompts[rid])


def test_pool_deadline_and_cancel(tiny):
    """A request past its deadline fails, its neighbour finishes; a
    cancelled one comes back failed at once."""
    def scenario(pool):
        pool.submit([1, 2, 3], 6, deadline_s=0.0)
        pool.submit([4, 5, 6], 6)
        victim = pool.submit([7, 8, 9], 6)
        out = pool.step()
        out.append(pool.cancel(victim, "user"))
        assert pool.cancel(victim) is None
        return out + pool.drain()

    rec, _ = both(tiny, scenario)
    assert rec["done"][0][1] == "deadline exceeded"
    assert rec["done"][2][1] == "user"
    assert rec["done"][1] == (solo(tiny, [4, 5, 6], 6), None)


def test_gang_eviction_drives_pool_failover(tiny):
    """The reference's control plane (``SimCluster``) kills the host under
    serving gang 0; the port pool's health watch sees the gang's pod
    deleted and fails replica 0 over at its next step, with the failover
    on the cluster's own metrics registry."""
    from kubegpu_tpu.cluster import SimCluster, tpu_pod
    from kubegpu_tpu.kubemeta import GangSpec
    from kubegpu_tpu.kubemeta.codec import pod_allocation

    _, _, cfg, params_t = tiny
    cl = SimCluster(["v5e-16", "v5e-16"])
    try:
        for g in range(2):
            cl.submit(tpu_pod(
                f"serve{g}-0", chips=4, workload="serving",
                gang=GangSpec(name=f"serve{g}", size=1, index=0),
                mesh_axes={"tp": 4}, command=["noop"]))
        result, _ = cl.step()
        assert len(result.scheduled) == 2
        pool = ts.DataParallelServePool(params_t, cfg, dp=2,
                                        devices=["cpu"] * 2,
                                        metrics=cl.metrics, **POOL)
        pool.bind_replica_gang(0, "serve0")
        pool.bind_replica_gang(1, "serve1")
        pool.watch_health(cl.api)
        prompts = mixed_prompts(cfg.vocab_size)
        rids = {pool.submit(p, n): (p, n) for p, n in prompts}
        done = {}
        for _ in range(3):
            done.update({r.rid: r for r in pool.step()})
        victim = pod_allocation(cl.api.get("Pod", "serve0-0"))
        evicted = cl.metrics.counter("gangs_evicted")
        cl.fail_host(victim.node_name)
        cl.step()
        assert cl.metrics.counter("gangs_evicted") == evicted + 1
        for r in pool.drain():
            assert r.rid not in done
            done[r.rid] = r
        assert pool.failovers == 1 and 0 in pool.dead_replicas
        assert set(done) == set(rids)
        for rid, (p, n) in rids.items():
            assert done[rid].error is None, (rid, done[rid].error)
            assert done[rid].tokens == solo(tiny, p, n), rid
        assert cl.metrics.counter("serve_failover_total") == 1
        pool.close()
        assert pool._unsub is None
    finally:
        cl.close()


def test_replica_kill_during_fused_serving(tiny):
    """A pool of ``fused_ticks=4`` engines, replica 1 killed mid-stream:
    the replays keep their solo tokens and equal the JAX pool's."""
    prompts = [(p, 20) for p, _ in mixed_prompts(tiny[2].vocab_size, n=4)]
    rec, pool = both(tiny, submit_drain(prompts), fused_ticks=4,
                     events={1: [(2, "kill_replica", 0.0)]})
    assert_solo(tiny, rec, prompts)
    assert pool.failovers == 1 and 1 in pool.dead_replicas
    assert sum(e.fused_dispatches for e in pool.replicas) > 0


def test_preempt_then_replica_kill_exactly_once_bit_exact(tiny):
    """Tier-2 requests decode, two tier-0 ones preempt some of them, then
    replica 0 dies while victims are parked: every request completes once
    with its solo tokens, as in the JAX pool."""
    vocab = tiny[2].vocab_size
    low = [([(i * 3 + j) % vocab for i in range(4 + j)], 8) for j in range(4)]
    hi = [([(i * 5 + 7) % vocab for i in range(5)], 6),
          ([(i * 7 + 3) % vocab for i in range(6)], 6)]

    def scenario(pool):
        for p, n in low:
            pool.submit(p, n, tier=2)
        done = []
        for _ in range(3):
            done += pool.step()
        for p, n in hi:
            pool.submit(p, n, tier=0)
        return done + pool.drain()

    rec, pool = both(tiny, scenario, paged=True, total_pages=12,
                     events={0: [(5, "kill_replica", 0.0)]})
    assert_solo(tiny, rec, low + hi)
    assert pool.failovers == 1 and 0 in pool.dead_replicas
    assert pool.requests_preempted >= 1
    assert pool._metrics.counter("serve_requests_preempted") >= 1


def test_chaos_failover_deletes_queue_depth_gauge(tiny):
    """A chaos death deletes the dead replica's queue-depth gauge."""
    rec, pool = both(tiny, submit_drain(mixed_prompts(tiny[2].vocab_size)),
                     events={1: [(1, "kill_replica", 0.0)]})
    gauges = pool._metrics.snapshot()["gauges"]
    assert 1 in pool.dead_replicas
    assert "serve_replica_queue_depth_r1" not in gauges
    assert "serve_replica_queue_depth_r0" in gauges
    assert gauges["serve_replicas_active"] == 1.0


# the role-split pools' engines: speculative (see the next docstring),
# prefix-cached and chunked
DISAGG = dict(spec_gamma=2, draft_layers=1, prefix_cache=True,
              chunked_prefill=True, prefill_chunk=8)


def test_disagg_pool_equals_reference(tiny):
    """The role-split pool: tokens (the solo run's), routes, migrations,
    migrated pages and the migration metrics equal the JAX pool's, every
    import's digest checked; the decode replica decodes every request and
    the prefill replica none past its first token.  Speculative engines:
    the reference's non-speculative consume misreads an import's first
    block (ROADMAP.md queue 3;
    ``tests/test_torch_page_migration.py::test_reference_import_reads_the_block_in_flight``)."""
    prompts = mixed_prompts(tiny[2].vocab_size)
    checked = []

    def scenario(pool):
        if isinstance(pool, ts.DisaggServePool):
            dec = pool.replicas[1]
            real = dec.import_chain

            def counted(exp, *a, **k):
                checked.append(exp["digest"] == ts._chain_digest(
                    exp["chain"], exp["t"]))
                return real(exp, *a, **k)

            dec.import_chain = counted
        return submit_drain(prompts)(pool)

    rec, pool = both(tiny, scenario, cls="DisaggServePool", **DISAGG)
    assert_solo(tiny, rec, prompts)
    # every import attempt (a full decode side defers some) met its digest
    assert pool.migrations == len(prompts) <= len(checked) and all(checked)
    assert pool.migrated_pages == len(prompts)     # one page a prompt
    assert pool._metrics.counter("serve_migrated_pages_total") == \
        pool.migrated_pages
    assert pool._metrics.histogram("serve_migration_ms").count == len(prompts)
    assert pool.replicas[0].chains_exported == len(prompts)
    assert pool.replicas[1].chains_imported == len(prompts)


def test_disagg_degrades_when_a_role_dies(tiny):
    """With the decode replica dead the role-split pool serves on its
    prefill replica (and a one-token request never migrates); tokens
    equal the solo run's and the JAX pool's."""
    prompts = mixed_prompts(tiny[2].vocab_size, n=4) + [([9, 8, 7], 1)]
    rec, pool = both(tiny, submit_drain(prompts), cls="DisaggServePool",
                     events={1: [(1, "kill_replica", 0.0)]}, **DISAGG)
    assert_solo(tiny, rec, prompts)
    assert pool.failovers == 1 and pool.dead_replicas == {
        1: pool.dead_replicas[1]}
    with pytest.raises(ValueError, match="role"):
        pool.add_replica(role="router")


def test_pool_refusals():
    """The pool's construction errors: too few devices (at tp = 2 too),
    an unknown routing, an empty role."""
    cfg = tl.LlamaConfig.tiny(max_seq_len=64)
    params = tl.llama_init(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        ts.DataParallelServePool(params, cfg, dp=3, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="routing"):
        ts.DataParallelServePool(params, cfg, dp=1, devices=["cpu"],
                                 routing="random", **POOL)
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        ts.DataParallelServePool(params, cfg, dp=2, tp=2,
                                 devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="one replica per role"):
        ts.DisaggServePool(params, cfg, prefill=0, devices=["cpu"])


ENGINE_CASES = {
    "dense": dict(paged=False),
    "evict-window": dict(prompt_buckets=(32, 40), n_slots=3,
                         evict_policy="window", evict_param=8.0),
    "spec-degrade": dict(stride=4, spec_gamma=3, draft_layers=1,
                         spec_degrade_after=2),
    "fused4-chaos": dict(fused_ticks=4),
    "tiers-quota": dict(total_pages=12, tenant_quotas={"a": 1}),
}


def engine_traffic(case, vocab):
    """(chaos events, a scenario over one engine) for each engine case."""
    mixed = mixed_prompts(vocab, n=3)
    if case == "evict-window":
        prompts = [([(5 * j + 3 * i + 2) % vocab for i in range(27)], 8)
                   for j in range(3)]
        return (), submit_drain(prompts)
    if case == "fused4-chaos":
        return ([(2, "nan_logits", 0.0), (3, "fail_dispatch", 0.0)],
                submit_drain([(p, 20) for p, _ in mixed[:2]]))
    if case == "tiers-quota":
        def tiers(eng):
            for p, n in mixed:
                eng.submit(p, 8, tier=2)
            eng.submit([9, 9, 9], 4, tenant="a")
            eng.submit([8, 8, 8], 4, tenant="a")      # over quota: shed
            done = eng.step() + eng.step() + eng.step()
            eng.submit([7, 6, 5, 4], 6, tier=0)      # preempts a tier-2
            eng.submit([1, 2], 6, tier=1, deadline_ticks=1)
            return done + eng.drain()
        return (), tiers
    return (), submit_drain(mixed)


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_metrics_equal_reference(tiny, case):
    """One engine with a registry, against the JAX engine on the same
    traffic: tokens and errors, every counter (sheds, preemptions and
    deadline misses by reason and tier, quarantines, retried dispatches,
    evicted pages, the spec degrade), the schedule's gauges (the kv width,
    the quality delta) and each histogram's sample count (queue wait and
    its tick twin, TTFT, token ms, the decode stall and its work, the spec
    acceptance, the fused block) equal."""
    cfg_j, params_j, cfg, params_t = tiny
    kw = {**POOL, "paged": True, **ENGINE_CASES[case]}
    events, scenario = engine_traffic(case, cfg.vocab_size)
    regs, records = [], []
    for mod, batcher, params, c, reg in (
            (tchaos, ts.ContinuousBatcher, params_t, cfg,
             tmetrics.MetricsRegistry()),
            (jchaos, js.ContinuousBatcher, params_j, cfg_j, JaxRegistry())):
        chaos = (mod.ChaosInjector([mod.ChaosEvent(tick=t, kind=k)
                                    for t, k, _ in events])
                 if events else None)
        extra = {"device": "cpu"} if batcher is ts.ContinuousBatcher else {}
        eng = batcher(params, c, metrics=reg, chaos=chaos, **kw, **extra)
        done = scenario(eng)
        eng.note_kv_quality(0.125)
        records.append(sorted((r.rid, list(r.tokens), r.error) for r in done))
        regs.append(metric_record(reg))
    assert records[0] == records[1]
    assert regs[0] == regs[1]
    counters = regs[0]["counters"]
    want = {"evict-window": "serve_pages_evicted_total",
            "spec-degrade": "serve_spec_degraded",
            "fused4-chaos": "serve_dispatch_failures",
            "tiers-quota": "serve_requests_shed_quota"}.get(case)
    if want:
        assert counters.get(want, 0) >= 1, counters
    assert regs[0]["gauges"]["serve_kv_quality_delta"] == 0.125
