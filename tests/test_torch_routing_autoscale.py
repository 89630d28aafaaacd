"""Prefix-affinity routing, the scale surface and the autoscaler of the
port (``DataParallelServePool`` and ``kubegpu_tpu_torch.scheduler.serve``)
against the JAX package's, the nine cases of
``tests/test_routing_autoscale.py``: the same seeded traffic routes alike
run to run and in both packages, zero-affinity traffic routes as the
least-loaded policy, a chain's home replica wins until load outweighs it,
the queue's token counter stays exact; a retire drains through the replay
without spending any replay budget, ``add_replica`` grows the pool until
the devices run out; the autoscale policy's decisions equal the
reference's, and the autoscaler runs a scale cycle through the reference's
``SimCluster`` extender gang path.  The port's replicas run on ``["cpu"] *
n``, the reference's all on its first virtual CPU device (its executables
compile once a device mesh)."""

import jax
import numpy as np
import pytest

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models import serve as js
from kubegpu_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from kubegpu_tpu.scheduler import serve as jscale
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts
from kubegpu_tpu_torch.obs.metrics import MetricsRegistry
from kubegpu_tpu_torch.scheduler import serve as tscale

# tests/test_routing_autoscale.py's pool
POOL = dict(n_slots=2, stride=2, prompt_buckets=(8, 24), page_size=8,
            prefix_cache=True)


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


def port_pool(tiny, dp=2, routing="affinity", metrics=None, **kw):
    _, _, cfg, params_t = tiny
    return ts.DataParallelServePool(params_t, cfg, dp=dp,
                                    devices=["cpu"] * kw.pop("n_dev", dp),
                                    routing=routing, metrics=metrics,
                                    **{**POOL, **kw})


def ref_pool(tiny, dp=2, routing="affinity", metrics=None, **kw):
    cfg_j, params_j, _, _ = tiny
    n_dev = kw.pop("n_dev", dp)
    return js.DataParallelServePool(params_j, cfg_j, dp=dp, tp=1,
                                    devices=[jax.devices()[0]] * n_dev,
                                    routing=routing, metrics=metrics,
                                    **{**POOL, **kw})


def chain_prompt(rng, lead, t, vocab):
    """A ``t``-token prompt whose first ``len(lead)`` tokens are the shared
    chain."""
    return list(lead) + rng.integers(1, vocab, t - len(lead)).tolist()


def run_trace(pool, trace):
    for p, n in trace:
        pool.submit(p, n)
    log = list(pool.route_log)
    return log, {r.rid: list(r.tokens) for r in pool.drain()}


def test_same_trace_routes_identically(tiny):
    """One seeded trace of shared-chain prompts gives one route log and
    one set of tokens, run to run and in both packages."""
    rng = np.random.default_rng(3)
    lead = rng.integers(1, 32, 16).tolist()
    trace = [(chain_prompt(rng, lead, 20, 32), 4) for _ in range(6)]
    a = run_trace(port_pool(tiny), trace)
    b = run_trace(port_pool(tiny), trace)
    ref = run_trace(ref_pool(tiny), trace)
    assert a == b == ref
    assert any(aff for _, _, aff in a[0])
    for rid, (p, n) in enumerate(trace):
        assert a[1][rid] == solo(tiny, p, n), rid


def test_chain_pulls_to_home_replica_until_load_dominates(tiny):
    """A 2-page chain on replica 0 pulls a same-chain request past a
    1-request load gap, not past a wider one."""
    rng = np.random.default_rng(5)
    lead = rng.integers(1, 32, 16).tolist()
    prompts = [chain_prompt(rng, lead, 20, 32) for _ in range(3)]
    logs = []
    for pool in (port_pool(tiny), ref_pool(tiny)):
        for p in prompts:
            pool.submit(p, 6)
        logs.append(list(pool.route_log))
        assert pool.routing_affinity_hits == 1
        assert pool.routing_affinity_hit_rate == pytest.approx(1 / 3)
        assert all(r.error is None for r in pool.drain())
    assert logs[0] == logs[1]
    assert [rep for _, rep, _ in logs[0]] == [0, 0, 1]
    assert [aff for _, _, aff in logs[0]] == [0, 2, 0]


def test_zero_affinity_is_bit_identical_to_least_loaded(tiny):
    """Prompts with no whole cacheable page route and emit exactly as the
    least-loaded policy, in both packages."""
    rng = np.random.default_rng(9)
    trace = [(rng.integers(1, 32, int(rng.integers(3, 8))).tolist(),
              int(rng.integers(2, 6))) for _ in range(8)]
    runs = {(pkg, routing): run_trace(mk(tiny, routing=routing), trace)
            for pkg, mk in (("port", port_pool), ("ref", ref_pool))
            for routing in ("affinity", "least_loaded")}
    logs = {k: [(rid, rep) for rid, rep, _ in v[0]] for k, v in runs.items()}
    assert len({tuple(v) for v in logs.values()}) == 1
    toks = [v[1] for v in runs.values()]
    assert all(t == toks[0] for t in toks)


def test_admission_queue_token_counter_invariant(tiny):
    """The router's queued-token tiebreak reads the admission queue's
    running total: it equals a full scan through submit, admission and
    retirement."""
    pool = port_pool(tiny, dp=1, n_slots=1, prompt_buckets=(8,),
                     prefix_cache=False)
    eng = pool.replicas[0]

    def check():
        assert eng.queue.prompt_tokens == sum(
            r.prompt_len for r, _ in eng.queue)

    rng = np.random.default_rng(1)
    for k in range(5):
        pool.submit(rng.integers(1, 32, 3 + k).tolist(), 3)
        check()
    for _ in range(40):
        pool.step()
        check()
        if not eng.queue and not eng.slot_req:
            break
    assert eng.queue.prompt_tokens == 0


def test_retire_replica_drains_bit_exact_without_burning_retries(tiny):
    """A graceful scale-down: residents replay on the survivor with their
    solo tokens, once; no failover, no replay budget spent; the retired
    replica's depth gauge is deleted; the registries equal the JAX
    pool's but for wall-clock values."""
    rng = np.random.default_rng(7)
    work = [(rng.integers(1, 32, 6).tolist(), 8) for _ in range(4)]
    out = []
    for mk, reg in ((port_pool, MetricsRegistry()),
                    (ref_pool, JaxRegistry())):
        pool = mk(tiny, metrics=reg)
        for p, n in work:
            pool.submit(p, n)
        done = {}
        for _ in range(2):
            done.update({r.rid: r.tokens for r in pool.step()})
        assert "serve_replica_queue_depth_r0" in reg.snapshot()["gauges"]
        pool.retire_replica(0)
        pool.retire_replica(0)           # a second ask is a no-op
        for r in pool.drain():
            assert r.rid not in done and r.error is None
            done[r.rid] = r.tokens
        assert 0 in pool.dead_replicas
        assert pool.drains == 1 and pool.drain_replays >= 1
        assert pool.failovers == 0 and pool.requests_retried == 0
        gauges = reg.snapshot()["gauges"]
        assert "serve_replica_queue_depth_r0" not in gauges
        assert gauges["serve_replicas_active"] == 1.0
        with pytest.raises(ValueError):
            pool.retire_replica(1)       # never the last replica
        with pytest.raises(ValueError, match="already dead"):
            pool.retire_replica(0)
        snap = reg.snapshot()
        out.append((done, pool.drain_replays, snap["counters"],
                    {k: h["count"] for k, h in snap["histograms"].items()}))
    assert out[0] == out[1]
    for rid, (p, n) in enumerate(work):
        assert out[0][0][rid] == solo(tiny, p, n), rid


def test_add_replica_grows_pool_and_exhausts_devices(tiny):
    """``add_replica`` builds a third replica on the third device; it
    serves routed traffic with the solo tokens; a fourth finds no
    device.  Routes equal the JAX pool's."""
    logs = []
    for mk in (port_pool, ref_pool):
        pool = mk(tiny, n_dev=3)
        i = pool.add_replica()
        assert i == 2 and pool.dp == 3 and len(pool._alive()) == 3
        assert pool.replicas_active_max == 3 and pool.autoscale_events == 1
        rng = np.random.default_rng(2)
        work = [(rng.integers(1, 32, 5).tolist(), 4) for _ in range(6)]
        for p, n in work:
            pool.submit(p, n)
        assert {rep for _, rep, _ in pool.route_log} == {0, 1, 2}
        for r in pool.drain():
            assert r.tokens == solo(tiny, *work[r.rid])
        with pytest.raises(ValueError, match="no spare devices"):
            pool.add_replica()
        logs.append(list(pool.route_log))
    assert logs[0] == logs[1]


@pytest.mark.parametrize("case", ["hysteresis", "bounds"])
def test_autoscale_policy_equals_reference(case):
    """The policy's actions and decisions equal the reference's on the
    same signals: hysteresis and seeded cooldown jitter (+1 only after
    ``hold_ticks`` of pressure, -1 after ``idle_ticks`` of calm, actions a
    cooldown apart), and the replica bounds clamping both ways."""
    if case == "hysteresis":
        kw = dict(min_replicas=1, max_replicas=4, queue_wait_high_ticks=4.0,
                  hold_ticks=2, idle_ticks=3, cooldown_ticks=4, seed=13,
                  cooldown_jitter_ticks=2)
        signals = ([(t, 2, 10.0, 1.0) for t in range(6)]
                   + [(t, 2, 0.0, 1.0) for t in range(6, 20)])
    else:
        kw = dict(min_replicas=1, max_replicas=2, hold_ticks=1, idle_ticks=1,
                  cooldown_ticks=0)
        signals = [(0, 2, 99.0, 0.0), (1, 1, 0.0, 1.0), (2, 1, 99.0, 0.0),
                   (3, 2, 0.0, 1.0)]
    runs = []
    for mod in (tscale, jscale, tscale):
        pol = mod.AutoscalePolicy(mod.AutoscaleConfig(**kw))
        acts = [pol.decide(t, n, queue_wait_ticks=q, attainment=a)
                for t, n, q, a in signals]
        runs.append((acts, pol.decisions))
    assert runs[0] == runs[1] == runs[2]
    acts, decisions = runs[0]
    if case == "hysteresis":
        assert acts[0] == 0 and acts[1] == 1 and -1 in acts[6:]
        ticks = [t for t, _ in decisions]
        assert all(b - a >= kw["cooldown_ticks"]
                   for a, b in zip(ticks, ticks[1:]))
        assert min(t for t, a in decisions if a == -1) >= 6 + 3 - 1
    else:
        assert acts[:2] == [0, 0] and acts[2:] == [1, -1]


def test_scale_cycle_through_extender_gang_path(tiny):
    """The port's autoscaler against the reference's live ``SimCluster``:
    pressure spawns a serving gang through the extender and binds a new
    replica to it; calm retires that replica (drain by replay) and evicts
    its gang without requeue, which the health watch then sees on an
    already drained replica.  Every request keeps its solo tokens."""
    from kubegpu_tpu.cluster import SimCluster
    from kubegpu_tpu.kubemeta.controlplane import NotFound

    _, _, cfg, params_t = tiny
    cl = SimCluster(["v5e-16"])
    try:
        assert cl.scheduler.spawn_serving_gang("serve-base", chips=1) == [
            "serve-base-0"]
        pool = ts.DataParallelServePool(
            params_t, cfg, dp=1, devices=["cpu"] * 2, n_slots=2, stride=2,
            prompt_buckets=(8,), page_size=8, metrics=cl.metrics)
        pool.bind_replica_gang(0, "serve-base")
        pool.watch_health(cl.api)
        scaler = tscale.ServingAutoscaler(
            pool, tscale.AutoscalePolicy(tscale.AutoscaleConfig(
                min_replicas=1, max_replicas=2, queue_wait_high_ticks=2.0,
                hold_ticks=1, idle_ticks=2, cooldown_ticks=2)),
            scheduler=cl.scheduler, cluster=cl, chips_per_replica=1)
        rng = np.random.default_rng(4)
        work = [(rng.integers(1, 32, 6).tolist(), 6) for _ in range(6)]
        rids = {pool.submit(p, n): (p, n) for p, n in work}
        done, tick = {}, 0
        while not scaler.scale_ups and tick < 50:
            done.update({r.rid: r for r in pool.step()})
            scaler(tick, {"attainment": 1.0})
            tick += 1
        assert scaler.scale_ups == 1
        assert pool._gang_replica.get("serve-asg0") == 1
        assert cl.api.get("Pod", "serve-asg0-0") is not None
        while not scaler.scale_downs and tick < 250:
            done.update({r.rid: r for r in pool.step()})
            scaler(tick, {"attainment": 1.0})
            tick += 1
        assert scaler.scale_downs == 1
        assert scaler.events == [(scaler.events[0][0], "up", 1),
                                 (scaler.events[1][0], "down", 1)]
        done.update({r.rid: r for r in pool.step()})
        assert 1 in pool.dead_replicas and pool.drains == 1
        with pytest.raises(NotFound):
            cl.api.get("Pod", "serve-asg0-0")
        cl.step()
        done.update({r.rid: r for r in pool.drain()})
        assert set(done) == set(rids)
        for rid, (p, n) in rids.items():
            assert done[rid].error is None
            assert done[rid].tokens == solo(tiny, p, n)
        assert pool.failovers == 0
        assert (pool.replicas_active_min, pool.replicas_active_max) == (1, 2)
        assert cl.metrics.counter("serve_autoscale_events") == 2
        p, n = work[0]
        rid = pool.submit(p, n)
        assert {r.rid: r for r in pool.drain()}[rid].tokens == solo(tiny, p, n)
        pool.close()
    finally:
        cl.close()


def test_extender_command_needs_the_cluster_layer(monkeypatch, capsys):
    """The port's ``main`` is the reference's extender service over the
    cluster layer: it binds the webhook, prints the reference's policy
    stanza for the bound address, and serves until interrupted."""
    import json
    import sys
    import threading

    from kubegpu_tpu.scheduler import webhook as rhook

    real_wait = threading.Event.wait

    def wait(self, timeout=None):
        # main's serve-forever wait is interrupted as ^C would; every
        # other wait (threads starting, the server's shutdown) is real
        if sys._getframe(1).f_code is tscale.main.__code__:
            raise KeyboardInterrupt
        return real_wait(self, timeout)

    monkeypatch.setattr(threading.Event, "wait", wait)
    assert tscale.main(["--port", "0", "--slices", "h100-sxm-1"]) == 0
    out = capsys.readouterr()
    addr = out.err.split("extender listening on ")[1].split()[0]
    assert json.loads(out.out) == rhook.policy_config(addr)
    with pytest.raises(SystemExit):
        tscale.main(["--bogus"])
