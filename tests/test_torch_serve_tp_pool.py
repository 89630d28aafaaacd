"""The port's replica pools at tp = 2 (``DataParallelServePool(dp=2, tp=2)``
and ``DisaggServePool(1, 1, tp=2)``: each replica a gang of two rank
processes over gloo, :class:`kubegpu_tpu_torch.models.serve._GangReplica`)
against the JAX package's pools at tp = 2 on the 8 virtual CPU devices of
``tests/conftest.py``, on the same converted f32 weights (the JAX package's
``tiny4`` config).

One scenario runs on both dp pools: ``test_dp_pool_exact_parity``'s
prompts, the seeded shared-chain trace of
``tests/test_torch_routing_autoscale.py`` (affinity routing), a retire of
replica 1 mid-traffic, an ``add_replica`` that reuses its device block and
whose engine a ``ChaosEvent`` kills at its first tick (a failover), and
the parity prompts again.  Tokens, errors, routes, the pool counters, the
metrics registry's counters, gauges and histogram counts, and the tracer's
spans by name must be EQUAL.  The disaggregated pool (speculative
engines, as ``tests/test_torch_serve_pool.py``'s, where the reference's
import does not read a block in flight) migrates every chain as the JAX
pool does, and each full-head export equals the JAX pool's and the port's
tp = 1 pool's within 1e-5.  Each port pool spawns once for the module;
its last cases end a gang on purpose (a rank that raises, host states
that part).  The rank bodies live in ``tests/tp_ranks.py`` (no JAX)."""

import collections
import functools
import os
import signal

import jax
import numpy as np
import pytest
import torch

import tp_ranks
from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models import serve as js
from kubegpu_tpu.models.moe import MoEConfig as JMoEConfig
from kubegpu_tpu.models.moe import moe_init as jmoe_init
from kubegpu_tpu.obs import chaos as jchaos
from kubegpu_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from kubegpu_tpu.obs.spans import Tracer as JaxTracer
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts
from kubegpu_tpu_torch.models.moe import MoEConfig, moe_init
from kubegpu_tpu_torch.obs import chaos as tchaos
from kubegpu_tpu_torch.obs.metrics import MetricsRegistry
from kubegpu_tpu_torch.obs.spans import Tracer

CFG_KW = dict(n_heads=4, n_kv_heads=4, max_seq_len=64)
# the dp pool: affinity routing over the prefix cache, buckets for the
# parity prompts (4-8 tokens) and the shared-chain trace (20)
POOL = dict(n_slots=2, stride=4, prompt_buckets=(8, 24), page_size=8,
            prefix_cache=True)
# tests/test_torch_serve_pool.py's disaggregated pool
DISAGG = dict(n_slots=2, stride=2, prompt_buckets=(8, 16), page_size=8,
              spec_gamma=2, draft_layers=1, prefix_cache=True,
              chunked_prefill=True, prefill_chunk=8)
COUNTERS = ("failovers", "requests_retried", "requests_preempted",
            "requests_resumed", "slots_quarantined", "deadline_misses",
            "drains", "drain_replays", "emitted_tokens", "autoscale_events",
            "routing_affinity_hits", "replicas_active_min",
            "replicas_active_max", "prefill_waves", "slot_steps")
# gauges whose values are the port's own: a wall-clock share, state bytes
OWN_GAUGES = ("serve_host_overhead_pct", "serve_hbm_pool_bytes",
              "serve_hbm_peak_bytes")
EXPORT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the tier-1 run puts six test
    processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights():
    cfg_j = jl.LlamaConfig.tiny(**CFG_KW)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(**CFG_KW), params_t


def parity_prompts(vocab: int) -> list:
    """``tests/test_serve.py::test_dp_pool_exact_parity``'s prompts."""
    return [([(i * 3 + j) % vocab for i in range(4 + j)], 5 + j)
            for j in range(5)]


def chain_trace() -> list:
    """``test_same_trace_routes_identically``'s seeded trace: six 20-token
    prompts sharing a 16-token chain."""
    rng = np.random.default_rng(3)
    lead = rng.integers(1, 32, 16).tolist()
    return [(list(lead) + rng.integers(1, 32, 4).tolist(), 4)
            for _ in range(6)]


def kill_added(mod) -> dict:
    """The chaos of both dp pools: the replica ``add_replica`` builds
    (index 2) dies at its first tick."""
    return {2: mod.ChaosInjector([mod.ChaosEvent(tick=1,
                                                 kind="kill_replica")])}


def dp_scenario(pool, vocab: int) -> dict:
    """The dp pools' scenario (module docstring); what must agree."""
    done = []
    for p, n in parity_prompts(vocab):
        pool.submit(p, n)
    done += pool.drain()
    for p, n in chain_trace():
        pool.submit(p, n)
    done += pool.step()
    pool.retire_replica(1)
    done += pool.drain()
    added = pool.add_replica()
    for p, n in parity_prompts(vocab):
        pool.submit(p, n)
    done += pool.drain()
    seen = {}
    for r in done:
        assert r.rid not in seen, f"rid {r.rid} completed twice"
        seen[r.rid] = (list(r.tokens), r.error)
    out = {"done": seen, "routes": [tuple(x) for x in pool.route_log],
           "dead": sorted(pool.dead_replicas), "added": added,
           "affinity_hit_rate": pool.routing_affinity_hit_rate,
           "queue_tokens": [e.queue.prompt_tokens for e in pool.replicas]}
    out.update({c: getattr(pool, c) for c in COUNTERS})
    return out


def kill_scenario(pool, vocab: int) -> dict:
    """A rank process killed mid-traffic: a replica added on the free
    device block beside replica 0, the parity prompts submitted and one
    pool step run, then rank 1 of the live replica holding the most
    requests gets SIGKILL and the pool drains."""
    fresh = pool.add_replica()
    rids = [pool.submit(p, n) for p, n in parity_prompts(vocab)]
    done = pool.step()
    victim = max(pool._alive(), key=lambda i: (
        len(pool.replicas[i].slot_req) + len(pool.replicas[i].queue), i))
    resident = len(pool.replicas[victim].slot_req) + len(
        pool.replicas[victim].queue)
    failovers, retried = pool.failovers, pool.requests_retried
    os.kill(pool.replicas[victim]._gang._procs[1].pid, signal.SIGKILL)
    done += pool.drain()
    got = {r.rid: (list(r.tokens), r.error) for r in done}
    return {"tokens": [got[r] for r in rids], "fresh": fresh,
            "victim": victim, "resident": resident,
            "failovers": pool.failovers - failovers,
            "retried": pool.requests_retried - retried,
            "dead": dict(pool.dead_replicas),
            "dead_flag": pool.replicas[victim].dead,
            "orphans": pool.replicas[victim].take_orphans(),
            "alive": pool._alive(), "stall_ms": len(pool.stall_ms),
            "hbm_pool_bytes": pool.hbm_pool_bytes,
            "chip_ticks": pool.cost.busy_chip_ticks}


def metric_record(reg) -> dict:
    snap = reg.snapshot()
    return {"counters": snap["counters"],
            "gauges": {k: v for k, v in snap["gauges"].items()
                       if k not in OWN_GAUGES},
            "gauge_names": sorted(snap["gauges"]),
            "hist_counts": {k: h["count"]
                            for k, h in snap["histograms"].items()}}


def span_names(tracer) -> dict:
    return dict(collections.Counter(s.name for s in tracer.spans()))


@functools.lru_cache(maxsize=None)
def _jax_dp() -> dict:
    cfg_j, params_j, _, _ = _weights()
    reg, tracer = JaxRegistry(), JaxTracer()
    pool = js.DataParallelServePool(
        params_j, cfg_j, dp=2, tp=2, devices=jax.devices()[:4],
        metrics=reg, tracer=tracer, chaos=kill_added(jchaos), **POOL)
    rec = dp_scenario(pool, cfg_j.vocab_size)
    return {"rec": rec, "metrics": metric_record(reg),
            "spans": span_names(tracer)}


@functools.lru_cache(maxsize=None)
def _port_dp() -> dict:
    """The port's dp pool through the scenario, then its gangs' own
    checks; every number is taken before the pool is closed."""
    _, _, cfg, params_t = _weights()
    reg, tracer = MetricsRegistry(), Tracer()
    pool = ts.DataParallelServePool(
        params_t, cfg, dp=2, tp=2, devices=["cpu"] * 4, metrics=reg,
        tracer=tracer, chaos=kill_added(tchaos), **POOL)
    try:
        out = {"rec": dp_scenario(pool, cfg.vocab_size),
               "metrics": metric_record(reg), "spans": span_names(tracer)}
        out["anchors"] = [e._engine_anchor for e in pool.replicas]
        out["span_parents"] = {
            s.name: s.parent_id for s in tracer.spans()
            if s.name in ("request.route", "pool.failover", "pool.scale")}
        out["shapes"] = [e.on_ranks(tp_ranks.engine_shapes)
                         for e in pool.replicas]
        out["devices"] = [e.devices for e in pool.replicas]
        out["round_trip_ms"] = list(pool.replicas[0].round_trip_ms)
        out["dead_flags"] = [e.dead for e in pool.replicas]
        out["occupancy"] = pool.occupancy
        out["stall_ms"] = len(pool.stall_ms)
        out["wave_sizes"] = len(pool.replicas[0].wave_sizes)
        out["kill"] = kill_scenario(pool, cfg.vocab_size)
        # a host state that parts on one rank ends its gang at the next
        # call; a rank that raises ends its gang with its traceback
        live = pool.replicas[pool._alive()[0]]
        live.on_ranks(tp_ranks.bump_rid, 1)
        with pytest.raises(RuntimeError) as parted:
            live.step()
        out["parted"] = str(parted.value)
        out["parted_gang_alive"] = live._gang.alive
        dead = pool.replicas[2]
        with pytest.raises(RuntimeError) as raised:
            dead.on_ranks(tp_ranks.raise_on_rank, 1)
        out["raised"] = str(raised.value)
        out["raised_gang_alive"] = dead._gang.alive
        procs = [p for e in pool.replicas for p in e._gang._procs]
    finally:
        pool.close()
    out["alive_after_close"] = [p.is_alive() for p in procs]
    return out


def test_dp_pool_tokens_equal_jax_pool():
    """dp = 2 × tp = 2 through the whole scenario: every request's tokens
    and errors equal the JAX pool's, none returned twice; the parity
    prompts' greedy tokens are the same again after the retire, the add
    and the failover."""
    got, want = _port_dp()["rec"], _jax_dp()["rec"]
    assert got["done"] == want["done"]
    n = len(parity_prompts(tl.LlamaConfig.tiny(**CFG_KW).vocab_size))
    first = [got["done"][i][0] for i in range(n)]
    again = [got["done"][i][0] for i in range(n + 6, 2 * n + 6)]
    assert first == again
    assert all(err is None for _, err in got["done"].values())


def test_dp_pool_routes_and_counters_equal_jax_pool():
    """The route log (affinity pages included), the dead replicas, the
    queued-token totals and every pool counter equal the JAX pool's: the
    host view each gang refreshes from rank 0 after every call routes as
    the in-process engines do."""
    got, want = _port_dp()["rec"], _jax_dp()["rec"]
    for key in ("routes", "dead", "added", "affinity_hit_rate",
                "queue_tokens", *COUNTERS):
        assert got[key] == want[key], key
    assert got["routing_affinity_hits"] > 0


def test_chaos_kill_of_a_gang_fails_over_bit_exact():
    """The added replica's gang dies at its first tick (both ranks raise
    ``ReplicaDeadError``, which reaches the pool as itself): one failover,
    every replayed request finishes with the JAX pool's tokens."""
    got = _port_dp()
    rec = got["rec"]
    assert rec["failovers"] == 1 and rec["requests_retried"] > 0
    assert rec["dead"] == [1, 2]
    assert got["dead_flags"][0] is None
    assert got["dead_flags"][1] == "retired (scale-down)"
    assert got["dead_flags"][2].startswith("chaos: replica killed")


def test_add_and_retire_at_tp2():
    """``retire_replica(1)`` drains through the replay without spending a
    replay; ``add_replica`` builds a gang on the retired replica's device
    block (devices 2-3 of four), each rank on its device with half the
    KV heads and half of wq's columns."""
    got = _port_dp()
    rec = got["rec"]
    assert rec["added"] == 2 and rec["drains"] == 1
    assert rec["drain_replays"] > 0 and rec["autoscale_events"] == 2
    assert got["devices"] == [["cpu", "cpu"]] * 3
    cfg = tl.LlamaConfig.tiny(**CFG_KW)
    for shapes in got["shapes"]:
        assert [s["kv_heads"] for s in shapes] == [cfg.n_kv_heads // 2] * 2
        assert [s["wq_cols"] for s in shapes] == \
            [cfg.n_heads * cfg.head_dim // 2] * 2
        assert {s["backend"] for s in shapes} == {"gloo"}


def test_metrics_equal_jax_pool():
    """Rank 0's metric writes replayed into the pool's registry: counters,
    the schedule's gauges and each histogram's sample count equal the JAX
    pool's."""
    assert _port_dp()["metrics"] == _jax_dp()["metrics"]


def test_ranks_spans_land_in_the_pool_tracer():
    """Rank 0's finished spans reach the pool's tracer: the spans by name
    equal the JAX pool's, and the pool's own spans hang under the
    replicas' engine anchors."""
    got = _port_dp()
    assert got["spans"] == _jax_dp()["spans"]
    anchors = {a.span_id for a in got["anchors"]}
    assert set(got["span_parents"].values()) <= anchors
    assert {"request.route", "pool.failover", "pool.scale"} == set(
        got["span_parents"])


def test_round_trips_and_remote_reads():
    """Each step's round trip is measured (the pool's wall minus rank 0's);
    the host view carries ``stall_ms`` and the counters behind
    ``occupancy``; a value it does not hold (``wave_sizes``) is read from
    rank 0."""
    got = _port_dp()
    assert got["round_trip_ms"] and all(x > 0 for x in got["round_trip_ms"])
    assert 0 < got["occupancy"] <= 1 and got["stall_ms"] > 0
    assert got["wave_sizes"] > 0


def test_a_killed_rank_fails_its_gang_over_bit_exact():
    """SIGKILL to one rank process mid-traffic: the replica's next call
    raises ``ReplicaDeadError``, the pool fails over once from the
    replica's last host view (no orphans: what finished in the dying step
    replays), every replayed request ends with the JAX pool's tokens for
    the same prompts, and the pool reads its aggregates over the dead
    replica and serves on the other one."""
    kill, want = _port_dp()["kill"], _jax_dp()["rec"]["done"]
    n = len(kill["tokens"])
    assert kill["tokens"] == [want[i] for i in range(n)]
    assert kill["resident"] > 0 and kill["failovers"] == 1
    assert kill["retried"] == kill["resident"]
    assert kill["fresh"] == 3 and kill["victim"] in kill["dead"]
    assert kill["dead"][kill["victim"]].startswith("tp gang on")
    assert kill["dead_flag"] == kill["dead"][kill["victim"]]
    assert kill["orphans"] == [] and len(kill["alive"]) == 1
    assert kill["stall_ms"] > 0 and kill["hbm_pool_bytes"] > 0
    assert kill["chip_ticks"] > 0


def test_a_failed_build_closes_the_replicas_built():
    """When replica 1's build raises, the pool's constructor ends the
    replicas already built before the error reaches the caller."""
    built = []

    class Built(ts._GangReplica):
        def __init__(self):
            self.closed = False

        def close(self):
            self.closed = True

    class FailsAtOne(ts.DataParallelServePool):
        def _build_engine(self, i):
            if i == 1:
                raise ValueError("replica 1 cannot be built")
            built.append(Built())
            return built[-1]

    _, _, cfg, params_t = _weights()
    with pytest.raises(ValueError, match="replica 1 cannot be built"):
        FailsAtOne(params_t, cfg, dp=2, devices=["cpu"] * 2, **POOL)
    assert len(built) == 1 and built[0].closed


def test_parted_host_state_and_a_raising_rank_end_the_gang():
    """A rank whose host state parts from rank 0's fails the next call
    with ``RuntimeError``; a rank that raises reaches the caller as
    ``RuntimeError`` with its traceback; each ends its gang, and
    ``close()`` ends every rank process of the pool."""
    got = _port_dp()
    assert "host state parted" in got["parted"]
    assert not got["parted_gang_alive"]
    assert "tp rank 1 failed" in got["raised"]
    assert "Traceback" in got["raised"]
    assert "ArithmeticError: rank 1 raised on purpose" in got["raised"]
    assert not got["raised_gang_alive"]
    assert got["alive_after_close"] and not any(got["alive_after_close"])


# -- the disaggregated pool ---------------------------------------------------

def disagg_scenario(pool, vocab: int) -> dict:
    """Parity prompts through the role-split pool, every export the
    prefill replica hands over recorded (as numpy)."""
    exports = []
    pre = pool.replicas[0]
    real = pre.take_export

    def recorded(rid):
        exp = real(rid)
        if exp is not None:
            exports.append({**exp, "chain": {
                k: np.asarray(v) for k, v in exp["chain"].items()}})
        return exp

    pre.take_export = recorded
    rids = [pool.submit(p, n) for p, n in parity_prompts(vocab)]
    done = {r.rid: (list(r.tokens), r.error) for r in pool.drain()}
    return {"tokens": [done[r] for r in rids], "exports": exports,
            "migrations": pool.migrations,
            "migrated_pages": pool.migrated_pages,
            "routes": [tuple(x) for x in pool.route_log]}


@functools.lru_cache(maxsize=None)
def _disagg(side: str) -> dict:
    cfg_j, params_j, cfg, params_t = _weights()
    if side == "jax":
        pool = js.DisaggServePool(params_j, cfg_j, prefill=1, decode=1, tp=2,
                                  devices=jax.devices()[4:8], **DISAGG)
        return disagg_scenario(pool, cfg.vocab_size)
    tp = 2 if side == "port" else 1
    with ts.DisaggServePool(params_t, cfg, prefill=1, decode=1, tp=tp,
                            devices=["cpu"] * 2 * tp, **DISAGG) as pool:
        return disagg_scenario(pool, cfg.vocab_size)


def test_disagg_pool_equals_jax_pool():
    """``DisaggServePool(1, 1, tp=2)``: tokens, routes, migrations and
    migrated pages equal the JAX pool's at tp = 2 and the port's at
    tp = 1."""
    got, want, one = _disagg("port"), _disagg("jax"), _disagg("tp1")
    for key in ("tokens", "routes", "migrations", "migrated_pages"):
        assert got[key] == want[key] == one[key], key
    assert got["migrations"] == len(parity_prompts(64)) > 0


def test_disagg_exports_hold_every_head():
    """Each export the tp = 2 prefill gang hands over holds the full-head
    chain (all-gathered over its ranks), within 1e-5 of the JAX pool's
    export and of the port's tp = 1 export, with the same length, first
    token and a digest over the full chain."""
    got, want, one = _disagg("port"), _disagg("jax"), _disagg("tp1")
    assert len(got["exports"]) == len(want["exports"]) == len(one["exports"])
    for mine, ref, solo in zip(got["exports"], want["exports"],
                               one["exports"]):
        for k in ("t", "tpad", "pages", "first_token"):
            assert mine[k] == ref[k] == solo[k], k
        assert mine["chain"]["k"].shape[2] == CFG_KW["n_kv_heads"]
        for leaf, x in mine["chain"].items():
            for other in (ref["chain"][leaf], solo["chain"][leaf]):
                assert x.shape == other.shape, leaf
                np.testing.assert_allclose(x, other, rtol=0, atol=EXPORT_TOL,
                                           err_msg=leaf)
        assert mine["digest"] == ts._chain_digest(
            {k: torch.from_numpy(v) for k, v in mine["chain"].items()},
            mine["t"])


def test_moe_at_tp2_is_refused_as_the_reference():
    """A MoE config at tp > 1: the gang's engine raises the reference's
    ``ValueError`` (MoE scales out on dp replicas), which reaches the
    caller as itself, and the gang is ended."""
    cfg_j = JMoEConfig.tiny(max_seq_len=64)
    with pytest.raises(ValueError) as ref:
        js.DataParallelServePool(jmoe_init(jax.random.PRNGKey(2), cfg_j),
                                 cfg_j, dp=1, tp=2,
                                 devices=jax.devices()[:2], **POOL)
    cfg = MoEConfig.tiny(max_seq_len=64)
    with pytest.raises(ValueError) as got:
        ts.DataParallelServePool(moe_init(cfg, device="cpu"), cfg, dp=1,
                                 tp=2, devices=["cpu"] * 2, **POOL)
    assert str(got.value) == str(ref.value)
