"""The port's fleet harness (``kubegpu_tpu_torch/fleet.py``: simulated
replicas under the port's REAL pools) against the JAX package's: a
counterpart of each test of ``tests/test_fleet.py``, run once through each
package, with the reference's assertions held on the port and the port's
results held equal to the reference's: the simulated engines' tokens and
admission logs, the pools' tokens and counters, and every field of
``run_fleet``'s ``FleetReport`` (its ``LoadReport`` records and per-tier
aggregates, the chaos, upgrade and recovery counters, the chip-tick
ledger and ``sim_ms``) but the wall clock.

Everything here is host-only: the fleet's replicas sit on the ``meta``
device and never touch a card, and the file never builds a model."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import kubegpu_tpu.fleet as jfleet
import kubegpu_tpu.loadgen as jlg
import kubegpu_tpu.obs.chaos as jchaos
import kubegpu_tpu.obs.metrics as jmetrics
import kubegpu_tpu.obs.tsdb as jtsdb
import kubegpu_tpu_torch.fleet as tfleet
import kubegpu_tpu_torch.loadgen as tlg
import kubegpu_tpu_torch.obs.chaos as tchaos
import kubegpu_tpu_torch.obs.metrics as tmetrics
import kubegpu_tpu_torch.obs.tsdb as ttsdb

PORT = types.SimpleNamespace(fleet=tfleet, lg=tlg, chaos=tchaos,
                             metrics=tmetrics, tsdb=ttsdb)
REF = types.SimpleNamespace(fleet=jfleet, lg=jlg, chaos=jchaos,
                            metrics=jmetrics, tsdb=jtsdb)
BOTH = pytest.mark.parametrize("m", [PORT, REF], ids=["port", "ref"])


def tiers(m):
    T = m.lg.TierSpec
    return (T("gold", ttft_slo_ticks=40, token_slo_ticks=40.0, share=0.2),
            T("silver", ttft_slo_ticks=80, token_slo_ticks=80.0,
              share=0.3),
            T("bronze", ttft_slo_ticks=10**6, token_slo_ticks=1e6,
              share=0.5))


def mk_trace(m, n=96, seed=1907, **kw):
    spec = dict(seed=seed, n_requests=n, mean_iat_ticks=0.25,
                tiers=tiers(m), diurnal=True, flash_at=(10.0,),
                flash_rate_x=4.0, flash_len_ticks=8.0)
    spec.update(kw)
    return m.lg.synth_trace(m.lg.LoadSpec(**spec))


def drain_engine(eng):
    out = []
    while eng.slot_req or eng.queue:
        out.extend(eng.step())
    return out


def load_fields(rep) -> dict:
    """A LoadReport without its wall clock, records as plain values."""
    d = rep.as_dict()
    d.pop("wall_s")
    d.pop("goodput_tokens_per_s")
    d["records"] = [{k: (np.asarray(v).tolist() if k == "prompt" else v)
                     for k, v in r.items()} for r in rep.records]
    return d


def fleet_fields(rep) -> dict:
    d = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)
         if f.name != "load"}
    d["load"] = load_fields(rep.load)
    return d


def both(fn):
    """``fn(PORT)`` and ``fn(REF)``: the port's result, checked equal to
    the reference's."""
    got, want = fn(PORT), fn(REF)
    assert got == want
    return got


def run(m, *a, **kw):
    return m.fleet.run_fleet(mk_trace(m, *a), tiers(m), **kw)


def domain_kill(m, tick, domain):
    return m.chaos.DomainChaosInjector(events=[m.chaos.DomainChaosEvent(
        tick=tick, kind=m.chaos.DOMAIN_KILL, domain=domain)])


# -- the simulated engine ----------------------------------------------

class TestSimEngine:
    def test_tokens_deterministic_pure_function_of_sequence(self):
        def case(m):
            a = m.fleet.SimReplicaEngine(m.fleet.FleetConfig())
            b = m.fleet.SimReplicaEngine(m.fleet.FleetConfig())
            pa, pb = a.submit([3, 5, 7], 6), b.submit([3, 5, 7], 6)
            ra = {r.rid: r for r in drain_engine(a)}[pa]
            rb = {r.rid: r for r in drain_engine(b)}[pb]
            assert ra.tokens == rb.tokens and len(ra.tokens) == 6
            assert all(1 <= t < m.fleet.FleetConfig().vocab
                       for t in ra.tokens)
            return ra.tokens
        both(case)

    def test_replay_as_prompt_plus_accepted_is_bit_exact(self):
        def case(m):
            ref = m.fleet.SimReplicaEngine(m.fleet.FleetConfig())
            full_rid = ref.submit([3, 5, 7], 8)
            full = {r.rid: r for r in drain_engine(ref)}[full_rid]
            head = full.tokens[:3]
            eng = m.fleet.SimReplicaEngine(m.fleet.FleetConfig())
            rid = eng.submit(np.concatenate(
                [np.asarray([3, 5, 7], np.int32),
                 np.asarray(head, np.int32)]), 5)
            tail = {r.rid: r for r in drain_engine(eng)}[rid]
            assert head + tail.tokens == full.tokens
            return full.tokens
        both(case)

    def test_strict_tier_admission_no_inversion(self):
        def case(m):
            eng = m.fleet.SimReplicaEngine(m.fleet.FleetConfig(n_slots=1))
            for p, tier in (([2, 2], 2), ([3, 3], 0), ([4, 4], 1)):
                eng.submit(p, 2, tier=tier)
            drain_engine(eng)
            order = [t for _, t, _ in eng.admission_log]
            assert order == sorted(order) and eng.tier_inversions == 0
            assert eng.queue.prompt_tokens == 0
            return eng.admission_log
        both(case)

    def test_prefix_registry_shortens_prefill(self):
        def case(m):
            cfg = m.fleet.FleetConfig(page_size=4, prefill_tokens_per_tick=4)
            eng = m.fleet.SimReplicaEngine(cfg)
            prompt = list(range(1, 17))
            r1 = eng.submit(prompt, 2)
            first = {r.rid: r for r in drain_engine(eng)}[r1]
            r2 = eng.submit(prompt, 2)
            second = {r.rid: r for r in drain_engine(eng)}[r2]
            assert second.tokens == first.tokens
            cold = first.first_tick - first.submit_tick
            warm = second.first_tick - second.submit_tick
            assert warm < cold
            return cold, warm, first.tokens
        both(case)

    def test_kill_stashes_finishers_as_orphans(self):
        def case(m):
            eng = m.fleet.SimReplicaEngine(
                m.fleet.FleetConfig(),
                chaos=m.chaos.ChaosInjector(events=[m.chaos.ChaosEvent(
                    tick=1, kind=m.chaos.KILL)]))
            eng.submit([5, 5], 2)
            eng.step()
            with pytest.raises(m.chaos.ReplicaDeadError):
                eng.step()
            assert eng.dead is not None
            done = [r for r in eng.take_orphans() if r.done]
            assert len(done) == 1 and len(done[0].tokens) == 2
            return done[0].tokens, eng.dead
        both(case)

    def test_bench_calibration_reads_rows_or_defaults(self, tmp_path):
        """The parser reads a bench row of the reference's layout written
        to a temporary directory, as the reference's does, and falls back
        to the defaults where there is none."""
        row = {"parsed": {"details": {"model": {"serving": {
            "decode_tokens_per_s": 4000.0, "batch": 8,
            "prefill_tokens_per_s": 50000.0}}}}}
        (tmp_path / "BENCH_r01.json").write_text(__import__("json").dumps(
            row))

        def case(m):
            c = m.fleet.ReplicaCosts.from_bench(root=str(tmp_path / "none"))
            assert c.block_ms == m.fleet.ReplicaCosts.block_ms
            c2 = m.fleet.ReplicaCosts.from_bench(root=str(tmp_path))
            assert c2.block_ms > 0 and c2.prefill_ms_per_token > 0
            return dataclasses.astuple(c), dataclasses.astuple(c2)
        got = both(case)
        assert got[1][:2] == (2.0, 0.02)


# -- the real pool over sim engines ------------------------------------

class TestFleetPool:
    def test_failover_exactly_once_bit_exact(self):
        def case(m):
            cfg = m.fleet.FleetConfig()
            ref = m.fleet.FleetPool(cfg, dp=2)
            pool = m.fleet.FleetPool(cfg, dp=2, chaos={
                0: m.chaos.ChaosInjector(events=[m.chaos.ChaosEvent(
                    tick=3, kind=m.chaos.KILL)])})
            prompts = [[i + 2, i + 3, i + 4] for i in range(6)]
            want, got = {}, {}
            for p in prompts:
                want[tuple(p)] = ref.submit(p, 6)
                got[tuple(p)] = pool.submit(p, 6)
            ref_out = {r.rid: r for r in ref.drain()}
            out = {r.rid: r for r in pool.drain()}
            assert pool.failovers >= 1 and len(out) == len(prompts)
            for p in prompts:
                assert (out[got[tuple(p)]].tokens
                        == ref_out[want[tuple(p)]].tokens)
            return ([out[got[tuple(p)]].tokens for p in prompts],
                    pool.failovers, pool.requests_retried,
                    pool.route_log)
        both(case)

    def test_no_device_touched(self):
        """Every replica of a fleet pool is a simulated engine on the
        ``meta`` device: the pool builds and runs on a host with no card
        and never initializes CUDA."""
        pool = tfleet.FleetPool(tfleet.FleetConfig(), dp=4, max_replicas=6)
        assert all(d.type == "meta" for d in pool._devs)
        assert all(isinstance(e, tfleet.SimReplicaEngine)
                   for e in pool.replicas)
        for i in range(8):
            pool.submit([i + 2, i + 3, i + 4], 5)
        i = pool.add_replica()
        assert isinstance(pool.replicas[i], tfleet.SimReplicaEngine)
        assert len(pool.drain()) == 8
        assert pool._params_by_dev == {}
        assert not torch.cuda.is_initialized()

    def test_dead_replica_gauge_deleted_after_harvest(self):
        def case(m):
            reg = m.metrics.MetricsRegistry()
            pool = m.fleet.FleetPool(
                m.fleet.FleetConfig(), dp=2, metrics=reg,
                chaos={1: m.chaos.ChaosInjector(events=[
                    m.chaos.ChaosEvent(tick=1, kind=m.chaos.KILL)])})
            for i in range(4):
                pool.submit([i + 2, i + 3], 4)
            pool.drain()
            assert 1 in pool.dead_replicas
            gauges = reg.snapshot()["gauges"]
            assert "serve_replica_queue_depth_r1" not in gauges
            assert "serve_replica_queue_depth_r0" in gauges
            return sorted(gauges), reg.snapshot()["counters"]
        both(case)

    def test_dead_replica_series_ends_at_harvest_choke_point(self):
        def case(m):
            reg = m.metrics.MetricsRegistry()
            store = m.tsdb.SeriesStore(reg)
            pool = m.fleet.FleetPool(
                m.fleet.FleetConfig(), dp=2, metrics=reg,
                chaos={1: m.chaos.ChaosInjector(events=[
                    m.chaos.ChaosEvent(tick=1, kind=m.chaos.KILL)])})
            for i in range(4):
                pool.submit([i + 2, i + 3], 4)
            tick = 0
            while pool._entries or pool._pending_deaths:
                pool.step()
                store.sample(tick)
                tick += 1
            assert 1 in pool.dead_replicas
            assert store.ended("serve_replica_queue_depth_r1")
            assert not store.ended("serve_replica_queue_depth_r0")
            dead = store.series("serve_replica_queue_depth_r1")
            alive = store.series("serve_replica_queue_depth_r0")
            assert alive and alive[-1][0] > (dead[-1][0] if dead else -1)
            return dead, alive
        both(case)

    def test_disagg_migration_over_sim_engines(self):
        def case(m):
            pool = m.fleet.FleetDisaggPool(m.fleet.FleetConfig(),
                                           prefill=1, decode=1)
            ref = m.fleet.FleetPool(m.fleet.FleetConfig(), dp=1)
            rids, refs = [], []
            for i in range(4):
                p = [i + 2, i + 3, i + 4, i + 5]
                rids.append(pool.submit(p, 8))
                refs.append(ref.submit(p, 8))
            out = {r.rid: r for r in pool.drain()}
            ref_out = {r.rid: r for r in ref.drain()}
            assert pool.migrations >= 1 and len(out) == 4
            for rid, rref in zip(rids, refs):
                assert out[rid].tokens == ref_out[rref].tokens
            return [out[r].tokens for r in rids], pool.migrations
        both(case)


# -- correlated failure domains ----------------------------------------

class TestDomainChaos:
    @BOTH
    def test_injector_validates_scope(self, m):
        with pytest.raises(ValueError):
            m.chaos.DomainChaosInjector(events=[m.chaos.DomainChaosEvent(
                tick=1, kind=m.chaos.KILL)])
        with pytest.raises(ValueError):
            m.chaos.DomainChaosInjector(events=[m.chaos.DomainChaosEvent(
                tick=1, kind=m.chaos.DOMAIN_KILL)])

    def test_from_seed_deterministic(self):
        def case(m):
            a = m.chaos.DomainChaosInjector.from_seed(
                7, 50, ("rack0", "rack1"), n_events=4)
            b = m.chaos.DomainChaosInjector.from_seed(
                7, 50, ("rack0", "rack1"), n_events=4)
            assert a.events == b.events
            return [dataclasses.astuple(e) for e in a.events]
        both(case)

    def test_quarter_fleet_dies_in_one_tick_outcomes_identical(self):
        def case(m):
            twin = run(m, replicas=64, domains=4)
            rep = run(m, replicas=64, domains=4,
                      chaos=domain_kill(m, 12, "rack1"))
            assert rep.killed_replicas == 16 and rep.failovers >= 16
            assert rep.load.lost == 0 and rep.load.duplicated == 0
            assert rep.tier_inversions == 0
            assert m.fleet.compare_outcomes(twin.load,
                                            rep.load)["identical"]
            return fleet_fields(twin), fleet_fields(rep)
        both(case)

    def test_watch_weather_dup_delay_reorder_idempotent(self):
        def case(m):
            E, c = m.chaos.DomainChaosEvent, m.chaos
            twin = run(m, replicas=16, domains=4)
            rep = run(m, replicas=16, domains=4,
                      chaos=c.DomainChaosInjector(events=[
                          E(tick=8, kind=c.WATCH_DUP, dup=3,
                            duration_ticks=8),
                          E(tick=8, kind=c.WATCH_DELAY, delay_ticks=3,
                            duration_ticks=8),
                          E(tick=8, kind=c.WATCH_REORDER, duration_ticks=8),
                          E(tick=10, kind=c.DOMAIN_KILL, domain="rack2")]))
            assert rep.watch_delivered >= 12
            assert rep.load.lost == 0 and rep.load.duplicated == 0
            assert m.fleet.compare_outcomes(twin.load,
                                            rep.load)["identical"]
            return fleet_fields(rep)
        both(case)

    def test_watch_partition_stale_reads_then_heal(self):
        def case(m):
            E, c = m.chaos.DomainChaosEvent, m.chaos
            twin = run(m, replicas=16, domains=4)
            rep = run(m, replicas=16, domains=4,
                      chaos=c.DomainChaosInjector(events=[
                          E(tick=9, kind=c.WATCH_PARTITION,
                            duration_ticks=6),
                          E(tick=10, kind=c.DOMAIN_EVICT, domain="rack3")]))
            assert rep.domain_evictions == 1 and rep.watch_delivered >= 4
            assert rep.load.lost == 0 and rep.load.duplicated == 0
            assert m.fleet.compare_outcomes(twin.load,
                                            rep.load)["identical"]
            return fleet_fields(rep)
        both(case)

    def test_deterministic_by_seed(self):
        def case(m):
            a, b = (run(m, replicas=32, domains=4,
                        chaos=domain_kill(m, 12, "rack0"))
                    for _ in range(2))
            cmp_ = m.fleet.compare_outcomes(a.load, b.load)
            assert cmp_["identical"] and cmp_["checked"] == 96
            return fleet_fields(a)
        both(case)


# -- rolling upgrades ---------------------------------------------------

class TestRollingUpgrade:
    def test_waves_cover_all_domains_floor_held(self):
        def case(m):
            twin = run(m, replicas=64, domains=4)
            rep = run(m, replicas=64, domains=4, upgrade=True,
                      upgrade_floor=56, upgrade_surge=4, upgrade_start=8)
            assert rep.upgrade_waves == 4 and rep.upgraded_replicas == 64
            assert rep.min_alive >= 56
            assert rep.load.lost == 0 and rep.load.duplicated == 0
            assert rep.tier_inversions == 0
            assert m.fleet.compare_outcomes(twin.load,
                                            rep.load)["identical"]
            return fleet_fields(rep)
        both(case)

    def test_surge_credit_returns_fleet_to_nominal(self):
        def case(m):
            pool = m.fleet.FleetPool(m.fleet.FleetConfig(), dp=8,
                                     max_replicas=24)
            topo = m.fleet.FleetTopology.grid(8, 2)
            for i in range(8):
                pool.bind_replica_gang(i, f"g{i}")
            upg = m.fleet.UpgradeWaveController(pool, topo, floor=6,
                                                surge=2)
            tick = 0
            while not upg.done and tick < 200:
                upg.on_tick(tick)
                pool.step()
                tick += 1
            assert upg.done and upg.waves_done == 2
            assert len(pool._alive()) == 8 and upg.min_alive >= 6
            return tick, upg.upgraded, topo.domains, pool._alive()
        both(case)


# -- control-plane crash recovery ---------------------------------------

class TestCrashRecovery:
    def test_mid_trace_crash_recovers_exactly_once(self):
        def case(m):
            twin = run(m, replicas=32, domains=4)
            journal = m.fleet.ControlPlaneJournal()
            rep = run(m, replicas=32, domains=4, journal=journal,
                      crash_at=12)
            assert rep.recoveries == 1 and rep.redriven >= 1
            assert rep.load.lost == 0 and rep.load.duplicated == 0
            assert rep.tier_inversions == 0
            assert m.fleet.compare_outcomes(twin.load,
                                            rep.load)["identical"]
            c = journal.counts()
            assert c["crash"] == 1 and c["recovered"] == 1
            assert c["finish"] >= c["submit"]
            assert c["resubmit"] == rep.redriven
            return fleet_fields(rep), journal.records
        both(case)

    def test_journal_inflight_is_submits_minus_finishes(self):
        def case(m):
            j = m.fleet.ControlPlaneJournal()
            j.append("submit", gid=0, tier=0)
            j.append("submit", gid=1, tier=1)
            j.append("finish", gid=0)
            assert j.inflight() == [1]
            return j.records, j.counts()
        both(case)

    def test_recovery_redrives_in_tier_order(self):
        def case(m):
            journal = m.fleet.ControlPlaneJournal()
            run(m, replicas=32, domains=4, journal=journal, crash_at=12)
            redriven = [r["tier"] for r in journal.records
                        if r["kind"] == "resubmit"]
            assert redriven == sorted(redriven)
            return redriven
        both(case)


# -- loadgen extensions -------------------------------------------------

class TestLoadgenFleetKnobs:
    def test_default_knobs_leave_traces_bit_identical(self):
        def case(m):
            base = dict(seed=11, n_requests=24, tiers=tiers(m))
            a = m.lg.synth_trace(m.lg.LoadSpec(**base))
            b = m.lg.synth_trace(m.lg.LoadSpec(**base, diurnal=False,
                                               flash_at=()))
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x["arrival_tick"] == y["arrival_tick"]
                assert np.array_equal(x["prompt"], y["prompt"])
            return [(e["arrival_tick"], e["prompt"].tolist()) for e in a]
        both(case)

    def test_diurnal_and_flash_modulate_arrivals(self):
        def case(m):
            base = dict(seed=11, n_requests=48, tiers=tiers(m))
            ticks = [[e["arrival_tick"] for e in m.lg.synth_trace(
                m.lg.LoadSpec(**base, **kw))] for kw in (
                {}, {"diurnal": True},
                {"flash_at": (2.0,), "flash_rate_x": 8.0,
                 "flash_len_ticks": 10.0})]
            t, td, tf = ticks
            assert td != t and tf != t and tf[-1] < t[-1]
            return ticks
        both(case)


# -- chip-tick cost attribution -----------------------------------------

class TestChipTickAttribution:
    def test_conservation_exact_under_domain_kill(self):
        def case(m):
            trace = m.lg.synth_trace(m.lg.LoadSpec(
                seed=1907, n_requests=96, mean_iat_ticks=0.25,
                tiers=tiers(m), tenants=("acme", "blue", "coral"),
                diurnal=True))
            rep = m.fleet.run_fleet(trace, tiers(m), replicas=16,
                                    domains=4,
                                    chaos=domain_kill(m, 10, "rack1"))
            assert rep.busy_chip_ticks > 0
            assert sum(rep.cost_by_key.values()) == rep.busy_chip_ticks
            assert rep.busy_chip_ticks == rep.busy_ticks
            assert all(isinstance(v, int)
                       for v in rep.cost_by_key.values())
            assert {k.split(":")[0] for k in rep.cost_by_key} \
                == {"acme", "blue", "coral"}
            return fleet_fields(rep)
        both(case)

    def test_crash_closure_keeps_pre_crash_charges(self):
        def case(m):
            rep = run(m, 64, replicas=16, domains=4,
                      journal=m.fleet.ControlPlaneJournal(), crash_at=12)
            assert rep.recoveries == 1
            assert sum(rep.cost_by_key.values()) == rep.busy_chip_ticks
            assert rep.busy_chip_ticks == rep.busy_ticks
            return fleet_fields(rep)
        both(case)

    def test_cost_summary_joins_goodput(self):
        def case(m):
            trace = m.lg.synth_trace(m.lg.LoadSpec(
                seed=7, n_requests=48, mean_iat_ticks=0.25,
                tiers=tiers(m), tenants=("acme", "blue")))
            rep = m.fleet.run_fleet(trace, tiers(m), replicas=8, domains=4)
            cs = rep.cost_summary()
            assert cs["busy_chip_ticks"] == rep.busy_chip_ticks
            assert cs["attributed_chip_ticks"] == rep.busy_chip_ticks
            for row in cs["per_key"].values():
                assert row["chip_ticks"] >= 0
                assert row["goodput_tokens"] <= row["total_tokens"]
                if row["chip_ticks"]:
                    assert row["goodput_per_chip_tick"] == pytest.approx(
                        row["goodput_tokens"] / row["chip_ticks"],
                        rel=1e-3)
            assert cs["goodput_per_chip_tick"] > 0
            return cs
        both(case)

    def test_suffixed_gauges_published(self):
        def case(m):
            reg = m.metrics.MetricsRegistry()
            trace = m.lg.synth_trace(m.lg.LoadSpec(
                seed=7, n_requests=32, mean_iat_ticks=0.25,
                tiers=tiers(m), tenants=("acme",)))
            rep = m.fleet.run_fleet(trace, tiers(m), replicas=8, domains=4,
                                    metrics=reg)
            g = reg.snapshot()["gauges"]
            assert g["serve_chip_ticks_total"] == float(rep.busy_chip_ticks)
            per = {k: v for k, v in g.items()
                   if k.startswith("serve_chip_ticks_total_")}
            assert per and sum(per.values()) == float(rep.busy_chip_ticks)
            return per, reg.snapshot()["counters"]
        both(case)

    def test_attribution_is_deterministic(self):
        def case(m):
            a = run(m, 48, replicas=8, domains=4)
            b = run(m, 48, replicas=8, domains=4)
            assert a.cost_by_key == b.cost_by_key
            assert a.busy_chip_ticks == b.busy_chip_ticks
            return a.cost_by_key
        both(case)
