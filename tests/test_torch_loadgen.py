"""The port's open-loop load harness (``kubegpu_tpu_torch/loadgen.py``)
against the JAX package's: ``synth_trace`` gives the reference's trace
bit for bit from one seed (bursty, diurnal, flash-crowd and
prefix-sharing specs), and ``run_load`` over the port's engine and its
dp=2 affinity pool gives the whole ``LoadReport`` the reference's
``run_load`` gives over the JAX engine and pool on the same converted f32
weights (records with their tokens and tick stamps, per-tier
aggregates, goodput a tick, lost and duplicated, the chip-tick ledger);
then a counterpart of each test of ``tests/test_loadgen.py`` on the
port's own harness, engine and ledger.  The JAX pool keeps every replica
on its first virtual CPU device (one compile)."""

import random

import jax
import numpy as np
import pytest

from kubegpu_tpu import loadgen as jlg
from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models import serve as js
from kubegpu_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from kubegpu_tpu_torch import loadgen as tlg
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.loadgen import TierSpec, run_load, synth_trace
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts
from kubegpu_tpu_torch.obs.cost import CostLedger
from kubegpu_tpu_torch.obs.metrics import MetricsRegistry

TIERS = (TierSpec("gold", ttft_slo_ticks=8, token_slo_ticks=4.0,
                  share=0.3),
         TierSpec("std", ttft_slo_ticks=30, token_slo_ticks=8.0,
                  share=0.4),
         TierSpec("batch", ttft_slo_ticks=10 ** 6,
                  token_slo_ticks=10 ** 6.0, share=0.3))
ENGINE = dict(n_slots=2, stride=2, prompt_buckets=(8, 16), paged=True,
              page_size=8, total_pages=12, prefix_cache=True)


def _spec(mod=tlg, **kw):
    kw.setdefault("seed", 7)
    kw.setdefault("n_requests", 24)
    kw.setdefault("mean_iat_ticks", 0.9)
    kw.setdefault("burst", True)
    kw.setdefault("prompt_len_max", 8)
    kw.setdefault("out_len_min", 2)
    kw.setdefault("out_len_max", 8)
    kw.setdefault("prefix_share", 0.4)
    kw.setdefault("prefix_len", 4)
    kw.setdefault("vocab", 48)
    tiers = kw.pop("tiers", TIERS)
    kw["tiers"] = tuple(mod.TierSpec(t.name, t.ttft_slo_ticks,
                                     t.token_slo_ticks, t.share)
                        for t in tiers)
    return mod.LoadSpec(**kw)


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny(max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(max_seq_len=64), params_t


def _eng(params, cfg, **kw):
    return ts.ContinuousBatcher(params, cfg, device="cpu",
                                **dict(ENGINE, **kw))


# -- the trace, bit for bit against the reference's ---------------------

# (seed, knobs): every knob on its own and together, over 24 seeds
TRACE_KNOBS = [
    {}, {"burst": False}, {"prefix_share": 1.0, "n_shared_prefixes": 1},
    {"diurnal": True}, {"flash_at": (2.0, 9.0), "flash_rate_x": 6.0},
    {"diurnal": True, "flash_at": (4.0,), "prefix_share": 0.7,
     "tenants": ("acme", "blue", "coral")},
    {"prompt_len_mean": 2.2, "prompt_len_max": 32, "prefix_len": 8,
     "out_len_max": 24, "burst_rate_x": 8.0},
    {"mean_iat_ticks": 0.25, "diurnal": True, "diurnal_period_ticks": 32.0,
     "diurnal_depth": 0.9},
]
TRACE_CASES = [(seed, TRACE_KNOBS[seed % len(TRACE_KNOBS)])
               for seed in range(24)]


@pytest.mark.parametrize("seed,knobs", TRACE_CASES,
                         ids=[f"s{s}" for s, _ in TRACE_CASES])
def test_trace_equals_reference(seed, knobs):
    got = synth_trace(_spec(seed=seed, n_requests=40, **knobs))
    want = jlg.synth_trace(_spec(jlg, seed=seed, n_requests=40, **knobs))
    assert len(got) == len(want) == 40
    for x, y in zip(got, want):
        assert x.keys() == y.keys()
        assert (x["arrival_tick"], x["max_new"], x["tier"], x["tenant"]) \
            == (y["arrival_tick"], y["max_new"], y["tier"], y["tenant"])
        assert x["prompt"].dtype == y["prompt"].dtype == np.int32
        np.testing.assert_array_equal(x["prompt"], y["prompt"])


# -- run_load: the whole report against the reference's -----------------

RECORD_KEYS = ("rid", "tier", "tenant", "max_new", "completed", "slo_met",
               "tokens", "error", "ttft_ticks", "ticks_per_token")


def _report(rep) -> dict:
    """Everything of a report but the wall clock: the summary, and each
    record's fields (the prompt as a list)."""
    d = rep.as_dict()
    d.pop("wall_s")
    d.pop("goodput_tokens_per_s")
    d["records"] = [dict({k: r.get(k) for k in RECORD_KEYS},
                         prompt=np.asarray(r["prompt"]).tolist())
                    for r in rep.records]
    return d


def _tenant_trace(mod):
    return mod.synth_trace(_spec(mod, tenants=("acme", "blue")))


@pytest.mark.parametrize("tiered", [True, False], ids=["tiered", "fifo"])
def test_engine_report_equals_reference(tiny, tiered):
    cfg_j, params_j, cfg, params_t = tiny
    reg = MetricsRegistry()
    eng = _eng(params_t, cfg, metrics=reg)
    got = run_load(eng, _tenant_trace(tlg), TIERS, tiered=tiered,
                   metrics=reg)
    jreg = JaxRegistry()
    ref = js.ContinuousBatcher(params_j, cfg_j, metrics=jreg, **ENGINE)
    want = jlg.run_load(ref, _tenant_trace(jlg), _spec(jlg).tiers,
                        tiered=tiered, metrics=jreg)
    assert _report(got) == _report(want)
    assert got.lost == got.duplicated == 0
    assert got.busy_chip_ticks == eng.busy_ticks > 0
    assert got.cost_summary() == want.cost_summary()
    g, jg = reg.snapshot()["gauges"], jreg.snapshot()["gauges"]
    for name in ("serve_goodput_tokens_per_tick", "serve_slo_attainment",
                 "serve_chip_ticks_total"):
        assert g[name] == jg[name], name


def test_affinity_pool_report_equals_reference(tiny):
    cfg_j, params_j, cfg, params_t = tiny
    kw = {k: v for k, v in ENGINE.items() if k != "paged"}
    pool = ts.DataParallelServePool(params_t, cfg, dp=2,
                                    devices=["cpu"] * 2,
                                    metrics=MetricsRegistry(),
                                    routing="affinity", **kw)
    spec = dict(prefix_share=0.8, prefix_len=8, prompt_len_mean=2.5,
                prompt_len_max=16, n_requests=32, mean_iat_ticks=0.5)
    got = run_load(pool, synth_trace(_spec(**spec)), TIERS)
    ref = js.DataParallelServePool(params_j, cfg_j, dp=2,
                                   devices=[jax.devices()[0]] * 2,
                                   metrics=JaxRegistry(),
                                   routing="affinity", **kw)
    want = jlg.run_load(ref, jlg.synth_trace(_spec(jlg, **spec)),
                        _spec(jlg).tiers)
    assert _report(got) == _report(want)
    assert got.lost == got.duplicated == 0
    assert pool.route_log == ref.route_log
    assert pool.routing_affinity_hits == ref.routing_affinity_hits > 0


# -- counterparts of tests/test_loadgen.py ------------------------------

class TestSynthTrace:
    def test_same_seed_same_trace_bit_for_bit(self):
        a, b = synth_trace(_spec()), synth_trace(_spec())
        assert len(a) == len(b) == 24
        for x, y in zip(a, b):
            assert x["arrival_tick"] == y["arrival_tick"]
            assert x["max_new"] == y["max_new"]
            assert x["tier"] == y["tier"]
            assert x["tenant"] == y["tenant"]
            assert np.array_equal(x["prompt"], y["prompt"])

    def test_different_seed_different_trace(self):
        a = synth_trace(_spec(seed=7))
        b = synth_trace(_spec(seed=8))
        assert any(
            x["arrival_tick"] != y["arrival_tick"]
            or not np.array_equal(x["prompt"], y["prompt"])
            for x, y in zip(a, b))

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_invariants_hold_for_arbitrary_seeds(self, seed):
        spec = _spec(seed=seed, n_requests=40)
        trace = synth_trace(spec)
        assert len(trace) == 40
        ticks = [e["arrival_tick"] for e in trace]
        assert ticks == sorted(ticks)
        for e in trace:
            assert 1 <= len(e["prompt"]) <= spec.prompt_len_max
            assert spec.out_len_min <= e["max_new"] <= spec.out_len_max
            assert 0 <= e["tier"] < len(spec.tiers)
            assert e["tenant"] in spec.tenants
            assert e["prompt"].dtype == np.int32
            assert all(0 < t < spec.vocab for t in e["prompt"])

    def test_prefix_sharing_actually_shares(self):
        spec = _spec(prefix_share=1.0, n_shared_prefixes=1,
                     prompt_len_mean=2.0, n_requests=40)
        trace = synth_trace(spec)
        long_prompts = [e["prompt"] for e in trace
                        if len(e["prompt"]) > spec.prefix_len]
        assert len(long_prompts) >= 2
        heads = {p[:spec.prefix_len].tobytes() for p in long_prompts}
        assert len(heads) == 1, "prefix_share=1.0 must reuse the prefix"
        off = synth_trace(_spec(prefix_share=0.0, prompt_len_mean=2.0,
                                n_requests=40))
        heads_off = {e["prompt"][:spec.prefix_len].tobytes()
                     for e in off if len(e["prompt"]) > spec.prefix_len}
        assert len(heads_off) > 1


class TestRunLoad:
    def test_exactly_once_and_goodput_decomposition(self, tiny):
        _, _, cfg, params = tiny
        reg = MetricsRegistry()
        eng = _eng(params, cfg, metrics=reg)
        trace = synth_trace(_spec())
        rep = run_load(eng, trace, TIERS, tiered=True, metrics=reg)
        assert rep.submitted == len(trace)
        assert rep.lost == 0 and rep.duplicated == 0
        assert rep.completed + rep.failed == rep.submitted
        assert 0.0 <= rep.slo_attainment <= 1.0
        assert rep.goodput_tokens <= rep.total_tokens
        assert rep.goodput_tokens == sum(
            a["goodput_tokens"] for a in rep.per_tier.values())
        assert sum(a["submitted"] for a in rep.per_tier.values()) \
            == rep.submitted
        assert rep.ticks > 0 and rep.goodput_tokens_per_tick == \
            pytest.approx(rep.goodput_tokens / rep.ticks)
        assert len(rep.records) == rep.submitted
        assert all(rec["tokens"] for rec in rep.records
                   if rec["completed"])
        g = reg.snapshot()["gauges"]
        assert g["serve_goodput_tokens_per_tick"] == \
            pytest.approx(rep.goodput_tokens_per_tick, abs=1e-3)
        assert g["serve_slo_attainment"] == \
            pytest.approx(rep.slo_attainment, abs=1e-3)
        assert "serve_slo_attainment_t0" in g
        assert g["serve_goodput_tokens_per_s"] >= 0

    def test_deterministic_twin_same_seed_same_report(self, tiny):
        _, _, cfg, params = tiny
        trace = synth_trace(_spec())

        def one():
            return run_load(_eng(params, cfg, metrics=MetricsRegistry()),
                            trace, TIERS, tiered=True)
        a, b = one(), one()
        da, db = a.as_dict(), b.as_dict()
        da.pop("wall_s"), db.pop("wall_s")
        da.pop("goodput_tokens_per_s"), db.pop("goodput_tokens_per_s")
        assert da == db
        assert [r["tokens"] for r in a.records] == \
            [r["tokens"] for r in b.records]

    def test_fifo_leg_scores_against_intended_tier(self, tiny):
        _, _, cfg, params = tiny
        trace = synth_trace(_spec())
        rep = run_load(_eng(params, cfg, metrics=MetricsRegistry()),
                       trace, TIERS, tiered=False,
                       metrics=MetricsRegistry())
        by_tier = {k: a["submitted"] for k, a in rep.per_tier.items()}
        want = {k: sum(1 for e in trace if e["tier"] == k)
                for k in range(len(TIERS))}
        assert by_tier == want
        assert sum(want.values()) == len(trace)

    def test_stuck_run_raises_not_hangs(self, tiny):
        _, _, cfg, params = tiny
        trace = synth_trace(_spec(n_requests=6))
        with pytest.raises(RuntimeError, match="did not go idle"):
            run_load(_eng(params, cfg, metrics=MetricsRegistry()),
                     trace, TIERS, tiered=True, max_ticks=2)


class TestCostLedger:
    def test_largest_remainder_conserves_exactly(self):
        rng = random.Random(20)
        led = CostLedger()
        for _ in range(300):
            n = rng.randrange(0, 5)
            led.charge([("t%d" % rng.randrange(3), rng.randrange(3),
                         rng.randrange(0, 7)) for _ in range(n)],
                       rng.randrange(0, 30))
        assert led.conserved
        assert sum(led.by_key.values()) == led.busy_chip_ticks

    def test_prorata_by_work_units(self):
        led = CostLedger()
        led.charge([("a", 0, 3), ("b", 0, 1)], 4)
        assert led.by_key == {"a:t0": 3, "b:t0": 1}

    def test_zero_work_splits_equally(self):
        led = CostLedger()
        led.charge([("a", 0, 0), ("b", 0, 0)], 5)
        assert led.busy_chip_ticks == 5
        assert sorted(led.by_key.values()) == [2, 3]

    def test_remainder_tie_break_is_stable(self):
        a = CostLedger()
        a.charge([("x", 0, 1), ("y", 0, 1), ("z", 0, 1)], 2)
        b = CostLedger()
        b.charge([("x", 0, 1), ("y", 0, 1), ("z", 0, 1)], 2)
        assert a.by_key == b.by_key
        assert sum(a.by_key.values()) == 2

    def test_merge_accumulates(self):
        a, b = CostLedger(), CostLedger()
        a.charge([("a", 0, 1)], 3)
        b.charge([("a", 0, 1), ("b", 1, 1)], 4)
        a.merge(b)
        assert a.busy_chip_ticks == 7
        assert a.conserved
        assert a.by_key["a:t0"] == 5 and a.by_key["b:t1"] == 2

    def test_publish_emits_total_and_suffixed_gauges(self):
        led = CostLedger()
        led.charge([("acme", 1, 2), ("blue", 0, 2)], 10)
        reg = MetricsRegistry()
        led.publish(reg)
        g = reg.snapshot()["gauges"]
        assert g["serve_chip_ticks_total"] == 10.0
        assert g["serve_chip_ticks_total_acme_t1"] == 5.0
        assert g["serve_chip_ticks_total_blue_t0"] == 5.0


class TestRunLoadCostHarvest:
    def test_engine_ledger_lands_in_report(self, tiny):
        _, _, cfg, params = tiny
        reg = MetricsRegistry()
        eng = _eng(params, cfg, metrics=reg)
        trace = synth_trace(_spec(n_requests=8, tenants=("acme", "blue")))
        rep = run_load(eng, trace, TIERS, max_ticks=600, metrics=reg)
        assert rep.completed == 8
        assert rep.busy_chip_ticks == eng.busy_ticks
        assert sum(rep.cost_by_key.values()) == rep.busy_chip_ticks
        assert rep.busy_chip_ticks > 0
        cs = rep.cost_summary()
        assert cs["attributed_chip_ticks"] == rep.busy_chip_ticks
        assert {k.split(":")[0] for k in cs["per_key"]} \
            <= {"acme", "blue"}
        g = reg.snapshot()["gauges"]
        assert g["serve_chip_ticks_total"] == float(rep.busy_chip_ticks)
        assert rep.as_dict()["busy_chip_ticks"] == rep.busy_chip_ticks
