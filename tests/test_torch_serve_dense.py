"""The port's dense slot engine (``ContinuousBatcher(paged=False)``, the
reference's default) against the JAX package's on the same converted f32
parameters: tick by tick (finished requests and their tokens, every slot's
position), the flush clamp of a row that holds its position near
``max_len``, the reference's ``ValueError``s, and the port's own oracles
(solo ``greedy_generate`` and the paged engine, tokens EQUAL).  The tick's
graph runner runs under a stand-in ``kernels.Graph`` whose replay calls the
tick body."""

import jax
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models.serve import ContinuousBatcher as JaxBatcher
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts

ENGINE = dict(n_slots=3, stride=4, prompt_buckets=(8, 16), max_len=48)
# (prompt length, max_new_tokens); three up front, the rest after two
# ticks, so slots retire and are re-admitted
REQUESTS = [(5, 10), (12, 3), (7, 1), (16, 9), (3, 6), (9, 5)]
# a row that retires at position 46 = max_len - 2 (14 + 8 blocks of 4;
# no row's held position can pass max_len - 2, since t + n + stride <=
# max_len) while another decodes on: its garbage flushes start past
# max_len - stride = 44 and clamp there
CLAMP = [(14, 30), (3, 41), (6, 2)]


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny(max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(max_seq_len=64), params_t


def _prompts(vocab, requests, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, t).tolist(), n) for t, n in requests]


def _drive(eng, prompts, late_at=2):
    """Submit the first three prompts, the rest after ``late_at`` steps,
    and step to the end.  Returns (tokens by rid, per-step records of the
    finished requests and every slot's position)."""
    done, ticks = [], []
    for p, n in prompts[:3]:
        eng.submit(p, n)
    for i in range(100):
        if i == late_at:
            for p, n in prompts[3:]:
                eng.submit(p, n)
        if i > late_at and not (eng.queue or eng.slot_req):
            break
        finished = eng.step()
        done += finished
        ticks.append(({r.rid: list(r.tokens) for r in finished},
                      np.asarray(eng.pos).tolist(),
                      np.asarray(eng.active).tolist()))
    assert not (eng.queue or eng.slot_req)
    return {r.rid: list(r.tokens) for r in done}, ticks


def test_default_engine_is_dense(tiny):
    _, _, cfg, params_t = tiny
    # the default buckets (128, 512, 1024) need max_len > 1024
    cfg = tl.LlamaConfig.tiny(max_seq_len=1040)
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu")
    assert not eng.paged and eng.pool is None
    assert tuple(eng.cache["k"].shape) == (cfg.n_layers, 8, cfg.n_kv_heads,
                                           cfg.max_seq_len, cfg.head_dim)
    eng.check_page_invariants()          # no pages: nothing to violate


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warmed"])
def test_ticks_match_reference_engine(tiny, warm):
    cfg_j, params_j, cfg, params_t = tiny
    prompts = _prompts(cfg.vocab_size, REQUESTS)
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", **ENGINE)
    if warm:
        eng.warmup()
        assert not eng.cache["k"].any() and not eng.pos.any()
        assert (eng._tick, eng.emitted_tokens) == (0, 0)
    ref_eng = JaxBatcher(params_j, cfg_j, **ENGINE)
    got, ticks = _drive(eng, prompts)
    ref, ref_ticks = _drive(ref_eng, prompts)
    assert got == ref
    assert ticks == ref_ticks
    assert eng.emitted_tokens == sum(n for _, n in REQUESTS)
    assert list(eng.wave_sizes) == [k for k, _ in ref_eng.wave_log]


def test_flush_clamps_like_the_reference(tiny):
    cfg_j, params_j, cfg, params_t = tiny
    prompts = _prompts(cfg.vocab_size, CLAMP, seed=3)
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", **ENGINE)
    ref_eng = JaxBatcher(params_j, cfg_j, **ENGINE)
    got, ticks = _drive(eng, prompts, late_at=50)
    ref, ref_ticks = _drive(ref_eng, prompts, late_at=50)
    assert got == ref and ticks == ref_ticks
    s, stride = ENGINE["max_len"], ENGINE["stride"]
    # the clamp bit: a slot that was inactive held a position past
    # max_len - stride while a tick ran
    held = [p for _, pos, act in ticks for p, a in zip(pos, act)
            if not a and p > s - stride]
    assert held and max(held) == s - 2
    for name in ("k", "v"):
        np.testing.assert_allclose(eng.cache[name].numpy(),
                                   np.asarray(ref_eng.cache[name]),
                                   atol=1e-5)
    solo = [td.greedy_generate(params_t, [p], n, cfg, max_len=s,
                               device="cpu")[0].tolist() for p, n in prompts]
    assert [got[rid] for rid in range(len(prompts))] == solo


def test_flush_buffer_clamps_its_start():
    cache = {n: torch.zeros(1, 2, 1, 8, 1) for n in ("k", "v")}
    buf = {n: torch.arange(1, 7, dtype=torch.float32).view(1, 2, 1, 3, 1)
           for n in ("k", "v")}
    ts._flush_buffer(cache, buf, torch.tensor([2, 7], dtype=torch.int32))
    assert cache["k"][0, 0, 0, :, 0].tolist() == [0, 0, 1, 2, 3, 0, 0, 0]
    # row 1's start 7 clamps to 8 - 3 = 5
    assert cache["v"][0, 1, 0, :, 0].tolist() == [0, 0, 0, 0, 0, 4, 5, 6]


@pytest.mark.parametrize("kw", [dict(kv_int8=True), dict(kv_bits=8),
                                dict(kv_bits=4), dict(fused_ticks=2),
                                dict(evict_policy="window")],
                         ids=["kv_int8", "kv_bits8", "kv_bits4", "fused",
                              "evict"])
def test_dense_engine_refuses_paged_knobs(tiny, kw):
    cfg_j, params_j, cfg, params_t = tiny
    with pytest.raises(ValueError, match="paged=True"):
        ts.ContinuousBatcher(params_t, cfg, device="cpu", **ENGINE, **kw)
    with pytest.raises(ValueError, match="paged=True"):
        JaxBatcher(params_j, cfg_j, **ENGINE, **kw)


def test_dense_equals_solo_greedy_and_paged_engine(tiny):
    _, _, cfg, params_t = tiny
    prompts = _prompts(cfg.vocab_size, REQUESTS, seed=1)
    dense, _ = _drive(ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                           **ENGINE), prompts)
    paged, _ = _drive(ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                           paged=True, page_size=8,
                                           **ENGINE), prompts)
    assert dense == paged
    for rid, (p, n) in enumerate(prompts):
        solo = td.greedy_generate(params_t, [p], n, cfg, max_len=48,
                                  device="cpu")
        assert dense[rid] == solo[0].tolist(), rid


class _ReplayedGraph:
    """``kernels.Graph`` on the CPU: the capture records nothing and a
    replay calls the captured function, so the engine's graph path runs as
    it does on the card."""
    replays = 0
    capture_s = instantiate_s = 0.0
    pool_bytes = 0
    tally: dict = {}

    def __init__(self, fn):
        self.fn = fn

    def capture(self):
        pass

    def replay(self):
        type(self).replays += 1
        self.fn()


@pytest.mark.parametrize("warm", [False, True], ids=["first_tick", "warmup"])
def test_dense_tick_graph_runner(tiny, monkeypatch, warm):
    """The graph path binds the live state: captured by warmup() (or after
    the first, eager tick) and replayed every later tick, it serves the
    eager engine's tokens."""
    _, _, cfg, params_t = tiny
    monkeypatch.setattr(ts.kernels, "Graph", _ReplayedGraph)
    monkeypatch.setattr(_ReplayedGraph, "replays", 0)
    prompts = _prompts(cfg.vocab_size, REQUESTS, seed=2)
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", **ENGINE)
    eng._use_graph = lambda: True
    if warm:
        eng.warmup()
        assert eng._graph is not None and eng.graph_stats is not None
    got, _ = _drive(eng, prompts)
    want, _ = _drive(ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                          **ENGINE), prompts)
    assert got == want
    assert _ReplayedGraph.replays == eng._tick - (not warm)
