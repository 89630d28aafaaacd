"""The port's sampling engine (``ContinuousBatcher(sampling=True, top_k,
seed)`` with per-request temperatures) against the JAX package's engine on
the CPU, on the same converted f32 parameters: greedy and sampled requests
side by side, staggered so slots retire and are re-admitted, on the dense
engine and on bf16-dtype (here f32), int8 and int4 pages, with fused
ticks and with chunked prefill plus the prefix cache.  The key schedule is
the reference's (JAX's threefry on the port's ``prng``), so every token
must be EQUAL, sampled ones included.  The JAX side runs its Pallas
kernels in interpret mode."""

import jax
import numpy as np
import pytest

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models.serve import ContinuousBatcher as JaxBatcher
from kubegpu_tpu_torch import kernels
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts

ENGINE = dict(n_slots=3, stride=4, prompt_buckets=(8, 16), page_size=8,
              sampling=True, top_k=8, seed=3)
# (prompt length, max_new_tokens, temperature): the first three arrive up
# front, the rest after two ticks
REQUESTS = [(5, 10, 0.8), (12, 3, 0.0), (7, 6, 1.3), (16, 9, 0.0),
            (3, 6, 0.7), (9, 5, 2.0)]
CASES = {
    "dense": dict(paged=False),
    "paged": dict(paged=True),
    "fused4": dict(paged=True, fused_ticks=4),
    "int8": dict(paged=True, kv_bits=8),
    "int4": dict(paged=True, kv_bits=4),
    "prefix-chunked": dict(paged=True, prefix_cache=True,
                           chunked_prefill=True, prefill_chunk=8),
    "top_k0": dict(paged=True, top_k=0),
}


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny(max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(max_seq_len=64), params_t


def _requests(vocab, shared=False):
    rng = np.random.default_rng(0)
    out = [(rng.integers(0, vocab, t).tolist(), n, temp)
           for t, n, temp in REQUESTS]
    if shared:
        # the last two share the first request's leading page (prefix hits)
        lead = rng.integers(0, vocab, 8).tolist()
        out[0] = (lead + out[0][0][:4], out[0][1], out[0][2])
        out[4] = (lead + out[4][0][:3], out[4][1], out[4][2])
        out[5] = (lead + out[5][0][:6], out[5][1], out[5][2])
    return out


def serve(eng, reqs):
    rids, done = [], []
    for p, n, temp in reqs[:3]:
        rids.append(eng.submit(p, n, temperature=temp))
    for _ in range(2):
        done += eng.step()
    for p, n, temp in reqs[3:]:
        rids.append(eng.submit(p, n, temperature=temp))
    done += eng.drain()
    return {r.rid: r.tokens for r in done}


def solo(tiny, prompt, n):
    _, _, cfg, params_t = tiny
    return td.greedy_generate(params_t, [prompt], n, cfg,
                              device="cpu")[0].tolist()


@pytest.mark.parametrize("case", CASES)
def test_sampled_engine_equals_reference(tiny, case):
    cfg_j, params_j, cfg, params_t = tiny
    kw = {**ENGINE, **CASES[case]}
    reqs = _requests(cfg.vocab_size, shared=case == "prefix-chunked")
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                               debug_invariants=kw["paged"], **kw)
    got = serve(eng, reqs)
    want = serve(JaxBatcher(params_j, cfg_j, **kw), reqs)
    assert got == want
    assert len(got) == len(REQUESTS)
    if case == "fused4":
        assert eng.fused_dispatches > 0
    if case == "prefix-chunked":
        assert eng.chunks_run > 0 and eng.prefix_hits > 0
    if not kw.get("kv_bits"):
        # greedy neighbours are untouched by the sampled rows
        for rid, (p, n, temp) in enumerate(reqs):
            if temp == 0.0:
                assert got[rid] == solo(tiny, p, n), rid


def test_fused_ticks_equal_single_ticks(tiny):
    """K fused ticks key each inner tick ``tick0 + tk``: the same draws as
    K single ticks."""
    _, _, cfg, params_t = tiny
    reqs = [(p, 24, temp) for p, _, temp in _requests(cfg.vocab_size)[:3]]
    runs = {}
    for k in (1, 4):
        eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", paged=True,
                                   fused_ticks=k, **ENGINE)
        for p, n, temp in reqs:
            eng.submit(p, n, temperature=temp)
        runs[k] = {r.rid: r.tokens for r in eng.drain()}
        if k == 4:
            assert eng.fused_dispatches > 1
    assert runs[1] == runs[4]


def test_sampled_and_greedy_coexist(tiny):
    """A sampled request never perturbs its greedy neighbour; the sampled
    one is deterministic per seed and the seed changes it."""
    _, _, cfg, params_t = tiny
    p_g = [(i * 7 + 1) % cfg.vocab_size for i in range(5)]
    p_s = [(i * 3 + 2) % cfg.vocab_size for i in range(5)]

    def run(seed):
        eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", n_slots=2,
                                   stride=4, prompt_buckets=(8,),
                                   sampling=True, top_k=8, seed=seed)
        rg = eng.submit(p_g, 8)
        rs = eng.submit(p_s, 8, temperature=1.0)
        done = {r.rid: r.tokens for r in eng.drain()}
        return done[rg], done[rs]

    (g1, s1), (g2, s2), (g3, s3) = run(0), run(0), run(123)
    assert g1 == g2 == g3 == solo(tiny, p_g, 8)
    assert s1 == s2
    assert s1 != s3
    assert all(0 <= t < cfg.vocab_size for t in s1)


def test_sampling_top_k_one_is_greedy(tiny):
    _, _, cfg, params_t = tiny
    reqs = _requests(cfg.vocab_size)
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                               **{**ENGINE, "paged": True, "top_k": 1})
    got = serve(eng, reqs)
    for rid, (p, n, _) in enumerate(reqs):
        assert got[rid] == solo(tiny, p, n), rid


@pytest.mark.parametrize("kw,match", [
    (dict(paged=True, spec_gamma=2), "greedy-only"),
    (dict(top_k=10 ** 6), "top_k"),
    (dict(top_k=-1), "top_k")], ids=["spec", "top_k_big", "top_k_neg"])
def test_sampling_knob_validation(tiny, kw, match):
    cfg_j, params_j, cfg, params_t = tiny
    kw = {**ENGINE, **kw}
    with pytest.raises(ValueError, match=match) as want:
        JaxBatcher(params_j, cfg_j, **kw)
    with pytest.raises(ValueError, match=match) as got:
        ts.ContinuousBatcher(params_t, cfg, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_warmup_is_state_free_when_sampling(tiny):
    _, _, cfg, params_t = tiny
    kw = {**ENGINE, "paged": True, "prefix_cache": True,
          "chunked_prefill": True, "prefill_chunk": 8}
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", **kw)
    eng.warmup()
    assert not (eng.temps.any() or eng.tokens.any() or eng.pos.any())
    assert eng._tick == 0
    reqs = _requests(cfg.vocab_size)
    assert serve(eng, reqs) == serve(
        ts.ContinuousBatcher(params_t, cfg, device="cpu", **kw), reqs)


class _ReplayedGraph:
    """``kernels.Graph`` on the CPU: the capture records nothing and each
    replay calls the captured function."""
    replays = 0

    def __init__(self, fn):
        self.fn = fn
        self.capture_s = self.instantiate_s = 0.0
        self.pool_bytes = 0
        self.tally = {}

    def capture(self):
        pass

    def replay(self):
        type(self).replays += 1
        self.fn()


@pytest.mark.parametrize("case", ["paged", "fused4", "dense",
                                  "prefix-chunked"])
def test_graph_engine_draws_each_ticks_keys(tiny, monkeypatch, case):
    """The graph path (a replayed tick and chunk step, the card's path
    rehearsed with a stand-in ``kernels.Graph``): the tick's key comes from
    the device tables, advanced by each fused replay, never from a value
    baked in at capture, so the replayed engine's tokens equal the eager
    engine's."""
    _, _, cfg, params_t = tiny
    kw = {**ENGINE, **CASES[case]}
    reqs = _requests(cfg.vocab_size, shared=case == "prefix-chunked")
    eager = serve(ts.ContinuousBatcher(params_t, cfg, device="cpu", **kw),
                  reqs)
    monkeypatch.setattr(kernels, "Graph", _ReplayedGraph)
    monkeypatch.setattr(ts.ContinuousBatcher, "_use_graph", lambda self: True)
    monkeypatch.setattr(_ReplayedGraph, "replays", 0)
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", **kw)
    eng.warmup()
    assert serve(eng, reqs) == eager
    assert _ReplayedGraph.replays >= eng._tick
