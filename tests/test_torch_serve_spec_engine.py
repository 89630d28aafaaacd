"""The port's speculative paged engine (``ContinuousBatcher(paged=True,
spec_gamma=γ, draft_layers=1, ...)``) against the JAX package's engine
(its Pallas kernels 4-6 in interpret mode) and the port's own
``greedy_generate``, on the same converted f32 parameters.

The traffic is ``tests/test_serve.py::TestSpeculativeEngine``'s (three
requests sharing an 8-token page, one of 15 tokens; the first alone for
three steps), on its engine (three slots, stride 4, pages of 8), at γ 2
and 3, with and without the prefix cache and chunked prefill, at
``fused_ticks`` 1 and 4 and over the three pool formats.  Tokens must be
EQUAL to the JAX engine's (and, on a pool of the model dtype, to solo
greedy's), and so must the speculative counters, ``slot_steps``,
``fused_dispatches``, the fast path's counters and the final per-slot caps
and acceptance EMAs; every engine runs with ``debug_invariants=True``."""

import jax
import numpy as np
import pytest

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models.serve import ContinuousBatcher as JaxBatcher
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts

ENGINE = dict(n_slots=3, stride=4, prompt_buckets=(8, 16), paged=True,
              page_size=8)
FAST = dict(prefix_cache=True, chunked_prefill=True, prefill_chunk=8)
KV = {16: {}, 8: {"kv_bits": 8}, 4: {"kv_bits": 4}}
COUNTERS = ("spec_ticks", "spec_drafts_proposed", "spec_drafts_accepted",
            "slot_steps", "fused_dispatches", "fused_ticks_run",
            "emitted_tokens", "prefix_hits", "pages_aliased", "chunks_run",
            "prefill_tokens")


@pytest.fixture(scope="module")
def tiny4():
    cfg_j = jl.LlamaConfig.tiny(n_heads=4, n_kv_heads=4, max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    cfg = tl.LlamaConfig.tiny(n_heads=4, n_kv_heads=4, max_seq_len=64)
    return cfg_j, params_j, cfg, params_t


def _traffic(vocab):
    shared = [(i * 5 + 3) % vocab for i in range(8)]
    prompts = [(shared + [(41 + 9 * j + i) % vocab for i in range(5)], 6)
               for j in range(3)]
    return prompts + [([(i * 13 + 4) % vocab for i in range(15)], 5)]


def _run(eng, prompts):
    rids, done = {}, {}
    p0, n0 = prompts[0]
    rids[eng.submit(p0, n0)] = (p0, n0)
    for _ in range(3):
        done.update({r.rid: r.tokens for r in eng.step()})
    for p, n in prompts[1:]:
        rids[eng.submit(p, n)] = (p, n)
    done.update({r.rid: r.tokens for r in eng.drain()})
    return rids, done


# (γ, fast path, fused_ticks, pool bits): every γ, fast-path, K and format
# value, each pair of γ/K with and without the fast path
CASES = [(3, False, 1, 16), (2, False, 4, 16), (3, True, 4, 16),
         (2, True, 1, 16), (2, False, 1, 8), (3, True, 4, 8),
         (3, False, 4, 4), (2, True, 1, 4)]


@pytest.mark.parametrize("gamma,fast,k,bits", CASES, ids=[
    f"g{g}-{'fast' if f else 'plain'}-k{k}-kv{b}" for g, f, k, b in CASES])
def test_spec_engine_matches_reference(tiny4, gamma, fast, k, bits):
    cfg_j, params_j, cfg, params_t = tiny4
    kw = dict(ENGINE, spec_gamma=gamma, draft_layers=1, fused_ticks=k,
              **(FAST if fast else {}), **KV[bits])
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                               debug_invariants=True, **kw)
    prompts = _traffic(cfg.vocab_size)
    rids, got = _run(eng, prompts)
    ref = JaxBatcher(params_j, cfg_j, **kw)
    ref_rids, want = _run(ref, prompts)
    assert ref_rids == rids and got == want
    assert {c: getattr(eng, c) for c in COUNTERS} == {
        c: getattr(ref, c) for c in COUNTERS}
    np.testing.assert_array_equal(eng._gcap, ref._gcap)
    np.testing.assert_array_equal(eng._accept_ema, ref._accept_ema)
    assert eng.spec_acceptance_rate == ref.spec_acceptance_rate
    assert eng.spec_tokens_per_tick == ref.spec_tokens_per_tick
    assert eng.spec_ticks > 0
    if k > 1:
        assert eng.fused_dispatches > 0
    if fast:
        assert eng.prefix_hits >= 1 and eng.chunks_run >= 1
    if bits == 16:
        for rid, (p, n) in rids.items():
            solo = td.greedy_generate(params_t, [p], n, cfg, device="cpu")
            assert got[rid] == solo[0].tolist(), rid
    # every page free, or (prefix cache) registered at refcount 0
    assert len(eng._free_pages) + len(eng._page_refs) == eng.total_pages
    assert not any(eng._page_refs.values())


@pytest.mark.parametrize("k", [1, 4])
def test_spec_equals_plain_engine(tiny4, k):
    """Every emitted token is the full model's argmax: on f32 the spec
    engine's tokens are the γ = 0 engine's, with both fast paths on."""
    _, _, cfg, params_t = tiny4
    prompts = _traffic(cfg.vocab_size)
    runs = []
    for gamma in (0, 3):
        eng = ts.ContinuousBatcher(
            params_t, cfg, device="cpu", debug_invariants=True,
            spec_gamma=gamma, draft_layers=1 if gamma else None,
            fused_ticks=k, **ENGINE, **FAST)
        runs.append(_run(eng, prompts)[1])
    assert runs[0] == runs[1]


def test_full_depth_draft_accepts(tiny4):
    """A draft of every layer proposes the full model's own argmaxes: the
    engine accepts most of them and banks more than one token a tick,
    with the JAX engine's counters."""
    cfg_j, params_j, cfg, params_t = tiny4
    kw = dict(ENGINE, spec_gamma=3, draft_layers=cfg.n_layers)
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                               debug_invariants=True, **kw)
    ref = JaxBatcher(params_j, cfg_j, **kw)
    prompts = _traffic(cfg.vocab_size)
    got, want = _run(eng, prompts)[1], _run(ref, prompts)[1]
    assert got == want
    assert (eng.spec_drafts_accepted, eng.spec_ticks) == (
        ref.spec_drafts_accepted, ref.spec_ticks)
    assert eng.spec_acceptance_rate > 0.5
    assert eng.spec_tokens_per_tick > 1.5
