"""The port's engine tick on its static device state, and ``fused_ticks``.

The tick reads its tables from buffers allocated once and refreshed in
place, so that a CUDA graph can bind them; on the CPU the same tick body
runs directly on the same buffers.  Fused ticks (K complete ticks a
dispatch, the lane freeze on the device) are held to the JAX package's
fused engine (its Pallas kernels in interpret mode) tick by tick, on the
same converted f32 parameters, for the model-dtype, int8 and int4 pools,
and to the port's own K=1 tokens."""

import jax
import numpy as np
import pytest

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models import serve as js
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts

# tests/test_torch_serve_kvquant.py's engine: 27-token prompts in a
# 32-token bucket (four prompt pages of 8), two decode steps a tick
ENGINE = dict(n_slots=3, max_len=48, stride=2, prompt_buckets=(32, 40),
              paged=True, page_size=8)
# (arrival tick, max_new_tokens): three up front fill the slots, so the
# queue empties and the engine fuses; 8 and 5 new tokens end mid-dispatch
# (budgets 7 and 4 over K·stride = 4 or 8), 1 retires without decoding,
# and the last two arrive while slots are busy
REQUESTS = [(0, 8), (0, 5), (0, 11), (2, 1), (2, 6), (3, 9)]


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny(n_heads=4, n_kv_heads=2, max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    cfg = tl.LlamaConfig.tiny(n_heads=4, n_kv_heads=2, max_seq_len=64)
    return cfg_j, params_j, cfg, params_t


def _prompt(vocab, j, plen=27):
    return [(7 * j + 3 * i + 1) % vocab for i in range(plen)]


def _drive(eng, check=None):
    """Submit ``REQUESTS`` at their ticks and step to the end; after each
    step record what a tick-by-tick comparison reads.  Returns (tokens by
    rid, per-tick records)."""
    vocab = eng.cfg.vocab_size
    done, ticks = [], []
    for tick in range(200):
        for j, (at, n) in enumerate(REQUESTS):
            if at == tick:
                eng.submit(_prompt(vocab, j), n)
        if tick > 3 and not (eng.queue or eng.slot_req):
            break
        finished = eng.step()
        done += finished
        if check is not None:
            check(eng)
        ticks.append(({r.rid: list(r.tokens) for r in finished},
                      eng.fused_dispatches, eng.fused_ticks_run,
                      eng.fused_stalls, len(eng._free_pages)))
    assert not (eng.queue or eng.slot_req)
    return {r.rid: r.tokens for r in done}, ticks


def _tables_check(eng, ptrs):
    """The device tables keep their addresses and, after a dispatch, hold
    the host tables the dispatch uploaded."""
    dev = (eng._pt_dev, eng._tvec_dev, eng._tpad_dev, eng._active_dev)
    assert [x.data_ptr() for x in dev] == ptrs
    if eng._inflight is not None:
        for got, host in zip(dev, (eng._pt, eng._tvec, eng._tpad,
                                   eng.active)):
            np.testing.assert_array_equal(got.numpy(), host.astype(np.int32))


def test_tables_stay_in_place_and_equal_the_host_tables(tiny):
    """Admission, retirement and window eviction rewrite the page table,
    the lengths and the active mask: the tick's device buffers keep their
    data pointers throughout (what a captured graph binds) and equal the
    tables the per-change upload of the earlier engine sent."""
    _, _, cfg, params_t = tiny
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                               evict_policy="window", evict_param=8.0,
                               debug_invariants=True, **ENGINE)
    ptrs = [x.data_ptr() for x in (eng._pt_dev, eng._tvec_dev,
                                   eng._tpad_dev, eng._active_dev)]
    eng.warmup()
    got, _ = _drive(eng, check=lambda e: _tables_check(e, ptrs))
    assert eng.pages_evicted >= 1
    assert len(got) == len(REQUESTS)
    assert eng._slab.data_ptr() == eng._live["out"]["blocks"].data_ptr()


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("kw", [{}, dict(kv_bits=8), dict(kv_bits=4)],
                         ids=["model_dtype", "int8", "int4"])
def test_fused_ticks_match_reference_tick_by_tick(tiny, kw, k):
    cfg_j, params_j, cfg, params_t = tiny
    ref = js.ContinuousBatcher(params_j, cfg_j, fused_ticks=k, **ENGINE,
                               **kw)
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", fused_ticks=k,
                               debug_invariants=True, **ENGINE, **kw)
    want, want_ticks = _drive(ref)
    got, got_ticks = _drive(eng)
    assert got_ticks == want_ticks
    assert got == want
    assert eng.fused_dispatches > 0 and eng.fused_ticks_run > 0
    assert sorted(eng._free_pages) == list(range(1, eng.total_pages + 1))
    one, _ = _drive(ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                         **ENGINE, **kw))
    assert got == one
    assert all(len(got[rid]) == n for rid, (_, n) in enumerate(REQUESTS))


@pytest.mark.parametrize("policy", ["mass", "window"])
def test_fused_ticks_refuse_eviction(tiny, policy):
    """As in the reference: eviction rides the plain K=1 tick."""
    cfg_j, params_j, cfg, params_t = tiny
    with pytest.raises(ValueError) as want:
        js.ContinuousBatcher(params_j, cfg_j, fused_ticks=2,
                             evict_policy=policy, **ENGINE)
    with pytest.raises(ValueError) as got:
        ts.ContinuousBatcher(params_t, cfg, device="cpu", fused_ticks=2,
                             evict_policy=policy, **ENGINE)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="fused_ticks"):
        ts.ContinuousBatcher(params_t, cfg, device="cpu", fused_ticks=0,
                             **ENGINE)


def test_stalled_lane_freezes_and_counts(tiny):
    """A lane whose next flush would pass its page cap freezes on the
    device: its position and token hold, ``fused_stalls`` counts it, and
    the lanes beside it run on unchanged."""
    _, _, cfg, params_t = tiny
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", fused_ticks=4,
                               **ENGINE)
    for j in range(2):
        eng.submit(_prompt(cfg.vocab_size, j), 19)
    eng.step()                      # admit both, dispatch 4 fused ticks
    eng.step()                      # 9 tokens each, 4 more ticks
    pos = eng.pos.clone()
    eng._cap[0] = int(pos[0]) - int(eng._tvec[0])   # no room for a block
    eng._collect()
    eng._dispatch_tick()
    assert eng._inflight_k == 4
    assert eng.pos[0] == pos[0]
    assert eng.pos[1] > pos[1]
    eng._collect()
    assert eng.fused_stalls == 1
