"""The port's prefix cache and chunked prefill (``ContinuousBatcher(paged=True,
prefix_cache=..., chunked_prefill=..., prefill_chunk=...)``) against the JAX
package's engine (its Pallas kernels 4-6 in interpret mode) and the port's
own ``greedy_generate``, on the same converted f32 parameters.

The cases are ``tests/test_serve.py::TestServingFastPath``'s (pages of 8,
buckets (8, 16), chunks of 8), plus every pool format through the chunk
path, the chunk step's pieces (``fold_chunk_queries``, the plain paged
attention over folded queries, ``_chunk_causal_partials``) against the
reference's functions on seeded numpy inputs, the bytes of shared pages
under a follower's chunks, and the refcount churn and eviction rails of
``tests/test_page_pool.py``.  Greedy tokens must be EQUAL, and so must the
five counters; every engine runs with ``debug_invariants=True``, so its page
invariants hold after every step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import decode as jd
from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models.serve import ContinuousBatcher as JaxBatcher
from kubegpu_tpu.ops import kvquant as jq
from kubegpu_tpu.ops import paged_attention as jpa
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts
from kubegpu_tpu_torch.ops import paged_attention as tpa

ENGINE = dict(n_slots=2, stride=4, prompt_buckets=(8, 16), paged=True,
              page_size=8, prefill_chunk=8)
COUNTERS = ("prefix_hits", "pages_aliased", "prefill_tokens_saved",
            "chunks_run", "prefill_tokens")
KV = {16: {}, 8: {"kv_bits": 8}, 4: {"kv_bits": 4}}


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny(max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(max_seq_len=64), params_t


def _port(tiny, **kw):
    _, _, cfg, params_t = tiny
    return ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                debug_invariants=True, **{**ENGINE, **kw})


def _drive(eng, script):
    """Run ``script`` (prompt lists to submit with their token counts, or
    an int: that many ``step()`` calls), then drain.  Returns ({rid:
    (prompt, n)}, {rid: tokens})."""
    rids, done = {}, []
    for item in script:
        if isinstance(item, int):
            for _ in range(item):
                done += eng.step()
        else:
            for p, n in item:
                rids[eng.submit(p, n)] = (p, n)
    done += eng.drain()
    return rids, {r.rid: r.tokens for r in done}


def _against_reference(tiny, script, **kw):
    """The port's engine and the JAX engine on ``script``: equal rids,
    tokens and counters, and on a pool of the model dtype every request
    equal to the port's solo ``greedy_generate`` (a quantized pool
    attends other values than the dense cache).  Returns the port's
    engine."""
    cfg_j, params_j, cfg, params_t = tiny
    eng = _port(tiny, **kw)
    rids, got = _drive(eng, script)
    ref = JaxBatcher(params_j, cfg_j, **{**ENGINE, **kw})
    ref_rids, want = _drive(ref, script)
    assert ref_rids == rids and set(got) == set(rids)
    for rid, (p, n) in rids.items():
        assert got[rid] == want[rid], rid
        if "kv_bits" not in kw:
            solo = td.greedy_generate(params_t, [p], n, cfg, device="cpu")
            assert got[rid] == solo[0].tolist(), rid
    assert {c: getattr(eng, c) for c in COUNTERS} == {
        c: getattr(ref, c) for c in COUNTERS}
    eng.check_page_invariants()
    return eng


def _seq(vocab, n, a, b):
    return [(i * a + b) % vocab for i in range(n)]


def test_chunked_prefill_interleaves_with_waves(tiny):
    """Multi-chunk admissions (bucket 16, chunk 8) interleaved with
    single-chunk wave admissions (bucket 8), staggered mid-flight."""
    v = tiny[2].vocab_size
    script = [[(_seq(v, 13, 3, 1), 9), (_seq(v, 5, 5, 2), 7)], 1,
              [(_seq(v, 15, 11, 3), 8), (_seq(v, 9, 13, 4), 5)]]
    eng = _against_reference(tiny, script, chunked_prefill=True)
    assert eng.chunks_run >= 2          # the long prompts went chunked
    assert eng.prefix_hits == 0


def test_shared_prefix_matches_reference_and_plain_paged(tiny):
    """3-way shared-prefix traffic: the followers alias the leader's page
    and prefill only their tails, with the tokens of the reference engine,
    of solo greedy decode and of a plain paged engine without the cache."""
    v = tiny[2].vocab_size
    shared = _seq(v, 8, 5, 3)
    prompts = [(shared + _seq(v, 5, 1, 41 + 9 * j), 6) for j in range(3)]
    script = [prompts[:1], 1, prompts[1:]]   # the leader registers first
    eng = _against_reference(tiny, script, n_slots=3, prefix_cache=True)
    plain = _port(tiny, n_slots=3)
    rids, got_plain = _drive(plain, [prompts])
    _, got = _drive(_port(tiny, n_slots=3, prefix_cache=True), script)
    assert sorted(got_plain.values()) == sorted(got.values())
    assert (eng.prefix_hits, eng.pages_aliased,
            eng.prefill_tokens_saved) == (2, 2, 16)
    assert eng.prefill_tokens < plain.prefill_tokens


def test_shared_prefix_with_chunked_long_prompts(tiny):
    """Both knobs composed: 15-token prompts sharing one full page, the
    leader and the follower's tail both chunked."""
    v = tiny[2].vocab_size
    shared = _seq(v, 8, 7, 2)
    p0, p1 = (shared + _seq(v, 7, 1, 61 + 5 * j) for j in range(2))
    eng = _against_reference(tiny, [[(p0, 5)], 3, [(p1, 5)]],
                             prefix_cache=True, chunked_prefill=True)
    assert eng.prefix_hits == 1 and eng.chunks_run == 3


def test_single_token_request_chunked(tiny):
    """max_new_tokens=1 through the chunk path: the final chunk's pick is
    the answer, and the request retires without decoding."""
    p = _seq(tiny[2].vocab_size, 11, 9, 1)
    eng = _against_reference(tiny, [[(p, 1)]], chunked_prefill=True)
    assert eng.chunks_run == 2 and eng.emitted_tokens == 1


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_every_pool_format_through_the_chunk_path(tiny, kv_bits):
    """bf16-role (the model dtype), int8 and packed-int4 pools: prompts of
    19-25 tokens in bucket 32 sharing two pages, three slots, both knobs;
    the chunk writes quantize per token (int8) or per group of 4 (int4),
    and the followers read the leader's quantized pages through the
    paged kernel."""
    v = tiny[2].vocab_size
    shared = _seq(v, 16, 3, 7)
    prompts = [(shared + _seq(v, 3 + 2 * j, 1, 11 * j + 5), 7 + j)
               for j in range(4)]
    eng = _against_reference(
        tiny, [prompts[:1], 4, prompts[1:]], n_slots=3,
        prompt_buckets=(8, 16, 32), prefix_cache=True, chunked_prefill=True,
        **KV[kv_bits])
    assert (eng.prefix_hits, eng.pages_aliased) == (3, 6)


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_follower_chunks_leave_shared_pages_unchanged(tiny, kv_bits):
    """A follower aliases the first of the leader's two registered pages
    and writes only its own: chunks of two pages from row-local page 1,
    the second over positions 24-39 of a 29-token prompt, so its padding
    spills into the follower's first decode page.  Every byte (and scale)
    of the registered pages is unchanged after each step, while the
    leader still decodes."""
    v = tiny[2].vocab_size
    shared = _seq(v, 8, 5, 1)
    eng = _port(tiny, n_slots=2, prompt_buckets=(8, 16, 32),
                prefill_chunk=16, prefix_cache=True, chunked_prefill=True,
                **KV[kv_bits])
    eng.submit(shared + _seq(v, 13, 1, 3), 20)
    for _ in range(3):
        eng.step()
    pages = list(eng._prefix_cache.values())
    assert len(pages) == 2 and eng.active.any()
    before = {n: x[:, pages].clone() for n, x in eng.pool.items()}
    eng.submit(shared + _seq(v, 21, 1, 9), 6)
    saw_prefill = False
    while eng.queue or eng.slot_req:
        eng.step()
        saw_prefill |= bool(eng._prefilling)
        for n, x in eng.pool.items():
            assert torch.equal(x[:, pages], before[n]), n
    assert saw_prefill and eng.prefix_hits == 1 and eng.chunks_run == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_partials_and_fold_match_reference(dtype):
    """``fold_chunk_queries`` is the reference's reshape, and
    ``_chunk_causal_partials`` its causal partials: f32 scores, the
    weights rounded to V's dtype before P.V.  Seeded numpy q [2, 8, 6,
    16], k/v [2, 2, 6, 16]; tolerance 1e-5 on o, m and l/|l| in f32;
    bf16 rounds the weights and the products to bf16 on both sides, in
    another summation order: 1e-2 on o, 1e-5 on m and l/|l|."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s, np.float32)
               for s in ((2, 8, 6, 16), (2, 2, 6, 16), (2, 2, 6, 16)))
    jx = [jnp.asarray(a, dtype) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    assert torch.equal(tpa.fold_chunk_queries(tx[0]).float(), torch.from_numpy(
        np.array(jpa.fold_chunk_queries(jx[0]), np.float32)))
    got = td._chunk_causal_partials(*tx)
    want = [np.asarray(a, np.float32) for a in jd._chunk_causal_partials(*jx)]
    assert [tuple(a.shape) for a in got] == [(2, 48, 16), (2, 48), (2, 48)]
    np.testing.assert_allclose(got[0].numpy(), want[0],
                               atol=1e-5 if dtype == "float32" else 1e-2)
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-5)


@pytest.mark.parametrize("fmt", ["f32", "q8", "q4g4"])
def test_paged_attention_over_folded_queries(fmt):
    """The plain paged attention (what the wrapper runs on the CPU) over a
    chunk's folded queries, C = 4 positions of GQA 2 (a group of 8), each
    row's history ``t = t_pad = s``, ``d = 0``: against the Pallas kernel
    in interpret mode and the reference's plain version, atol 1e-5.  Row
    1 is a first chunk, s = 0: no valid key, so l = 0 and o = 0, which
    ``merge_partials`` drops exactly."""
    rng = np.random.default_rng(5)
    raw = [rng.standard_normal((2, 9, 2, 8, 16), np.float32) for _ in "kv"]
    if fmt == "f32":
        pools = (raw[0], raw[1], None, None)
    elif fmt == "q8":
        (kq, ks), (vq, vs) = (jq.quantize_rows(jnp.asarray(x)) for x in raw)
        pools = tuple(np.asarray(a) for a in (kq, vq, ks, vs))
    else:
        (kq, ks), (vq, vs) = (jq.quantize_groups_q4(jnp.asarray(x), 4)
                              for x in raw)
        pools = tuple(np.asarray(a) for a in (kq, vq, ks, vs))
    q = rng.standard_normal((2, 4, 4, 16), np.float32)
    pt = np.array([[3, 7, 2, 5], [6, 1, 0, 0]], np.int32)
    s = np.array([16, 0], np.int32)
    d = np.zeros(2, np.int32)
    jsc = [None if a is None else jnp.asarray(a) for a in pools[2:]]
    jargs = (jpa.fold_chunk_queries(jnp.asarray(q)), jnp.asarray(pools[0]),
             jnp.asarray(pools[1]), jnp.asarray(pt), jnp.int32(1),
             jnp.asarray(s), jnp.asarray(s), jnp.asarray(d), *jsc)
    ker = jpa.paged_attention(*jargs, interpret=True)
    ref = jpa.paged_attention_ref(*jargs)
    tsc = [None if a is None else torch.from_numpy(a) for a in pools[2:]]
    got = tpa.paged_attention(
        tpa.fold_chunk_queries(torch.from_numpy(q)),
        torch.from_numpy(pools[0]), torch.from_numpy(pools[1]),
        torch.from_numpy(pt), 1, torch.from_numpy(s), torch.from_numpy(s),
        torch.from_numpy(d), *tsc)
    for a, k_, r_ in zip(got, ker, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(k_), atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(r_), atol=1e-5)
    assert got[0].shape == (2, 16, 16)
    assert not got[0][1].any() and not got[2][1].any()
    # the empty row drops out of the merge: its weight is exactly 0
    o2 = torch.randn(2, 16, 16)
    m2, l2 = torch.randn(2, 16), torch.rand(2, 16) + 0.5
    np.testing.assert_allclose(tpa.merge_partials(*got, o2, m2, l2)[1],
                               o2[1], rtol=1e-6)


def test_warmup_runs_the_chunk_step_state_free(tiny):
    """warmup() runs the chunk step on scratch too: pool, slot vectors,
    registry and counters untouched, and the same tokens as a cold
    engine."""
    v = tiny[2].vocab_size
    kw = dict(prefix_cache=True, chunked_prefill=True)
    eng = _port(tiny, **kw)
    eng.warmup()
    assert not eng.pool["k"].any() and not eng.pool["v"].any()
    assert not (eng.tokens.any() or eng.pos.any() or eng.first_toks.any())
    assert not any(getattr(eng, c) for c in COUNTERS)
    assert not (eng._prefix_cache or eng._prefilling or eng.slot_req)
    shared = _seq(v, 8, 5, 3)
    script = [[(shared + [1, 2, 3], 5)], 3, [(shared + [4, 5, 6, 7], 6)]]
    assert _drive(eng, script)[1] == _drive(_port(tiny, **kw), script)[1]


def _refcount_invariants(eng):
    """``tests/test_page_pool.py::check_refcount_invariants`` (tables
    without eviction holes): pages partition into free and allocated,
    refcounts equal owners, a refcount-0 page is registered, and table
    rows list their slots' pages."""
    allocated = set(eng._page_refs)
    assert 0 not in allocated and 0 not in eng._page_key
    assert not set(eng._free_pages) & allocated
    assert set(eng._free_pages) | allocated == set(
        range(1, eng.total_pages + 1))
    owners = {}
    for pages in eng._slot_pages.values():
        assert len(pages) == len(set(pages))
        for p in pages:
            owners[p] = owners.get(p, 0) + 1
    for p in allocated:
        assert eng._page_refs[p] == owners.get(p, 0)
        if eng._page_refs[p] == 0:
            assert p in eng._page_key
    for p, key in eng._page_key.items():
        assert eng._prefix_cache[key] == p
    for slot in range(eng.n_slots):
        pages = eng._slot_pages.get(slot, [])
        assert list(eng._pt[slot][:len(pages)]) == pages
        assert not eng._pt[slot][len(pages):].any()


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
@pytest.mark.parametrize("chunked", [False, True], ids=["waves", "chunked"])
def test_churn_with_prefix_cache_no_leak(tiny, kv_bits, chunked):
    """``test_page_pool.py``'s refcount churn (its engine: 3 slots,
    max_len 32, stride 2): random mixed traffic, half of it sharing a
    first page, through a cache-enabled engine of each pool format; the
    partition law holds after every step, every request finishes with its
    token count, and once drained every page is free or registered at
    refcount 0."""
    v = tiny[2].vocab_size
    rng = np.random.default_rng(7)
    eng = _port(tiny, n_slots=3, max_len=32, stride=2, prefix_cache=True,
                chunked_prefill=chunked, **KV[kv_bits])
    shared = _seq(v, 8, 5, 3)
    want, done = {}, {}
    for _ in range(40):
        if rng.random() < 0.5 and len(eng.queue) < 4:
            new = int(rng.integers(1, 6))
            if rng.random() < 0.5:
                prompt = shared + list(rng.integers(0, v, int(
                    rng.integers(1, 8))))
            else:
                prompt = list(rng.integers(0, v, int(rng.integers(1, 16))))
            want[eng.submit(prompt, new)] = new
        for r in eng.step():
            done[r.rid] = len(r.tokens)
        _refcount_invariants(eng)
    for r in eng.drain():
        done[r.rid] = len(r.tokens)
    _refcount_invariants(eng)
    assert done == want and not eng._slot_pages and eng.prefix_hits > 0
    assert all(r == 0 for r in eng._page_refs.values())
    assert len(eng._free_pages) + len(eng._page_refs) == eng.total_pages


def test_registered_pages_are_retained_then_reclaimed(tiny):
    """A registered page outlives its last owner at refcount 0 (a later
    request with its prefix aliases it: only the tail is prefilled), and
    a pool with no free page left reclaims it for a request that does
    not match, dropping its registry entry (``test_page_pool.py``'s
    retention and LRU cases)."""
    v = tiny[2].vocab_size
    shared = _seq(v, 8, 5, 3)
    eng = _port(tiny, n_slots=1, max_len=32, stride=2, total_pages=3,
                prefix_cache=True)
    _drive(eng, [[(shared + [1, 2, 3, 4], 4)]])
    (cached,) = eng._prefix_cache.values()
    assert eng._page_refs[cached] == 0 and cached not in eng._free_pages
    before = eng.prefill_tokens
    _drive(eng, [[(shared + [5, 6, 7, 8], 4)]])
    assert (eng.prefix_hits, eng.prefill_tokens - before) == (1, 4)
    _drive(eng, [[(_seq(v, 12, 11, 9), 4)]])
    assert cached not in eng._page_key
    assert len(eng._free_pages) + len(eng._page_refs) == 3


@pytest.mark.parametrize("policy,param", [("window", 8.0), ("mass", 0.25)])
def test_eviction_never_drops_a_registered_or_shared_page(tiny, policy,
                                                          param):
    """``test_page_pool.py``'s eviction rails under shared-prefix traffic
    (27-token prompts sharing two pages, bucket 32, 3 slots): after every
    step, a table entry that became a hole held a single-owner,
    unregistered page other than the sink, two live prompt pages remain,
    and every request completes."""
    _, _, cfg, params_t = tiny
    v = cfg.vocab_size
    eng = ts.ContinuousBatcher(
        params_t, cfg, n_slots=3, max_len=48, stride=2,
        prompt_buckets=(32, 40), paged=True, page_size=8, prefix_cache=True,
        prefill_chunk=8, evict_policy=policy, evict_param=param,
        debug_invariants=True, device="cpu")
    shared = _seq(v, 16, 5, 3)
    rids = [eng.submit(shared + _seq(v, 11, 1, 31 + 7 * j), 8)
            for j in range(3)]
    done, saw_multi = [], False
    while eng.queue or eng.slot_req:
        owner = {s: r.rid for s, r in eng.slot_req.items()}
        rows = {s: eng._pt[s].copy() for s in owner}
        refs, keyed = dict(eng._page_refs), set(eng._page_key)
        done += eng.step()
        saw_multi |= any(r > 1 for r in eng._page_refs.values())
        for s, rid in owner.items():
            r = eng.slot_req.get(s)
            if r is None or r.rid != rid:
                continue
            before, after = rows[s], eng._pt[s]
            for pi in np.nonzero((before != 0) & (after == 0))[0]:
                page = int(before[pi])
                assert pi >= 1 and refs.get(page) == 1
                assert page not in keyed, f"evicted registered page {page}"
                assert (after[:int(eng._tpad[s]) // 8] != 0).sum() >= 2
    assert saw_multi and eng.prefix_hits >= 1
    assert sorted(r.rid for r in done) == sorted(rids)
    assert all(len(r.tokens) == 8 for r in done)
