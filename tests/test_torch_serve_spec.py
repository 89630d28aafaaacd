"""The pieces of the port's speculative decoding and its tick body against
the JAX package's, on the CPU (the reference's Pallas kernels 4-6 in
interpret mode, the port's paged attention through its plain version).

- ``draft_view`` on model-dtype and int8 (``quantize_llama``) trees: the
  reference's leaves, and views of the full tree's storage;
- ``spec_acceptance``, ``_gamma_from_accept`` and ``truncate_at_eos``,
  equal to the reference's;
- the spec tick body (:func:`spec_tick_body` through the engine's static
  tables) against the JAX engine's ``verify_block`` on one seeded pool,
  tables and tokens, for pools of 16, 8 and 4 bits and a draft of one
  layer and of all: emit, take, matched, tokens and positions EQUAL, the
  pool's int8 and int4 codes equal, their scales within 1e-6 relative and
  f32 pages within 1e-6 + 1e-5 relative (the K/V differ in their last
  ulps: another summation order); the rows
  hold a window that crosses a page, one clamped at the table's edge, one
  reaching past the row's pages and an inactive row;
- ``eos_id`` on the plain paged engine (K = 1 and 4), the spec engine and
  the dense engine (the reference's EOS case), ``spec_degrade_after``,
  the resets at retirement, single-token requests and the page cases of
  ``tests/test_page_pool.py``'s speculative classes, each against the
  JAX engine where it has one.

The engines are the reference's tiny configs (``TestSpeculativeEngine``'s
MHA ``tiny(n_heads=4, n_kv_heads=4)`` and the GQA ``tiny()``), f32, their
parameters converted by ``convert_llama_params``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import decode as jd
from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models import quant as jquant
from kubegpu_tpu.models import serve as js
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import quant as tquant
from kubegpu_tpu_torch.models import serve as ts
from kubegpu_tpu_torch.tree import tree_leaves

# the reference's TestSpeculativeEngine geometry
ENGINE = dict(n_slots=3, stride=4, prompt_buckets=(8, 16), paged=True,
              page_size=8)


def _pair(**kw):
    cfg_j = jl.LlamaConfig.tiny(max_seq_len=64, **kw)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(max_seq_len=64, **kw), \
        params_t


@pytest.fixture(scope="module")
def tiny4():
    return _pair(n_heads=4, n_kv_heads=4)


@pytest.fixture(scope="module")
def gqa():
    return _pair()


def _engines(pair, **kw):
    cfg_j, params_j, cfg, params_t = pair
    kw = {**ENGINE, **kw}
    return (ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                 debug_invariants=True, **kw),
            js.ContinuousBatcher(params_j, cfg_j, **kw))


def _drain(eng, prompts):
    rids = [eng.submit(p, n) for p, n in prompts]
    done = {r.rid: r.tokens for r in eng.drain()}
    return [done[r] for r in rids]


def _solo(pair, p, n):
    _, _, cfg, params_t = pair
    return td.greedy_generate(params_t, [p], n, cfg, device="cpu")[0].tolist()


# -- the pieces ---------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_draft_view_is_the_references_slice_and_a_view(gqa, quantized):
    _, params_j, _, params_t = gqa
    if quantized:
        params_j = jquant.quantize_llama(params_j)
        params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                        device="cpu")
    want = jax.tree.map(np.asarray, jd.draft_view(params_j, 1))
    got = td.draft_view(params_t, 1)

    def pairs(g, w, full):
        if isinstance(g, dict):
            assert set(g) == set(w)
            for k in g:
                yield from pairs(g[k], w[k], full[k])
        elif isinstance(g, tquant.QTensor):
            yield g.values, w.values, full.values
            yield g.scale, w.scale, full.scale
        else:
            yield g, w, full

    for g, w, full in pairs(got, want, params_t):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # a view of the full tree's storage: nothing was copied
        assert g.untyped_storage().data_ptr() == \
            full.untyped_storage().data_ptr()
    assert len(tree_leaves(got)) == len(jax.tree.leaves(want))
    layers = got["layers"]
    assert all(v.shape[0] == 1 for v in layers.values())
    if quantized:
        assert isinstance(layers["wq"], tquant.QTensor)
        with pytest.raises(TypeError, match="slice"):
            layers["wq"][0]


def test_spec_acceptance_matches_reference():
    rng = np.random.default_rng(0)
    full = rng.integers(0, 4, (64, 5)).astype(np.int32)
    drafted = np.where(rng.random((64, 4)) < 0.7, full[:, :4],
                       rng.integers(0, 4, (64, 4))).astype(np.int32)
    cap = rng.integers(0, 5, 64).astype(np.int32)
    for c_j, c_t in ((cap, torch.from_numpy(cap)), (2, 2)):
        wm, wt = jd.spec_acceptance(jnp.asarray(drafted), jnp.asarray(full),
                                    c_j if np.ndim(c_j) == 0
                                    else jnp.asarray(c_j))
        gm, gt = td.spec_acceptance(torch.from_numpy(drafted),
                                    torch.from_numpy(full), c_t)
        assert gm.dtype == gt.dtype == torch.int32
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    assert (np.asarray(wm) > 0).any() and (np.asarray(wm) < 4).any()


@pytest.mark.parametrize("gamma", [1, 2, 4, 8])
def test_gamma_from_accept_matches_reference(gamma):
    emas = np.linspace(0.0, 1.0, 101)
    got = ts._gamma_from_accept(emas, gamma)
    np.testing.assert_array_equal(got, js._gamma_from_accept(emas, gamma))
    assert got.dtype == np.int32
    assert (np.diff(got) >= 0).all() and got[0] == 0 and got[-1] == gamma


@pytest.mark.parametrize("tokens,eos", [
    ([3, 5, 7, 5], 5), ([3, 5, 7], 9), ([5], 5), ([], 5), ([3, 5], None)])
def test_truncate_at_eos_matches_reference(tokens, eos):
    got, want = list(tokens), list(tokens)
    assert td.truncate_at_eos(got, eos) == jd.truncate_at_eos(want, eos)
    assert got == want


# -- the tick body against the JAX engine's verify_block -----------------------

GAMMA = 3
# (row-local pages, t, t_pad, d0, active, gcap): a window crossing page 2
# into 3; one at the table's edge (phys 77-80 in a 10-page table: the last
# position clamps onto the last page); an inactive row (d0 = 0: its window
# lands at its t_pad); one reaching past its two pages (into page id 0)
ROWS = [(5, 13, 16, 5, True, 3), (10, 12, 16, 61, True, 2),
        (4, 9, 16, 7, False, 3), (2, 5, 8, 6, True, 0)]
KV = {16: {}, 8: {"kv_bits": 8}, 4: {"kv_bits": 4}}


def _seeded_pool(eng, rng):
    """The port engine's pool filled from ``rng`` in its own format (f32
    normals, or normals rated by the engine's quantizers: every int8 row
    and int4 group then holds its full-range code, as the engine writes
    them) and the same pool as JAX arrays."""
    vals = {n: torch.from_numpy(rng.standard_normal(
        eng.pool["k"].shape[:-1] + (eng.cfg.head_dim,)).astype(np.float32))
        for n in ("k", "v")}
    for name, x in ts._quantize_like(eng.pool, vals, eng.page_size).items():
        eng.pool[name].copy_(x)
    return {n: jnp.asarray(x.numpy()) for n, x in eng.pool.items()}


@pytest.mark.parametrize("draft_layers", [1, 2], ids=["draft1", "draftL"])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_spec_tick_matches_verify_block(gqa, bits, draft_layers):
    cfg_j, params_j, cfg, params_t = gqa
    kw = dict(ENGINE, n_slots=len(ROWS), total_pages=21, spec_gamma=GAMMA,
              draft_layers=draft_layers, **KV[bits])
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", **kw)
    ref = js.ContinuousBatcher(params_j, cfg_j, **kw)
    rng = np.random.default_rng(bits + draft_layers)
    pool_j = _seeded_pool(eng, rng)
    n_wide = eng.max_pages
    pt = np.zeros((len(ROWS), n_wide), np.int32)
    nxt = 1
    for i, (n, *_rest) in enumerate(ROWS):
        pt[i, :n] = np.arange(nxt, nxt + n)
        nxt += n
    tvec, tpad, d0, active, gcap = (np.array([r[i] for r in ROWS])
                                    for i in range(1, 6))
    pos = (tvec + d0).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, len(ROWS))
    tv = eng._tv
    for name, x in (("pt", pt), ("tvec", tvec), ("tpad", tpad),
                    ("active", active), ("gcap", gcap)):
        tv[name].copy_(torch.from_numpy(x.astype(np.int32)).view_as(
            tv[name]))
    tv["cap"].fill_(ts._NO_CAP)
    tv["budget"].fill_(1 << 20)
    eng.tokens.copy_(torch.from_numpy(tokens))
    eng.pos.copy_(torch.from_numpy(pos))
    eng._tick_on(eng._live, "spec")
    emit, take, matched, bad, tok_j, pos_j, pool_j = ref._fns[5](
        ref.params, ref._draft_params, pool_j, jnp.asarray(pt),
        jnp.asarray(tvec, jnp.int32), jnp.asarray(tpad, jnp.int32),
        jnp.asarray(tokens, jnp.int32), jnp.asarray(pos),
        jnp.asarray(active), jnp.asarray(gcap, jnp.int32))
    out = eng._live["spec_out"]
    np.testing.assert_array_equal(out["emit"][0].numpy(), np.asarray(emit))
    np.testing.assert_array_equal(out["take"][0].numpy(), np.asarray(take))
    np.testing.assert_array_equal(out["matched"][0].numpy(),
                                  np.asarray(matched))
    np.testing.assert_array_equal(out["bads"][0].numpy(), np.asarray(bad))
    np.testing.assert_array_equal(eng.tokens.numpy(), np.asarray(tok_j))
    np.testing.assert_array_equal(eng.pos.numpy(), np.asarray(pos_j))
    assert int(eng._tv["tk"]) == 1
    # the live pages (1..); trash page 0 takes whatever lands past a table
    for name, x in eng.pool.items():
        got, want = x.numpy()[:, 1:], np.asarray(pool_j[name])[:, 1:]
        if bits == 16:
            # the second layer's K/V carry the first layer's summation
            # order (a few f32 ulps)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        elif name.endswith("_scale"):
            # a new row's scale is its amax / 127 (or a group's / 7): the
            # K/V's last ulp shows
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got, want)
    if draft_layers == cfg.n_layers:
        # the draft is the full model: the active uncapped rows accept
        assert int(np.asarray(take)[0]) == GAMMA


# -- eos_id, degradation, resets and pages ----------------------------------

def _eos_prompts(vocab):
    return [([(i * 7 + 3) % vocab for i in range(5 + 3 * j)], 25)
            for j in range(3)]


@pytest.mark.parametrize("kw", [
    dict(), dict(fused_ticks=4), dict(spec_gamma=3, draft_layers=1),
    dict(paged=False)], ids=["paged", "fused4", "spec", "dense"])
def test_eos_truncates_as_the_reference(tiny4, kw):
    """The reference's EOS case: a token the engine emits mid-run becomes
    the stop token; the port's tokens equal the JAX engine's, end at the
    EOS and are shorter than without it."""
    prompts = _eos_prompts(tiny4[2].vocab_size)
    free = _drain(_engines(tiny4, **kw)[0], prompts)
    for (p, n), toks in zip(prompts, free):
        assert toks == _solo(tiny4, p, n)
    eos = free[0][len(free[0]) // 2]
    eng, ref = _engines(tiny4, eos_id=eos, **kw)
    got, want = _drain(eng, prompts), _drain(ref, prompts)
    assert got == want
    assert len(got[0]) < len(free[0]) and got[0][-1] == eos
    for toks, full in zip(got, free):
        assert toks == full[:len(toks)]
        assert eos not in toks[:-1]


def test_spec_degrades_at_the_references_tick(tiny4):
    """``spec_degrade_after=1``: the first verify tick with no match over
    the active slots degrades the engine to the plain tick, at the JAX
    engine's tick, with its tokens and counters; the tokens are solo
    greedy's."""
    prompts = [([(i * 3 + 1) % 256 for i in range(5)], 10),
               ([(i * 5 + 2) % 256 for i in range(7)], 10)]
    eng, ref = _engines(tiny4, n_slots=2, spec_gamma=3, draft_layers=1,
                        spec_degrade_after=1)
    for e in (eng, ref):
        for p, n in prompts:
            e.submit(p, n)
    trail, trail_ref, done, done_ref = [], [], {}, {}
    for _ in range(40):
        if not (eng.slot_req or eng.queue):
            break
        done.update({r.rid: r.tokens for r in eng.step()})
        done_ref.update({r.rid: r.tokens for r in ref.step()})
        trail.append((eng.spec_degraded, eng.spec_ticks, eng._tick))
        trail_ref.append((ref.spec_degraded, ref.spec_ticks, ref._tick))
    assert not (ref.slot_req or ref.queue)
    assert trail == trail_ref and done == done_ref
    assert eng.spec_degraded and 0 < eng.spec_ticks < eng._tick
    for rid, (p, n) in enumerate(prompts):
        assert done[rid] == _solo(tiny4, p, n)


def test_adaptive_state_resets_at_retirement(tiny4):
    eng, _ = _engines(tiny4, spec_gamma=2, draft_layers=1)
    eng.submit([1, 2, 3], 10)
    eng.drain()
    assert eng.spec_ticks > 0
    assert (eng._gcap == 2).all() and (eng._accept_ema == 1.0).all()
    assert 0.0 <= eng.spec_acceptance_rate <= 1.0
    assert eng.spec_tokens_per_tick >= 1.0


@pytest.mark.parametrize("fused", [1, 4])
def test_single_token_requests(tiny4, fused):
    eng, ref = _engines(tiny4, spec_gamma=2, draft_layers=1,
                        fused_ticks=fused)
    prompts = [([9, 8, 7], 1), ([5, 4], 1), ([1, 2, 3, 4, 5, 6], 3)]
    got = _drain(eng, prompts)
    assert got == _drain(ref, prompts)
    for (p, n), toks in zip(prompts, got):
        assert toks == _solo(tiny4, p, n)


def _page_engine(gqa, **kw):
    """``tests/test_page_pool.py``'s engine: three slots, max_len 32,
    stride 2, pages of 8, with its invariant checks every step."""
    _, _, cfg, params_t = gqa
    return ts.ContinuousBatcher(
        params_t, cfg, device="cpu", n_slots=3, max_len=32, stride=2,
        prompt_buckets=(8, 16), paged=True, page_size=8,
        debug_invariants=True, **{"spec_gamma": 2, "draft_layers": 1, **kw})


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
def test_spec_churn_no_double_use_no_leak(gqa, prefix):
    """The page pool's fuzz, speculative edition (with the prefix cache
    and chunked prefill: shared leading pages): the invariants after every
    step, every request finished with its tokens, no page leaked."""
    cfg = gqa[2]
    kw = (dict(prefix_cache=True, chunked_prefill=True, prefill_chunk=8)
          if prefix else {})
    eng = _page_engine(gqa, **kw)
    rng = np.random.default_rng(11 if prefix else 43)
    shared = [(i * 5 + 3) % cfg.vocab_size for i in range(8)]
    want, done = {}, {}
    for _ in range(60):
        if rng.random() < 0.5 and len(eng.queue) < 4:
            new = int(rng.integers(1, 6))
            if prefix and rng.random() < 0.5:
                prompt = shared + list(rng.integers(
                    0, cfg.vocab_size, int(rng.integers(1, 8))))
            else:
                prompt = list(rng.integers(0, cfg.vocab_size,
                                           int(rng.integers(1, 16))))
            want[eng.submit(prompt, new)] = new
        done.update({r.rid: len(r.tokens) for r in eng.step()})
    done.update({r.rid: len(r.tokens) for r in eng.drain()})
    assert done == want
    assert not eng._slot_pages
    assert len(eng._free_pages) + len(eng._page_refs) == eng.total_pages
    assert not any(eng._page_refs.values())


def test_rejection_never_touches_page_tables(gqa):
    eng = _page_engine(gqa)
    eng.submit(np.arange(1, 7), 8)
    eng.step()
    row = eng._pt[0].copy()
    assert row.any()
    while eng.slot_req:
        assert (eng._pt[0] == row).all()
        eng.step()
    assert not eng._pt[0].any()
    assert eng.spec_ticks > 0


def test_spec_pages_cover_gamma_overhang(gqa):
    cfg_j, params_j, cfg, params_t = gqa
    plain = _page_engine(gqa, spec_gamma=0)
    spec = _page_engine(gqa)
    ref = js.ContinuousBatcher(params_j, cfg_j, n_slots=3, max_len=32,
                               stride=2, prompt_buckets=(8, 16), paged=True,
                               page_size=8, spec_gamma=2, draft_layers=1)
    for n in (1, 6, 8, 9, 14):
        for bucket in (8, 16):
            assert spec._pages_needed(n, bucket) == \
                ref._pages_needed(n, bucket) >= plain._pages_needed(n, bucket)
    assert spec._pages_needed(8, 8) == 1 + -(-(8 + 2) // 8)
    with pytest.raises(ValueError, match="stride/γ"):
        _page_engine(gqa, spec_gamma=7).submit([1, 2, 3], 22)
