"""The port's paged ContinuousBatcher with int8 / packed-int4 KV pages and
window / mass page eviction, against the JAX package's engine (its Pallas
kernels 4-6 in interpret mode) on the same converted f32 parameters.

Shapes are ``tests/test_page_pool.py::TestAttentionAwareEviction``'s: 27-token
prompts padded to bucket 32 (four prompt pages of 8, two of them evictable
under the rails).  Greedy tokens, ``pages_evicted`` and the per-page mass EMA
must agree; the pool leaves after the first admission must be EQUAL in their
values (int8 / packed bytes) and within 1e-6 in their f32 scales (both sides
quantize the same prefill panel, whose f32 values agree to ~1e-7)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models import serve as js
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts
from kubegpu_tpu_torch.ops import kvquant as tq

ENGINE = dict(n_slots=3, max_len=48, stride=2, prompt_buckets=(32, 40),
              paged=True, page_size=8)


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny(n_heads=4, n_kv_heads=2, max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    cfg = tl.LlamaConfig.tiny(n_heads=4, n_kv_heads=2, max_seq_len=64)
    return cfg_j, params_j, cfg, params_t


def _prompt(vocab, j, plen=27):
    return [(5 * j + 3 * i + 2) % vocab for i in range(plen)]


def _engines(tiny, **kw):
    cfg_j, params_j, cfg, params_t = tiny
    return (js.ContinuousBatcher(params_j, cfg_j, **ENGINE, **kw),
            ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                 debug_invariants=True, **ENGINE, **kw))


def _audit_rails(eng, before_rows, before_refs, owner):
    """What ``test_page_pool.py``'s ``_run_checked`` asserts after a tick: a
    position that became a hole held a single-owner page, never the
    slot's sink page, and two live prompt pages remain."""
    for s, rid in owner.items():
        r = eng.slot_req.get(s)
        if r is None or r.rid != rid:
            continue         # slot retired/recycled, not a hole
        before, after = before_rows[s], eng._pt[s]
        for pi in np.nonzero((before != 0) & (after == 0))[0]:
            page = int(before[pi])
            assert pi >= 1, "evicted the attention sink page"
            assert before_refs.get(page, 0) == 1, f"evicted shared page {page}"
            assert (after[:int(eng._tpad[s]) // eng.page_size]
                    != 0).sum() >= 2, "fewer than 2 live prompt pages"


def _lockstep(ref, eng, n_reqs=3, n_new=8, first_pools=None):
    """Drive both engines tick by tick on the same requests; after every
    tick audit the port's rails and hold its eviction state to the
    reference's.  Returns each engine's tokens by rid."""
    vocab = eng.cfg.vocab_size
    for e in (ref, eng):
        for j in range(n_reqs):
            e.submit(_prompt(vocab, j), n_new)
    done = {"ref": [], "port": []}
    for tick in range(300):
        if not (eng.queue or eng.slot_req):
            break
        owner = {s: r.rid for s, r in eng.slot_req.items()}
        rows = {s: eng._pt[s].copy() for s in owner}
        refs = dict(eng._page_refs)
        done["ref"] += ref.step()
        done["port"] += eng.step()
        eng.check_page_invariants()
        _audit_rails(eng, rows, refs, owner)
        assert eng.pages_evicted == ref.pages_evicted, tick
        np.testing.assert_array_equal(eng._pt, ref._pt)
        if eng.evict_policy is not None:
            np.testing.assert_allclose(eng._page_mass, ref._page_mass,
                                       atol=1e-6)
        if tick == 0 and first_pools is not None:
            first_pools.append({n: (np.asarray(ref.pool[n]),
                                    eng.pool[n].numpy().copy())
                                for n in ref.pool})
    assert not (eng.queue or eng.slot_req or ref.queue or ref.slot_req)
    assert len(eng._free_pages) == eng.total_pages
    eng.check_page_invariants()
    return ({r.rid: r.tokens for r in done["ref"]},
            {r.rid: r.tokens for r in done["port"]})


@pytest.mark.parametrize("kw", [dict(kv_bits=8), dict(kv_bits=4),
                                dict(kv_bits=4, kv_group=1),
                                dict(kv_int8=True)],
                         ids=["int8", "int4_g2", "int4_g1", "kv_int8"])
def test_quantized_engine_matches_reference(tiny, kw):
    ref, eng = _engines(tiny, **kw)
    assert (eng.kv_bits, eng.kv_group) == (ref.kv_bits, ref.kv_group)
    pools = []
    want, got = _lockstep(ref, eng, first_pools=pools)
    assert got == want and all(len(t) == 8 for t in got.values())
    for name, (a, b) in pools[0].items():
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name.endswith("scale"):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("kv_bits", [16, 4], ids=["f32_pool", "int4_pool"])
@pytest.mark.parametrize("policy,param", [("window", 8.0), ("mass", 0.25)],
                         ids=["window", "mass"])
def test_eviction_matches_reference(tiny, kv_bits, policy, param):
    """Both policies drop pages in the middle of decoding, the same pages
    at the same ticks as the reference, and every request still finishes
    with the reference's tokens."""
    ref, eng = _engines(tiny, kv_bits=kv_bits, evict_policy=policy,
                        evict_param=param)
    want, got = _lockstep(ref, eng)
    assert eng.pages_evicted >= 1, f"{policy} never evicted"
    assert got == want and all(len(t) == 8 for t in got.values())


def test_eviction_defaults_match_reference(tiny):
    cfg_j, params_j, cfg, params_t = tiny
    for policy in ("window", "mass"):
        ref, eng = _engines(tiny, evict_policy=policy)
        assert eng.evict_param == ref.evict_param
    assert ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                **ENGINE).evict_param == 0.0


@pytest.mark.parametrize("kw", [
    dict(kv_int8=True, kv_bits=4), dict(kv_bits=4, kv_group=3),
    dict(kv_bits=4, odd_head=True), dict(evict_policy="lru"),
    dict(kv_group=2), dict(kv_bits=8, kv_group=2), dict(kv_bits=5)],
    ids=["int8_and_int4", "group_not_dividing_stride", "odd_head_dim",
         "unknown_policy", "group_without_int4", "group_with_int8",
         "bad_bits"])
def test_constructor_errors_match_reference(tiny, kw):
    cfg_j, params_j, cfg, params_t = tiny
    if kw.pop("odd_head", False):
        cfg_j = dataclasses.replace(cfg_j, d_model=60)
        cfg = dataclasses.replace(cfg, d_model=60)
        assert cfg.head_dim == cfg_j.head_dim == 15
    with pytest.raises(ValueError) as want:
        js.ContinuousBatcher(params_j, cfg_j, **ENGINE, **kw)
    with pytest.raises(ValueError) as got:
        ts.ContinuousBatcher(params_t, cfg, device="cpu", **ENGINE, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(kv_bits=8),
                                dict(kv_bits=4, evict_policy="mass")],
                         ids=["int8", "int4_mass"])
def test_warmup_is_state_free(tiny, kw):
    """warmup() runs on a scratch pool in the engine's own format: the
    pool stays empty (int8 zeros / 0x88 bytes, scales 1), and counters,
    tables and the mass EMA stay untouched."""
    _, eng = _engines(tiny, **kw)
    empty = {n: x.clone() for n, x in eng.pool.items()}
    eng.warmup()
    for n, x in eng.pool.items():
        assert torch.equal(x, empty[n]), n
    if eng.kv_bits == 4:
        assert (eng.pool["k"] == tq.Q4_ZERO_BYTE).all()
    assert (eng.pool["k_scale"] == 1).all()
    assert (eng._tick, eng.emitted_tokens, eng.pages_evicted) == (0, 0, 0)
    assert not eng._page_mass.any() and eng._mass_pending is None


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_flush_matches_reference(fmt):
    """The block flush quantizes the whole buffer once and scatters values
    and scales into each row's decode page: byte for byte the reference's
    ``_flush_buffer_paged``, a retired row (zeroed table) writing only
    trash page 0."""
    rng = np.random.default_rng(0)
    L, n_pages, hkv, P, D, stride = 2, 6, 2, 8, 16, 4
    if fmt == "int8":
        vals = np.zeros((L, n_pages, hkv, P, D), np.int8)
        scales = np.ones((L, n_pages, hkv, P), np.float32)
    else:   # groups of 2 keys
        vals = np.full((L, n_pages, hkv, P, D // 2), tq.Q4_ZERO_BYTE,
                       np.uint8)
        scales = np.ones((L, n_pages, hkv, P // 2), np.float32)
    pool = {"k": vals, "v": vals.copy(), "k_scale": scales,
            "v_scale": scales.copy()}
    buf = {n: rng.standard_normal((L, 2, hkv, stride, D), np.float32)
           for n in ("k", "v")}
    pt = np.array([[3, 5, 0], [0, 0, 0]], np.int32)
    tpad = np.array([8, 0], np.int32)
    d0 = np.array([4, 0], np.int32)
    want = js._flush_buffer_paged(
        {n: jnp.asarray(x) for n, x in pool.items()},
        {n: jnp.asarray(x) for n, x in buf.items()},
        *map(jnp.asarray, (pt, tpad, d0)), P)
    mine = {n: torch.from_numpy(x.copy()) for n, x in pool.items()}
    ts._flush_buffer_paged(mine, {n: torch.from_numpy(x)
                                  for n, x in buf.items()},
                           *map(torch.from_numpy, (pt, tpad, d0)), P)
    for n in pool:
        np.testing.assert_array_equal(mine[n].numpy(), np.asarray(want[n]))
        # only the decode page (5) and the trash page (0) were written
        assert (mine[n][:, [1, 2, 3, 4]].numpy() == pool[n][:, [1, 2, 3, 4]]
                ).all()
    assert not (mine["k"][:, 5].numpy() == pool["k"][:, 5]).all()
