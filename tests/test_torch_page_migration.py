"""Page-chain migration in the port against the JAX package: the page
gather and scatter over the three pool formats, the chain digest (the same
hex string for a chain in either package), the engine's export and import
(``submit(migrate_out=True)``, ``take_export``, ``import_chain``) mirrored
from ``tests/test_page_pool.py::TestChainMigration``, and the eviction and
preemption rails of a migrate-out leg.

Tokens, counters and refcounts must equal the JAX engine's on the same
converted f32 weights; a chain the JAX engine exported, converted to host
tensors, keeps its digest and decodes in the port to the JAX tokens.  The
JAX side runs its Pallas kernels in interpret mode on the CPU."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models import serve as js
from kubegpu_tpu.ops import paged_attention as jpa
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts
from kubegpu_tpu_torch.ops import paged_attention as tpa

from jax_shared import one_torch_thread, shared_paged_executables


@pytest.fixture(scope="module", autouse=True)
def fast_module():
    """One torch thread, and the JAX engines' executables shared across
    this module's configs (``tests/jax_shared.py``)."""
    with one_torch_thread(), shared_paged_executables(js):
        yield


# tests/test_page_pool.py's engine, with its prefix cache and chunks
ENGINE = dict(n_slots=3, max_len=32, stride=2, prompt_buckets=(8, 16),
              paged=True, page_size=8, debug_invariants=True,
              prefix_cache=True, chunked_prefill=True, prefill_chunk=8)
KV_MODES = {"bf16": {}, "int8": {"kv_int8": True}, "int4": {"kv_bits": 4}}
COUNTERS = ("chains_exported", "chains_imported", "pages_migrated_out",
            "pages_migrated_in")


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny(n_heads=4, n_kv_heads=2, max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    cfg = tl.LlamaConfig.tiny(n_heads=4, n_kv_heads=2, max_seq_len=64)
    return cfg_j, params_j, cfg, params_t


def host_pool(fmt: str, rng) -> dict:
    """A [L=2, 6 pages, Hkv=2, P=8, D=16] pool of random bytes in ``fmt``
    as numpy leaves (bf16 as ml_dtypes' bfloat16)."""
    shape = (2, 6, 2, 8, 16)
    if fmt == "bf16":
        return {n: rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
                for n in ("k", "v")}
    if fmt == "int8":
        vals = {n: rng.integers(-127, 128, shape).astype(np.int8)
                for n in ("k", "v")}
        n_scale = 8
    else:
        vals = {n: rng.integers(0, 256, shape[:-1] + (8,)).astype(np.uint8)
                for n in ("k", "v")}
        n_scale = 4
    scales = {f"{n}_scale": rng.random(shape[:3] + (n_scale,)).astype(
        np.float32) for n in ("k", "v")}
    return {**vals, **scales}


def to_torch(leaves: dict) -> dict:
    """Numpy leaves as host tensors (bf16 through its bits)."""
    out = {}
    for n, a in leaves.items():
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            out[n] = torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out[n] = torch.from_numpy(a.copy())
    return out


def to_numpy(leaves: dict) -> dict:
    out = {}
    for n, t in leaves.items():
        if t.dtype == torch.bfloat16:
            out[n] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[n] = t.numpy()
    return out


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_gather_scatter_pages_equal_reference(fmt):
    """Every leaf (values and scales) gathered at the same ids, trash page
    0 included, and the chain scattered into other pages of a second
    pool, equal the reference's, byte for byte."""
    rng = np.random.default_rng(3)
    src, dst = host_pool(fmt, rng), host_pool(fmt, rng)
    ids, dst_ids = np.array([4, 0, 2]), np.array([1, 0, 5])
    want = jpa.gather_pages({n: jnp.asarray(a) for n, a in src.items()},
                            jnp.asarray(ids))
    got = tpa.gather_pages(to_torch(src), torch.from_numpy(ids))
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(to_numpy(got)[n], np.asarray(want[n]))
    pool_t = to_torch(dst)
    tpa.scatter_pages(pool_t, got, torch.from_numpy(dst_ids))
    ref = jpa.scatter_pages({n: jnp.asarray(a) for n, a in dst.items()},
                            want, jnp.asarray(dst_ids))
    for n in ref:
        a, b = to_numpy(pool_t)[n], np.asarray(ref[n])
        # page 0 takes the trash write in both; every other page is exact
        np.testing.assert_array_equal(a[:, 1:], b[:, 1:])


@pytest.mark.parametrize("fmt", ["bf16", "f32", "int8", "int4"])
def test_chain_digest_equals_reference(fmt):
    """The same chain hashes to the same hex string in both packages; a
    flipped byte or another prompt length changes it."""
    rng = np.random.default_rng(5)
    chain = host_pool("bf16" if fmt == "f32" else fmt, rng)
    if fmt == "f32":
        chain = {n: a.astype(np.float32) for n, a in chain.items()}
    want = js._chain_digest(chain, 13)
    got = ts._chain_digest(to_torch(chain), 13)
    assert got == want and len(got) == 64
    assert ts._chain_digest(to_torch(chain), 12) != got
    torn = to_torch(chain)
    torn["k"].view(torch.uint8).view(-1)[0] ^= 1
    assert ts._chain_digest(torn, 13) != got


def port_engine(tiny, **kw):
    _, _, cfg, params_t = tiny
    return ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                **{**ENGINE, **kw})


def ref_engine(tiny, **kw):
    cfg_j, params_j, _, _ = tiny
    return js.ContinuousBatcher(params_j, cfg_j, **{**ENGINE, **kw})


def migrate(src, dst, prompt, total, churn_vocab):
    """The reference test's story on one package's engines: a prefill leg
    with ``migrate_out``, its export taken exactly once, the source's
    freed pages churned by four more requests, a tampered copy refused,
    then the import and the decode.  Returns what must agree."""
    rid = src.submit(prompt, 1, migrate_out=True)
    (leg,) = src.drain()
    assert leg.rid == rid and leg.error is None
    exp = src.take_export(rid)
    assert exp is not None and exp["pages"] == 2   # bucket 16, P = 8
    assert src.take_export(rid) is None
    frozen = {n: np.array(a, copy=True) if not isinstance(a, torch.Tensor)
              else a.clone() for n, a in exp["chain"].items()}
    for j in range(4):
        src.submit([(41 + 5 * j + 3 * i) % churn_vocab for i in range(12)], 4)
    src.drain()
    src.check_page_invariants()
    for n, a in exp["chain"].items():
        assert (np.asarray(a) == np.asarray(frozen[n])).all(), n
    local = dst.import_chain(exp, max_new_tokens=total)
    assert local is not None
    dst.check_page_invariants()
    (out,) = dst.drain()
    assert out.rid == local and out.error is None
    dst.check_page_invariants()
    return {"first": leg.tokens, "tokens": out.tokens,
            "counters": [getattr(e, c) for e in (src, dst) for c in COUNTERS],
            "free": [len(e._free_pages) for e in (src, dst)],
            "refs": [sorted(e._page_refs.items()) for e in (src, dst)],
            "keys": len(exp["prefix_keys"])}, exp


@pytest.mark.parametrize("kv", list(KV_MODES))
def test_export_mutate_import_bit_exact_refcounts(tiny, kv):
    """``TestChainMigration``'s export → churn → import story on the port
    and on the JAX engine: the same first token, decode tokens (equal to a
    never-migrated run's), counters, free lists and refcounts; the
    imported pages hold the export's bytes; a tampered chain is refused.
    The JAX export, converted to host tensors, keeps its digest and
    decodes in a fresh port engine to the same tokens."""
    _, _, cfg, params_t = tiny
    kw = KV_MODES[kv]
    vocab = cfg.vocab_size
    prompt = [(i * 7 + 2) % vocab for i in range(12)]
    total = 6
    solo = port_engine(tiny, **kw)
    solo.submit(prompt, total)
    (never,) = solo.drain()
    src, dst = port_engine(tiny, **kw), port_engine(tiny, **kw)
    got, exp = migrate(src, dst, prompt, total, vocab)
    want, exp_j = migrate(ref_engine(tiny, **kw), ref_engine(tiny, **kw),
                          prompt, total, vocab)
    assert got == want
    assert got["first"] + got["tokens"][1:] == got["tokens"] == never.tokens
    if not kw:
        assert never.tokens == td.greedy_generate(params_t, [prompt], total,
                                                  cfg, device="cpu")[0].tolist()
    assert exp["digest"] == ts._chain_digest(exp["chain"], exp["t"])
    # the imported pages hold the export's bytes (dst's first slot)
    fresh = port_engine(tiny, **kw)
    local = fresh.import_chain(exp, max_new_tokens=total)
    slot = next(s for s, r in fresh.slot_req.items() if r.rid == local)
    pages = torch.tensor(fresh._slot_pages[slot][:exp["pages"]])
    for n, leaf in fresh.pool.items():
        assert torch.equal(leaf.index_select(1, pages), exp["chain"][n]), n
    # a tampered chain is refused before the pool is touched
    bad = dict(exp, chain={n: a.clone() for n, a in exp["chain"].items()})
    bad["chain"]["k"].view(torch.uint8).view(-1)[0] ^= 1
    with pytest.raises(ValueError, match="digest"):
        port_engine(tiny, **kw).import_chain(bad, max_new_tokens=total)
    # the JAX engine's export in the port
    conv = dict(exp_j, chain=to_torch(exp_j["chain"]))
    assert ts._chain_digest(conv["chain"], conv["t"]) == exp_j["digest"]
    other = port_engine(tiny, **kw)
    other.import_chain(conv, max_new_tokens=total)
    (out,) = other.drain()
    assert out.tokens == want["tokens"]


def test_import_refusals_and_capacity(tiny):
    """``import_chain``'s errors (as the reference's): a dense engine, a
    budget below 2, another page size, a request past ``max_len`` or past
    the pool, a sampled request on a greedy engine, a dead engine; None
    while no slot or pages are free, then the import once one is."""
    _, _, cfg, params_t = tiny
    src = port_engine(tiny)
    rid = src.submit(list(range(1, 13)), 1, migrate_out=True)
    src.drain()
    exp = src.take_export(rid)
    dense = ts.ContinuousBatcher(params_t, cfg, device="cpu", n_slots=2,
                                 max_len=32, stride=2, prompt_buckets=(8, 16))
    with pytest.raises(ValueError, match="paged pool"):
        dense.import_chain(exp, 4)
    with pytest.raises(ValueError, match="migrate_out needs the paged"):
        dense.submit([1, 2, 3], 2, migrate_out=True)
    eng = port_engine(tiny)
    with pytest.raises(ValueError, match=">= 2"):
        eng.import_chain(exp, 1)
    with pytest.raises(ValueError, match="page-size"):
        eng.import_chain(dict(exp, page_size=16), 4)
    with pytest.raises(ValueError, match="max_len"):
        eng.import_chain(exp, 20)
    with pytest.raises(ValueError, match="sampling"):
        eng.import_chain(exp, 4, temperature=0.5)
    small = port_engine(tiny, total_pages=2)
    with pytest.raises(ValueError, match="pool has only"):
        small.import_chain(exp, 4)
    # three resident requests hold every slot: no import yet
    for j in range(3):
        eng.submit([7 + j, 8, 9], 12)
    eng.step()
    assert eng.import_chain(exp, 4) is None
    eng.drain()
    local = eng.import_chain(exp, 4)
    assert local is not None and eng.chains_imported == 1
    (out,) = eng.drain()
    assert len(out.tokens) == 4
    eng.dead = "killed"
    with pytest.raises(ts.ReplicaDeadError):
        eng.import_chain(exp, 4)


def test_migrate_out_leg_is_spared_by_eviction_and_preemption(tiny):
    """A migrate-out leg's pages must stay whole until its export: the
    eviction pass skips its slot (``_migrate_out``), and preemption never
    picks it as a victim.  Shown on a slot forced into decoding with a
    window that would otherwise evict its cold prompt pages."""
    _, _, cfg, params_t = tiny
    # the 40 bucket holds a parked request's replay (prompt + tokens)
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", n_slots=2,
                               max_len=56, stride=2, prompt_buckets=(32, 40),
                               paged=True, page_size=8,
                               evict_policy="window", evict_param=8.0)
    prompt = [(5 * i + 2) % cfg.vocab_size for i in range(27)]
    kept = eng.submit(prompt, 12, migrate_out=True)
    plain = eng.submit(prompt[::-1], 12)
    for _ in range(4):
        eng.step()
    slots = {r.rid: s for s, r in eng.slot_req.items()}
    assert (eng._pt[slots[kept], :4] != 0).all(), "the leg lost a page"
    assert (eng._pt[slots[plain], :4] == 0).any(), "nothing was evicted"
    assert eng.pages_evicted >= 1
    victims = eng._maybe_preempt(
        ts._Request(rid=99, prompt_len=3, max_new_tokens=2, tier=0,
                    prompt=np.arange(3)), 0, need_slot=True)
    assert victims == []     # both residents are tier 0: none outranked
    req = eng.slot_req[slots[kept]]
    req.tier = eng.slot_req[slots[plain]].tier = 1
    victims = eng._maybe_preempt(
        ts._Request(rid=99, prompt_len=3, max_new_tokens=2, tier=0,
                    prompt=np.arange(3)), 0, need_slot=True)
    assert victims == [slots[plain]]
    eng.drain()
    assert eng.chains_exported == 1 and eng.take_export(kept) is not None


# tests/test_page_pool.py's pool traffic: 16-token prompts, 8 new tokens
POOL = dict(n_slots=2, max_len=32, stride=2, prompt_buckets=(16,),
            paged=True, page_size=8, prefix_cache=True,
            chunked_prefill=True, prefill_chunk=8)


def stream(vocab, n):
    base = np.arange(2, 18)
    return [(((base + 3 * i) % vocab).tolist(), 8) for i in range(n)]


def pool_run(pool, reqs):
    """Submit ``reqs`` and drain: (tokens by submit order, None for a
    failed request; completions seen twice)."""
    rids = [pool.submit(p, n) for p, n in reqs]
    seen, dup = {}, 0
    for r in pool.drain():
        dup += r.rid in seen
        seen[r.rid] = None if r.error is not None else list(r.tokens)
    return [seen.get(r) for r in rids], dup


def port_pool(tiny, cls, n, **kw):
    _, _, cfg, params_t = tiny
    return cls(params_t, cfg, devices=["cpu"] * n, **kw)


def ref_pool(tiny, cls, **kw):
    """The reference's pool, its two replicas on its first device (its
    executables compile once a device mesh)."""
    cfg_j, params_j, _, _ = tiny
    return cls(params_j, cfg_j, tp=1, devices=[jax.devices()[0]] * 2, **kw)


def test_migration_composes_spec_fused(tiny):
    """The role-split pool over speculative (γ 2), fused (K 4), prefix-
    cached, chunked engines: every request migrates, and the tokens equal
    the symmetric pool's and the JAX role-split pool's."""
    kw = dict(POOL, spec_gamma=2, draft_layers=1, fused_ticks=4)
    reqs = stream(tiny[2].vocab_size, 4)
    sym, _ = pool_run(port_pool(tiny, ts.DataParallelServePool, 2, dp=2,
                                **kw), reqs)
    dis = port_pool(tiny, ts.DisaggServePool, 2, prefill=1, decode=1, **kw)
    got, dup = pool_run(dis, reqs)
    ref = ref_pool(tiny, js.DisaggServePool, prefill=1, decode=1, **kw)
    want, _ = pool_run(ref, reqs)
    assert dup == 0 and all(t is not None and len(t) == 8 for t in got)
    assert got == sym == want
    assert (dis.migrations, dis.migrated_pages) == (
        ref.migrations, ref.migrated_pages) == (4, 8)
    assert [e.chains_imported for e in dis.replicas] == [0, 4]


def test_chaos_prefill_kill_mid_migration_exactly_once(tiny):
    """A prefill-replica kill while migrations are in flight: exports
    already taken are host memory and migrate, unfinished prefills replay;
    every request completes exactly once with the fault-free tokens (the
    solo tokens), and the failover and migration counters equal the JAX
    pool's under the same chaos."""
    from kubegpu_tpu.obs import chaos as jchaos
    from kubegpu_tpu_torch.obs import chaos as tchaos
    _, _, cfg, params_t = tiny
    reqs = stream(cfg.vocab_size, 6)
    solo = [td.greedy_generate(params_t, [p], n, cfg,
                               device="cpu")[0].tolist() for p, n in reqs]
    base_pool = port_pool(tiny, ts.DisaggServePool, 2, **POOL)
    base, dup0 = pool_run(base_pool, reqs)
    assert dup0 == 0 and base == solo
    assert base_pool.migrations == len(reqs)

    def kill(mod):
        return {0: mod.ChaosInjector([mod.ChaosEvent(tick=2,
                                                     kind="kill_replica")])}

    pool = port_pool(tiny, ts.DisaggServePool, 2, chaos=kill(tchaos), **POOL)
    toks, dup = pool_run(pool, reqs)
    ref = ref_pool(tiny, js.DisaggServePool, chaos=kill(jchaos), **POOL)
    ref_toks, _ = pool_run(ref, reqs)
    assert dup == 0, "a request completed twice across the kill"
    assert toks == base, "a replayed request lost its tokens"
    assert pool.failovers == ref.failovers == 1
    assert pool.migrations == ref.migrations <= len(reqs)
    assert [t is None for t in toks] == [t is None for t in ref_toks]


def test_reference_import_reads_the_block_in_flight(tiny):
    """A fault of the reference (ROADMAP.md queue 3): its decode replica
    imports a chain while a block is in flight, and its next collect
    credits the imported slot with that block's column, dispatched before
    the slot was active; without speculation (whose consume is gated by
    the dispatch's active mask) those tokens are garbage.  The port skips
    the imported slot in that block (``_imported``): its disaggregated
    tokens equal the solo run's, the JAX pool's part from them."""
    _, _, cfg, params_t = tiny
    kw = dict(n_slots=2, stride=2, prompt_buckets=(8, 16), page_size=8,
              prefix_cache=True, chunked_prefill=True, prefill_chunk=8)
    reqs = [([(i * 3 + j) % cfg.vocab_size for i in range(4 + j)], 5 + j)
            for j in range(5)]
    solo = [td.greedy_generate(params_t, [p], n, cfg,
                               device="cpu")[0].tolist() for p, n in reqs]
    got, _ = pool_run(port_pool(tiny, ts.DisaggServePool, 2, **kw), reqs)
    want, _ = pool_run(ref_pool(tiny, js.DisaggServePool, **kw), reqs)
    assert got == solo
    assert want != solo
    assert [len(t) for t in want] == [n for _, n in reqs]
