"""The port's engine accounting (``ContinuousBatcher``'s prefill waves, the
per-tick stall and host-overhead lists, busy ticks and the chip-tick cost
ledger, live state bytes, the fault counters and ``note_kv_quality``)
against the JAX package's engine on the same traffic, on the dense engine,
the paged one, ``fused_ticks=4``, speculative γ = 2 and the prefix cache
with chunked prefill; the JAX side runs its Pallas kernels in interpret
mode.

Wall-clock lists can only be held by their lengths; everything the
schedule decides must be equal.  The pool (or cache) leaves' bytes must
equal the reference's.  The slot vectors differ: the port keeps
``tokens``/``first_toks`` as int64 and ``pos``/``temps`` as int32/f32 (24
bytes a slot), the reference ``first_toks``/``tokens``/``pos``/``temps`` as
four 4-byte words (16 bytes a slot)."""

import jax
import numpy as np
import pytest

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models.serve import ContinuousBatcher as JaxBatcher
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts

BASE = dict(n_slots=3, stride=4, prompt_buckets=(8, 16), page_size=8)
CASES = {
    "dense": dict(paged=False),
    "paged": dict(paged=True),
    "fused4": dict(paged=True, fused_ticks=4),
    "spec2": dict(paged=True, spec_gamma=2, draft_layers=1),
    "prefix-chunked": dict(paged=True, prefix_cache=True,
                           chunked_prefill=True, prefill_chunk=8),
}
EQUAL = ("prefill_waves", "wave_log", "wave_sizes", "busy_ticks",
         "slot_steps", "prefill_tokens", "emitted_tokens", "_tick_log")
LENGTHS = ("stall_ms", "host_overhead_ms", "fused_block_ms")
FAULTS = ("requests_retried", "slots_quarantined", "requests_shed")


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny(n_heads=4, n_kv_heads=4, max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    cfg = tl.LlamaConfig.tiny(n_heads=4, n_kv_heads=4, max_seq_len=64)
    return cfg_j, params_j, cfg, params_t


def traffic(vocab):
    """Three requests sharing a full 8-token page, a 15-token one, and
    three more, one of them a single-token request."""
    shared = [(i * 5 + 3) % vocab for i in range(8)]
    prompts = [(shared + [(41 + 9 * j + i) % vocab for i in range(5)], 6)
               for j in range(3)]
    prompts.append(([(i * 13 + 4) % vocab for i in range(15)], 5))
    prompts += [([(7 * i + j) % vocab for i in range(n)], m)
                for j, (n, m) in enumerate(((5, 10), (12, 3), (7, 1)))]
    return prompts


def serve(eng, prompts):
    """The first two requests alone for three steps, then the rest;
    returns {rid: tokens}."""
    done = {}
    for p, n in prompts[:2]:
        eng.submit(p, n)
    for _ in range(3):
        done.update({r.rid: r.tokens for r in eng.step()})
    for p, n in prompts[2:]:
        eng.submit(p, n)
    done.update({r.rid: r.tokens for r in eng.drain()})
    return done


def acct(eng) -> dict:
    out = {name: getattr(eng, name) for name in EQUAL}
    out["wave_sizes"] = list(out["wave_sizes"])
    out["wave_log"] = [tuple(x) for x in out["wave_log"]]
    out["_tick_log"] = [(d["tick"], [tuple(w) for w in d["work"]])
                        for d in out["_tick_log"]]
    out.update({f"len({n})": len(getattr(eng, n)) for n in LENGTHS})
    out["cost"] = (eng.cost.as_dict(), eng.cost.busy_chip_ticks,
                   eng.cost.conserved)
    out.update({n: getattr(eng, n) for n in FAULTS})
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_accounting_matches_reference(tiny, case):
    cfg_j, params_j, cfg, params_t = tiny
    kw = dict(BASE, **CASES[case])
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                               debug_invariants=kw["paged"], **kw)
    ref = JaxBatcher(params_j, cfg_j, **kw)
    prompts = traffic(cfg.vocab_size)
    assert serve(eng, prompts) == serve(ref, prompts)
    ours, theirs = acct(eng), acct(ref)
    assert ours == theirs
    assert ours["prefill_waves"] > 0 and ours["busy_ticks"] > 0
    assert ours["cost"][1] == ours["busy_ticks"]     # one device a tick
    assert not any(ours[n] for n in FAULTS)
    if case == "fused4":
        assert eng.fused_dispatches > 0 and ours["len(fused_block_ms)"] > 0
    if case == "prefix-chunked":
        assert eng.chunks_run > 0 and any(
            w[0] == "chunk" for _, work in ours["_tick_log"] for w in work)
    # live bytes: the pool (cache) leaves equal the reference's; the slot
    # vectors are 24 bytes a slot here and 16 there (see the docstring)
    leaves, mirrors = eng._state_bytes()
    store = ref.pool if kw["paged"] else ref.cache
    ref_leaves = sum(x.nbytes for x in jax.tree.leaves(store))
    ref_mirrors = sum(x.nbytes for x in (ref.first_toks, ref.tokens,
                                         ref.pos, ref.temps))
    assert leaves == ref_leaves > 0
    assert (mirrors, ref_mirrors) == (24 * kw["n_slots"],
                                      16 * kw["n_slots"])
    assert eng.hbm_pool_bytes == eng.hbm_peak_bytes == leaves + mirrors
    assert ref.hbm_pool_bytes == ref_leaves + ref_mirrors
    assert eng.hbm.samples > 0
    eng.note_kv_quality(0.125)
    ref.note_kv_quality(0.125)
    assert eng.kv_quality_delta == ref.kv_quality_delta == 0.125


def test_accounting_lists_are_trimmed(tiny):
    """Past ``_ACCT_CAP`` entries a list drops its oldest down to half the
    cap, as the reference's sweep does."""
    xs = list(range(ts._ACCT_CAP + 1))
    ts._trim_acct(xs)
    assert xs == list(range(ts._ACCT_CAP // 2 + 1, ts._ACCT_CAP + 1))
    ys = list(range(10))
    ts._trim_acct(ys)
    assert ys == list(range(10))
    from kubegpu_tpu.models import serve as js
    assert js._ACCT_CAP == ts._ACCT_CAP
    zs = list(range(ts._ACCT_CAP + 1))
    js._trim_acct(zs)
    assert zs == xs
