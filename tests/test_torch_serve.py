"""The port's paged ContinuousBatcher against the port's own solo
``greedy_generate`` and the JAX package's paged engine (which runs its
Pallas kernel in interpret mode on the CPU), on the same converted f32
parameters.  Greedy tokens must be EQUAL, with staggered arrivals that
retire and re-admit slots; the page invariants must hold throughout."""

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

ENGINE = dict(n_slots=3, stride=4, prompt_buckets=(8, 16), paged=True,
              page_size=8)
# (prompt length, max_new_tokens); the first three arrive up front, the
# rest after two ticks, so slots retire and are re-admitted
REQUESTS = [(5, 10), (12, 3), (7, 1), (16, 9), (3, 6), (9, 5)]


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny(max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(max_seq_len=64), params_t


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, t).tolist(), n) for t, n in REQUESTS]


def _serve(eng, prompts, check=None):
    rids = {}
    done = []
    for p, n in prompts[:3]:
        rids[eng.submit(p, n)] = (p, n)
    for _ in range(2):
        done += eng.step()
        if check:
            check()
    for p, n in prompts[3:]:
        rids[eng.submit(p, n)] = (p, n)
    done += eng.drain()
    return rids, {r.rid: r.tokens for r in done}


def test_engine_matches_solo_greedy_and_reference_engine(tiny):
    cfg_j, params_j, cfg, params_t = tiny
    prompts = _prompts(cfg.vocab_size)
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", **ENGINE)
    rids, got = _serve(eng, prompts, check=eng.check_page_invariants)
    assert set(got) == set(rids)
    eng.check_page_invariants()
    assert sorted(eng._free_pages) == list(range(1, eng.total_pages + 1))
    assert eng.emitted_tokens == sum(n for _, n in REQUESTS)
    ref_rids, ref = _serve(JaxBatcher(params_j, cfg_j, **ENGINE), prompts)
    assert ref_rids == rids
    for rid, (p, n) in rids.items():
        solo = td.greedy_generate(params_t, [p], n, cfg, device="cpu")
        assert got[rid] == solo[0].tolist() == ref[rid], rid


def test_page_accounting_matches_reference(tiny):
    cfg_j, params_j, cfg, params_t = tiny
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", **ENGINE)
    ref = JaxBatcher(params_j, cfg_j, **ENGINE)
    assert (eng.max_pages, eng.total_pages) == (ref.max_pages,
                                                ref.total_pages)
    for n in (1, 4, 5, 9, 30):
        for bucket in (8, 16):
            assert eng._pages_needed(n, bucket) == ref._pages_needed(n,
                                                                     bucket)


# the engine knobs of the reference that the port takes at their defaults
# only (besides ``mesh``): name -> (default, another value, ROADMAP.md item);
# collect_overlap and donate are ported (tests/test_torch_serve_overlap.py)
LATER_KNOBS: dict = {}
# knobs and submit keywords (ported, or taken at their defaults only) whose
# reference defaults must keep serving the plain greedy tokens; every
# submit keyword is ported (migrate_out: tests/test_torch_page_migration.py)
DEFAULT_KNOBS = {"max_retries": 2, "collect_overlap": False, "donate": True,
                 "spec_adaptive": True, "spec_degrade_after": None}
DEFAULT_SUBMIT = {"deadline_s": None, "deadline_ticks": None, "tier": 0,
                  "tenant": "", "migrate_out": False}


@pytest.mark.parametrize("knob,value", [
    ("mesh", object()),
    *((k, v[1]) for k, v in LATER_KNOBS.items()),
])
def test_unported_knobs_raise(tiny, knob, value):
    """Each knob taken at its default only raises at another value.  Every
    knob is ported now (``_LATER`` is empty): ``mesh`` takes a ("tp",)
    DeviceMesh (tests/test_torch_serve_tp.py), and anything else raises
    the reference's ValueError."""
    assert ts._LATER_SUBMIT == {} and ts._LATER == {}
    _, _, cfg, params_t = tiny
    kw = dict(ENGINE, device="cpu")
    kw[knob] = value
    if knob == "mesh":
        with pytest.raises(ValueError, match=r"exactly the \('tp',\) axis"):
            ts.ContinuousBatcher(params_t, cfg, **kw)
        return
    item = LATER_KNOBS[knob][2]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        ts.ContinuousBatcher(params_t, cfg, **kw)


@pytest.mark.parametrize("knob", [*DEFAULT_KNOBS, *(
    f"submit:{k}" for k in DEFAULT_SUBMIT)])
def test_reference_defaults_are_accepted(tiny, knob):
    """Each of these knobs at the reference's default: the engine builds,
    takes the request and serves the solo greedy tokens."""
    _, _, cfg, params_t = tiny
    kw = dict(ENGINE, device="cpu")
    sub = {}
    if knob.startswith("submit:"):
        name = knob.split(":")[1]
        sub[name] = DEFAULT_SUBMIT[name]
    else:
        kw[knob] = DEFAULT_KNOBS[knob]
    eng = ts.ContinuousBatcher(params_t, cfg, **kw)
    p = [5, 1, 4, 1, 5, 9]
    eng.submit(p, 5, **sub)
    (done,) = eng.drain()
    assert done.tokens == td.greedy_generate(params_t, [p], 5, cfg,
                                             device="cpu")[0].tolist()


@pytest.mark.parametrize("kw,match", [
    (dict(paged=False, spec_gamma=2), "requires paged=True"),
    (dict(spec_gamma=2, draft_layers=3), "draft_layers 3 not in"),
    (dict(spec_gamma=2, draft_layers=0), "draft_layers 0 not in"),
    (dict(spec_gamma=8), "page_size"),
    (dict(spec_gamma=2, evict_policy="window"), "evict_policy rides"),
], ids=["dense", "draft_too_deep", "draft_empty", "gamma_past_page",
        "eviction"])
def test_spec_knob_validation(tiny, kw, match):
    """The speculative knobs' ``ValueError``s, with the reference's
    messages: speculation on the dense engine, a draft deeper than the
    model (L + 1 = 3) or empty, γ + 1 past a page of 8, and eviction."""
    cfg_j, params_j, cfg, params_t = tiny
    with pytest.raises(ValueError, match=match) as want:
        JaxBatcher(params_j, cfg_j, **{**ENGINE, **kw})
    with pytest.raises(ValueError, match=match) as got:
        ts.ContinuousBatcher(params_t, cfg, device="cpu", **{**ENGINE, **kw})
    assert str(got.value) == str(want.value)


def test_max_wave_caps_waves_as_the_reference(tiny):
    """``max_wave=2``: six same-bucket requests on five slots prefill in
    waves of at most 2 (the default cap of 8 takes four at once), the
    reference's wave sizes, with its tokens."""
    cfg_j, params_j, cfg, params_t = tiny
    kw = dict(ENGINE, n_slots=5, max_wave=2)
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                               debug_invariants=True, **kw)
    ref = JaxBatcher(params_j, cfg_j, **kw)
    prompts = [(p, n) for p, n in _prompts(cfg.vocab_size)
               if len(p) <= 8][:3] * 2
    got, want = ({e.submit(p, n): None for p, n in prompts} and
                 {r.rid: r.tokens for r in e.drain()} for e in (eng, ref))
    assert got == want
    assert list(eng.wave_sizes) == list(ref.wave_sizes) == [2, 2, 1, 1]
    wide = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                **dict(kw, max_wave=8))
    for p, n in prompts:
        wide.submit(p, n)
    wide.drain()
    assert list(wide.wave_sizes) == [4, 1, 1]


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_chunk=12), "prefill_chunk 12 must be a multiple"),
    (dict(paged=False, prefix_cache=True), "require paged=True"),
    (dict(paged=False, chunked_prefill=True), "require paged=True"),
])
def test_fast_path_knob_errors_match_reference(tiny, kw, match):
    cfg_j, params_j, cfg, params_t = tiny
    with pytest.raises(ValueError, match=match):
        JaxBatcher(params_j, cfg_j, **{**ENGINE, **kw})
    with pytest.raises(ValueError, match=match):
        ts.ContinuousBatcher(params_t, cfg, device="cpu",
                             **{**ENGINE, **kw})


def test_warmup_is_state_free(tiny):
    """warmup() runs every wave size and a decode block on scratch state:
    the pool, slot vectors, tables and counters are untouched, and the
    engine then serves the same tokens as one that was never warmed."""
    _, _, cfg, params_t = tiny
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", **ENGINE)
    eng.warmup()
    assert not eng.pool["k"].any() and not eng.pool["v"].any()
    assert not (eng.tokens.any() or eng.pos.any() or eng.first_toks.any())
    assert (eng._tick, eng.emitted_tokens, eng.slot_steps) == (0, 0, 0)
    assert not eng.wave_sizes and not eng.slot_req
    eng.check_page_invariants()
    prompts = _prompts(cfg.vocab_size)
    _, got = _serve(eng, prompts)
    _, cold = _serve(ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                          **ENGINE), prompts)
    assert got == cold


def test_submit_validation(tiny):
    _, _, cfg, params_t = tiny
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="sampling-enabled"):
        eng.submit([1, 2], 3, temperature=0.5)
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(list(range(17)), 3)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit([1, 2], 60)
    with pytest.raises(TypeError, match="unexpected"):
        ts.ContinuousBatcher(params_t, cfg, device="cpu", bogus=1, **ENGINE)


def test_flush_writes_current_decode_page(tiny):
    """The block buffer lands at each row's decode page and offset;
    a retired row (zeroed table) writes only trash page 0."""
    _, _, cfg, _ = tiny
    pool = {n: torch.zeros(2, 6, 2, 8, 16) for n in ("k", "v")}
    rng = np.random.default_rng(0)
    buf = {n: torch.from_numpy(rng.standard_normal((2, 2, 2, 4, 16),
                                                   np.float32))
           for n in ("k", "v")}
    pt = torch.tensor([[3, 5, 0], [0, 0, 0]], dtype=torch.int32)
    tpad = torch.tensor([8, 0], dtype=torch.int32)
    d0 = torch.tensor([4, 0], dtype=torch.int32)
    ts._flush_buffer_paged(pool, buf, pt, tpad, d0, 8)
    for n in ("k", "v"):
        assert torch.equal(pool[n][:, 5, :, 4:8], buf[n][:, 0])
        assert torch.equal(pool[n][:, 0, :, 0:4], buf[n][:, 1])
        assert not pool[n][:, [1, 2, 3, 4]].any()
