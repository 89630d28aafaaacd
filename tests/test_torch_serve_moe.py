"""The MoE family on the port's serving engines against the JAX package's,
on the same converted f32 ``moe_init`` parameters (``tests/test_serve.py``'s
``TestMoEOnEngine`` config, ``capacity_factor=4.0``): staggered requests on
the dense and the paged engine, with f32 and int8 pages and fused ticks,
tokens EQUAL to the JAX engine's and to the port's solo
``moe_greedy_generate``; one tight-capacity paged engine on packed int4
pages with the prefix cache and chunked prefill whose tokens equal the
JAX engine's
(the same routing groups: a wave's whole padded row, a chunk, one token a
slot a step); the refusals; and ``DataParallelServePool(dp=2)`` against the
JAX pool.  Each JAX engine config runs once a module (its compiles dominate
this file)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import moe as jm
from kubegpu_tpu.models import serve as js
from kubegpu_tpu_torch.convert import convert_moe_params
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import moe as tm
from kubegpu_tpu_torch.models import serve as ts

ENGINE = dict(n_slots=2, stride=4, prompt_buckets=(8, 16))
PAGED = dict(ENGINE, paged=True, page_size=8)
ENGINES = {
    "dense": ENGINE,
    "paged": PAGED,
    "fused4": dict(PAGED, fused_ticks=4),
    "kv8_fused4": dict(PAGED, kv_bits=8, fused_ticks=4),
}
# the JAX engine each port engine is held to: fused ticks give the K = 1
# tokens (the reference's contract), so bf16 fused K = 4 is held to the
# JAX K = 1 engine and the JAX fused block runs on int8 pages
REFERENCE = {"fused4": "paged"}
# a tight capacity (prefill rows drop) on the fast path over packed int4
# pages: a leader (up front), then a short prompt, a follower sharing the
# leader's first two pages and a prompt past the chunk
TIGHT = dict(n_slots=2, stride=4, prompt_buckets=(8, 16, 32), paged=True,
             page_size=8, prefix_cache=True, chunked_prefill=True,
             prefill_chunk=8, kv_bits=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the tier-1 run puts six test
    processes on the host's cores, and torch's default of a thread a core
    oversubscribes them (six concurrent copies of
    ``tests/test_torch_serve_moe.py`` took 488 s at the default, 50 s at
    one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab):
    """The reference test's three requests (two up front, one after a
    step)."""
    return [([(i * 3 + 1) % vocab for i in range(4)], 8),
            ([(i * 5 + 2) % vocab for i in range(11)], 6),
            ([(i * 7 + 3) % vocab for i in range(6)], 9)]


def _tight_prompts(vocab):
    rng = np.random.default_rng(11)
    lead = rng.integers(0, vocab, 20).tolist()
    return [(lead, 6), (rng.integers(0, vocab, 5).tolist(), 7),
            (lead[:16] + rng.integers(0, vocab, 6).tolist(), 5),
            (rng.integers(0, vocab, 27).tolist(), 4)]


def drive(eng, prompts, up_front=2) -> dict:
    """Submit ``up_front`` prompts, step once, submit the rest, drain:
    the finished tokens by rid."""
    for p, n in prompts[:up_front]:
        eng.submit(p, n)
    done = list(eng.step())
    for p, n in prompts[up_front:]:
        eng.submit(p, n)
    done += eng.drain()
    out = {r.rid: list(r.tokens) for r in done}
    assert len(out) == len(done) == len(prompts)
    return out


@pytest.fixture(scope="module")
def moe():
    cfg_j = jm.MoEConfig.tiny(max_seq_len=64, capacity_factor=4.0)
    params_j = jax.jit(jm.moe_init, static_argnums=1)(jax.random.PRNGKey(1),
                                                      cfg_j)
    params_t = convert_moe_params(jax.tree.map(np.asarray, params_j),
                                  device="cpu")
    return (cfg_j, params_j,
            tm.MoEConfig.tiny(max_seq_len=64, capacity_factor=4.0), params_t)


@pytest.fixture(scope="module")
def reference(moe):
    """The JAX engine's tokens by engine name, each config run once."""
    cfg_j, params_j, cfg, _ = moe

    @functools.lru_cache(maxsize=None)
    def run(name: str, capacity_factor: float = 4.0) -> dict:
        c = dataclasses.replace(cfg_j, capacity_factor=capacity_factor)
        if name == "tight":
            return drive(js.ContinuousBatcher(params_j, c, **TIGHT),
                         _tight_prompts(cfg.base.vocab_size), up_front=1)
        return drive(js.ContinuousBatcher(params_j, c, **ENGINES[name]),
                     _prompts(cfg.base.vocab_size))
    return run


@pytest.fixture(scope="module")
def solo(moe):
    """The port's solo ``moe_greedy_generate`` of each staggered prompt
    (``tests/test_torch_moe.py`` holds it to the reference's)."""
    _, _, cfg, params_t = moe
    return [tm.moe_greedy_generate(params_t, [p], n, cfg,
                                   device="cpu")[0].tolist()
            for p, n in _prompts(cfg.base.vocab_size)]


@pytest.mark.parametrize("name", list(ENGINES))
def test_staggered_moe_equals_reference_and_solo(moe, reference, solo,
                                                 name):
    _, _, cfg, params_t = moe
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", **ENGINES[name])
    assert eng.cfg == cfg.base          # the engine runs the backbone
    got = drive(eng, _prompts(cfg.base.vocab_size))
    assert got == reference(REFERENCE.get(name, name))
    assert [got[r] for r in range(3)] == solo
    if "fused4" in name:
        assert eng.fused_dispatches > 0
    if eng.paged:
        eng.check_page_invariants()
        assert len(eng._free_pages) == eng.total_pages


def test_warmed_graph_runner_equals_reference(moe, reference, monkeypatch):
    """The paged engine after ``warmup()`` with its tick and chunk bodies
    run through the graph runner (a stand-in ``kernels.Graph`` whose
    replay calls the body): the captured functions carry the ffn."""
    _, _, cfg, params_t = moe

    class Replayed:
        capture_s = instantiate_s = 0.0
        pool_bytes = 0

        def __init__(self, fn):
            self.fn, self.tally = fn, {}

        def capture(self):
            pass

        def replay(self):
            self.fn()

    monkeypatch.setattr(ts.kernels, "Graph", Replayed)
    monkeypatch.setattr(ts.ContinuousBatcher, "_use_graph",
                        lambda self: True)
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", **PAGED)
    eng.warmup()
    assert "plain" in eng._graphs
    assert drive(eng, _prompts(cfg.base.vocab_size)) == reference("paged")


def test_tight_capacity_fast_path_equals_reference(moe, reference):
    """capacity_factor=1.0 on int4 pages with the prefix cache and chunked
    prefill: prefill rows drop tokens (shown below on the first prompt's
    wave), so tokens are the reference's only where the routing groups
    are the reference's: the padded wave row, the chunk and one token a
    slot a step."""
    _, _, cfg, params_t = moe
    tight = dataclasses.replace(cfg, capacity_factor=1.0)
    eng = ts.ContinuousBatcher(params_t, tight, device="cpu", **TIGHT)
    got = drive(eng, _tight_prompts(cfg.base.vocab_size), up_front=1)
    assert got == reference("tight", 1.0)
    assert eng.prefix_hits >= 1 and eng.chunks_run >= 1
    eng.check_page_invariants()
    # the first prompt's wave row drops tokens at this capacity
    x = tl.embed_lookup(params_t["embed"], torch.tensor(
        [_tight_prompts(cfg.base.vocab_size)[0][0][:16]]))
    lp = {n: v[0] for n, v in params_t["layers"].items()}
    h = tl._rmsnorm(x, lp["mlp_norm"], cfg.base.norm_eps)
    dispatch, _, _ = tm.route_tokens(h @ lp["w_router"], tight.top_k,
                                     tight.capacity(16))
    assert float(dispatch.sum()) < 16 * tight.top_k


def test_refusals(moe):
    cfg_j, params_j, cfg, params_t = moe
    with pytest.raises(ValueError, match="Llama"):
        js.ContinuousBatcher(params_j, cfg_j, spec_gamma=2, **PAGED)
    with pytest.raises(ValueError, match="Llama"):
        ts.ContinuousBatcher(params_t, cfg, spec_gamma=2, device="cpu",
                             **PAGED)
    # the reference's refusal: MoE scales out on dp replicas, not tp
    with pytest.raises(ValueError, match="MoE scales out on dp replicas"):
        ts.ContinuousBatcher(params_t, cfg, mesh=object(), device="cpu",
                             **PAGED)
    with pytest.raises(TypeError, match="unsupported engine config"):
        ts.ContinuousBatcher(params_t, object(), device="cpu", **PAGED)


class _MeshlessJaxPool(js.DataParallelServePool):
    """The JAX pool with its replicas built without a mesh.  Its own
    ``_build_engine`` hands every replica a tp = 1 serving mesh, which the
    JAX engine refuses for a MoE config (it sends MoE to dp replicas, the
    pool's own job): the subclass seam the reference documents builds the
    plain single-device engine instead, leaving routing and the rest of
    the pool as they are."""

    def _build_engine(self, i: int):
        return js.ContinuousBatcher(
            self._params, self._cfg, metrics=self._metrics,
            chaos=self._chaos.get(i), tracer=self._tracer,
            trace_ctx=self._trace_ctx, **self._engine_kw)


def test_dp_pool_equals_reference_pool(moe, solo):
    """``DataParallelServePool(dp=2)`` over the MoE config: tokens and
    routes equal the JAX pool's (:class:`_MeshlessJaxPool`), and every
    request its solo run."""
    cfg_j, params_j, cfg, params_t = moe
    prompts = _prompts(cfg.base.vocab_size)
    with pytest.raises(ValueError, match="Llama"):
        js.DataParallelServePool(params_j, cfg_j, dp=1, tp=1,
                                 devices=[jax.devices()[0]], **PAGED)
    port = ts.DataParallelServePool(params_t, cfg, dp=2,
                                    devices=["cpu"] * 2, **PAGED)
    ref = _MeshlessJaxPool(params_j, cfg_j, dp=2, tp=1,
                           devices=[jax.devices()[0]] * 2, **PAGED)
    runs = []
    for pool in (port, ref):
        for p, n in prompts:
            pool.submit(p, n)
        runs.append(({r.rid: list(r.tokens) for r in pool.drain()},
                     [tuple(x) for x in pool.route_log]))
    assert runs[0] == runs[1]
    assert [runs[0][0][r] for r in range(3)] == solo
    assert {rep for _, rep, _ in runs[0][1]} == {0, 1}
    assert all(eng.cfg == cfg.base for eng in port.replicas)


def test_disagg_pool_serves_moe(moe, solo):
    """``DisaggServePool`` over the MoE config (the JAX pool refuses it, as
    above): a prefill replica hands each request's page chain to the
    decode replica, and every request equals its solo run."""
    _, _, cfg, params_t = moe
    pool = ts.DisaggServePool(params_t, cfg, prefill=1, decode=1,
                              devices=["cpu"] * 2, **PAGED)
    rids = [pool.submit(p, n) for p, n in _prompts(cfg.base.vocab_size)]
    done = {r.rid: list(r.tokens) for r in pool.drain()}
    assert [done[r] for r in rids] == solo
    assert pool.migrations == len(rids)
    assert all(eng.cfg == cfg.base for eng in pool.replicas)


@pytest.mark.parametrize("knob", ["collect_overlap", "sampling", "evict"])
def test_engine_knobs_serve_moe(moe, reference, solo, knob):
    """The engine's other knobs over the MoE config: overlapped collects
    give the JAX engine's tokens; a sampling engine's greedy request gives
    its solo tokens and its sampled ones repeat under the same seed;
    window eviction drops prompt pages and leaks none."""
    _, _, cfg, params_t = moe
    prompts = _prompts(cfg.base.vocab_size)
    if knob == "collect_overlap":
        eng = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                   collect_overlap=True, **PAGED)
        assert drive(eng, prompts) == reference("paged")
        assert eng.overlap_ms
    elif knob == "sampling":
        runs = []
        for _ in range(2):
            eng = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                       sampling=True, top_k=8, seed=3,
                                       **PAGED)
            rids = [eng.submit(p, n, temperature=t)
                    for (p, n), t in zip(prompts, (0.0, 0.9, 0.9))]
            done = {r.rid: list(r.tokens) for r in eng.drain()}
            runs.append([done[r] for r in rids])
        assert runs[0] == runs[1]
        assert runs[0][0] == solo[0]
    else:
        # prompts of 3-4 pages: a window of one page leaves pages to drop
        rng = np.random.default_rng(5)
        prompts = [(rng.integers(0, cfg.base.vocab_size, t).tolist(), 6)
                   for t in (30, 27, 25)]
        eng = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                   evict_policy="window", evict_param=8,
                                   **dict(PAGED, prompt_buckets=(8, 16, 32)))
        got = drive(eng, prompts)
        assert [len(got[r]) for r in range(3)] == [n for _, n in prompts]
        assert eng.pages_evicted >= 1
        eng.check_page_invariants()
        assert len(eng._free_pages) == eng.total_pages
