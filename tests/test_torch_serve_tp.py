"""The port's tensor-parallel paged engine (``ContinuousBatcher(paged=True,
mesh=make_serve_mesh(tp))``) against the JAX package's mesh engine and the
port's own tp = 1 engine, on the CPU.

The port's ranks are spawned processes joined over gloo
(:func:`kubegpu_tpu_torch.parallel.launch`, a ``file://`` rendezvous, one
torch thread a rank); their bodies live in ``tests/tp_ranks.py``, which
imports no JAX.  The JAX engines run under ``make_serve_mesh(2 | 4)`` on the
8 virtual CPU devices of ``tests/conftest.py``, their Pallas kernels in
interpret mode.  Parameters are the JAX package's ``llama_init`` at the
reference's ``tiny4`` config (f32), converted.  Tokens must be EQUAL; the
tp-aware bodies' logits (one decode step, the verify, a prompt chunk, a
prefill) agree with the tp = 1 bodies' within 1e-5 (a row-split product's
partials are summed in another order than one GEMM's); after every drain
each rank's host digest (page tables, free list, counters) is the same,
and equal to the tp = 1 engine's.  Page-chain migration between two
engines of one tp = 2 group exports the full-head chain (all-gathered over
the ranks) within 1e-5 of the JAX mesh engine's and the tp = 1 engine's,
and the importer's tokens equal theirs.  Two launches (tp = 2 and tp = 4)
run every case and the JAX side runs once per case, both memoized for the
module; ``llama_serve.py`` with ``SERVE_TP=2`` spawns its own ranks."""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

import tp_ranks
from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models import serve as js
from kubegpu_tpu.models.quant import quantize_llama as jquantize
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts
from kubegpu_tpu_torch.models.quant import QTensor
from kubegpu_tpu_torch.parallel import launch, pool_specs, serve_param_specs
from kubegpu_tpu_torch.parallel.sharding import shard_tree
from kubegpu_tpu_torch.workloads.programs import llama_serve as tls

CFG_KW = dict(n_heads=4, n_kv_heads=4, max_seq_len=64)
ENGINE = dict(n_slots=3, stride=4, prompt_buckets=(8, 16), paged=True,
              page_size=8)
FAST = dict(ENGINE, prefix_cache=True, chunked_prefill=True, prefill_chunk=8)
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the tier-1 run puts six test
    processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny4():
    cfg_j = jl.LlamaConfig.tiny(**CFG_KW)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, params_j, jax.tree.map(np.asarray, params_j)


def _submit(p, n, **kw):
    return ("submit", p, n, kw)


def fast_traffic(vocab: int) -> list:
    """The reference's tp traffic: a leader that chunk-prefills and
    registers its prefix, three followers sharing its 8-token prefix, and a
    15-token prompt that prefills as chunks."""
    shared = [(i * 5 + 3) % vocab for i in range(8)]
    prompts = [(shared + [(41 + 9 * j + i) % vocab for i in range(5)], 6)
               for j in range(3)]
    prompts += [([(i * 13 + 4) % vocab for i in range(15)], 5)]
    return ([_submit(*prompts[0]), ("step", 3)]
            + [_submit(p, n) for p, n in prompts[1:]] + [("drain",)])


def plain_traffic(vocab: int) -> list:
    """The reference's plain paged traffic: waves, adoption and decode
    blocks alone, a request arriving after the first step."""
    prompts = [([(i * 3 + 1) % vocab for i in range(4)], 9),
               ([(i * 5 + 2) % vocab for i in range(11)], 7),
               ([(i * 7 + 5) % vocab for i in range(6)], 12)]
    return ([_submit(*p) for p in prompts[:2]] + [("step", 1)]
            + [_submit(*prompts[2]), ("drain",)])


def sampled_traffic(vocab: int) -> list:
    p_g = [(i * 7 + 1) % vocab for i in range(5)]
    p_s = [(i * 3 + 2) % vocab for i in range(5)]
    return [_submit(p_g, 8), _submit(p_s, 8, temperature=1.0), ("drain",)]


def deadline_traffic(vocab: int) -> list:
    """A wall-clock deadline that cannot pass, one that passes at once
    (pruned from the queue), a tick deadline, and plain requests."""
    p = [[(i * k + 1) % vocab for i in range(5 + k)] for k in range(4)]
    return [_submit(p[0], 6, deadline_s=600.0), _submit(p[1], 6,
                                                        deadline_s=0.0),
            _submit(p[2], 20, deadline_ticks=2), ("step", 1),
            _submit(p[3], 5, deadline_s=600.0), ("drain",)]


# name -> (engine kwargs, int8 weights, traffic); each runs on the JAX mesh
# engine at tp = 2 (FAST also at 4), the port's tp = 1 engine, and the
# port's ranks
CASES = {
    "fast": (FAST, False, fast_traffic),
    "plain": (ENGINE, False, plain_traffic),
    "int8": (dict(ENGINE, kv_bits=8), True, plain_traffic),
    "int4": (dict(ENGINE, kv_bits=4), False, plain_traffic),
    "sampled": (dict(ENGINE, n_slots=2, sampling=True, top_k=8, seed=0),
                False, sampled_traffic),
    "spec_fused": (dict(FAST, spec_gamma=3, draft_layers=1, fused_ticks=4),
                   False, fast_traffic),
}
# port-only cases: the deadline traffic (host decisions on a clock) and
# the refusals
PORT_CASES = {
    "deadline": (ENGINE, False, deadline_traffic),
}
REFUSALS = {
    "dense": {"engine": dict(ENGINE, paged=False)},
    "divide": {"engine": dict(ENGINE), "cfg": dict(n_heads=6, n_kv_heads=3)},
    "moe": {"engine": dict(ENGINE), "moe": True},
    "evict": {"engine": dict(ENGINE, evict_policy="window")},
    "axes": {"engine": dict(ENGINE), "mesh_names": ("dp",)},
}
# page-chain migration between two engines of one group, a pool format
# each: a 13-token prompt (two pages, prefix keys for the first) exported
# after its one-token prefill leg and imported to make 6 tokens
MIGRATIONS = {
    "migrate": dict(ENGINE, prefix_cache=True),
    "migrate_int8": dict(ENGINE, prefix_cache=True, kv_bits=8),
    "migrate_int4": dict(ENGINE, prefix_cache=True, kv_bits=4),
}
MIGRATE_N = 6


def migrate_prompt(vocab: int) -> list:
    return [(i * 11 + 7) % vocab for i in range(13)]


def _case(name: str, vocab: int) -> dict:
    if name in MIGRATIONS:
        return {"name": name, "engine": MIGRATIONS[name],
                "prompt": migrate_prompt(vocab), "n": MIGRATE_N}
    eng, quant, traffic = {**CASES, **PORT_CASES}[name]
    return {"name": name, "engine": eng, "quant_weights": quant,
            "events": traffic(vocab)}


def _rank_cases(vocab: int, tp: int) -> list:
    names = list(CASES) + list(PORT_CASES) if tp == 2 else ["fast"]
    cases = [_case(n, vocab) for n in names]
    if tp == 2:
        # sampling is deterministic per seed: the same seed again
        cases.append(dict(_case("sampled", vocab), name="sampled_again"))
        cases += [{"name": n, "events": [], **c} for n, c in REFUSALS.items()]
        cases += [_case(n, vocab) for n in MIGRATIONS]
    return cases


@functools.lru_cache(maxsize=None)
def _launched(tp: int):
    """Every case on ``tp`` port ranks, and the tp-aware bodies' logits
    on the ranks' shards: one launch a tp, memoized for the module."""
    cfg_j = jl.LlamaConfig.tiny(**CFG_KW)
    params_np = jax.tree.map(np.asarray,
                             jl.llama_init(jax.random.PRNGKey(0), cfg_j))
    cases = _rank_cases(cfg_j.vocab_size, tp)
    out = launch(tp_ranks.serve_cases, tp, params_np, CFG_KW, cases, 0,
                 device="cpu", timeout_s=900)
    return {c["name"]: r for c, r in zip(cases, out["cases"])}, \
        out["pieces"]


@pytest.fixture(scope="module")
def ranks2():
    return _launched(2)


@pytest.fixture(scope="module")
def ranks4():
    return _launched(4)


@functools.lru_cache(maxsize=None)
def _jax_tokens(name: str, tp: int) -> dict:
    """The JAX mesh engine's {rid: (tokens, error)} on case ``name``."""
    cfg_j = jl.LlamaConfig.tiny(**CFG_KW)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    eng_kw, quant, traffic = CASES[name]
    if quant:
        params_j = jquantize(params_j)
    eng = js.ContinuousBatcher(params_j, cfg_j, mesh=js.make_serve_mesh(tp),
                               **eng_kw)
    return tp_ranks.run_traffic(eng, traffic(cfg_j.vocab_size))


@functools.lru_cache(maxsize=None)
def _port_tp1(name: str) -> dict:
    cfg_j = jl.LlamaConfig.tiny(**CFG_KW)
    params_np = jax.tree.map(np.asarray,
                             jl.llama_init(jax.random.PRNGKey(0), cfg_j))
    case = _case(name, cfg_j.vocab_size)
    params = tp_ranks.engine_params(params_np, case.get("quant_weights",
                                                        False))
    return tp_ranks.serve_case(params, tl.LlamaConfig.tiny(**CFG_KW), case)


@functools.lru_cache(maxsize=None)
def _jax_migration(name: str) -> dict:
    """The JAX mesh engines' migration case ``name`` at tp = 2: the
    export and the importer's tokens."""
    cfg_j = jl.LlamaConfig.tiny(**CFG_KW)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    mesh = js.make_serve_mesh(2)
    src = js.ContinuousBatcher(params_j, cfg_j, mesh=mesh,
                               **MIGRATIONS[name])
    rid = src.submit(migrate_prompt(cfg_j.vocab_size), 1, migrate_out=True)
    first = [r.tokens for r in src.drain()]
    exp = src.take_export(rid)
    dst = js.ContinuousBatcher(params_j, cfg_j, mesh=mesh,
                               **MIGRATIONS[name])
    dst.import_chain(exp, MIGRATE_N)
    return {"export": exp, "first": first,
            "tokens": {r.rid: r.tokens for r in dst.drain()}}


# -- the shard cutter ---------------------------------------------------------

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("quant", [False, True])
def test_param_specs_are_the_reference(quant):
    """``serve_param_specs`` is the reference's ``_serve_param_specs``,
    leaf for leaf (a PartitionSpec as a tuple; QTensor pairs as pairs)."""
    ref = js._serve_param_specs(quant)
    ours = serve_param_specs(quant)
    got = dict(_leaves(ours))
    for name, spec in _leaves(ref):
        mine = got.pop(name)
        if quant and hasattr(spec, "values"):
            assert isinstance(mine, QTensor), name
            assert (mine.values, mine.scale) == (tuple(spec.values),
                                                 tuple(spec.scale)), name
        else:
            assert mine == tuple(spec), name
    assert not got


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", [False, True])
def test_shards_concatenate_back(tiny4, tp, quant):
    """Rank shards concatenated along the spec's dim give back each leaf;
    an int8 leaf's scale is cut with its values on a column split and
    stays whole on a row split."""
    params = tp_ranks.engine_params(tiny4[2], quant)
    specs = serve_param_specs(quant)
    shards = [shard_tree(params, specs, r, tp) for r in range(tp)]
    leaves = dict(_leaves(params))
    for name, spec in _leaves(specs):
        full = leaves[name]
        parts = [dict(_leaves(s))[name] for s in shards]
        pairs = ([(full.values, [p.values for p in parts], spec.values),
                  (full.scale, [p.scale for p in parts], spec.scale)]
                 if isinstance(full, QTensor) else
                 [(full, parts, spec)])
        for whole, cut, sp in pairs:
            if "tp" in sp:
                dim = sp.index("tp")
                assert all(c.shape[dim] * tp == whole.shape[dim] for c in cut)
                assert torch.equal(torch.cat(cut, dim), whole), name
            else:
                assert all(c is whole for c in cut), name
        if isinstance(full, QTensor):
            col = name.split(".")[-1] in ("wq", "wk", "wv", "w_gate",
                                          "w_up", "lm_head")
            assert ("tp" in spec.scale) == col, name
            assert parts[0].scale.shape[-1] * (tp if col else 1) == \
                full.scale.shape[-1], name


def test_pool_specs_cut_kv_heads(tiny4):
    """The pool's spec cuts the KV-head dim 2 of values and scales, for
    every format."""
    rng = np.random.default_rng(0)
    pool = {"k": torch.from_numpy(rng.integers(0, 255, (2, 5, 4, 8, 8),
                                               dtype=np.uint8)),
            "k_scale": torch.from_numpy(rng.random((2, 5, 4, 2),
                                                   np.float32))}
    specs = pool_specs(pool)
    assert specs == {"k": (None, None, "tp", None, None),
                     "k_scale": (None, None, "tp", None)}
    for name, x in pool.items():
        cut = [shard_tree(pool, specs, r, 2)[name] for r in range(2)]
        assert torch.equal(torch.cat(cut, 2), x)


# -- the bodies ---------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_bodies_match_tp1_logits(tiny4, ranks2, ranks4, tp, weights):
    """One decode step (kernel 4's plain version on the local heads), the
    verify over folded queries, a prompt chunk and a prefill on each
    rank's weight and pool shards, with the local config: the all-gathered
    logits equal the tp = 1 bodies' within 1e-5, and the pool shards the
    ranks wrote concatenate to the pool the tp = 1 bodies wrote."""
    got = (ranks2 if tp == 2 else ranks4)[1][weights]
    cfg = tl.LlamaConfig.tiny(**CFG_KW)
    ref = tp_ranks.pieces(tp_ranks.engine_params(tiny4[2], weights == "int8"),
                          cfg, tp_ranks.piece_inputs(cfg, 0))
    for name in ("step", "verify", "chunk", "prefill"):
        assert got[name].shape == ref[name].shape, name
        np.testing.assert_allclose(got[name], ref[name], rtol=0,
                                   atol=LOGIT_TOL, err_msg=name)
    for name, x in ref["pool"].items():
        np.testing.assert_allclose(
            np.concatenate([p[name] for p in got["pools"]], axis=2), x,
            rtol=0, atol=LOGIT_TOL, err_msg=name)


# -- the engine ---------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_fast_path_tokens_equal_jax_mesh_engine(ranks2, ranks4, tp):
    """The reference's traffic with the prefix cache and chunked prefill
    on: the port's tokens at tp equal the JAX mesh engine's at tp and the
    port's tp = 1 engine's, and both fast paths engaged."""
    got = (ranks2 if tp == 2 else ranks4)[0]["fast"]
    assert "error" not in got, got.get("error")
    ref = _port_tp1("fast")
    assert got["tokens"] == ref["tokens"] == _jax_tokens("fast", tp)
    assert got["counters"] == ref["counters"]
    assert got["counters"]["prefix_hits"] >= 1
    assert got["counters"]["chunks_run"] >= 1


@pytest.mark.parametrize("name", ["plain", "int8", "int4", "sampled",
                                  "spec_fused"])
def test_tp2_tokens_equal_jax_mesh_engine(ranks2, name):
    """Waves and decode blocks alone; int8 pages with int8 weights (kernel
    5's plain version on the local heads; column scales cut with their
    values); packed int4 pages (kernel 6's); sampling; the speculative
    tick fused 4 at a time with both fast paths: every token equal to the
    JAX mesh engine's at tp = 2 and the port's tp = 1 engine's."""
    got = ranks2[0][name]
    assert "error" not in got, got.get("error")
    ref = _port_tp1(name)
    assert got["tokens"] == ref["tokens"] == _jax_tokens(name, 2)
    assert got["counters"] == ref["counters"]
    assert all(len(t) > 0 and err is None for t, err in
               got["tokens"].values())
    if name == "spec_fused":
        assert got["counters"]["spec_ticks"] > 0
        assert got["counters"]["fused_dispatches"] > 0
    if name == "sampled":
        again = ranks2[0]["sampled_again"]["tokens"]
        assert again == got["tokens"]


@pytest.mark.parametrize("name", [*CASES, *PORT_CASES])
def test_ranks_hold_one_host_state(ranks2, name):
    """After the drain every rank's host digest (page tables, lengths,
    the free list, refcounts, the prefix registry, the queue, counters)
    is the same and equal to the tp = 1 engine's; every page is back
    (free, or registered in the prefix cache at refcount 0)."""
    got = ranks2[0][name]
    ref = _port_tp1(name)
    assert len(set(got["digests"])) == 1
    assert got["digests"][0] == got["digest"] == ref["digest"]
    assert got["available_pages"] == got["total_pages"]


def test_wall_clock_deadlines_agree(ranks2):
    """A ``deadline_s`` read on rank 0's clock: the request whose deadline
    passes at once is pruned from the queue on every rank, the tick
    deadline cancels its request, the others finish as on one engine."""
    got = ranks2[0]["deadline"]
    ref = _port_tp1("deadline")
    assert got["tokens"] == ref["tokens"]
    errors = [err for _, err in got["tokens"].values()]
    assert errors.count("deadline exceeded") == 2
    assert got["counters"]["deadline_misses"] == 2


def _jax_refusal(name: str) -> str:
    """The JAX engine's message for a refusal case."""
    cfg = jl.LlamaConfig.tiny(**CFG_KW)
    params = jl.llama_init(jax.random.PRNGKey(0), cfg)
    kw = dict(REFUSALS[name]["engine"], mesh=js.make_serve_mesh(2))
    if name == "divide":
        cfg = jl.LlamaConfig.tiny(**{**CFG_KW, **REFUSALS[name]["cfg"]})
        params = jl.llama_init(jax.random.PRNGKey(1), cfg)
    elif name == "moe":
        from kubegpu_tpu.models.moe import MoEConfig, moe_init
        cfg = MoEConfig.tiny(max_seq_len=64)
        params = moe_init(jax.random.PRNGKey(2), cfg)
    elif name == "axes":
        from jax.sharding import Mesh
        kw["mesh"] = Mesh(np.array(jax.devices()[:2]), ("dp",))
    with pytest.raises(ValueError) as exc:
        js.ContinuousBatcher(params, cfg, **kw)
    return f"ValueError: {exc.value}"


@pytest.mark.parametrize("name", ["dense", "divide", "moe", "evict", "axes"])
def test_refusals_are_the_reference(ranks2, name):
    """The reference's validation errors under a mesh, message for
    message: the dense engine, a tp that does not divide the KV heads, the
    MoE family, ``evict_policy``, a mesh without the ("tp",) axis."""
    assert ranks2[0][name]["error"] == _jax_refusal(name)


@pytest.mark.parametrize("name", list(MIGRATIONS))
def test_migration_under_a_mesh_equals_jax(ranks2, name):
    """Two engines of one tp = 2 group: the exporter's ranks all-gather
    their KV heads of the chain, so the export holds every head (int8 and
    int4 scales with their values) within 1e-5 of the JAX mesh engine's
    export and of the tp = 1 engine's, with the same length, pages, first
    token and prefix keys, and a digest over the full chain; the
    importer's ranks each scatter their heads, and its tokens, counters
    and host digest equal the tp = 1 importer's, the tokens the JAX
    importer's too, on every rank."""
    got = ranks2[0][name]
    ref = _port_tp1(name)
    want = _jax_migration(name)
    exp, jexp = got["export"], want["export"]
    assert set(exp["chain"]) == set(jexp["chain"]) == set(
        ref["export"]["chain"])
    for leaf, x in exp["chain"].items():
        for other in (np.asarray(jexp["chain"][leaf]),
                      ref["export"]["chain"][leaf]):
            assert x.shape == other.shape, leaf
            np.testing.assert_allclose(x.astype(np.float64),
                                       other.astype(np.float64), rtol=0,
                                       atol=LOGIT_TOL, err_msg=leaf)
    assert exp["chain"]["k"].shape[2] == CFG_KW["n_kv_heads"]
    for k in ("t", "tpad", "pages", "first_token"):
        assert exp[k] == jexp[k] == ref["export"][k], k
    assert exp["keys"] == len(jexp["prefix_keys"]) == ref["export"]["keys"]
    assert exp["digest"] == ts._chain_digest(
        {k: torch.from_numpy(v) for k, v in exp["chain"].items()}, exp["t"])
    assert got["first"] == ref["first"] == want["first"]
    assert list(got["tokens"].values()) == list(ref["tokens"].values()) \
        == list(want["tokens"].values())
    assert got["counters"] == ref["counters"]
    assert got["counters"]["chains_imported"] == 1
    assert got["exported"] == ref["exported"] == (1, exp["pages"])
    assert len(set(got["digests"])) == 1
    assert got["digest"] == ref["digest"]


class _DuckMesh:
    """A ("tp",) mesh of 2 as the engine reads one, over no group."""
    mesh_dim_names = ("tp",)

    def __init__(self, device_type: str):
        self.device_type = device_type

    def size(self):
        return 2

    def get_group(self, name):
        return "group"

    def get_local_rank(self, name):
        return 1


def test_engine_shards_at_construction(monkeypatch):
    """Rank 1 of 2 holds half the KV heads in its pool, its q-head columns
    of wq, its rows of wo, its vocabulary half of lm_head, and runs the
    local config (the head width kept); a mesh of another device type
    than the engine's raises."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    cfg = tl.LlamaConfig.tiny(**CFG_KW)
    params = tl.llama_init(cfg, device="cpu")
    eng = ts.ContinuousBatcher(params, cfg, device="cpu",
                               mesh=_DuckMesh("cpu"), **ENGINE)
    assert (eng.tp, eng.tp_rank) == (2, 1)
    assert (eng._lcfg.n_heads, eng._lcfg.n_kv_heads, eng._lcfg.d_ff,
            eng._lcfg.head_dim) == (2, 2, cfg.d_ff // 2, cfg.head_dim)
    assert eng.pool["k"].shape[2] == 2
    half = 2 * cfg.head_dim
    assert torch.equal(eng.params["layers"]["wq"],
                       params["layers"]["wq"][..., half:])
    assert torch.equal(eng.params["layers"]["wo"],
                       params["layers"]["wo"][:, half:])
    assert torch.equal(eng.params["lm_head"],
                       params["lm_head"][:, cfg.vocab_size // 2:])
    assert eng.params["embed"] is params["embed"]
    with pytest.raises(ValueError, match="mesh devices"):
        ts.ContinuousBatcher(params, cfg, device="cpu",
                             mesh=_DuckMesh("cuda"), **ENGINE)


def test_gloo_group_refuses_graphs_on_the_card(monkeypatch):
    """Gloo moves CUDA tensors through the host, which no CUDA graph can
    capture: a card engine over a gloo group needs ``graphs=False``."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    eng = ts.ContinuousBatcher.__new__(ts.ContinuousBatcher)
    eng.device, eng.graphs, eng._tp_group = (torch.device("cuda"), True,
                                             "group")
    with pytest.raises(ValueError, match="graphs=False"):
        eng._shard_for_mesh(_DuckMesh("cuda"))


# -- the pod program ----------------------------------------------------------

@pytest.fixture
def clean_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith(("SERVE_", "KUBETPU_", "TPU_", "JAX_NUM_",
                            "JAX_COORD")):
            monkeypatch.delenv(name)
    return monkeypatch


def test_llama_serve_tp2_equals_tp1(clean_env, capsys):
    """``SERVE_TP=2`` on two devices spawns two ranks of one sharded
    engine: its tokens equal ``SERVE_TP=1``'s, and it prints the same
    metric lines, the deterministic values equal, ``serve_engine_cfg_tp``
    and ``serve_engine_cfg_mesh_devices`` 2."""
    for k, v in {"SERVE_MODE": "continuous", "SERVE_BATCH": "1",
                 "SERVE_REQS": "3", "SERVE_STEPS": "16"}.items():
        clean_env.setenv(k, v)
    clean_env.setattr(tls, "_device_count", lambda device: 2)
    real = tls._serve_continuous
    runs = {}
    for tp in ("1", "2"):
        clean_env.setenv("SERVE_TP", tp)
        rec = {}
        clean_env.setattr(tls, "_serve_continuous",
                          lambda *a, **k: real(*a, record=rec, **k))
        assert tls.main(device="cpu") == 0
        lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
        assert [json.loads(ln) for ln in rec["lines"]] == lines
        runs[tp] = (rec, lines)
    (one, l1), (two, l2) = runs["1"], runs["2"]
    assert two["tokens"] == one["tokens"]
    assert all(len(t) == 16 for t in two["tokens"])
    assert [m["metric"] for m in l2] == [m["metric"] for m in l1]
    got = {m["metric"]: m["value"] for m in l2}
    want = {m["metric"]: m["value"] for m in l1}
    assert (got["serve_engine_cfg_tp"], got["serve_engine_cfg_dp"],
            got["serve_engine_cfg_mesh_devices"]) == (2, 1, 2)
    timed = ("tokens_per_s", "_ms", "hbm_")
    for name in want:
        if name in ("serve_engine_cfg_tp", "serve_engine_cfg_mesh_devices") \
                or any(t in name for t in timed):
            continue
        assert got[name] == want[name], name
    # a rank's pool holds half the KV heads (its slot vectors are whole)
    assert got["serve_hbm_pool_bytes"] < want["serve_hbm_pool_bytes"]
