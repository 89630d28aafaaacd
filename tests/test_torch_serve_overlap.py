"""The port engine's double-buffered collect (``collect_overlap=True``),
its ``donate=False`` debug mode and its admission queue's running prompt
total, against the port's own engine with the knob off, its solo
``greedy_generate`` and the JAX package's engine with the same knob (its
Pallas kernels in interpret mode), on the same converted f32 parameters.

Overlap changes when the host reads a tick, never what the tick computes:
greedy tokens must be EQUAL at γ 0 and 2, at ``fused_ticks`` 1 and 4 and
on int8 pages, with ``overlap_ms`` non-empty and as many overlapped reads
as the reference engine makes.  The ``cuda``-marked test holds the slab's
host copy on the card, where tick N+1 rewrites the live slab before the
host reads tick N.  The JAX package is imported inside the fixtures, so
that test also runs where JAX is missing."""

import importlib

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import serve as ts
from kubegpu_tpu_torch.obs.chaos import (
    ChaosEvent,
    ChaosInjector,
    ReplicaDeadError,
)

ENGINE = dict(n_slots=2, stride=4, prompt_buckets=(8, 16), paged=True,
              page_size=8)
TINY = dict(n_heads=4, n_kv_heads=4, max_seq_len=64)


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


@pytest.fixture(scope="module")
def tiny4():
    jax = importlib.import_module("jax")
    jl = importlib.import_module("kubegpu_tpu.models.llama")
    convert = importlib.import_module("kubegpu_tpu_torch.convert")
    cfg_j = jl.LlamaConfig.tiny(**TINY)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert.convert_llama_params(
        jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(**TINY), params_t


def _traffic(vocab):
    """Three requests sharing an 8-token page, then three more after one
    step: slots retire and are re-admitted between overlapped ticks."""
    shared = [(i * 5 + 3) % vocab for i in range(8)]
    first = [(shared + [(41 + 9 * j + i) % vocab for i in range(5)], 7)
             for j in range(3)]
    later = [([(i * 13 + 4 + j) % vocab for i in range(6 + 4 * j)], 6 + j)
             for j in range(3)]
    return first, later


def _run(eng, vocab):
    first, later = _traffic(vocab)
    rids = {eng.submit(p, n): (p, n) for p, n in first}
    done = {r.rid: r.tokens for r in eng.step()}
    rids.update({eng.submit(p, n): (p, n) for p, n in later})
    done.update({r.rid: r.tokens for r in eng.drain()})
    assert set(done) == set(rids)
    return rids, done


CASES = [(0, 1, 16), (0, 4, 16), (2, 1, 16), (2, 4, 16), (0, 1, 8)]


@pytest.fixture(scope="module")
def jserve():
    """The JAX package's serve module, its paged engines sharing their
    executables across this module's configs.  The reference builds a
    config's jitted executables afresh (one ``_paged_engine_fns`` entry a
    config), and tracing them dominates this file's time.  Two configs
    that differ only in ``fused_k`` run the same single-tick executables
    (decode and verify block: a fused block runs the unmodified
    single-tick body), and the wave, adopt and chunk executables do not
    read ``spec_gamma``, ``draft_layers`` or ``fused_k``: a later config
    gets the jitted functions an earlier one built, so each program is
    traced and compiled once a module."""
    mod = importlib.import_module("kubegpu_tpu.models.serve")
    inner, shared = mod._paged_engine_fns, {}

    def fns(*args, **kw):
        out = list(inner(*args, **kw))
        tick = dict(kw, fused_k=0)
        wave = dict(tick, spec_gamma=0, draft_layers=0)
        for what, key, idx in (("tick", tick, (0, 5)),
                               ("wave", wave, (1, 2, 3))):
            key = (what, args, tuple(sorted(key.items())))
            first = shared.setdefault(key, [out[i] for i in idx])
            for i, fn in zip(idx, first):
                out[i] = fn
        return tuple(out)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "_paged_engine_fns", fns)
        yield mod


@pytest.mark.parametrize("gamma,k,bits", CASES,
                         ids=[f"g{g}-k{k}-kv{b}" for g, k, b in CASES])
def test_overlap_tokens_equal_serial_and_reference(tiny4, jserve, gamma, k,
                                                   bits):
    cfg_j, params_j, cfg, params_t = tiny4
    kw = dict(ENGINE, fused_ticks=k, spec_gamma=gamma,
              draft_layers=1 if gamma else None,
              **({"kv_bits": bits} if bits != 16 else {}))
    runs = {}
    for overlap in (False, True):
        eng = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                   collect_overlap=overlap,
                                   debug_invariants=True, **kw)
        runs[overlap] = (eng, _run(eng, cfg.vocab_size))
    eng, (rids, got) = runs[True]
    assert got == runs[False][1][1]
    assert eng.overlap_ms, "steady-state ticks must have overlapped"
    assert not runs[False][0].overlap_ms
    assert sorted(eng._free_pages) == list(range(1, eng.total_pages + 1))
    ref = jserve.ContinuousBatcher(params_j, cfg_j, collect_overlap=True,
                                   **kw)
    ref_rids, want = _run(ref, cfg.vocab_size)
    assert ref_rids == rids
    assert got == want
    assert len(eng.overlap_ms) == len(ref.overlap_ms)
    if bits == 16:
        for rid, (p, n) in rids.items():
            solo = td.greedy_generate(params_t, [p], n, cfg, device="cpu")
            assert got[rid] == solo[0].tolist(), rid


def test_overlap_kill_consumes_the_unread_tick(tiny4):
    """A chaos kill at an overlapped dispatch: tick N was dispatched but
    not read, so its tokens are consumed before the engine dies and what
    finished in it goes to the orphans; the pool's failover then replays
    every other request, and every token equals the fault-free run's."""
    _, _, cfg, params_t = tiny4
    first, later = _traffic(cfg.vocab_size)
    prompts = first + later
    clean = ts.DataParallelServePool(params_t, cfg, dp=2,
                                     devices=["cpu"] * 2,
                                     collect_overlap=True, **ENGINE)
    want_rids = [clean.submit(p, n) for p, n in prompts]
    want = {r.rid: r.tokens for r in clean.drain()}
    pool = ts.DataParallelServePool(
        params_t, cfg, dp=2, devices=["cpu"] * 2, collect_overlap=True,
        chaos={1: ChaosInjector([ChaosEvent(4, "kill_replica")])},
        **ENGINE)
    rids = [pool.submit(p, n) for p, n in prompts]
    dead = pool.replicas[1]
    orphaned, killed = [], []
    take, overlap_step = dead.take_orphans, dead._overlap_step

    def noted():
        out = take()
        orphaned.extend(out)
        return out

    def watched(t_tick):
        try:
            return overlap_step(t_tick)
        except ReplicaDeadError:
            killed.append(dead._tick)
            raise

    dead.take_orphans, dead._overlap_step = noted, watched
    got = {r.rid: r.tokens for r in pool.drain()}
    assert pool.failovers == 1 and 1 in pool.dead_replicas
    assert killed == [4], "the kill must land on an overlapped dispatch"
    assert orphaned, "the unread tick's finishers must reach the orphans"
    assert [got[r] for r in rids] == [want[r] for r in want_rids]


def test_donation_off_keeps_old_handles_readable(tiny4):
    """``donate=False``: a handle to a pool leaf taken before a step keeps
    the values it had (the reference's test of the same name), the live
    pool moves on, tokens equal ``donate=True``'s, and the peak state
    bytes grow by exactly one pool."""
    _, _, cfg, params_t = tiny4
    runs = {}
    for donate in (True, False):
        eng = ts.ContinuousBatcher(params_t, cfg, device="cpu",
                                   donate=donate, **ENGINE)
        eng.submit(list(range(1, 9)), 8)
        eng.step()
        stale = eng.pool["k"]
        snap = stale.clone()
        eng.step()
        if donate:
            assert stale is eng.pool["k"]
        else:
            assert stale is not eng.pool["k"]
            assert torch.equal(stale, snap)
            assert not torch.equal(eng.pool["k"], snap)
            assert torch.equal(eng.pool["k"], eng._live["pool"]["k"])
        (done,) = eng.drain()
        runs[donate] = (eng, done.tokens)
    assert runs[True][1] == runs[False][1]
    leaves = sum(x.numel() * x.element_size()
                 for x in runs[True][0].pool.values())
    assert (runs[False][0].hbm_peak_bytes - runs[True][0].hbm_peak_bytes
            == leaves)


def test_donation_off_dense_cache(tiny4):
    """The dense engine's public ``cache`` is rebound the same way."""
    _, _, cfg, params_t = tiny4
    eng = ts.ContinuousBatcher(params_t, cfg, device="cpu", donate=False,
                               n_slots=2, stride=4, prompt_buckets=(8,))
    eng.submit([3, 1, 4, 1, 5], 9)
    eng.step()
    stale = eng.cache["k"]
    snap = stale.clone()
    eng.step()
    assert torch.equal(stale, snap) and stale is not eng.cache["k"]
    (done,) = eng.drain()
    assert done.tokens == td.greedy_generate(
        params_t, [[3, 1, 4, 1, 5]], 9, cfg, device="cpu")[0].tolist()


MUTATIONS = ("append", "appendleft", "extend", "popleft", "pop", "remove",
             "clear", "delitem")


@pytest.mark.parametrize("op", MUTATIONS)
def test_admission_queue_total_matches_reference(op):
    """Every deque mutation the reference's queue overrides keeps the
    port's ``prompt_tokens`` equal to the reference queue's and to the
    sum over the queue."""
    jserve = importlib.import_module("kubegpu_tpu.models.serve")
    queues = []
    for mod in (ts, jserve):
        reqs = [mod._Request(rid=i, prompt_len=3 + 2 * i, max_new_tokens=4)
                for i in range(5)]
        items = [(r, np.zeros(8)) for r in reqs]
        q = mod._AdmissionQueue(items[:3])
        extra = items[3:]
        if op == "append":
            q.append(extra[0])
        elif op == "appendleft":
            q.appendleft(extra[0])
        elif op == "extend":
            q.extend(extra)
        elif op == "popleft":
            q.popleft()
        elif op == "pop":
            q.pop()
        elif op == "remove":
            q.remove(items[1])
        elif op == "clear":
            q.clear()
            q.extend(extra)
        else:
            del q[1]
        assert q.prompt_tokens == sum(r.prompt_len for r, _ in q)
        queues.append(q)
    assert queues[0].prompt_tokens == queues[1].prompt_tokens
    assert ([r.rid for r, _ in queues[0]]
            == [r.rid for r, _ in queues[1]])


@pytest.mark.cuda
def test_overlap_reads_the_host_copy_on_the_card():
    """On the card tick N+1's replay rewrites the graph's static slab
    before the host reads tick N: the collect must read tick N's pinned
    copy.  Each staged copy is checked against a clone of the live slab
    taken right after its dispatch, and the live slab has moved on by the
    overlapped read; the tokens equal an un-overlapped engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = tl.LlamaConfig.tiny(**TINY)
    params = tl.llama_init(cfg, seed=0, device="cuda")
    first, later = _traffic(cfg.vocab_size)
    runs = {}
    for overlap in (False, True):
        eng = ts.ContinuousBatcher(params, cfg, device="cuda",
                                   collect_overlap=overlap, **ENGINE)
        eng.warmup()
        staged, moved = {}, []
        stage, read = eng._stage_out, eng._read_out

        def stage_out(eng=eng, stage=stage, staged=staged):
            i = stage()
            torch.cuda.synchronize()
            staged[i] = eng._slab.cpu().numpy().copy()
            return i

        def read_out(i, eng=eng, read=read, staged=staged, moved=moved):
            out = read(i)
            np.testing.assert_array_equal(out, staged[i])
            moved.append(not np.array_equal(eng._slab.cpu().numpy(), out))
            return out

        eng._stage_out, eng._read_out = stage_out, read_out
        runs[overlap] = (eng, _run(eng, cfg.vocab_size)[1], moved)
    eng, got, moved = runs[True]
    assert eng.overlap_ms
    assert got == runs[False][1]
    assert any(moved), "no overlapped read found the live slab rewritten"
    assert not any(runs[False][2])
