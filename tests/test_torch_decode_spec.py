"""The port's speculative decoders against the JAX package's on a tiny f32
config of 3 layers: ``spec_generate`` (the host loop) and
``spec_generate_fused`` (acceptance on the device) over drafts of 1 and 2
layers, ``pld_generate_fused`` and ``pld_generate_paged`` (pages of 8).
Tokens EQUAL to JAX's and to ``greedy_generate``'s, ``iterations`` and
``acceptance_rate`` EQUAL to JAX's; a perfect draft accepts exactly 1.0;
the int8 cache and int8 weights through ``draft_view``; the n-gram window
at a prompt shorter than the n-gram (JAX clamps the slice start); the
reference's paged PLD at γ > page_size (its two-page window's clamped
write) and the port's refusal of it; the fused loops' block schedule under
a stand-in ``kernels.Graph`` whose replay calls the iteration (no
iteration past ``n_steps``); the ``ValueError``s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import decode as jd
from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models import quant as jq
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import draft_view, llama as tl
from kubegpu_tpu_torch.models import quant as tq
from kubegpu_tpu_torch.models import spec_generate

SPEC_CASES = [(n, dl, g) for n in (1, 2, 9) for dl, g in ((1, 4), (2, 2))]
PAGE = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run puts six test files on the host
    at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    kw = dict(max_seq_len=64, n_layers=3)
    cfg_j = jl.LlamaConfig.tiny(**kw)
    params_j = jl.llama_init(jax.random.PRNGKey(5), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(**kw), params_t


def _prompt(seed, b, t, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


PROMPTS = {"spec": _prompt(1, 2, 6),
           # a repeating prompt: the lookup finds its n-grams
           "repeat": np.tile([5, 9, 2, 7, 11], 4)[None].repeat(2, 0),
           "plain": _prompt(2, 2, 9),
           # shorter than the n-gram: the window start clamps to 0
           "short": np.array([[3, 7], [3, 3]])}


@pytest.fixture(scope="module")
def jax_runs(tiny):
    """Memoized JAX results: (tokens, stats) by call."""
    cfg_j, params_j, _, _ = tiny
    memo = {}

    def run(fn, prompt, n, **kw):
        key = (fn, prompt, n, tuple(sorted(kw.items())))
        if key not in memo:
            toks, stats = getattr(jd, fn)(
                params_j, jnp.asarray(PROMPTS[prompt], jnp.int32), n, cfg_j,
                **kw)
            memo[key] = np.asarray(toks), stats
        return memo[key]

    return run


@pytest.fixture(scope="module")
def greedy(tiny):
    _, _, cfg, params = tiny
    memo = {}

    def run(prompt, n, kv_int8=False, max_len=None):
        key = (prompt, n, kv_int8, max_len)
        if key not in memo:
            memo[key] = td.greedy_generate(params, PROMPTS[prompt], n, cfg,
                                           kv_int8=kv_int8, max_len=max_len,
                                           device="cpu").numpy()
        return memo[key]

    return run


@pytest.mark.parametrize("fn", ["spec_generate", "spec_generate_fused"])
def test_spec_matches_jax_and_greedy(tiny, jax_runs, greedy, fn):
    _, _, cfg, params = tiny
    for n, dl, g in SPEC_CASES:
        toks, stats = getattr(td, fn)(params, PROMPTS["spec"], n, cfg,
                                      draft_layers=dl, gamma=g, device="cpu")
        want, want_stats = jax_runs(fn, "spec", n, draft_layers=dl, gamma=g)
        msg = f"n={n} draft_layers={dl} gamma={g}"
        np.testing.assert_array_equal(toks.numpy(), want, err_msg=msg)
        np.testing.assert_array_equal(toks.numpy(), greedy("spec", n),
                                      err_msg=msg)
        assert stats == want_stats, msg


def test_perfect_draft_accepts_everything(tiny, jax_runs, greedy):
    """draft_layers = n_layers: the draft IS the model.  n = 12 cuts the
    last slab short; the acceptable slots follow min(γ, remaining) - 1, so
    the fused loop still reads exactly 1.0."""
    _, _, cfg, params = tiny
    for fn in ("spec_generate", "spec_generate_fused"):
        toks, stats = getattr(td, fn)(params, PROMPTS["spec"], 12, cfg,
                                      draft_layers=3, gamma=4, device="cpu")
        want, want_stats = jax_runs(fn, "spec", 12, draft_layers=3, gamma=4)
        np.testing.assert_array_equal(toks.numpy(), want)
        np.testing.assert_array_equal(toks.numpy(), greedy("spec", 12))
        assert stats == want_stats
    assert stats["acceptance_rate"] == 1.0


def test_spec_kv_int8(tiny, jax_runs, greedy):
    _, _, cfg, params = tiny
    for fn in ("spec_generate", "spec_generate_fused"):
        toks, stats = getattr(td, fn)(params, PROMPTS["spec"], 6, cfg,
                                      draft_layers=1, gamma=3, kv_int8=True,
                                      device="cpu")
        want, want_stats = jax_runs(fn, "spec", 6, draft_layers=1, gamma=3,
                                    kv_int8=True)
        np.testing.assert_array_equal(toks.numpy(), want)
        np.testing.assert_array_equal(toks.numpy(),
                                      greedy("spec", 6, kv_int8=True))
        assert stats == want_stats


def test_spec_on_int8_weights_through_draft_view(tiny):
    """A quantized tree slices into the draft view (values and scales
    together, as views) and decodes to the JAX package's tokens."""
    cfg_j, params_j, cfg, params = tiny
    q_j, q_t = jq.quantize_llama(params_j), tq.quantize_llama(params)
    dview = draft_view(q_t, 2)
    assert dview["layers"]["wq"].values.shape[0] == 2
    assert dview["layers"]["wq"].scale.shape[0] == 2
    assert dview["layers"]["wq"].values.data_ptr() == \
        q_t["layers"]["wq"].values.data_ptr()
    prompt = PROMPTS["spec"]
    want, want_stats = jd.spec_generate(
        q_j, jnp.asarray(prompt, jnp.int32), 4, cfg_j, draft_layers=2,
        gamma=2, dparams=jd.draft_view(q_j, 2))
    toks, stats = spec_generate(q_t, prompt, 4, cfg, draft_layers=2, gamma=2,
                                dparams=dview, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    assert stats == want_stats
    np.testing.assert_array_equal(
        toks.numpy(), td.greedy_generate(q_t, prompt, 4, cfg,
                                         device="cpu").numpy())


def test_spec_validation(tiny):
    _, _, cfg, params = tiny
    prompt = np.zeros((1, 4), np.int64)
    for fn in (td.spec_generate, td.spec_generate_fused):
        for dl in (0, 4):
            with pytest.raises(ValueError, match="draft_layers"):
                fn(params, prompt, 2, cfg, draft_layers=dl, device="cpu")
        with pytest.raises(ValueError, match="gamma"):
            fn(params, prompt, 2, cfg, draft_layers=1, gamma=0, device="cpu")
        with pytest.raises(ValueError, match="n_steps"):
            fn(params, prompt, 0, cfg, draft_layers=1, device="cpu")


# (prompt, n_steps, gamma, ngram, kv_int8, max_len): a repeating prompt
# (the lookup accepts), a non-repeating one, the int8 cache, and an n-gram
# longer than the prompt (the first windows' starts clamp)
PLD_CASES = {"repeat": ("repeat", 14, 4, 2, False, 48),
             "plain": ("plain", 8, 3, 2, False, 32),
             "kv8": ("repeat", 14, 4, 2, True, 48),
             "short": ("short", 9, 3, 4, False, 32)}


@pytest.mark.parametrize("case", list(PLD_CASES))
def test_pld_matches_jax_and_paged_equals_fused(tiny, jax_runs, greedy,
                                                case):
    _, _, cfg, params = tiny
    prompt, n, g, ng, kv8, max_len = PLD_CASES[case]
    kw = dict(gamma=g, ngram=ng, max_len=max_len)
    toks, stats = td.pld_generate_fused(params, PROMPTS[prompt], n, cfg,
                                        kv_int8=kv8, device="cpu", **kw)
    want, want_stats = jax_runs("pld_generate_fused", prompt, n,
                                kv_int8=kv8, **kw)
    np.testing.assert_array_equal(toks.numpy(), want)
    assert stats == want_stats
    np.testing.assert_array_equal(toks.numpy(),
                                  greedy(prompt, n, kv8, max_len))
    if case == "repeat":
        assert stats["acceptance_rate"] > 0
    if kv8:
        return
    paged, pstats = td.pld_generate_paged(params, PROMPTS[prompt], n, cfg,
                                          page_size=PAGE, device="cpu", **kw)
    want_p, want_pstats = jax_runs("pld_generate_paged", prompt, n,
                                   page_size=PAGE, **kw)
    np.testing.assert_array_equal(paged.numpy(), want_p)
    assert pstats == want_pstats
    assert torch.equal(paged, toks) and pstats == stats


def test_pld_lookup_at_a_prompt_shorter_than_the_ngram():
    """At pos < ngram - 1 JAX's ``dynamic_slice`` clamps the window's start
    to 0 (a negative index would raise in the port's gather); no earlier
    position can match, so the draft repeats the token at ``pos``.  The
    latest match wins otherwise, and its continuation is read past
    ``pos``."""
    seq = torch.tensor([[3, 7, 0, 0, 0, 0, 0, 0],
                        [3, 3, 0, 0, 0, 0, 0, 0]])
    pos = torch.tensor([1])
    got = td._pld_lookup(seq, pos, 4, 3)
    assert got.tolist() == [[7, 7, 7], [3, 3, 3]]
    seq = torch.tensor([[1, 2, 5, 1, 2, 6, 1, 2, 0, 0]])
    got = td._pld_lookup(seq, torch.tensor([7]), 2, 2)
    assert got.tolist() == [[6, 1]]


def test_reference_paged_pld_window_clamp_and_the_port_refusal(tiny,
                                                               jax_runs):
    """The reference writes the verify chunk (γ+1 positions) into a
    two-page window with ``dynamic_update_slice``, which clamps: at γ >
    page_size a chunk that starts late in its page lands shifted back over
    the history.  At γ = 12 over pages of 8 its paged tokens and stats
    leave its own ``pld_generate_fused``'s.  The port raises ``ValueError``
    for γ > page_size; at γ = page_size its paged tokens and stats equal
    its fused ones (which equal the reference's, above)."""
    _, _, cfg, params = tiny
    kw = dict(ngram=2, max_len=48)
    fused, fstats = jax_runs("pld_generate_fused", "repeat", 20, gamma=12,
                             **kw)
    paged, pstats = jax_runs("pld_generate_paged", "repeat", 20, gamma=12,
                             page_size=PAGE, **kw)
    assert (fused != paged).any() or fstats != pstats
    with pytest.raises(ValueError, match="page_size"):
        td.pld_generate_paged(params, PROMPTS["repeat"], 20, cfg, gamma=12,
                              page_size=PAGE, device="cpu", **kw)
    toks, stats = td.pld_generate_paged(params, PROMPTS["repeat"], 20, cfg,
                                        gamma=PAGE, page_size=PAGE,
                                        device="cpu", **kw)
    want, want_stats = td.pld_generate_fused(params, PROMPTS["repeat"], 20,
                                             cfg, gamma=PAGE, device="cpu",
                                             **kw)
    assert torch.equal(toks, want) and stats == want_stats


def test_pld_validation(tiny):
    _, _, cfg, params = tiny
    prompt = np.zeros((1, 8), np.int64)
    for fn in (td.pld_generate_fused, td.pld_generate_paged):
        with pytest.raises(ValueError, match="gamma"):
            fn(params, prompt, 4, cfg, gamma=0, device="cpu")
        with pytest.raises(ValueError, match="ngram"):
            fn(params, prompt, 4, cfg, ngram=0, device="cpu")


class _ReplayedGraph:
    """``kernels.Graph`` on the CPU: the capture records nothing and a
    replay calls the captured function."""

    def __init__(self, fn):
        self.fn = fn

    def capture(self):
        pass

    def replay(self):
        self.fn()


@pytest.mark.parametrize("loop", ["spec", "pld", "pld_paged"])
def test_fused_block_schedule_runs_no_iteration_past_the_end(
        tiny, jax_runs, monkeypatch, loop):
    """Through the graph runner (two calls of one shape: the second replays
    every iteration of the cached graph), the block schedule gives JAX's
    tokens and stats; the iteration body runs exactly ``iterations`` times
    (an iteration past ``n_steps`` would run it once more), ``n_out`` ends
    at ``n_steps``, and the counters are read once a block."""
    _, _, cfg, params = tiny
    monkeypatch.setattr(td.kernels, "Graph", _ReplayedGraph)
    calls = {"body": 0, "n_out": []}
    advance, read = td._advance, td._read_loop_state

    def counted_advance(*a):
        calls["body"] += 1
        advance(*a)

    def counted_read(st):
        out = read(st)
        calls["n_out"].append(out[0])
        return out

    monkeypatch.setattr(td, "_advance", counted_advance)
    monkeypatch.setattr(td, "_read_loop_state", counted_read)
    td.clear_graphs()
    if loop == "spec":
        n, prompt = 9, "spec"
        want, want_stats = jax_runs("spec_generate_fused", prompt, n,
                                    draft_layers=1, gamma=4)
        run = (lambda: td._spec_fused(
            params, draft_view(params, 1), torch.as_tensor(PROMPTS[prompt]),
            cfg, n, 64, 1, 4, False, graphs=True))
        max_emit = 4
    else:
        n, prompt = 14, "repeat"
        page = PAGE if loop == "pld_paged" else None
        want, want_stats = jax_runs(
            "pld_generate_fused", prompt, n, gamma=4, ngram=2, max_len=48)
        run = (lambda: td._pld(params, torch.as_tensor(PROMPTS[prompt]), cfg,
                               n, 48, 4, 2, False, page, graphs=True))
        max_emit = 5
    for _ in range(2):
        calls.update(body=0, n_out=[])
        toks, stats = run()
        np.testing.assert_array_equal(toks.numpy(), want)
        assert stats == want_stats
        assert calls["body"] == stats["iterations"]
        # one read a block; a block is ceil(remaining / max_emit)
        # iterations, and the last read finds n_steps out
        before = [1] + calls["n_out"][:-1]
        blocks = [-(-(n - b) // max_emit) for b in before]
        assert sum(blocks) == stats["iterations"]
        assert calls["n_out"][-1] == n and len(blocks) < stats["iterations"]
    st = next(iter(td._graph_cache.values()))[1]
    assert st["ctr"][0].item() == n
    td.clear_graphs()
