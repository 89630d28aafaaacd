"""The port's beam search (``beam_generate``, dense over a bf16-form cache in
f32 and over the int8 cache, and ``beam_generate_paged`` on pages of 8, an
unaligned 5-token prompt included) against the JAX package's on a tiny f32
config: tokens EQUAL and scores within ``1e-4``.  Also: ``beams=1`` equals
``greedy_generate``; the score equals the teacher-forced sum of
log-probabilities through the port's ``llama_forward`` (``2e-3``, as the
reference's own test); paged equals dense; the top-k's tie order is
``lax.top_k``'s; the step's graph runner (a stand-in ``kernels.Graph``
whose replay calls the step) gives the eager tokens; the ``ValueError``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from kubegpu_tpu.models import decode as jd
from kubegpu_tpu.models import llama as jl
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import beam_generate, beam_generate_paged
from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import llama as tl

N_STEPS, BEAMS, PAGE = 7, 3, 8


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
    cfg_j = jl.LlamaConfig.tiny(max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(3), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(max_seq_len=64), params_t


def _prompt(seed, b, t, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


@pytest.fixture(scope="module")
def prompts():
    # an 11-token prompt spans two pages of 8; the 5-token one ends inside
    # its only page (t_pad = t unaligned, the pad masked)
    return {"aligned": _prompt(1, 2, 11), "unaligned": _prompt(2, 3, 5)}


@pytest.fixture(scope="module")
def jax_beams(tiny, prompts):
    """The JAX package's results, one executable a case."""
    cfg_j, params_j, _, _ = tiny
    p = jnp.asarray(prompts["aligned"], jnp.int32)
    u = jnp.asarray(prompts["unaligned"], jnp.int32)
    out = {
        "dense": jd.beam_generate(params_j, p, N_STEPS, cfg_j, beams=BEAMS),
        "kv8": jd.beam_generate(params_j, p, N_STEPS, cfg_j, beams=BEAMS,
                                kv_int8=True),
        "paged": jd.beam_generate_paged(params_j, p, N_STEPS, cfg_j,
                                        beams=BEAMS, page_size=PAGE),
        "unaligned": jd.beam_generate_paged(params_j, u, 6, cfg_j, beams=2,
                                            page_size=PAGE)}
    return {k: (np.asarray(t), np.asarray(s)) for k, (t, s) in out.items()}


def _seq_logprob(params, cfg, prompt, gen) -> np.ndarray:
    """Teacher-forced sum of log-probabilities of ``gen`` after ``prompt``
    through the port's ``llama_forward``."""
    full = torch.cat([torch.as_tensor(prompt), gen], dim=1)
    logp = torch.log_softmax(tl.llama_forward(params, full[:, :-1], cfg)
                             .float(), dim=-1)
    t = prompt.shape[1]
    return logp[:, t - 1:].gather(2, gen[..., None])[..., 0].sum(1).numpy()


def test_top_k_breaks_ties_as_lax_top_k():
    """Exact ties: the kept entries and their order are ``lax.top_k``'s
    (descending, the lower index first), on rows whose ties straddle the
    k-th place."""
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.5],
                  [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                  [-1.0, 4.0, -1.0, 4.0, 0.0, 4.0]], np.float32)
    for k in (1, 2, 3, 5):
        want_v, want_i = lax.top_k(jnp.asarray(x), k)
        got_v, got_i = td._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_beam_tie_order_follows_lax_top_k(tiny):
    """A zero final norm makes every logit exactly 0: every joint score of
    every step ties, so the frontier and each step's survivors are decided
    by the tie order alone.  ``lax.top_k`` keeps the lower flat index, so
    the best beam is token 0 throughout, and the port's must be too."""
    cfg_j, params_j, cfg, _ = tiny
    params_j = dict(params_j, final_norm=jnp.zeros_like(
        params_j["final_norm"]))
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    prompt = _prompt(4, 2, 6)
    want, want_s = jd.beam_generate(params_j, jnp.asarray(prompt, jnp.int32),
                                    3, cfg_j, beams=BEAMS)
    got, got_s = beam_generate(params_t, prompt, 3, cfg, beams=BEAMS,
                               device="cpu")
    assert not np.asarray(want).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)


@pytest.mark.parametrize("case", ["dense", "kv8", "paged"])
def test_beam_matches_jax(tiny, prompts, jax_beams, case):
    _, _, cfg, params = tiny
    kw = dict(beams=BEAMS, device="cpu")
    if case == "paged":
        toks, score = beam_generate_paged(params, prompts["aligned"], N_STEPS,
                                          cfg, page_size=PAGE, **kw)
    else:
        toks, score = beam_generate(params, prompts["aligned"], N_STEPS, cfg,
                                    kv_int8=case == "kv8", **kw)
    want_t, want_s = jax_beams[case]
    assert toks.dtype == torch.long and score.dtype == torch.float32
    np.testing.assert_array_equal(toks.numpy(), want_t)
    np.testing.assert_allclose(score.numpy(), want_s, atol=1e-4)


def test_beam_paged_equals_dense_and_the_unaligned_prompt(tiny, prompts,
                                                         jax_beams):
    _, _, cfg, params = tiny
    dense = beam_generate(params, prompts["aligned"], N_STEPS, cfg,
                          beams=BEAMS, device="cpu")
    paged = beam_generate_paged(params, prompts["aligned"], N_STEPS, cfg,
                                beams=BEAMS, page_size=PAGE, device="cpu")
    assert torch.equal(dense[0], paged[0])
    np.testing.assert_allclose(paged[1].numpy(), dense[1].numpy(), atol=1e-4)
    u_dense = beam_generate(params, prompts["unaligned"], 6, cfg, beams=2,
                            device="cpu")
    u_paged = beam_generate_paged(params, prompts["unaligned"], 6, cfg,
                                  beams=2, page_size=PAGE, device="cpu")
    want_t, want_s = jax_beams["unaligned"]
    np.testing.assert_array_equal(u_paged[0].numpy(), want_t)
    np.testing.assert_allclose(u_paged[1].numpy(), want_s, atol=1e-4)
    assert torch.equal(u_paged[0], u_dense[0])


def test_beam_one_equals_greedy_and_scores_are_log_probs(tiny, prompts):
    _, _, cfg, params = tiny
    prompt = prompts["aligned"]
    greedy = td.greedy_generate(params, prompt, 5, cfg, device="cpu")
    for fn, kw in ((beam_generate, {}), (beam_generate_paged,
                                         {"page_size": PAGE})):
        toks, score = fn(params, prompt, 5, cfg, beams=1, device="cpu", **kw)
        assert torch.equal(toks, greedy)
        np.testing.assert_allclose(
            score.numpy(), _seq_logprob(params, cfg, prompt, toks),
            atol=2e-3, rtol=2e-3)
    toks, score = beam_generate(params, prompt, 4, cfg, beams=4,
                                device="cpu")
    np.testing.assert_allclose(score.numpy(),
                               _seq_logprob(params, cfg, prompt, toks),
                               atol=2e-3, rtol=2e-3)
    # one step: beam search is exhaustive over the first token
    toks, _ = beam_generate(params, prompt, 1, cfg, beams=4, device="cpu")
    assert torch.equal(toks, greedy[:, :1])


class _ReplayedGraph:
    """``kernels.Graph`` on the CPU: the capture records nothing and a
    replay calls the captured function."""
    replays = 0

    def __init__(self, fn):
        self.fn = fn

    def capture(self):
        pass

    def replay(self):
        type(self).replays += 1
        self.fn()


@pytest.mark.parametrize("page_size", [None, PAGE], ids=["dense", "paged"])
def test_beam_graph_runner_gives_the_eager_tokens(tiny, prompts, jax_beams,
                                                  monkeypatch, page_size):
    """Two calls of one shape through the graph runner: the first runs its
    step eagerly once and captures it, the second reuses the cached state
    and replays every step; both equal the JAX tokens."""
    _, _, cfg, params = tiny
    monkeypatch.setattr(td.kernels, "Graph", _ReplayedGraph)
    monkeypatch.setattr(_ReplayedGraph, "replays", 0)
    td.clear_graphs()
    prompt = torch.as_tensor(prompts["aligned"])
    want_t, want_s = jax_beams["dense" if page_size is None else "paged"]
    for call in range(2):
        toks, score = td._beam_search(params, prompt, cfg, N_STEPS, BEAMS,
                                      False, page_size, graphs=True)
        np.testing.assert_array_equal(toks.numpy(), want_t)
        np.testing.assert_allclose(score.numpy(), want_s, atol=1e-4)
    assert _ReplayedGraph.replays == 2 * (N_STEPS - 1) - 1
    assert len(td._graph_cache) == 1
    td.clear_graphs()


def test_beam_validation(tiny):
    _, _, cfg, params = tiny
    prompt = np.zeros((1, 4), np.int64)
    for fn in (beam_generate, beam_generate_paged):
        for beams in (0, cfg.vocab_size + 1):
            with pytest.raises(ValueError, match="beams"):
                fn(params, prompt, 2, cfg, beams=beams, device="cpu")
        with pytest.raises(ValueError, match="max_len"):
            fn(params, prompt, 80, cfg, device="cpu")
