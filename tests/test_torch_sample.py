"""The port's sampling (``models/decode.py``: ``_nucleus_mask``,
``_sample_token``, ``sample_generate``) against the JAX package's on the
CPU, on the same converted f32 parameters and the same keys
(``prng.prng_key(seed)`` against ``jax.random.PRNGKey(seed)``): the mask
within 1e-6 of the reference's (a softmax's cumulative sum; the kept set
equal), the sampled tokens EQUAL.  Exact logit ties at the top-k boundary
(where ``torch.topk`` and ``lax.top_k`` may keep different tokens) do not
occur in these f32 draws; a test pins that no draw here has one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import decode as jd
from kubegpu_tpu.models import llama as jl
from kubegpu_tpu_torch import prng
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import llama as tl


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny(max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(max_seq_len=64), params_t


def _prompt(cfg, b=2, t=5, mult=3):
    return (np.arange(b * t).reshape(b, t) * mult) % cfg.vocab_size


@pytest.mark.parametrize("top_p", [0.05, 0.5, 0.9, 1.0])
def test_nucleus_mask(top_p):
    rng = np.random.default_rng(1)
    logits = -np.sort(-rng.standard_normal((4, 64)).astype(np.float32) * 2,
                      axis=-1)
    want = np.asarray(jd._nucleus_mask(jnp.asarray(logits), top_p))
    got = td._nucleus_mask(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert ((got > -1e29).sum(axis=-1) >= 1).all()


@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("nucleus", [False, True])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_sample_token(top_k, nucleus, seed):
    """Per-row temperatures ([B, 1], one of them near zero) and a scalar
    top_p, as the engine and ``sample_generate`` pass them."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((6, 300)).astype(np.float32) * 4
    temps = np.array([[0.5], [1.0], [2.0], [1e-7], [0.8], [3.0]],
                     np.float32)
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    kt = prng.fold_in(prng.prng_key(seed, device="cpu"), 5)
    want = np.asarray(jd._sample_token(
        jnp.asarray(logits), kj, jnp.asarray(temps), jnp.float32(0.7),
        top_k, nucleus))
    got = td._sample_token(torch.from_numpy(logits), kt,
                           torch.from_numpy(temps), torch.tensor(0.7),
                           top_k, nucleus)
    np.testing.assert_array_equal(got.numpy(), want)
    if top_k:
        # no exact tie at the k-th place: torch.topk keeps lax.top_k's set
        top = -np.sort(-(logits / np.maximum(temps, 1e-6)), axis=-1)
        assert (top[:, top_k - 1] != top[:, top_k]).all()


@pytest.mark.parametrize("kw", [
    dict(temperature=2.0), dict(temperature=0.8, top_k=5),
    dict(temperature=1.0, top_p=0.9),
    dict(temperature=0.9, top_k=8, top_p=0.8)],
    ids=["temp", "top_k", "top_p", "top_k_p"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["kv16", "kv8"])
def test_sample_generate_equals_reference(tiny, kw, kv_int8):
    cfg_j, params_j, cfg, params_t = tiny
    prompt = _prompt(cfg)
    for seed in (1, 2):
        want = np.asarray(jd.sample_generate(
            params_j, jnp.asarray(prompt, jnp.int32), 8, cfg_j,
            jax.random.PRNGKey(seed), kv_int8=kv_int8, **kw))
        got = td.sample_generate(params_t, prompt, 8, cfg,
                                 prng.prng_key(seed, device="cpu"),
                                 kv_int8=kv_int8, device="cpu", **kw)
        np.testing.assert_array_equal(got.numpy(), want)


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


def test_sample_generate_graph_runner(tiny, monkeypatch):
    """Through the graph runner (two calls of one shape and knobs: the
    second reuses the first's state and replays every step): the step
    index and the key rows live on the device, so each replay draws its
    own step's noise, and the tokens equal the eager call's."""
    _, _, cfg, params_t = tiny
    monkeypatch.setattr(td.kernels, "Graph", _ReplayedGraph)
    monkeypatch.setattr(_ReplayedGraph, "replays", 0)
    td.clear_graphs()
    n = 9
    for seed in (5, 6):
        prompt = torch.from_numpy(_prompt(cfg, t=7, mult=seed))
        key = prng.prng_key(seed, device="cpu")
        eager = td.sample_generate(params_t, prompt, n, cfg, key,
                                   temperature=1.5, top_k=6, device="cpu")
        before = _ReplayedGraph.replays
        sample = {"key": key, "temperature": 1.5, "top_p": 1.0,
                  "top_k": 6, "nucleus": False}
        graph = td._rollout(params_t, prompt, cfg, n, 32, False,
                            graphs=True, sample=sample)
        assert torch.equal(graph, eager)
        assert _ReplayedGraph.replays - before == n - 1 - (seed == 5)
    td.clear_graphs()


def test_near_zero_temperature_matches_greedy(tiny):
    _, _, cfg, params_t = tiny
    prompt = _prompt(cfg)
    greedy = td.greedy_generate(params_t, prompt, 6, cfg, device="cpu")
    sampled = td.sample_generate(params_t, prompt, 6, cfg,
                                 prng.prng_key(0, device="cpu"),
                                 temperature=1e-5, device="cpu")
    assert torch.equal(sampled, greedy)


def test_top_k_one_matches_greedy(tiny):
    _, _, cfg, params_t = tiny
    prompt = _prompt(cfg)
    greedy = td.greedy_generate(params_t, prompt, 6, cfg, device="cpu")
    sampled = td.sample_generate(params_t, prompt, 6, cfg,
                                 prng.prng_key(7, device="cpu"), top_k=1,
                                 temperature=5.0, device="cpu")
    assert torch.equal(sampled, greedy)


def test_tiny_top_p_collapses_to_greedy(tiny):
    _, _, cfg, params_t = tiny
    prompt = _prompt(cfg, b=1)
    greedy = td.greedy_generate(params_t, prompt, 4, cfg, device="cpu")
    for seed in range(3):
        got = td.sample_generate(params_t, prompt, 4, cfg,
                                 prng.prng_key(seed, device="cpu"),
                                 temperature=1.0, top_p=1e-6, device="cpu")
        assert torch.equal(got, greedy)


def test_deterministic_per_key_and_varies_across_keys(tiny):
    _, _, cfg, params_t = tiny
    prompt = _prompt(cfg)

    def draw(seed):
        return td.sample_generate(params_t, prompt, 8, cfg,
                                  prng.prng_key(seed, device="cpu"),
                                  temperature=2.0, device="cpu")

    a1, a2, b = draw(1), draw(1), draw(2)
    assert torch.equal(a1, a2)
    assert not torch.equal(a1, b)
    assert ((a1 >= 0) & (a1 < cfg.vocab_size)).all()


@pytest.mark.parametrize("kw,match", [
    (dict(top_p=0.0), "top_p"), (dict(temperature=0.0), "temperature"),
    (dict(top_k=10 ** 6), "top_k"), (dict(n_steps=0), "n_steps"),
    (dict(n_steps=70), "max_len")])
def test_sample_generate_validation(tiny, kw, match):
    cfg_j, params_j, cfg, params_t = tiny
    n = kw.pop("n_steps", 2)
    prompt = np.zeros((1, 4), np.int64)
    with pytest.raises(ValueError, match=match):
        jd.sample_generate(params_j, jnp.asarray(prompt, jnp.int32), n,
                           cfg_j, jax.random.PRNGKey(0), **kw)
    with pytest.raises(ValueError, match=match):
        td.sample_generate(params_t, prompt, n, cfg,
                           prng.prng_key(0, device="cpu"), device="cpu",
                           **kw)
