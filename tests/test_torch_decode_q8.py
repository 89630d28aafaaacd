"""The port's dense int8 KV cache and the static greedy path on int8 weights
against the JAX package's, on a tiny f32 config: the cache's initial
state, ``_cached_attend_q8`` (``1e-5``), prefill logits (``1e-4``) with
the cache's int8 bytes within one quantization step and its scales within
``1e-5``, and ``greedy_generate``'s tokens EQUAL for int8 weights × int8
cache, with the static step also run through the graph runner (a stand-in
``kernels.Graph`` whose replay calls the step)."""

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
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import quant as tq


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny(max_seq_len=64)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(max_seq_len=64), params_t


def test_init_int8_cache_matches_reference(tiny):
    cfg_j, _, cfg, _ = tiny
    ref = jd.init_kv_cache(cfg_j, 3, 16, kv_int8=True)
    got = td.init_kv_cache(cfg, 3, 16, kv_int8=True, device="cpu")
    assert set(got) == set(ref) == {"k", "v", "k_scale", "v_scale"}
    for name, r in ref.items():
        assert tuple(got[name].shape) == r.shape
        assert str(got[name].dtype).split(".")[-1] == str(r.dtype)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(r))
    assert set(td.init_kv_cache(cfg, 1, 8, device="cpu")) == {"k", "v"}


def test_cached_attend_q8_matches_reference():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 3, 16), np.float32)
    ck, cv = (rng.integers(-127, 128, (2, 2, 10, 16)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.05, (2, 2, 10)).astype(np.float32)
              for _ in range(2))
    for q_pos in (np.array([4, 5, 6], np.int32),
                  np.array([7, 8, 9], np.int32)):
        args = (q, ck, cv, ks, vs, q_pos)
        ref = jd._cached_attend_q8(*map(jnp.asarray, args))
        got = td._cached_attend_q8(*map(torch.from_numpy, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_prefill_into_int8_cache_matches_reference(tiny):
    cfg_j, params_j, cfg, params_t = tiny
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 11))
    ref_l, ref_c = jd.prefill(params_j, jnp.asarray(prompt, jnp.int32),
                              cfg_j, max_len=32, kv_int8=True)
    out_l, out_c = td.prefill(params_t, torch.from_numpy(prompt), cfg,
                              max_len=32, kv_int8=True)
    np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l), atol=1e-4)
    for name in ("k", "v"):
        diff = np.abs(out_c[name].numpy().astype(np.int32)
                      - np.asarray(ref_c[name]).astype(np.int32))
        assert diff.max() <= 1, name          # one int8 step at most
        np.testing.assert_allclose(out_c[f"{name}_scale"].numpy(),
                                   np.asarray(ref_c[f"{name}_scale"]),
                                   rtol=1e-5)


def _logit_gap(params, prompt, n, cfg):
    """The smallest top-1 minus top-2 logit over the reference rollout's
    steps (a near tie flips on summation order alone)."""
    logits, cache = td.prefill(params, torch.from_numpy(prompt), cfg,
                               kv_int8=True)
    gaps = []
    for i in range(n):
        top = logits.topk(2, dim=-1).values
        gaps.append(float((top[:, 0] - top[:, 1]).min()))
        tok = logits.argmax(dim=-1)
        logits, cache = td.decode_step(params, cache, tok,
                                       prompt.shape[1] + i, cfg)
    return min(gaps)


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


@pytest.mark.parametrize("int8_weights", [False, True],
                         ids=["bf16w", "int8w"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["kv16", "kv8"])
def test_greedy_tokens_equal_reference(tiny, monkeypatch, int8_weights,
                                       kv_int8):
    """Eager and through the graph runner (two calls of one shape: the
    second reuses the first's state and replays every step)."""
    cfg_j, params_j, cfg, params_t = tiny
    if int8_weights:
        params_j = jq.quantize_llama(params_j)
        params_t = tq.quantize_llama(params_t)
    monkeypatch.setattr(td.kernels, "Graph", _ReplayedGraph)
    monkeypatch.setattr(_ReplayedGraph, "replays", 0)
    td.clear_graphs()
    n = 9
    for seed in (5, 6):
        prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                      (2, 7))
        ref = np.asarray(jd.greedy_generate(
            params_j, jnp.asarray(prompt, jnp.int32), n, cfg_j,
            max_len=32, kv_int8=kv_int8))
        eager = td.greedy_generate(params_t, prompt, n, cfg, max_len=32,
                                   kv_int8=kv_int8, device="cpu")
        before = _ReplayedGraph.replays
        graph = td._rollout(params_t, torch.from_numpy(prompt), cfg, n, 32,
                            kv_int8, graphs=True)
        assert torch.equal(graph, eager)
        # the first call runs one step eagerly before its capture
        assert _ReplayedGraph.replays - before == n - 1 - (seed == 5)
        if eager.tolist() != ref.tolist():
            gap = _logit_gap(params_t, prompt, n, cfg) if kv_int8 else None
            pytest.fail(f"tokens differ from JAX (smallest logit gap "
                        f"{gap}): {eager.tolist()} != {ref.tolist()}")
    assert len(td._graph_cache) == 1
    td.clear_graphs()
