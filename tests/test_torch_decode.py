"""The port's cached decode against the JAX package's on the tiny config:
greedy tokens must be EQUAL; prefill logits and the attention partials
within ``1e-4`` / ``1e-5`` (f32 on the CPU, another summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import decode as jd
from kubegpu_tpu.models import llama as jl
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


@pytest.mark.parametrize("t,n", [(5, 12), (9, 7)])
def test_greedy_tokens_equal_reference(tiny, t, n):
    cfg_j, params_j, cfg, params_t = tiny
    prompt = np.random.default_rng(t).integers(0, cfg.vocab_size, (2, t))
    ref = jd.greedy_generate(params_j, jnp.asarray(prompt, jnp.int32), n,
                             cfg_j)
    out = td.greedy_generate(params_t, prompt, n, cfg, device="cpu")
    assert out.tolist() == np.asarray(ref).tolist()


def test_prefill_logits_and_cache_match(tiny):
    cfg_j, params_j, cfg, params_t = tiny
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 11))
    ref_l, ref_c = jd.prefill(params_j, jnp.asarray(prompt, jnp.int32),
                              cfg_j, max_len=32)
    out_l, out_c = td.prefill(params_t, torch.from_numpy(prompt), cfg,
                              max_len=32)
    np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l), atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(out_c[name].numpy(),
                                   np.asarray(ref_c[name]), atol=1e-5)


def test_cached_attend_and_buffer_partials_match():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4, 3, 16), np.float32)
    ck, cv = (rng.standard_normal((2, 2, 10, 16), np.float32)
              for _ in range(2))
    q_pos = np.array([4, 5, 6], np.int32)
    np.testing.assert_allclose(
        td._cached_attend(*map(torch.from_numpy, (q, ck, cv, q_pos))).numpy(),
        np.asarray(jd._cached_attend(*map(jnp.asarray, (q, ck, cv, q_pos)))),
        atol=1e-5)
    q1 = q[:, :, :1]
    for j in (0, 5):
        ref = jd._attend_buffer_partials(jnp.asarray(q1), jnp.asarray(ck),
                                         jnp.asarray(cv), jnp.int32(j))
        out = td._attend_buffer_partials(torch.from_numpy(q1),
                                         torch.from_numpy(ck),
                                         torch.from_numpy(cv), j)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_rollout_length_contract(tiny):
    _, _, cfg, params_t = tiny
    with pytest.raises(ValueError, match="n_steps"):
        td.greedy_generate(params_t, [[1, 2]], 0, cfg, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        td.greedy_generate(params_t, [[1, 2]], 70, cfg, device="cpu")
