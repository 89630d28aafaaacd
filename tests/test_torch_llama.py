"""The port's Llama forward against the JAX package's, on
``LlamaConfig.tiny()`` with the same (converted) parameters.

Tolerances (f32 on the CPU, same math in another summation order):
``1e-5`` for the norm and rope units, ``1e-4`` for the logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import llama as tl


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jl.LlamaConfig.tiny()
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(), params_t


def test_configs_agree():
    for name in ("llama3_8b", "tiny"):
        cj, ct = getattr(jl.LlamaConfig, name)(), \
            getattr(tl.LlamaConfig, name)()
        for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "max_seq_len", "rope_theta",
                  "norm_eps", "dtype", "remat", "head_dim"):
            assert getattr(cj, f) == getattr(ct, f), (name, f)


def test_init_shapes_and_scales_match(tiny):
    _, params_j, cfg, _ = tiny
    params_t = tl.llama_init(cfg, seed=0, device="cpu")
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): v
              for path, v in jax.tree_util.tree_flatten_with_path(
                  params_j)[0]}
    flat_t = {"embed": params_t["embed"], "final_norm":
              params_t["final_norm"], "lm_head": params_t["lm_head"],
              **{f"layers/{k}": v for k, v in params_t["layers"].items()}}
    assert set(flat_j) == set(flat_t)
    for name, vj in flat_j.items():
        vt = flat_t[name]
        assert tuple(vt.shape) == vj.shape and vt.dtype == torch.float32
        # same distribution: std within 10% of the reference leaf's
        sj, st = float(np.std(np.asarray(vj))), float(vt.std())
        assert abs(st - sj) <= 0.1 * max(sj, 1e-6) or sj == st == 0.0, name


def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16), np.float32)
    w = rng.standard_normal((16,), np.float32)
    np.testing.assert_allclose(
        tl._rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jl._rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=1e-5)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tl._rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0
                 ).numpy(),
        np.asarray(jl._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)),
        atol=1e-5)


@pytest.mark.parametrize("t", [16, 33])
def test_forward_logits_match(tiny, t):
    cfg_j, params_j, cfg, params_t = tiny
    tokens = np.random.default_rng(t).integers(0, cfg.vocab_size, (2, t))
    ref = jl.llama_forward(params_j, jnp.asarray(tokens, jnp.int32), cfg_j)
    out = tl.llama_forward(params_t, torch.from_numpy(tokens), cfg)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_convert_keeps_bf16_bits():
    a = np.asarray(jnp.asarray([[1.5, -2.25], [3e-3, 7.0]], jnp.bfloat16))
    t = convert_llama_params({"w": a}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
