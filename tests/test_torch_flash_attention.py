"""The port's flash attention against the JAX package's.

The same numpy inputs (f32) go through the JAX Pallas kernel in interpret
mode, the JAX ``xla_attention``, and the port's plain version.  Tolerance:
``atol=1e-5`` — the same f32 algorithm on the CPU, summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.ops.flash_attention import flash_attention as jax_flash
from kubegpu_tpu.ops.flash_attention import xla_attention as jax_xla
from kubegpu_tpu_torch.ops import attention, repeat_kv, xla_attention
from kubegpu_tpu_torch.ops.flash_attention import flash_attention

ATOL = 1e-5


# (b, hq, hkv, t, s, causal, block_q, block_k) for the JAX kernel
CASES = {
    "causal_t_eq_s": (2, 4, 4, 64, 64, True, 32, 32),
    "end_aligned_t_lt_s": (1, 4, 2, 32, 96, True, 16, 32),
    "non_causal_group4": (2, 4, 1, 64, 64, False, 32, 32),
    "group1": (1, 2, 2, 48, 48, True, 16, 16),
    "ragged_t": (1, 8, 2, 40, 40, True, 40, 40),
}


def _qkv(b, hq, hkv, t, s, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, t, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_kernel_and_xla(case):
    b, hq, hkv, t, s, causal, bq, bk = CASES[case]
    q, k, v = _qkv(b, hq, hkv, t, s)
    ref_o, ref_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, block_q=bq, block_k=bk,
                               interpret=True, return_lse=True)
    ref_x = jax_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_o), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=ATOL)
    np.testing.assert_allclose(xla_attention(tq, tk, tv, causal).numpy(),
                               np.asarray(ref_x), atol=ATOL)
    np.testing.assert_allclose(
        attention(tq, tk, tv, causal, impl="plain").numpy(),
        np.asarray(ref_x), atol=ATOL)


def test_causal_more_queries_than_keys_raises():
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 2, 16, 8))
    for fn in (flash_attention, xla_attention):
        with pytest.raises(ValueError, match="ill-defined"):
            fn(q, k, v, causal=True)


def test_repeat_kv_is_consecutive():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 4, 4))
    rk, _ = repeat_kv(q, k, v)
    assert torch.equal(rk[:, 0], k[:, 0]) and torch.equal(rk[:, 1], k[:, 0])
    assert torch.equal(rk[:, 2], k[:, 1])
    with pytest.raises(ValueError, match="multiple"):
        repeat_kv(q, k[:, :1].expand(1, 3, 4, 32), v)

