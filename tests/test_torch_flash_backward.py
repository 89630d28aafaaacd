"""The port's flash-attention backward against the JAX package's.

The same numpy inputs (f32) go through the JAX Pallas backward
(``flash_attention_bwd``) in interpret mode, ``jax.grad`` of the JAX
``xla_attention``, the port's plain backward ``flash_attention_bwd_ref``
and the port's ``attention()`` under autograd (``_FlashAttention``, whose
CPU backward is the plain version).  Tolerance: ``atol=2e-5`` — the same
f32 algorithm on the CPU, summed in another order, on gradients of size
~1 (scores of N(0, 1) inputs at head_dim 32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.ops.flash_attention import flash_attention as jax_flash
from kubegpu_tpu.ops.flash_attention import flash_attention_bwd as jax_bwd
from kubegpu_tpu.ops.flash_attention import xla_attention as jax_xla
from kubegpu_tpu_torch.ops import attention
from kubegpu_tpu_torch.ops.flash_attention import (
    _FlashAttention,
    flash_attention,
    flash_attention_bwd_ref,
)

ATOL = 2e-5

# (b, hq, hkv, t, s, causal, block_q, block_k) for the JAX kernels;
# block None: the shape does not tile, so only jax.grad is the reference
CASES = {
    "causal_t_eq_s": (2, 4, 4, 64, 64, True, 32, 32),
    "end_aligned_t_lt_s": (1, 4, 2, 32, 96, True, 16, 32),
    "non_causal": (1, 4, 2, 48, 64, False, 16, 32),
    "group4": (2, 4, 1, 64, 64, True, 32, 32),
    "group1": (1, 2, 2, 48, 48, True, 16, 16),
    "ragged_t": (1, 8, 2, 37, 45, True, None, None),
}


def _inputs(b, hq, hkv, t, s, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, t, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32),
            rng.standard_normal((b, hq, t, d), np.float32))


def _jax_grads(q, k, v, do, causal):
    """jax.grad of the JAX XLA attention: (dq, dk, dv) as numpy."""
    _, vjp = jax.vjp(lambda a, b_, c: jax_xla(a, b_, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax(case):
    b, hq, hkv, t, s, causal, bq, bk = CASES[case]
    q, k, v, do = _inputs(b, hq, hkv, t, s)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    got = flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal)
    assert [tuple(x.shape) for x in got] == [q.shape, k.shape, v.shape]
    refs = [_jax_grads(q, k, v, do, causal)]
    if bq is not None:
        jo, jl = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, block_q=bq, block_k=bk,
                           interpret=True, return_lse=True)
        refs.append([np.asarray(x) for x in jax_bwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jl,
            jnp.asarray(do), causal=causal, block_q=bq, block_k=bk,
            interpret=True)])
    for ref in refs:
        for name, g, r in zip("qkv", got, ref):
            np.testing.assert_allclose(g.numpy(), r, atol=ATOL,
                                       err_msg=f"d{name}")


@pytest.mark.parametrize("case", list(CASES))
def test_attention_autograd_matches_jax(case):
    """Gradients through the port's ``attention()`` (the autograd
    Function) equal ``jax.grad``'s; dk/dv come back at Hkv heads."""
    b, hq, hkv, t, s, causal, _, _ = CASES[case]
    q, k, v, do = _inputs(b, hq, hkv, t, s, seed=1)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention(tq, tk, tv, causal=causal)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__.startswith(_FlashAttention.__name__)
    out.backward(torch.from_numpy(do))
    for name, x, r in zip("qkv", (tq, tk, tv),
                          _jax_grads(q, k, v, do, causal)):
        assert x.grad.shape == x.shape
        np.testing.assert_allclose(x.grad.numpy(), r, atol=ATOL,
                                   err_msg=f"d{name}")


def test_attention_without_grad_skips_the_function():
    """Serving runs under ``no_grad``: the forward alone, no lse."""
    q, k, v, _ = map(torch.from_numpy, _inputs(1, 4, 2, 16, 16))
    with torch.no_grad():
        assert attention(q.requires_grad_(), k, v).grad_fn is None
    assert attention(q.detach(), k, v).grad_fn is None
