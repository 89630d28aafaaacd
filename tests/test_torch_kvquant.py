"""The port's KV quantizers against ``kubegpu_tpu.ops.kvquant``, byte for
byte: the same numpy inputs, made from a seed, go through both, and every
value, packed byte and scale must be EQUAL (both divide in f32 and round
half to even)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.ops import kvquant as jq
from kubegpu_tpu_torch.ops import kvquant as tq


def _inputs(seed=0, shape=(2, 3, 8, 16)):
    """Normal values with the edge cases planted: an all-zero token row, an
    all-zero [8, D] group, and rows whose values sit exactly on .5 ties of
    the quantization grid (amax 127 or 7, so the scale is exactly 1)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[0, 0, 3] = 0.0                        # zero token row
    x[0, 1] = 0.0                           # zero group (8 tokens)
    x[1, 0, 0] = np.resize([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 127.0], 16)
    x[1, 0, 1:8] = np.resize([0.5, -1.5, 2.5, 6.5, -6.5, 7.0], 16)
    return x


def _eq(mine, ref):
    ref = np.asarray(ref)
    assert mine.dtype == getattr(torch, str(ref.dtype)), (mine.dtype,
                                                          ref.dtype)
    np.testing.assert_array_equal(mine.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_matches_jax(dtype):
    x = _inputs()
    q, s = tq.quantize_rows(torch.from_numpy(x).to(getattr(torch, dtype)))
    rq, rs = jq.quantize_rows(jnp.asarray(x).astype(dtype))
    _eq(q, rq)
    _eq(s, rs)
    assert (s[0, 0, 3] == 1).item() and not q[0, 0, 3].any()
    # ties at scale 1 round half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    assert q[1, 0, 0, :6].tolist() == [0, 2, 2, 0, -2, 4]


@pytest.mark.parametrize("g", [1, 2, 8])
def test_quantize_groups_q4_matches_jax(g):
    x = _inputs(1)
    packed, s = tq.quantize_groups_q4(torch.from_numpy(x), g)
    rp, rs = jq.quantize_groups_q4(jnp.asarray(x), g)
    _eq(packed, rp)
    _eq(s, rs)
    assert packed.shape == (2, 3, 8, 8) and s.shape == (2, 3, 8 // g)
    # the zero group packs to the empty byte and keeps scale 1
    assert (packed[0, 1] == tq.Q4_ZERO_BYTE).all() and (s[0, 1] == 1).all()
    deq = tq.dequantize_q4(packed, s, g)
    _eq(deq, jq.dequantize_q4(rp, rs, g))
    assert deq.dtype == torch.float32 and deq.shape == x.shape


def test_q4_pack_round_trip_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.integers(-7, 8, (4, 5, 32)).astype(np.int32)
    packed = tq.q4_pack(torch.from_numpy(q))
    _eq(packed, jq.q4_pack(jnp.asarray(q)))
    back = tq.q4_unpack(packed)
    _eq(back, jq.q4_unpack(jnp.asarray(np.asarray(packed))))
    np.testing.assert_array_equal(back.numpy(), q)
    # layout: byte d = channel d (low nibble) | channel d + D/2 (high)
    assert packed[0, 0, 0].item() == (q[0, 0, 0] + 8) | ((q[0, 0, 16] + 8) << 4)


def test_empty_byte_dequantizes_to_zero():
    """A page filled with 0x88 is zero under any scale, as the engine's
    unwritten int4 pages must be."""
    page = torch.full((2, 8, 8), tq.Q4_ZERO_BYTE, dtype=torch.uint8)
    scales = torch.tensor([[1.0, 3.5], [1e6, 0.25]])
    out = tq.dequantize_q4(page, scales, 4)
    assert out.shape == (2, 8, 16) and not out.any()
    assert not tq.q4_unpack(page).any()
    _eq(out, jq.dequantize_q4(jnp.asarray(page.numpy()),
                              jnp.asarray(scales.numpy()), 4))
    assert (tq.Q4_BIAS, tq.Q4_ZERO_BYTE) == (jq.Q4_BIAS, jq.Q4_ZERO_BYTE)
