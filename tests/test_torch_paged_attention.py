"""The port's paged attention against the JAX package's.

The same numpy pool, queries and page tables go through the JAX Pallas
kernel in interpret mode, the JAX ``paged_attention_ref`` and the port's
plain version.  Tolerance ``atol=1e-5``: f32 on the CPU, the same math
summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.ops import paged_attention as jpa
from kubegpu_tpu_torch.ops import (
    decode_capacity,
    merge_partials,
    page_table_size,
    paged_attention_ref,
)
from kubegpu_tpu_torch.ops.paged_attention import paged_attention

ATOL = 1e-5
L, N_PAGES, HKV, P, D = 2, 12, 2, 8, 16
# row0: prompt 5 (page 7), decode region at 8 with 3 written (page 1);
# row1: prompt 13 (pages 3-4) with a HOLE (id 0) at row-local page 1;
# row2: empty (zeroed table row);
# row3: prompt 3, decode region at 8 with 11 written (pages 2 and 9).
PT = np.array([[7, 1, 2, 0], [3, 0, 5, 6], [0, 0, 0, 0], [4, 2, 9, 0]],
              np.int32)
T = np.array([5, 13, 0, 3], np.int32)
TPAD = np.array([8, 16, 0, 8], np.int32)
DCNT = np.array([3, 0, 0, 11], np.int32)


def _pool(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, N_PAGES, HKV, P, D), np.float32),
            rng.standard_normal((L, N_PAGES, HKV, P, D), np.float32))


@pytest.mark.parametrize("hq", [2, 4, 8, 16],
                         ids=["mha", "gqa2", "gqa4", "folded_c2"])
def test_plain_matches_jax_kernel_and_ref(hq):
    """hq=16 is a GQA-4 query block of C=2 positions folded into the head
    dim (``fold_chunk_queries``)."""
    pk, pv = _pool()
    q = np.random.default_rng(1).standard_normal((4, hq, D), np.float32)
    jargs = (jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
             jnp.asarray(PT), jnp.int32(1), jnp.asarray(T),
             jnp.asarray(TPAD), jnp.asarray(DCNT))
    ker = jpa.paged_attention(*jargs, interpret=True)
    ref = jpa.paged_attention_ref(*jargs)
    out = paged_attention_ref(*map(torch.from_numpy, (q, pk, pv, PT)), 1,
                              *map(torch.from_numpy, (T, TPAD, DCNT)))
    for mine, k_, r_ in zip(out, ker, ref):
        np.testing.assert_allclose(mine.numpy(), np.asarray(k_), atol=ATOL)
        np.testing.assert_allclose(mine.numpy(), np.asarray(r_), atol=ATOL)
    # the empty row: zeros, m = NEG_INF, l = 0
    assert not out[0][2].any() and not out[2][2].any()
    assert (out[1][2] == -1e30).all()


def test_wrapper_takes_plain_version_on_cpu():
    pk, pv = _pool()
    q = torch.from_numpy(
        np.random.default_rng(2).standard_normal((4, 4, D), np.float32))
    args = (q, torch.from_numpy(pk), torch.from_numpy(pv),
            torch.from_numpy(PT), 0, *map(torch.from_numpy, (T, TPAD, DCNT)))
    for a, b in zip(paged_attention(*args), paged_attention_ref(*args)):
        assert torch.equal(a, b)


def test_unported_options_raise():
    pk, pv = map(torch.from_numpy, _pool())
    q = torch.zeros(4, 4, D)
    args = (q, pk, pv, torch.from_numpy(PT), 0,
            *map(torch.from_numpy, (T, TPAD, DCNT)))
    with pytest.raises(NotImplementedError, match="KV-quant"):
        paged_attention(*args, k_scale=torch.ones(1))
    with pytest.raises(NotImplementedError, match="eviction"):
        paged_attention(*args, collect_mass=True)


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(3)
    o1, o2 = (rng.standard_normal((3, 4, D), np.float32) for _ in range(2))
    m1, m2 = (rng.standard_normal((3, 4), np.float32) for _ in range(2))
    l1, l2 = (rng.uniform(0.5, 2, (3, 4)).astype(np.float32)
              for _ in range(2))
    l2[0] = 0.0            # a source with no valid keys drops out
    m2[0] = -1e30
    ref = jpa.merge_partials(*map(jnp.asarray, (o1, m1, l1, o2, m2, l2)))
    out = merge_partials(*map(torch.from_numpy, (o1, m1, l1, o2, m2, l2)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(out[0].numpy(), o1[0], atol=ATOL)


@pytest.mark.parametrize("max_len,page", [(100, 8), (128, 128), (1, 16)])
def test_page_helpers_match_jax(max_len, page):
    assert page_table_size(max_len, page) == jpa.page_table_size(max_len,
                                                                 page)
    for n_pages, t_pad in ((0, 0), (3, 16), (5, 512 // page * page)):
        assert (decode_capacity(n_pages, t_pad, page)
                == jpa.decode_capacity(n_pages, t_pad, page))

