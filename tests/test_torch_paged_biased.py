"""The port's biased paged attention (kernel 7's plain version) and T5's
bucketing against the JAX package's.

The same numpy pool, queries, page tables, positions and bias table go
through the JAX Pallas kernel ``paged_attention_biased`` in interpret mode
and the port's plain version.  Tolerance ``atol=1e-5``: f32 on the CPU, the
same math summed in another order.  Buckets are integers and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models.t5 import rel_pos_bucket as jax_bucket
from kubegpu_tpu.ops import paged_attention as jpa
from kubegpu_tpu_torch.ops import paged_attention_biased_ref, rel_pos_bucket
from kubegpu_tpu_torch.ops.paged_attention import paged_attention_biased

ATOL = 1e-5
L, N_PAGES, P, D = 2, 12, 8, 16
NB, MAX_DIST = 8, 32
# row0: prompt 5 (page 7), decode region at 8 with 3 written (page 1);
# row1: prompt 13 over row-local pages 0-1, whose page 1 is id 0: kernel 7
#       has no hole mask, so it attends page 0's keys;
# row2: empty (zeroed table row);
# row3: prompt 3, decode region at 8 with 11 written (pages 2 and 9).
PT = np.array([[7, 1, 2, 0], [3, 0, 5, 6], [0, 0, 0, 0], [4, 2, 9, 0]],
              np.int32)
T = np.array([5, 13, 0, 3], np.int32)
TPAD = np.array([8, 16, 0, 8], np.int32)
DCNT = np.array([3, 0, 0, 11], np.int32)
# query positions: near the keys, then far enough that every bucket up to
# the clamp (distance >= MAX_DIST) is hit
QPOS = {"near": np.array([11, 13, 0, 19], np.int32),
        "far": np.array([40, 70, 5, 100], np.int32)}


def _inputs(h, seed=0):
    rng = np.random.default_rng(seed)
    pk, pv = (rng.standard_normal((L, N_PAGES, h, P, D), np.float32)
              for _ in range(2))
    q = rng.standard_normal((4, h, D), np.float32)
    table = rng.standard_normal((h, NB), np.float32)
    return q, pk, pv, table


def _torch_args(q, pk, pv, table, qpos):
    return (torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
            torch.from_numpy(PT), 1, *map(torch.from_numpy, (T, TPAD, DCNT)),
            torch.from_numpy(qpos), torch.from_numpy(table))


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("nb,max_dist", [(8, 32), (32, 128)])
def test_buckets_equal_jax(nb, max_dist, bidirectional):
    """Every rel in [-3 max_dist, 3 max_dist]: equal, not close (an ulp of
    the f32 log only flips a bucket where the product lands on an
    integer; for these two shapes that is at n = max_dist, under the
    clamp)."""
    rel = np.arange(-3 * max_dist, 3 * max_dist + 1, dtype=np.int32)
    ref = np.asarray(jax_bucket(jnp.asarray(rel), bidirectional, nb,
                                max_dist))
    got = rel_pos_bucket(torch.from_numpy(rel), bidirectional, nb, max_dist)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # every bucket is hit, the clamp included (bidirectional: the future
    # half starts at distance 1, so its bucket nb/2 + 0 never appears)
    assert set(np.unique(ref)) == set(range(nb)) - (
        {nb // 2} if bidirectional else set())


@pytest.mark.parametrize("qpos", list(QPOS), ids=list(QPOS))
@pytest.mark.parametrize("h", [2, 4])
def test_plain_matches_jax_kernel(h, qpos):
    q, pk, pv, table = _inputs(h)
    jargs = (jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
             jnp.asarray(PT), jnp.int32(1), jnp.asarray(T),
             jnp.asarray(TPAD), jnp.asarray(DCNT), jnp.asarray(QPOS[qpos]),
             jnp.asarray(table))
    ker = jpa.paged_attention_biased(*jargs, bias_max_dist=MAX_DIST,
                                     interpret=True)
    out = paged_attention_biased_ref(*_torch_args(q, pk, pv, table,
                                                  QPOS[qpos]), MAX_DIST)
    for mine, k_ in zip(out, ker):
        assert mine.dtype == torch.float32
        np.testing.assert_allclose(mine.numpy(), np.asarray(k_), atol=ATOL)
    # the empty row: o = 0, m = NEG_INF, l = 0 (merge_partials drops it)
    assert not out[0][2].any() and not out[2][2].any()
    assert (out[1][2] == -1e30).all()


def test_hole_attends_page_zero():
    """A 0 inside a row's used range reads the trash page's keys: changing
    page 0 moves row 1 (prompt over a hole) and no other row."""
    q, pk, pv, table = _inputs(4)
    base = paged_attention_biased_ref(*_torch_args(q, pk, pv, table,
                                                   QPOS["near"]), MAX_DIST)
    pk2, pv2 = pk.copy(), pv.copy()
    pk2[:, 0] += 1.0
    pv2[:, 0] -= 2.0
    moved = paged_attention_biased_ref(*_torch_args(q, pk2, pv2, table,
                                                    QPOS["near"]), MAX_DIST)
    for a, b in zip(base, moved):
        assert not torch.equal(a[1], b[1])
        for r in (0, 2, 3):
            assert torch.equal(a[r], b[r])


def test_wrapper_takes_plain_version_on_cpu():
    q, pk, pv, table = _inputs(4, seed=2)
    args = _torch_args(q, pk, pv, table, QPOS["far"])
    for a, b in zip(paged_attention_biased(*args, bias_max_dist=MAX_DIST),
                    paged_attention_biased_ref(*args, MAX_DIST)):
        assert torch.equal(a, b)


def test_gqa_raises():
    """The bias is per query head over MHA pages (the reference's
    ``bias[:, None, :]`` only broadcasts for Hq == Hkv)."""
    q, pk, pv, table = _inputs(2)
    q4 = np.concatenate([q, q], axis=1)
    args = _torch_args(q4, pk, pv, np.concatenate([table, table]),
                       QPOS["near"])
    with pytest.raises(ValueError, match="MHA"):
        paged_attention_biased(*args, bias_max_dist=MAX_DIST)
    with pytest.raises(ValueError, match="MHA"):
        paged_attention_biased_ref(*args, MAX_DIST)


@pytest.mark.parametrize("needs_grad", ["q", "pool_k", "pool_v", "table"])
def test_gradient_request_raises(needs_grad):
    q, pk, pv, table = _inputs(2)
    args = list(_torch_args(q, pk, pv, table, QPOS["near"]))
    which = {"q": 0, "pool_k": 1, "pool_v": 2, "table": 9}[needs_grad]
    args[which].requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        paged_attention_biased(*args, bias_max_dist=MAX_DIST)
    with torch.no_grad():
        assert paged_attention_biased(
            *args, bias_max_dist=MAX_DIST)[0].shape == (4, 2, D)
