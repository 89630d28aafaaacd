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
from kubegpu_tpu_torch.ops.flash_attention import NEG_INF
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


def model_split_walk(q, pk, pv, pt, layer, t, t_pad, d, q_pos, table,
                     max_dist, n_splits):
    """Kernel 7's split walk in plain PyTorch: a row's pages cut into
    ``n_splits`` splits of ceil(max_pages / n_splits) pages, each split's
    partial (unnormalized acc, m, l) over its valid keys, the weights
    rounded to the pool's type before P.V, then the splits merged in split
    order.  Returns (o normalized, m, l) as the kernel does."""
    b, h, dd = q.shape
    p, max_pages = pk.shape[3], pt.shape[1]
    pps = -(-max_pages // n_splits)
    o = torch.zeros(b, h, dd)
    m = torch.full((b, h), NEG_INF)
    l = torch.zeros(b, h)
    for r in range(b):
        parts = []
        for sp in range(n_splits):
            pages = range(sp * pps, min(sp * pps + pps, max_pages))
            phys = torch.tensor([rl * p + j for rl in pages for j in range(p)],
                                dtype=torch.long)
            ids = pt[r, list(pages)].long()
            k = pk[layer][ids].permute(1, 0, 2, 3).reshape(h, -1, dd)
            v = pv[layer][ids].permute(1, 0, 2, 3).reshape(h, -1, dd)
            valid = (phys < t[r]) | ((phys >= t_pad[r])
                                     & (phys < t_pad[r] + d[r]))
            bucket = rel_pos_bucket(phys - q_pos[r], False, table.shape[1],
                                    max_dist)
            s = torch.einsum("hd,hsd->hs", q[r].float(), k.float()) \
                * dd ** -0.5 + table.float()[:, bucket]
            s = torch.where(valid, s, torch.full_like(s, NEG_INF))
            ms = s.amax(-1) if s.shape[-1] else torch.full((h,), NEG_INF)
            w = torch.where(valid, torch.exp(s - ms[:, None]),
                            torch.zeros_like(s))
            acc = torch.einsum("hs,hsd->hd", w.to(pv.dtype).float(),
                               v.float())
            parts.append((acc, ms, w.sum(-1)))
        mm = torch.stack([x[1] for x in parts]).amax(0)
        ll = sum(torch.exp(ms - mm) * ls for _, ms, ls in parts)
        acc = sum(torch.exp(ms - mm)[:, None] * a for a, ms, _ in parts)
        o[r] = acc / ll.clamp(min=1e-30)[:, None]
        m[r], l[r] = mm, ll
    return o, m, l


# the query sets of the split-walk tests: QPOS's, and one whose queries sit
# on a valid key or before it (distance 0: bucket 0)
SPLIT_QPOS = {**QPOS, "on_key": np.array([4, 12, 0, 1], np.int32)}


@pytest.mark.parametrize("n_splits", [1, 3, 4])
@pytest.mark.parametrize("qpos", list(SPLIT_QPOS), ids=list(SPLIT_QPOS))
def test_split_walk_model_matches_plain_and_jax(qpos, n_splits):
    """The split walk's order (per-split partials merged in split order;
    4 splits is the wrapper's one a page, 3 leaves the last split without
    a page) against ``paged_attention_biased_ref`` and the Pallas kernel 7
    in interpret mode, within ``ATOL``: row 1 attends page 0 through its
    hole and row 2 is empty (o = 0, m = NEG_INF, l = 0)."""
    q, pk, pv, table = _inputs(4, seed=4)
    args = _torch_args(q, pk, pv, table, SPLIT_QPOS[qpos])
    got = model_split_walk(*args, MAX_DIST, n_splits)
    ref = paged_attention_biased_ref(*args, MAX_DIST)
    ker = jpa.paged_attention_biased(
        *(jnp.asarray(x) for x in (q, pk, pv, PT)), jnp.int32(1),
        *(jnp.asarray(x) for x in (T, TPAD, DCNT, SPLIT_QPOS[qpos], table)),
        bias_max_dist=MAX_DIST, interpret=True)
    for mine, r, k_ in zip(got, ref, ker):
        np.testing.assert_allclose(mine.numpy(), r.numpy(), atol=ATOL)
        np.testing.assert_allclose(mine.numpy(), np.asarray(k_), atol=ATOL)
    assert not got[0][2].any() and not got[2][2].any()
    assert (got[1][2] == NEG_INF).all()
    # the hole: row 1's prompt covers its table's 0, and page 0 is attended
    pk0 = pk.copy()
    pk0[:, 0] += 1.0
    moved = model_split_walk(
        *_torch_args(q, pk0, pv, table, SPLIT_QPOS[qpos]), MAX_DIST,
        n_splits)
    assert not torch.equal(moved[0][1], got[0][1])
    assert torch.equal(moved[0][0], got[0][0])


def test_split_walk_cases_hit_every_bucket():
    """The valid keys of the split-walk query sets reach every bucket of
    (NB, MAX_DIST), bucket 0 and the clamp included."""
    phys = torch.arange(PT.shape[1] * P)[None, :]
    t, tpad, d = (torch.from_numpy(x)[:, None] for x in (T, TPAD, DCNT))
    valid = (phys < t) | ((phys >= tpad) & (phys < tpad + d))
    hit = set()
    for qp in SPLIT_QPOS.values():
        bucket = rel_pos_bucket(phys - torch.from_numpy(qp)[:, None].long(),
                                False, NB, MAX_DIST)
        hit |= set(bucket[valid].tolist())
    assert hit == set(range(NB))
