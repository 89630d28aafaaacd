"""The port's plain paged attention over int8 and packed-int4 pools, and its
per-page attention mass on all three pool formats, against the JAX
package's Pallas kernels 4-6 in interpret mode and its
``paged_attention_ref``.

The same numpy pools (quantized from a seeded normal pool by the JAX
quantizers), queries and page tables go through all three; tolerance
``atol=1e-5``: f32 on the CPU, the same math summed in another order.
The layout (holes, an empty row, decode pages past ``t_pad``) is
``tests/test_torch_paged_attention.py``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.ops import kvquant as jq
from kubegpu_tpu.ops import paged_attention as jpa
from kubegpu_tpu_torch.ops import kvquant as tq
from kubegpu_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_ref,
)

ATOL = 1e-5
L, N_PAGES, HKV, P, D = 2, 12, 2, 8, 16
PT = np.array([[7, 1, 2, 0], [3, 0, 5, 6], [0, 0, 0, 0], [4, 2, 9, 0]],
              np.int32)
T = np.array([5, 13, 0, 3], np.int32)
TPAD = np.array([8, 16, 0, 8], np.int32)
DCNT = np.array([3, 0, 0, 11], np.int32)


def _pools(fmt: str, seed=0):
    """(pool_k, pool_v, k_scale, v_scale) as numpy, in format ``bf16``
    (f32 here), ``q8`` or ``q4g<g>``."""
    rng = np.random.default_rng(seed)
    raw = [rng.standard_normal((L, N_PAGES, HKV, P, D), np.float32)
           for _ in range(2)]
    if fmt == "f32":
        return raw[0], raw[1], None, None
    if fmt == "q8":
        (kq, ks), (vq, vs) = (jq.quantize_rows(jnp.asarray(x)) for x in raw)
    else:
        g = int(fmt[3:])
        (kq, ks), (vq, vs) = (jq.quantize_groups_q4(jnp.asarray(x), g)
                              for x in raw)
    return tuple(np.array(a) for a in (kq, vq, ks, vs))


def _run_all(fmt, hq, collect_mass, seed=0):
    pk, pv, ks, vs = _pools(fmt, seed)
    q = np.random.default_rng(seed + 1).standard_normal((4, hq, D),
                                                        np.float32)
    jargs = (jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
             jnp.asarray(PT), jnp.int32(1), jnp.asarray(T),
             jnp.asarray(TPAD), jnp.asarray(DCNT))
    jsc = (None, None) if ks is None else (jnp.asarray(ks), jnp.asarray(vs))
    ker = jpa.paged_attention(*jargs, *jsc, interpret=True,
                              collect_mass=collect_mass)
    ref = jpa.paged_attention_ref(*jargs, *jsc, collect_mass=collect_mass)
    tsc = (None, None) if ks is None else (torch.from_numpy(ks),
                                           torch.from_numpy(vs))
    targs = (*map(torch.from_numpy, (q, pk, pv, PT)), 1,
             *map(torch.from_numpy, (T, TPAD, DCNT)), *tsc)
    mine = paged_attention_ref(*targs, collect_mass=collect_mass)
    return mine, ker, ref, targs


CASES = [(fmt, hq, mass) for fmt, hq in (
    ("q8", 4), ("q8", 16), ("q4g1", 4), ("q4g2", 4), ("q4g8", 4),
    ("q4g2", 16)) for mass in (False, True)] + [("f32", 4, True),
                                                ("f32", 16, True)]


@pytest.mark.parametrize("fmt,hq,collect_mass", CASES, ids=[
    f"{f}-hq{h}-{'mass' if m else 'partials'}" for f, h, m in CASES])
def test_plain_matches_jax_kernels_and_ref(fmt, hq, collect_mass):
    """hq=16 is a GQA-4 query block of C=2 positions folded into the head
    dim (``fold_chunk_queries``); q4g8 is one scale per page (g = P).  The
    f32 pool's partials without mass are tests/test_torch_paged_attention.py's."""
    mine, ker, ref, _ = _run_all(fmt, hq, collect_mass)
    assert len(mine) == len(ker) == len(ref) == (4 if collect_mass else 3)
    for a, k_, r_ in zip(mine, ker, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(k_), atol=ATOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(r_), atol=ATOL)
    assert not mine[0][2].any() and not mine[2][2].any()   # the empty row
    if collect_mass:
        mass = mine[3]
        assert mass.shape == (4, PT.shape[1])
        assert (mass.sum(dim=1) <= 1 + 1e-5).all() and (mass >= 0).all()
        assert not mass[2].any()                 # the empty row
        assert mass[1, 1] == 0                   # the hole
        assert mass[0, 2] == 0 and mass[0, 3] == 0   # pages never walked
        np.testing.assert_allclose(mass.sum(dim=1).numpy()[[0, 1, 3]], 1.0,
                                   atol=ATOL)


@pytest.mark.parametrize("fmt", ["q8", "q4g2"])
def test_wrapper_takes_plain_version_on_cpu(fmt):
    *_, targs = _run_all(fmt, 4, False)
    got = paged_attention(*targs, collect_mass=True)
    for a, b in zip(got, paged_attention_ref(*targs, collect_mass=True)):
        assert torch.equal(a, b)


def test_int4_pool_without_scales_raises():
    pk, pv, _, _ = _pools("q4g2")
    args = (torch.zeros(4, 4, D), *map(torch.from_numpy, (pk, pv, PT)), 1,
            *map(torch.from_numpy, (T, TPAD, DCNT)))
    with pytest.raises(ValueError, match="int4"):
        paged_attention(*args)
    with pytest.raises(ValueError, match="int4"):
        jpa.paged_attention(*(jnp.asarray(a.numpy()) if torch.is_tensor(a)
                              else a for a in args), interpret=True)


def test_empty_int4_pages_attend_as_zero():
    """Pages of the engine's empty byte 0x88 hold zero keys and values: a
    row over them gives o = 0 and equal weights, under any scale."""
    pk = torch.full((L, N_PAGES, HKV, P, D // 2), tq.Q4_ZERO_BYTE,
                    dtype=torch.uint8)
    sc = torch.rand(L, N_PAGES, HKV, P // 2) * 10
    q = torch.randn(4, 4, D)
    o, m, l, mass = paged_attention_ref(
        q, pk, pk, torch.from_numpy(PT), 0,
        *map(torch.from_numpy, (T, TPAD, DCNT)), sc, sc, collect_mass=True)
    assert not o.any()
    keys = torch.tensor([8, 8, 0, 14], dtype=torch.float32)  # valid per row
    np.testing.assert_allclose(l.numpy(), keys[:, None].expand(4, 4).numpy())
    # equal weights: a page's mass is its share of the row's valid keys
    np.testing.assert_allclose(mass[3].numpy(), [3 / 14, 8 / 14, 3 / 14, 0],
                               atol=ATOL)
