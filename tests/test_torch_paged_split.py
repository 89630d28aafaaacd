"""The split walk of kernels 4-6 (``csrc/paged_decode.cuh`` namespace
``split``), modelled in plain PyTorch, against the port's
``paged_attention_ref`` and the JAX package's Pallas kernels 4-6 in
interpret mode.

The model repeats the walk's arithmetic: a row's pages cut into splits of
ceil(max_pages / n_splits) pages, each split's partial (acc, m, l) per
query head over its used pages (a page is used when it holds a valid key
and, without the bias, its table entry is not the hole 0), the weights
rounded to q's type after the v-scale before P.V, the splits merged in
split order, and per page and head the split's sum of weights with its
max, rescaled to the final (M, L), summed over each chunk of <= 8 query
heads, then over the (kv head, chunk) partials in order, and divided by
Hq.  With a bias (kernel 7's case) there is no hole mask.

The same numpy pools (quantized by the JAX quantizers), queries and page
tables go through all three.  Tolerances: ``ATOL = 1e-5`` plus ``RTOL =
1e-6`` of the value in f32 (the same math summed in another order); in
bf16 o within ``BF16_O = 1e-2`` (both round the weights to bf16 before
P.V, but against different maxima: the split's, the TPU kernel's running
one or the row's final one, so a weight may round one bf16 ulp apart), m,
l and the mass within ``ATOL`` (they are taken from the unrounded f32
weights).  Every row's ``t_pad`` is a multiple of the page size, as the
engine's prompt buckets are.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.ops import kvquant as jq
from kubegpu_tpu.ops import paged_attention as jpa
from kubegpu_tpu_torch.ops.flash_attention import NEG_INF
from kubegpu_tpu_torch.ops.kvquant import q4_unpack
from kubegpu_tpu_torch.ops.paged_attention import (
    _GMAX,
    _MAX_SPLITS,
    paged_attention_ref,
    rel_pos_bucket,
)

ATOL = 1e-5
RTOL = 1e-6
BF16_O = 1e-2
L, HKV, P, D = 2, 2, 8, 16
# row0: prompt 5 (page 7), decode region at 8 with 3 written (page 1);
# row1: prompt 13 over row-local pages 0-1, whose page 1 is the hole 0;
# row2: empty (zeroed table row);
# row3: prompt 3, decode region at 8 with 11 written (pages 2 and 9).
EDGE = ([[7, 1, 2, 0], [3, 0, 5, 6], [0, 0, 0, 0], [4, 2, 9, 0]],
        [5, 13, 0, 3], [8, 16, 0, 8], [3, 0, 0, 11])
# 40 pages a row (32 splits of 2 pages): a long prompt with a hole at
# row-local page 7, a prompt with a decode region far past it, a decode
# region alone, and an empty row
_W = 40
_HOLED = [1 + i if i != 7 else 0 for i in range(_W)]
WIDE = ([_HOLED, list(range(_W + 1, 2 * _W + 1)),
         list(range(2 * _W + 1, 3 * _W + 1)), [0] * _W],
        [300, 30, 0, 0], [304, 64, 0, 0], [0, 200, 129, 0])


def _inputs(layout, fmt, hq, dtype, seed=0):
    """numpy (q, pool_k, pool_v, k_scale, v_scale, pt, t, t_pad, d) for a
    layout (EDGE or WIDE) in format ``f32`` (a pool of q's type), ``q8``
    (int8, one scale a key) or ``q4g<g>``; ``dtype`` is q's (and a plain
    pool's) type, ``float32``
    or ``bfloat16``; bf16 arrays are rounded once, by JAX, and passed to
    both sides as the same bits."""
    pt, t, tpad, d = (np.asarray(x, np.int32) for x in layout)
    rng = np.random.default_rng(seed)
    n_pages = int(pt.max()) + 1
    raw = [rng.standard_normal((L, n_pages, HKV, P, D), np.float32)
           for _ in range(2)]
    q = rng.standard_normal((pt.shape[0], hq, D), np.float32)
    cast = (lambda x: x) if dtype == "float32" else (
        lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16)))
    q = cast(q)
    if fmt == "f32":
        pk, pv, ks, vs = cast(raw[0]), cast(raw[1]), None, None
    elif fmt == "q8":
        (pk, ks), (pv, vs) = (tuple(np.asarray(a) for a in jq.quantize_rows(
            jnp.asarray(x))) for x in raw)
    else:
        g = int(fmt[3:])
        (pk, ks), (pv, vs) = (
            tuple(np.asarray(a) for a in jq.quantize_groups_q4(
                jnp.asarray(x), g)) for x in raw)
    return q, pk, pv, ks, vs, pt, t, tpad, d


def _torch(x):
    """A numpy array as a tensor; bf16 (JAX's ml_dtypes) keeps its bits."""
    if x is None:
        return None
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _jax_kernel(inp, collect_mass=True):
    q, pk, pv, ks, vs, pt, t, tpad, d = inp
    sc = (None, None) if ks is None else (jnp.asarray(ks), jnp.asarray(vs))
    out = jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pt),
        jnp.int32(1), jnp.asarray(t), jnp.asarray(tpad), jnp.asarray(d), *sc,
        interpret=True, collect_mass=collect_mass)
    return [np.asarray(x).astype(np.float32) for x in out]


def _ref(inp, collect_mass=True):
    q, pk, pv, ks, vs, pt, t, tpad, d = map(_torch, inp)
    return paged_attention_ref(q, pk, pv, pt, 1, t, tpad, d, ks, vs,
                               collect_mass=collect_mass)


def model_split_walk(q, pk, pv, pt, layer, t, t_pad, d, n_splits,
                     k_scale=None, v_scale=None, bias=None, round_pv=True):
    """The split walk in plain PyTorch.  q: [B, Hq, D] (f32 or bf16); pool:
    [L, n_pages, Hkv, P, D] of q's type, int8 with per-key scales [L,
    n_pages, Hkv, P] or packed int4 (uint8, [..., D/2]) with group scales
    [L, n_pages, Hkv, P/g]; ``bias``: (q_pos, table, max_dist) for kernel
    7's T5 bias (MHA, no hole mask).  ``round_pv``: round the P.V weights
    to q's type (the kernels and the reference do).  Returns (o, m, l,
    mass) as kernels 4-6 do (kernel 7 has no mass)."""
    b, hq, dd = q.shape
    hkv, p = pk.shape[2], pk.shape[3]
    grp, max_pages = hq // hkv, pt.shape[1]
    pps = -(-max_pages // n_splits)
    kl, vl = pk[layer], pv[layer]
    if pk.dtype == torch.uint8:
        kl, vl = q4_unpack(kl), q4_unpack(vl)
    kl, vl = kl.to(q.dtype).float(), vl.to(q.dtype).float()

    def per_key(sc):   # [n_pages, Hkv, P]: each key's scale
        if sc is None:
            return torch.ones(kl.shape[:3])
        return sc[layer].repeat_interleave(p // sc.shape[-1], dim=-1)
    ksk, vsk = per_key(k_scale), per_key(v_scale)
    o = torch.zeros(b, hq, dd)
    m = torch.full((b, hq), NEG_INF)
    l = torch.zeros(b, hq)
    mass = torch.zeros(b, max_pages)
    for r in range(b):
        tb, tp, db = int(t[r]), int(t_pad[r]), int(d[r])

        def extent(rl):   # the page's used rows [0, hi); 0: not walked
            k0 = rl * p
            hi = min(p, tb - k0) if k0 < tb else 0
            if db > 0 and k0 < tp + db and k0 + p > tp:
                hi = max(hi, min(p, tp + db - k0))
            return hi if bias is not None or pt[r, rl] != 0 else 0
        parts_mass = []
        for hk in range(hkv):
            for c0 in range(0, grp, _GMAX):
                heads = list(range(hk * grp + c0,
                                   hk * grp + min(grp, c0 + _GMAX)))
                qh = q[r, heads].float()                     # [n, D]
                parts, recs = [], {}
                for sp in range(n_splits):
                    pages = [rl for rl in range(sp * pps,
                                                min(sp * pps + pps, max_pages))
                             if extent(rl) > 0]
                    s_all, v_all, vs_all, page_of = [], [], [], []
                    for rl in pages:
                        pid = int(pt[r, rl])
                        phys = rl * p + torch.arange(p)
                        ok = (phys < tb) | ((phys >= tp) & (phys < tp + db))
                        s = qh @ kl[pid, hk].T * dd ** -0.5 * ksk[pid, hk]
                        if bias is not None:
                            q_pos, table, max_dist = bias
                            bucket = rel_pos_bucket(phys - int(q_pos[r]),
                                                    False, table.shape[1],
                                                    max_dist)
                            s = s + table.float()[heads][:, bucket]
                        s_all.append(s[:, ok])
                        v_all.append(vl[pid, hk][ok])
                        vs_all.append(vsk[pid, hk][ok])
                        page_of += [rl] * int(ok.sum())
                    if not page_of:
                        parts.append((torch.zeros(len(heads), dd),
                                      torch.full((len(heads),), NEG_INF),
                                      torch.zeros(len(heads))))
                        continue
                    s = torch.cat(s_all, dim=1)
                    ms = s.amax(dim=1)
                    w = torch.exp(s - ms[:, None])
                    wv = w * torch.cat(vs_all)[None, :]
                    if round_pv:
                        wv = wv.to(q.dtype).float()
                    parts.append((wv @ torch.cat(v_all), ms, w.sum(dim=1)))
                    page_of = torch.tensor(page_of)
                    for rl in pages:
                        recs[rl] = (w[:, page_of == rl].sum(dim=1), ms)
                # the splits merged in split order
                mm = torch.stack([x[1] for x in parts]).amax(dim=0)
                f = [torch.exp(x[1] - mm) for x in parts]
                ll = sum(fi * x[2] for fi, x in zip(f, parts))
                acc = sum(fi[:, None] * x[0] for fi, x in zip(f, parts))
                o[r, heads] = acc / ll.clamp(min=1e-30)[:, None]
                m[r, heads], l[r, heads] = mm, ll
                part = torch.zeros(max_pages)
                for rl, (lp, ms) in recs.items():
                    part[rl] = (lp * torch.exp(ms - mm)
                                / ll.clamp(min=1e-30)).sum()
                parts_mass.append(part)
        mass[r] = sum(parts_mass) / hq
    return o, m, l, mass


def _model(inp, n_splits, **kw):
    q, pk, pv, ks, vs, pt, t, tpad, d = map(_torch, inp)
    return model_split_walk(q, pk, pv, pt, 1, t, tpad, d, n_splits, ks, vs,
                            **kw)


def _close(got, want, bf16):
    """o within BF16_O in bf16, everything else within ATOL plus RTOL of
    the value (l sums up to 300 weights of ~1 on the wide tables)."""
    for i, (a, w) in enumerate(zip(got, want)):
        a = a.numpy() if torch.is_tensor(a) else a
        w = w.float().numpy() if torch.is_tensor(w) else w
        np.testing.assert_allclose(a, w, atol=BF16_O if bf16 and i == 0
                                   else ATOL, rtol=RTOL)


CASES = [(fmt, hq, dtype) for fmt in ("f32", "q8", "q4g1", "q4g4", "q4g8")
         for hq, dtype in ((2, "float32"), (8, "float32"), (32, "float32"),
                           (8, "bfloat16"))]


@pytest.mark.parametrize("n_splits", [1, 3, 4])
@pytest.mark.parametrize("fmt,hq,dtype", CASES)
def test_model_matches_ref_and_jax_kernels(fmt, hq, dtype, n_splits):
    """Over the edge rows (a hole, an empty row, decode pages past t_pad):
    G = 1, 4 and 16 (folded queries: two chunks of 8 query heads), pools of
    q's type (kernel 4), int8 with a scale a key (kernel 5) and int4
    groups of 1, 4 and P (kernel 6), one split, 3 splits of 2 pages (the
    last one empty) and one split a page."""
    inp = _inputs(EDGE, fmt, hq, dtype)
    got = _model(inp, n_splits)
    bf16 = dtype == "bfloat16"
    _close(got, _ref(inp), bf16)
    _close(got, _jax_kernel(inp), bf16)
    o, m, l, mass = got
    assert not o[2].any() and not l[2].any() and not mass[2].any()
    assert (m[2] == NEG_INF).all()
    assert mass[1, 1] == 0                      # the hole
    assert (mass.sum(dim=1) <= 1 + ATOL).all()


@pytest.mark.parametrize("fmt,dtype", [("f32", "float32"),
                                       ("q8", "bfloat16"),
                                       ("q4g4", "float32"),
                                       ("q4g8", "bfloat16")])
def test_model_on_tables_wider_than_32_pages(fmt, dtype):
    """40 pages a row and the wrapper's split count (32 splits, 2 pages
    each, so a split records the mass of two pages): the long prompt's
    hole gets no mass and the pages past its prompt none either."""
    inp = _inputs(WIDE, fmt, 8, dtype, seed=1)
    n_splits = min(_W, _MAX_SPLITS)
    assert -(-_W // n_splits) == 2
    got = _model(inp, n_splits)
    bf16 = dtype == "bfloat16"
    _close(got, _ref(inp), bf16)
    _close(got, _jax_kernel(inp), bf16)
    mass = got[3]
    assert mass[0, 7] == 0 and not mass[0, 38:].any() and not mass[3].any()


def _few_keys(fmt, seed=3):
    """bf16, V = 1, and rows of 2-4 valid keys at the start of one page."""
    rng = np.random.default_rng(seed)
    pt = np.array([[3, 0], [5, 0], [0, 7]], np.int32)
    t, tpad, d = (np.array(x, np.int32) for x in ([3, 0, 0], [8, 0, 8],
                                                   [0, 4, 2]))
    k = rng.standard_normal((L, 8, HKV, P, D), np.float32)
    v = np.ones_like(k)
    q = rng.standard_normal((3, 8, D), np.float32)
    bf = (lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16)))
    if fmt == "f32":
        return bf(q), bf(k), bf(v), None, None, pt, t, tpad, d
    if fmt == "q8":
        (kq, ks), (vq, vs) = (tuple(np.asarray(a) for a in jq.quantize_rows(
            jnp.asarray(x))) for x in (k, v))
        return bf(q), kq, vq, ks, vs, pt, t, tpad, d
    (kq, ks), (vq, vs) = (tuple(np.asarray(a) for a in jq.quantize_groups_q4(
        jnp.asarray(x), int(fmt[3:]))) for x in (k, v))
    return bf(q), kq, vq, ks, vs, pt, t, tpad, d


@pytest.mark.parametrize("fmt", ["f32", "q8", "q4g4"])
def test_weights_are_rounded_before_pv(fmt):
    """The fault the kernels had: the TPU kernels round each P.V weight to
    q's type (after the v-scale), so with V = 1 and a few keys o is off 1
    by the rounding.  The Pallas kernel in interpret mode, the port's plain
    version and the model agree on it within ATOL (all of a row's keys lie
    in one page, so every side rounds against the row's final max); the
    same model without the rounding puts o at 1."""
    inp = _few_keys(fmt)
    ker, ref = _jax_kernel(inp), _ref(inp)
    got = _model(inp, 2)
    for a, k_, r_ in zip(got, ker, ref):
        np.testing.assert_allclose(a.numpy(), k_, atol=ATOL, rtol=0)
        np.testing.assert_allclose(a.numpy(), r_.numpy(), atol=ATOL, rtol=0)
    off = np.abs(ker[0] - 1).max()
    assert 1e-4 < off < 1e-2
    unrounded = _model(inp, 2, round_pv=False)[0]
    np.testing.assert_allclose(unrounded.numpy(), 1.0, atol=1e-6)


def test_page_zero_moves_kernel7_only():
    """A 0 inside a row's used range: with the bias (kernel 7) the walk
    attends page 0's keys, so editing page 0 moves that row; with the hole
    mask (kernels 4-6) it does not, and the edited model still equals
    the plain version."""
    inp = list(_inputs(EDGE, "f32", HKV, "float32", seed=5))
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.standard_normal((HKV, 8), np.float32))
    bias = (torch.tensor([11, 13, 0, 19]), table, 32)
    base_b = _model(inp, 4, bias=bias)
    base_h = _model(inp, 4)
    inp[1] = inp[1].copy()
    inp[1][:, 0] += 1.0
    moved_b = _model(inp, 4, bias=bias)
    moved_h = _model(inp, 4)
    assert not torch.equal(moved_b[0][1], base_b[0][1])
    for a, b_ in zip(moved_h, base_h):
        assert torch.equal(a, b_)
    _close(moved_h, _ref(inp), False)
