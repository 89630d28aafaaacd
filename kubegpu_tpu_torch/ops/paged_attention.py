"""Paged decode attention: hand-written Hopper kernels plus their plain
version (counterpart of ``kubegpu_tpu/ops/paged_attention.py``).

The pool is ``[L, n_pages, Hkv, P, D]`` shared by every slot; a per-row
page table maps row-local page index to pool page id, and page 0 is the
trash page (and the eviction hole), which never counts as a key.  Per row,
valid keys are ``phys < t | t_pad <= phys < t_pad + d``.  Both versions
return the softmax partials ``(o normalized, m, l)`` for
:func:`merge_partials` and, with ``collect_mass``, the per-page attention
mass the engine's mass eviction reads.

Three page formats, told apart by the pool's dtype: bf16/f32 pages of q's
type (kernel 4), int8 pages with per-token f32 scales ``[L, n_pages, Hkv,
P]`` (kernel 5), and packed int4 pages (uint8 ``[..., D/2]``, see
:mod:`kubegpu_tpu_torch.ops.kvquant`) with one f32 scale per group of
tokens ``[L, n_pages, Hkv, P/g]`` (kernel 6).
"""

from __future__ import annotations

import torch

from kubegpu_tpu_torch import kernels
from kubegpu_tpu_torch.ops.flash_attention import KERNEL_MAX_HEAD_DIM, NEG_INF
from kubegpu_tpu_torch.ops.kvquant import q4_unpack

# keys per chunk and query heads per CTA of csrc/paged_decode.cuh: they size
# the scratch of the mass output
_KC, _GMAX = 32, 8


def page_table_size(max_len: int, page_size: int) -> int:
    """Row-local page count covering ``max_len`` physical positions."""
    return -(-max_len // page_size)


def decode_capacity(n_pages: int, t_pad: int, page_size: int) -> int:
    """Decode positions a row's allocation can hold: everything its
    ``n_pages`` pages cover past the page-aligned prompt region."""
    return max(n_pages * page_size - t_pad, 0)


def merge_partials(o1, m1, l1, o2, m2, l2) -> torch.Tensor:
    """Combine two normalized softmax partials over disjoint key sets
    (flash decoding's split merge).  o: [B, Hq, D] f32; m/l: [B, Hq].
    Sources with no valid keys (l == 0) drop out exactly."""
    m = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - m) * l1
    w2 = torch.exp(m2 - m) * l2
    tot = torch.clamp(w1 + w2, min=1e-30)
    return (o1 * w1[..., None] + o2 * w2[..., None]) / tot[..., None]


def paged_attention_ref(q, pool_k, pool_v, page_table, layer, t, t_pad, d,
                        k_scale=None, v_scale=None, collect_mass=False):
    """Gather-based plain version.  q: [B, Hq, D]; pool: [L, n_pages, Hkv,
    P, D] (uint8 pools: packed int4, [..., D/2]); page_table: [B,
    max_pages] int32; layer: int; t/t_pad/d: [B] int32; k_scale/v_scale:
    f32 [L, n_pages, Hkv, P] per token (int8) or [L, n_pages, Hkv, P/g] per
    group of g tokens (int4).  The k-scale multiplies the scores after
    ``* D^-0.5``; the v-scale multiplies the weights after l and the mass
    are taken, before the P.V product.  Returns (o [B, Hq, D] f32
    normalized, m [B, Hq] f32, l [B, Hq] f32), plus with ``collect_mass``
    the per-page normalized mass [B, max_pages] (mean over query heads, so
    a row sums to at most 1; holes and pages never walked get 0)."""
    b, hq, dd = q.shape
    hkv, p = pool_k.shape[2], pool_k.shape[3]
    g = hq // hkv
    max_pages = page_table.shape[1]
    s_len = max_pages * p
    pt = page_table.long()
    kl, vl = pool_k[layer], pool_v[layer]     # [n_pages, Hkv, P, D]
    if pool_k.dtype == torch.uint8:          # packed int4 pages
        kl, vl = q4_unpack(kl), q4_unpack(vl)
    # [B, max_pages, Hkv, P, D] -> [B, Hkv, S, D]
    k = kl[pt].permute(0, 2, 1, 3, 4).reshape(b, hkv, s_len, dd)
    v = vl[pt].permute(0, 2, 1, 3, 4).reshape(b, hkv, s_len, dd)

    def per_token(sc):
        st = sc[layer][pt].permute(0, 2, 1, 3).reshape(b, hkv, -1)
        if st.shape[-1] != s_len:   # int4 group scales -> per token
            st = st.repeat_interleave(s_len // st.shape[-1], dim=-1)
        return st

    qg = q.reshape(b, hkv, g, dd)
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                     k.to(q.dtype).float()) * (dd ** -0.5)
    if k_scale is not None:
        s = s * per_token(k_scale)[:, :, None, :]
    phys = torch.arange(s_len, device=q.device)[None, :]
    t, t_pad, d = t[:, None], t_pad[:, None], d[:, None]
    valid = (phys < t) | ((phys >= t_pad) & (phys < t_pad + d))
    valid = valid & (pt.repeat_interleave(p, dim=1) != 0)
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    w = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = w.sum(dim=-1)
    if collect_mass:
        wn = w / torch.clamp(l, min=1e-30)[..., None]
        mass = wn.reshape(b, hkv, g, max_pages, p).sum(dim=(1, 2, 4)) / hq
    if v_scale is not None:
        w = w * per_token(v_scale)[:, :, None, :]
        v = v.to(q.dtype)
    o = torch.einsum("bkgs,bksd->bkgd", w.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    out = (o.reshape(b, hq, dd), m.reshape(b, hq), l.reshape(b, hq))
    return out + (mass,) if collect_mass else out


_layer_ids: dict[tuple, torch.Tensor] = {}


def _layer_ptr(layer, n_layers: int, device) -> int:
    """Device address of an int32 holding ``layer``: the kernel reads its
    layer index itself, like the TPU kernel's scalar prefetch."""
    if isinstance(layer, torch.Tensor):
        if layer.dtype != torch.int32 or layer.numel() != 1 \
                or layer.device != device:
            raise ValueError("layer tensor must be one int32 on q's device")
        return layer.data_ptr()
    layer = int(layer)
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} not in [0, {n_layers})")
    key = (str(device), n_layers)
    if key not in _layer_ids:
        _layer_ids[key] = torch.arange(n_layers, dtype=torch.int32,
                                       device=device)
    return _layer_ids[key].data_ptr() + 4 * layer


def _paged_cuda(q, pool_k, pool_v, page_table, layer, t, t_pad, d,
                k_scale, v_scale, collect_mass):
    b, hq, dd = q.shape
    n_layers, n_pages, hkv, p, row = pool_k.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged kernel takes bf16/f32 queries, got {q.dtype}")
    if pool_v.dtype != pool_k.dtype or pool_v.shape != pool_k.shape:
        raise ValueError("pool_k and pool_v must share one dtype and shape")
    quant = pool_k.dtype in (torch.int8, torch.uint8)
    if quant:
        name = "paged_decode_q4" if pool_k.dtype == torch.uint8 \
            else "paged_decode_q8"
        want_row = dd // 2 if pool_k.dtype == torch.uint8 else dd
        if pool_k.dtype == torch.uint8 and dd % 2:
            raise ValueError(f"int4 pages need an even head_dim, got {dd}")
        if k_scale is None or v_scale is None:
            raise ValueError(f"{pool_k.dtype} pool requires k_scale and "
                             "v_scale")
        n_sc = k_scale.shape[-1]
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or sc.shape != k_scale.shape \
                    or sc.shape[:3] != pool_k.shape[:3] or not 0 < n_sc <= p \
                    or p % n_sc or (pool_k.dtype == torch.int8 and n_sc != p):
                raise ValueError(f"scales {tuple(sc.shape)} {sc.dtype} do "
                                 f"not fit pool {tuple(pool_k.shape)} "
                                 f"{pool_k.dtype}")
    else:
        name, want_row, n_sc = "paged_decode", dd, 0
        if pool_k.dtype != q.dtype:
            raise TypeError("q and a bf16/f32 pool must share one dtype")
        if k_scale is not None or v_scale is not None:
            raise ValueError("scales go with int8/uint8 pools only")
    if row != want_row or hq % hkv:
        raise ValueError(f"pool {tuple(pool_k.shape)} {pool_k.dtype} does "
                         f"not fit q {tuple(q.shape)}")
    if not 0 < dd <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dd} not in [1, {KERNEL_MAX_HEAD_DIM}]")
    for label, x in (("page_table", page_table), ("t", t), ("t_pad", t_pad),
                     ("d", d)):
        if x.dtype != torch.int32 or x.device != q.device:
            raise TypeError(f"{label} must be int32 on {q.device}")
    if page_table.shape[0] != b or not (t.shape == t_pad.shape == d.shape
                                        == (b,)):
        raise ValueError("page_table/t/t_pad/d must have one row per query")
    tensors = (q, pool_k, pool_v, page_table, t, t_pad, d) + (
        (k_scale, v_scale) if quant else ())
    if not all(x.is_contiguous() and x.device == q.device for x in tensors):
        raise ValueError("paged kernel needs contiguous tensors on one device")
    max_pages = page_table.shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((b, hq, dd), **f32)
    m = torch.empty((b, hq), **f32)
    l = torch.empty((b, hq), **f32)
    mass = scratch = None
    n_scratch = 0
    if collect_mass:
        mass = torch.empty((b, max_pages), **f32)
        # per CTA: a (sum, max) record per chunk and query head, then one
        # partial per page
        ctas = b * hkv * -(-(hq // hkv) // _GMAX)
        n_scratch = ctas * max_pages * (-(-p // _KC) * _GMAX * 2 + 1)
        scratch = torch.empty(max(n_scratch, 1), **f32)
    if b:
        ptr = (lambda x: None if x is None else x.data_ptr())
        kernels.call(name, q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                     ptr(k_scale), ptr(v_scale), page_table.data_ptr(),
                     _layer_ptr(layer, n_layers, q.device), t.data_ptr(),
                     t_pad.data_ptr(), d.data_ptr(), o.data_ptr(),
                     m.data_ptr(), l.data_ptr(), ptr(mass), ptr(scratch), b,
                     hq, hkv, n_pages, p, dd, max_pages, n_sc, n_scratch,
                     int(q.dtype == torch.bfloat16))
    out = (o, m, l)
    return out + (mass,) if collect_mass else out


def paged_attention(q, pool_k, pool_v, page_table, layer, t, t_pad, d,
                    k_scale=None, v_scale=None, collect_mass=False):
    """Paged decode attention over one layer of the pool; same signature
    and outputs as :func:`paged_attention_ref`.  CUDA tensors launch the
    Hopper kernel of the pool's format, which reads only the pages each
    row holds: ``csrc/paged_decode.cu`` for bf16/f32 pools, ``_q8.cu`` for
    int8 and ``_q4.cu`` for packed int4 (uint8); CPU tensors run the plain
    version.  A uint8 pool without scales raises ``ValueError``, as the
    reference does.

    There is no gradient, as the reference's ``pallas_call`` has none under
    ``jax.grad``: with grad enabled and an input that requires it, this
    raises rather than return a result that autograd cannot see through."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, pool_k, pool_v)):
        raise RuntimeError("paged_attention has no gradient: call it under "
                           "torch.no_grad() or on tensors that need none")
    if pool_k.dtype == torch.uint8 and k_scale is None:
        raise ValueError("packed int4 pool requires group scales")
    if q.is_cuda:
        return _paged_cuda(q, pool_k, pool_v, page_table, layer, t, t_pad, d,
                           k_scale, v_scale, collect_mass)
    if q.device.type != "cpu":
        raise ValueError(f"no paged_attention for device {q.device}")
    return paged_attention_ref(q, pool_k, pool_v, page_table, layer, t,
                               t_pad, d, k_scale, v_scale, collect_mass)
