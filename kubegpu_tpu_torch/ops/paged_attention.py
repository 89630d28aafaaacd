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
tokens ``[L, n_pages, Hkv, P/g]`` (kernel 6).  :func:`paged_attention_biased`
is the T5 decoder's variant over bf16/f32 pages (kernel 7): MHA, T5's causal
relative-position bias added to each score, and no page-id-0 hole mask.
"""

from __future__ import annotations

import torch

from kubegpu_tpu_torch import kernels
from kubegpu_tpu_torch.ops.flash_attention import KERNEL_MAX_HEAD_DIM, NEG_INF
from kubegpu_tpu_torch.ops.kvquant import q4_unpack

# csrc/paged_decode.cuh's split walk (kernels 4-7) takes up to this many
# query heads a CTA; it cuts a row's pages into one split a page, up to
# _MAX_SPLITS splits (at most its split::MAX_SPLITS); its CTAs have this
# many warps, each of which records a page's mass
_GMAX = 8
_MAX_SPLITS = 32
_SPLIT_WARPS = 4


def page_table_size(max_len: int, page_size: int) -> int:
    """Row-local page count covering ``max_len`` physical positions."""
    return -(-max_len // page_size)


def decode_capacity(n_pages: int, t_pad: int, page_size: int) -> int:
    """Decode positions a row's allocation can hold: everything its
    ``n_pages`` pages cover past the page-aligned prompt region."""
    return max(n_pages * page_size - t_pad, 0)


def gather_pages(pool: dict, page_ids: torch.Tensor) -> dict:
    """The listed pages of every pool leaf, the transfer unit of page
    migration between engines: the page axis is axis 1 of the model-dtype
    two-leaf pool, and of the values and scales of the int8 and packed
    int4 pools, so the scales travel with their values.  Id 0 gathers the
    trash page, which is never attended."""
    return {name: leaf.index_select(1, page_ids)
            for name, leaf in pool.items()}


def scatter_pages(pool: dict, chain: dict, page_ids: torch.Tensor) -> None:
    """Write a gathered chain into ``pool`` IN PLACE at ``page_ids`` (the
    import side of page migration; the reference returns the updated
    pool).  Each chain leaf carries ``len(page_ids)`` pages; id 0 writes
    the trash page, which is never attended."""
    for name, leaf in pool.items():
        leaf.index_copy_(1, page_ids, chain[name])


def merge_partials(o1, m1, l1, o2, m2, l2) -> torch.Tensor:
    """Combine two normalized softmax partials over disjoint key sets
    (flash decoding's split merge).  o: [B, Hq, D] f32; m/l: [B, Hq].
    Sources with no valid keys (l == 0) drop out exactly."""
    m = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - m) * l1
    w2 = torch.exp(m2 - m) * l2
    tot = torch.clamp(w1 + w2, min=1e-30)
    return (o1 * w1[..., None] + o2 * w2[..., None]) / tot[..., None]


def fold_chunk_queries(q: torch.Tensor) -> torch.Tensor:
    """Fold a query block ``[B, Hq, C, D]`` (C positions a row) into the
    paged kernels' query-head dim: ``[B, Hq·C, D]`` in (hkv, group,
    c)-major order, so the C positions of a query head ride as C more
    heads of its kv head's group over the same page walk.  All C positions
    of a row must share one history window (a prompt chunk's queries all
    see ``[0, s)``); their causal part over the chunk's own keys comes
    from ``models/decode.py``'s ``_chunk_causal_partials`` in the same
    order, merged by :func:`merge_partials`."""
    b, hq, c, d = q.shape
    return q.reshape(b, hq * c, d)


def paged_attention_ref(q, pool_k, pool_v, page_table, layer, t, t_pad, d,
                        k_scale=None, v_scale=None, collect_mass=False):
    """Gather-based plain version.  q: [B, Hq, D]; pool: [L, n_pages, Hkv,
    P, D] (uint8 pools: packed int4, [..., D/2]); page_table: [B,
    max_pages] int32; layer: int; t/t_pad/d: [B] int32; k_scale/v_scale:
    f32 [L, n_pages, Hkv, P] per token (int8) or [L, n_pages, Hkv, P/g] per
    group of g tokens (int4).  The k-scale multiplies the scores after
    ``* D^-0.5``; the v-scale multiplies the weights after l and the mass
    are taken, before the P.V product.  Masked positions are selected out
    of the scores and of P.V, never multiplied by a zero, so NaN left in
    a recycled page's masked rows (K, V or their scales) stays out of
    every output, as in the kernels, which load only valid rows.  Returns (o [B, Hq, D] f32
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
    # a masked position adds nothing, whatever its bytes: a recycled page
    # may still hold NaN there (a quarantined slot's), which a zero weight
    # would carry into o; the kernels never load those rows
    if v_scale is not None:
        w = torch.where(valid, w * per_token(v_scale)[:, :, None, :], 0.0)
        v = v.to(q.dtype)
    v = v.masked_fill(~valid[:, :, 0, :, None], 0)
    o = torch.einsum("bkgs,bksd->bkgd", w.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    out = (o.reshape(b, hq, dd), m.reshape(b, hq), l.reshape(b, hq))
    return out + (mass,) if collect_mass else out


def rel_pos_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
                   max_dist: int) -> torch.Tensor:
    """T5's log-spaced relative-position bucketing.  ``rel`` is memory_pos -
    query_pos (integer tensor).  Bidirectional splits the bucket space by
    sign; causal buckets only the past (the future clamps to bucket 0).  The
    log-spaced part is the reference's f32 arithmetic in its order: the log
    of the f32 ratio over the f32 log of ``max_dist / max_exact``, times the
    bucket count, truncated; kernel 7 computes the same with ``logf``."""
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).to(rel.dtype) * num_buckets
        n = rel.abs()
    else:
        n = torch.clamp(-rel, min=0)
    max_exact = num_buckets // 2
    # the f32 ratio made on rel's device: a host tensor copied there would
    # synchronize the stream once a decode step
    log_denom = torch.full((), max_dist / max_exact, dtype=torch.float32,
                           device=rel.device).log()
    val_large = max_exact + (
        torch.log(torch.clamp(n, min=1).float() / max_exact) / log_denom
        * (num_buckets - max_exact)).to(rel.dtype)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_large)


def _check_mha(q, pool_k) -> None:
    if q.shape[1] != pool_k.shape[2]:
        raise ValueError(f"the biased paged attention is MHA: Hq {q.shape[1]}"
                         f" != Hkv {pool_k.shape[2]}")


def paged_attention_biased_ref(q, pool_k, pool_v, page_table, layer, t, t_pad,
                               d, q_pos, bias_table, bias_max_dist: int):
    """Gather-based plain version of kernel 7.  q: [B, H, D]; pool: [L,
    n_pages, H, P, D] bf16/f32; q_pos: [B] the query's global position;
    bias_table: [H, n_buckets] (taken in f32).  Each valid key's score is
    ``q.k * D^-0.5 + bias_table[h, bucket(phys - q_pos)]`` with T5's causal
    bucketing over ``bias_max_dist``; valid keys are ``phys < t | t_pad <=
    phys < t_pad + d`` with no page-id test (a 0 in a row's used range
    attends page 0's keys).  Returns (o [B, H, D] f32 normalized, m [B, H],
    l [B, H])."""
    _check_mha(q, pool_k)
    b, h, dd = q.shape
    p = pool_k.shape[3]
    s_len = page_table.shape[1] * p
    pt = page_table.long()
    # [B, max_pages, H, P, D] -> [B, H, S, D]
    k = pool_k[layer][pt].permute(0, 2, 1, 3, 4).reshape(b, h, s_len, dd)
    v = pool_v[layer][pt].permute(0, 2, 1, 3, 4).reshape(b, h, s_len, dd)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k.float()) * (dd ** -0.5)
    phys = torch.arange(s_len, device=q.device)[None, :]
    bucket = rel_pos_bucket(phys - q_pos.long()[:, None], False,
                            bias_table.shape[1], bias_max_dist)   # [B, S]
    s = s + bias_table.float()[:, bucket].permute(1, 0, 2)
    t, t_pad, d = t[:, None], t_pad[:, None], d[:, None]
    valid = ((phys < t) | ((phys >= t_pad) & (phys < t_pad + d)))[:, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    w = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = w.sum(dim=-1)
    o = torch.einsum("bhs,bhsd->bhd", w.to(v.dtype).float(), v.float())
    return o / torch.clamp(l, min=1e-30)[..., None], m, l


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
        if kernels.capturing():
            raise RuntimeError("the layer ids would be made during a CUDA "
                               "graph capture: run the function eagerly "
                               "once before capturing it")
        _layer_ids[key] = torch.arange(n_layers, dtype=torch.int32,
                                       device=device)
    if kernels.capturing():
        kernels.hold(_layer_ids[key])
    return _layer_ids[key].data_ptr() + 4 * layer


def _check_walk(q, pool_k, pool_v, page_table, rows: dict,
                extra=()) -> None:
    """What every paged kernel's walk relies on: a head dim it has an
    instance for, int32 page table and per-row state (``rows``, one value a
    query row) on q's device, and contiguous tensors on one device."""
    b, dd = q.shape[0], q.shape[-1]
    if not 0 < dd <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dd} not in [1, {KERNEL_MAX_HEAD_DIM}]")
    for label, x in (("page_table", page_table), *rows.items()):
        if x.dtype != torch.int32 or x.device != q.device:
            raise TypeError(f"{label} must be int32 on {q.device}")
    if page_table.shape[0] != b or any(x.shape != (b,) for x in rows.values()):
        raise ValueError(f"page_table/{'/'.join(rows)} must have one row per "
                         "query")
    tensors = (q, pool_k, pool_v, page_table, *rows.values(), *extra)
    if not all(x.is_contiguous() and x.device == q.device for x in tensors):
        raise ValueError("paged kernel needs contiguous tensors on one device")


def _refuse_grad(name: str, *tensors) -> None:
    """No silent gradient: as the reference's ``pallas_call`` raises under
    ``jax.grad``, the wrappers raise when grad is enabled and an input
    requires it, rather than return a result autograd cannot see through."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise RuntimeError(f"{name} has no gradient: call it under "
                           "torch.no_grad() or on tensors that need none")


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
    _check_walk(q, pool_k, pool_v, page_table, {"t": t, "t_pad": t_pad,
                                                "d": d},
                (k_scale, v_scale) if quant else ())
    max_pages = page_table.shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((b, hq, dd), **f32)
    m = torch.empty((b, hq), **f32)
    l = torch.empty((b, hq), **f32)
    mass = torch.empty((b, max_pages), **f32) if collect_mass else None
    if b:
        ptr = (lambda x: None if x is None else x.data_ptr())
        args = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                ptr(k_scale), ptr(v_scale), page_table.data_ptr(),
                _layer_ptr(layer, n_layers, q.device), t.data_ptr(),
                t_pad.data_ptr(), d.data_ptr(), o.data_ptr(), m.data_ptr(),
                l.data_ptr(), ptr(mass))
        n_splits = min(max_pages, _MAX_SPLITS)
        n_chunks = -(-(hq // hkv) // _GMAX)
        # the splits' partials, and with the mass a (sum, max) record per
        # query head, page and warp and a page-mass partial per (row, kv
        # head, query chunk) and page
        n_floats = b * hq * n_splits * (dd + 2) + (
            b * max_pages * (hq * _SPLIT_WARPS * 2 + hkv * n_chunks)
            if collect_mass else 0)
        parts, count = _split_scratch(q.device, n_floats,
                                      b * hkv * n_chunks + b)
        kernels.call(name, *args, parts.data_ptr(), count.data_ptr(), b, hq,
                     hkv, n_pages, p, dd, max_pages, n_sc, n_splits,
                     parts.numel(), int(q.dtype == torch.bfloat16))
    out = (o, m, l)
    return out + (mass,) if collect_mass else out


def paged_attention(q, pool_k, pool_v, page_table, layer, t, t_pad, d,
                    k_scale=None, v_scale=None, collect_mass=False):
    """Paged decode attention over one layer of the pool; same signature
    and outputs as :func:`paged_attention_ref`.  CUDA tensors launch the
    Hopper kernel of the pool's format, which reads only the pages each
    row holds: ``csrc/paged_decode.cu`` for bf16/f32 pools, ``_q8.cu`` for
    int8 and ``_q4.cu`` for packed int4 (uint8), all three on the split
    walk (one CTA per row, kv head, chunk of <= 8 query heads and page, up
    to 32 splits a row, merged with the mass in a fixed order, in one
    launch); CPU tensors run the plain version.  A uint8 pool without
    scales raises ``ValueError``, as the reference does.

    There is no gradient (see :func:`_refuse_grad`)."""
    _refuse_grad("paged_attention", q, pool_k, pool_v)
    if pool_k.dtype == torch.uint8 and k_scale is None:
        raise ValueError("packed int4 pool requires group scales")
    if q.is_cuda:
        return _paged_cuda(q, pool_k, pool_v, page_table, layer, t, t_pad, d,
                           k_scale, v_scale, collect_mass)
    if q.device.type != "cpu":
        raise ValueError(f"no paged_attention for device {q.device}")
    return paged_attention_ref(q, pool_k, pool_v, page_table, layer, t,
                               t_pad, d, k_scale, v_scale, collect_mass)


_split_buffers: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _split_scratch(device, n_floats: int, n_counts: int):
    """The split walk's scratch on ``device``, shared by kernels 4-7
    on one stream: the splits' partials and mass records (f32) and the
    counters that pick the last CTA of a merge (int32, zero between
    launches: the kernel's last CTA resets its own).  Kept and reused
    across calls, grown when a call needs more: no allocation per call once
    warm, and nothing read back to the host, so a CUDA graph can capture
    the call.  Under a :class:`kernels.Graph` capture it must not grow
    (the graph would own the new buffer, which no eager call could then
    share): that raises.  The graph holds what it captured, so a later
    growth leaves its buffers alive.  Graph replays and eager calls share
    the buffers, so both must run on one stream (``Graph.replay`` checks
    that)."""
    parts, count = _split_buffers.get(device, (None, None))
    grow_parts = parts is None or parts.numel() < n_floats
    grow_count = count is None or count.numel() < n_counts
    if kernels.capturing():
        if grow_parts or grow_count:
            raise RuntimeError("the split walk's scratch would grow during "
                               "a CUDA graph capture: run the function "
                               "eagerly once before capturing it")
        kernels.hold(parts, count)
        return parts, count
    if grow_parts:
        parts = torch.empty(n_floats, dtype=torch.float32, device=device)
    if grow_count:
        count = torch.zeros(n_counts, dtype=torch.int32, device=device)
    _split_buffers[device] = (parts, count)
    return parts, count


def _paged_bias_cuda(q, pool_k, pool_v, page_table, layer, t, t_pad, d, q_pos,
                     table, max_dist: int):
    _check_mha(q, pool_k)
    b, h, dd = q.shape
    n_layers, n_pages, _, p, row = pool_k.shape
    if q.dtype not in (torch.bfloat16, torch.float32) or pool_k.dtype != \
            q.dtype or pool_v.dtype != q.dtype:
        raise TypeError("kernel 7 takes bf16/f32 queries and pools of q's "
                        f"dtype, got {q.dtype}, {pool_k.dtype}, "
                        f"{pool_v.dtype}")
    if pool_v.shape != pool_k.shape or row != dd:
        raise ValueError(f"pools {tuple(pool_k.shape)}, {tuple(pool_v.shape)}"
                         f" do not fit q {tuple(q.shape)}")
    nb = table.shape[-1]
    if table.shape != (h, nb) or nb < 2 or max_dist <= nb // 2:
        raise ValueError(f"bias table {tuple(table.shape)} with max_dist "
                         f"{max_dist} does not fit {h} heads (needs >= 2 "
                         "buckets and max_dist > n_buckets // 2)")
    _check_walk(q, pool_k, pool_v, page_table,
                {"t": t, "t_pad": t_pad, "d": d, "q_pos": q_pos}, (table,))
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((b, h, dd), **f32)
    m = torch.empty((b, h), **f32)
    l = torch.empty((b, h), **f32)
    max_pages = page_table.shape[1]
    if b:
        n_splits = min(max_pages, _MAX_SPLITS)
        n_floats = b * h * n_splits * (dd + 2)
        parts, count = _split_scratch(q.device, n_floats, b * h)
        kernels.call("paged_decode_bias", q.data_ptr(), pool_k.data_ptr(),
                     pool_v.data_ptr(), page_table.data_ptr(),
                     _layer_ptr(layer, n_layers, q.device), t.data_ptr(),
                     t_pad.data_ptr(), d.data_ptr(), q_pos.data_ptr(),
                     table.data_ptr(), o.data_ptr(), m.data_ptr(),
                     l.data_ptr(), parts.data_ptr(), count.data_ptr(), b, h,
                     n_pages, p, dd, max_pages, nb, max_dist, n_splits,
                     parts.numel(), int(q.dtype == torch.bfloat16))
    return o, m, l


def paged_attention_biased(q, pool_k, pool_v, page_table, layer, t, t_pad, d,
                           q_pos, bias_table, bias_max_dist: int):
    """:func:`paged_attention` plus T5's causal relative-position bias, for
    the T5 decoder's paged self-attention; same signature and outputs as
    :func:`paged_attention_biased_ref`.  ``bias_table`` is cast to a
    contiguous f32 ``[H, n_buckets]``.  CUDA tensors launch kernel 7
    (``csrc/paged_decode_bias.cu``, the split walk: one CTA per row, head
    and page, up to 32 splits a row, merged in a fixed order), which reads
    only the pages each row holds; CPU tensors run the plain version.  ``Hq != Hkv`` raises
    ``ValueError`` (the bias is per query head over MHA pages), and so does
    a gradient request (see :func:`_refuse_grad`)."""
    _refuse_grad("paged_attention_biased", q, pool_k, pool_v, bias_table)
    table = bias_table.to(torch.float32).contiguous()
    if q.is_cuda:
        return _paged_bias_cuda(q, pool_k, pool_v, page_table, layer, t,
                                t_pad, d, q_pos, table, bias_max_dist)
    if q.device.type != "cpu":
        raise ValueError(f"no paged_attention_biased for device {q.device}")
    return paged_attention_biased_ref(q, pool_k, pool_v, page_table, layer, t,
                                      t_pad, d, q_pos, table, bias_max_dist)
