"""Paged decode attention: a hand-written Hopper kernel plus its plain
version.

Counterpart of ``kubegpu_tpu/ops/paged_attention.py`` for bf16/f32 pools.
The pool is ``[L, n_pages, Hkv, P, D]`` shared by every slot; a per-row
page table maps row-local page index to pool page id, and page 0 is the
trash page (and the eviction hole), which never counts as a key.  Per row,
valid keys are ``phys < t | t_pad <= phys < t_pad + d``.  Both versions
return the softmax partials ``(o normalized, m, l)`` for
:func:`merge_partials`.

Not in this slice: the int8/int4 pools (``k_scale``) and the per-page
attention mass (``collect_mass``); both raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from kubegpu_tpu_torch import kernels
from kubegpu_tpu_torch.ops.flash_attention import KERNEL_MAX_HEAD_DIM, NEG_INF

_QUANT_TODO = ("int8/int4 pages wait for the KV-quant slice "
               "(ROADMAP.md queue 1, 'KV quantization + eviction')")
_MASS_TODO = ("collect_mass comes back with eviction (ROADMAP.md queue 1, "
              "'KV quantization + eviction')")


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
    P, D]; page_table: [B, max_pages] int32; layer: int; t/t_pad/d: [B]
    int32.  Returns (o [B, Hq, D] f32 normalized, m [B, Hq] f32, l [B, Hq]
    f32)."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(_QUANT_TODO)
    if collect_mass:
        raise NotImplementedError(_MASS_TODO)
    b, hq, dd = q.shape
    hkv, p = pool_k.shape[2], pool_k.shape[3]
    g = hq // hkv
    max_pages = page_table.shape[1]
    s_len = max_pages * p
    pt = page_table.long()
    # [B, max_pages, Hkv, P, D] -> [B, Hkv, S, D]
    k = pool_k[layer][pt].permute(0, 2, 1, 3, 4).reshape(b, hkv, s_len, dd)
    v = pool_v[layer][pt].permute(0, 2, 1, 3, 4).reshape(b, hkv, s_len, dd)
    qg = q.reshape(b, hkv, g, dd)
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                     k.to(q.dtype).float()) * (dd ** -0.5)
    phys = torch.arange(s_len, device=q.device)[None, :]
    t, t_pad, d = t[:, None], t_pad[:, None], d[:, None]
    valid = (phys < t) | ((phys >= t_pad) & (phys < t_pad + d))
    valid = valid & (pt.repeat_interleave(p, dim=1) != 0)
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    w = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = w.sum(dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", w.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, hq, dd), m.reshape(b, hq), l.reshape(b, hq)


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


def _paged_cuda(q, pool_k, pool_v, page_table, layer, t, t_pad, d):
    b, hq, dd = q.shape
    n_layers, n_pages, hkv, p, pdim = pool_k.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged kernel takes bf16/f32, got {q.dtype}")
    if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError("q and the pool must share one dtype")
    if pool_v.shape != pool_k.shape or pdim != dd or hq % hkv:
        raise ValueError(f"pool {tuple(pool_k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if not 0 < dd <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dd} not in [1, {KERNEL_MAX_HEAD_DIM}]")
    for name, x in (("page_table", page_table), ("t", t), ("t_pad", t_pad),
                    ("d", d)):
        if x.dtype != torch.int32 or x.device != q.device:
            raise TypeError(f"{name} must be int32 on {q.device}")
    if page_table.shape[0] != b or not (t.shape == t_pad.shape == d.shape
                                        == (b,)):
        raise ValueError("page_table/t/t_pad/d must have one row per query")
    tensors = (q, pool_k, pool_v, page_table, t, t_pad, d)
    if not all(x.is_contiguous() and x.device == q.device for x in tensors):
        raise ValueError("paged kernel needs contiguous tensors on one device")
    o = torch.empty((b, hq, dd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    if b:
        kernels.call("paged_decode", q.data_ptr(), pool_k.data_ptr(),
                     pool_v.data_ptr(), page_table.data_ptr(),
                     _layer_ptr(layer, n_layers, q.device), t.data_ptr(),
                     t_pad.data_ptr(), d.data_ptr(), o.data_ptr(),
                     m.data_ptr(), l.data_ptr(), b, hq, hkv, n_pages, p, dd,
                     page_table.shape[1], int(q.dtype == torch.bfloat16))
    return o, m, l


def paged_attention(q, pool_k, pool_v, page_table, layer, t, t_pad, d,
                    k_scale=None, v_scale=None, collect_mass=False):
    """Paged decode attention over one layer of the pool; same signature
    and partials as :func:`paged_attention_ref`.  CUDA tensors launch the
    Hopper kernel (``csrc/paged_decode.cu``), which reads only the pages
    each row holds; CPU tensors run the plain version."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(_QUANT_TODO)
    if collect_mass:
        raise NotImplementedError(_MASS_TODO)
    if q.is_cuda:
        return _paged_cuda(q, pool_k, pool_v, page_table, layer, t, t_pad, d)
    if q.device.type != "cpu":
        raise ValueError(f"no paged_attention for device {q.device}")
    return paged_attention_ref(q, pool_k, pool_v, page_table, layer, t,
                               t_pad, d)
