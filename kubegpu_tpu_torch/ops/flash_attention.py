"""Flash attention: a hand-written Hopper kernel plus its plain version.

Counterpart of ``kubegpu_tpu/ops/flash_attention.py``.  Dispatch goes by
tensor device: a CUDA tensor launches the kernel in
``csrc/flash_fwd.cu`` (or raises), a CPU tensor takes the plain version
:func:`xla_attention`.  The kernel masks ragged T/S edges itself, so no
shape falls back.
"""

from __future__ import annotations

import torch

from kubegpu_tpu_torch import kernels

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# head dims 64 and 128 run the kernels' vectorized instances; any other
# up to this one runs an instance padded to 32/64/128/256 channels
KERNEL_MAX_HEAD_DIM = 256


def repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """GQA: repeat kv heads up to the query head count (Hq % Hkv == 0)."""
    hq, hkv = q.shape[1], k.shape[1]
    if hq == hkv:
        return k, v
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    rep = hq // hkv
    return (k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1))


def _check_causal(t: int, s: int, causal: bool) -> None:
    if causal and t > s:
        raise ValueError(
            f"causal attention with more queries ({t}) than keys ({s}) is "
            "ill-defined (queries before the key horizon attend nothing)")


def _masked_scores(q, k, causal, scale):
    """f32 scores [B, Hq, T, S] with the end-aligned causal mask."""
    t, s = q.shape[2], k.shape[2]
    k = repeat_kv(q, k, k)[0]
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(t, s, dtype=torch.bool, device=q.device).tril(s - t)
        scores = scores.masked_fill(~mask, NEG_INF)
    return scores


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: float | None = None
                  ) -> torch.Tensor:
    """Plain attention.  q: [B, Hq, T, D]; k/v: [B, Hkv, S, D].  GQA via
    ``repeat_kv``; the causal mask is end-aligned when t < s (query i
    attends keys <= i + s - t)."""
    d = q.shape[-1]
    _check_causal(q.shape[2], k.shape[2], causal)
    scale = scale if scale is not None else d ** -0.5
    probs = torch.softmax(_masked_scores(q, k, causal, scale), dim=-1)
    v = repeat_kv(q, v, v)[0]
    return torch.einsum("bhts,bhsd->bhtd", probs.to(v.dtype), v)


def _xla_lse(q, k, causal, scale):
    """Per-row logsumexp of the masked scores: the plain version of the
    kernel's lse output."""
    return torch.logsumexp(_masked_scores(q, k, causal, scale), dim=-1)


def _flash_cuda(q, k, v, causal, return_lse):
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention kernel takes bf16/f32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if not 0 < d <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} not in [1, {KERNEL_MAX_HEAD_DIM}]")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q/k/v")
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        kernels.call("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr() if return_lse else None,
                     b, hq, hkv, t, s, d, int(causal),
                     int(q.dtype == torch.bfloat16))
    return (out, lse) if return_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, return_lse: bool = False):
    """Flash attention with grouped GQA reads; shapes as
    :func:`xla_attention`.  With ``return_lse`` also returns the per-row
    natural-log logsumexp [B, Hq, T] (f32).  CUDA tensors launch the
    Hopper kernel, CPU tensors run the plain version."""
    b, hq, t, d = q.shape
    _check_causal(t, k.shape[2], causal)
    if hq % k.shape[1]:
        raise ValueError(f"query heads {hq} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if q.is_cuda:
        return _flash_cuda(q, k, v, causal, return_lse)
    if q.device.type != "cpu":
        raise ValueError(f"no flash_attention for device {q.device}")
    out = xla_attention(q, k, v, causal=causal)
    if not return_lse:
        return out
    return out, _xla_lse(q, k, causal, d ** -0.5)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """Dispatch by device: ``auto`` runs :func:`flash_attention` (the kernel
    on CUDA tensors, the plain version on CPU tensors); ``plain`` forces
    the plain version, for comparisons."""
    if impl == "auto":
        return flash_attention(q, k, v, causal=causal)
    if impl == "plain":
        return xla_attention(q, k, v, causal=causal)
    raise ValueError(f"attention impl {impl!r} not in ('auto', 'plain')")
