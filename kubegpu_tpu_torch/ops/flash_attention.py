"""Flash attention: hand-written Hopper kernels plus their plain versions.

Counterpart of ``kubegpu_tpu/ops/flash_attention.py``.  Dispatch goes by
tensor device: a CUDA tensor launches the kernels in ``csrc/`` (or
raises), a CPU tensor takes the plain versions.  The forward is
``csrc/flash_fwd.cu`` against :func:`xla_attention`; the backward is
``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu`` against
:func:`flash_attention_bwd_ref`, joined to autograd by
:class:`_FlashAttention`.  The kernels mask ragged T/S edges themselves,
so no shape falls back.  Kernels 1 and 3 have two instances each, and
:func:`_flash_route` picks one by dtype and head dim.
"""

from __future__ import annotations

import torch

from kubegpu_tpu_torch import kernels

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# bf16 at head dims 64 and 128 runs kernels 1 and 3 on the tensor cores
# (_flash_route); f32 at 64 and 128 runs the vectorized CUDA-core
# instances; any other head dim up to this one runs a CUDA-core instance
# padded to 32/64/128/256 channels
KERNEL_MAX_HEAD_DIM = 256


def _flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The instance of kernels 1 and 3 for a dtype and head dim: ``"tc"``
    (wgmma on the tensor cores, fed by TMA) for bf16 at head dims 64 and
    128, ``"simt"`` (f32 FMA loops on the CUDA cores) otherwise.  f32 stays
    off the tensor cores, where it would compute in TF32.  This is a
    dispatch, not a fallback: a launch that the chosen instance refuses
    raises."""
    if dtype == torch.bfloat16 and head_dim in (64, 128):
        return "tc"
    return "simt"


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


def _check_flash_inputs(q, k, v):
    """What the flash kernels (forward and backward) take."""
    b, _, _, d = q.shape
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
    if _flash_route(q.dtype, d) == "tc" and any(
            x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the tensor-core flash kernels need 16-byte aligned "
                         "q/k/v (TMA)")


def _flash_cuda(q, k, v, causal, return_lse):
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    _check_flash_inputs(q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        # the kernel writes through a raw pointer: autograd cannot see it
        raise RuntimeError("flash_attention's kernel has no grad_fn: call "
                           "attention(), whose autograd Function runs the "
                           "backward kernels")
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        kernels.call("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr() if return_lse else None,
                     b, hq, hkv, t, s, d, int(causal),
                     int(q.dtype == torch.bfloat16),
                     route=_flash_route(q.dtype, d))
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


def flash_attention_bwd_ref(q, k, v, out, lse, do, causal: bool = True):
    """Plain flash-attention backward: ``(dq, dk, dv)`` from the forward's
    output and natural-log lse, with no T×S residual saved.  Shapes as
    :func:`xla_attention`, ``do`` like ``out``, ``lse`` f32 [B, Hq, T]; dk
    and dv come back at Hkv heads (summed over each query group).  f32
    throughout, results cast to the inputs' dtypes."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    _check_causal(t, s, causal)
    scale = d ** -0.5
    qf, dof = q.float(), do.float()
    kr, vr = (x.float() for x in repeat_kv(q, k, v))
    delta = (dof * out.float()).sum(-1, keepdim=True)
    # p recomputed from the saved lse: masked scores are NEG_INF, so
    # exp(NEG_INF - lse) is exactly 0
    p = torch.exp(_masked_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bhtd,bhsd->bhts", dof, vr)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kr)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf)
    dv = torch.einsum("bhts,bhtd->bhsd", p, dof)
    dk = dk.view(b, hkv, hq // hkv, s, d).sum(2)
    dv = dv.view(b, hkv, hq // hkv, s, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd_inputs(q, k, v, do, lse, delta):
    """What the backward kernels take besides the forward's inputs."""
    b, hq, t, _ = q.shape
    _check_flash_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError("do must be contiguous, with q's shape and dtype")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or x.shape != (b, hq, t) \
                or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{name} must be contiguous f32 [B, Hq, T] on "
                             f"{q.device}")
    if any(x.data_ptr() % 16 for x in (q, k, v, do)):
        raise ValueError("flash backward kernels need 16-byte aligned q/k/v/do")


def _bwd_args(q, k, v, do, lse, delta, causal):
    b, hq, t, d = q.shape
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr()),
            (b, hq, k.shape[1], t, k.shape[2], d, int(causal),
             int(q.dtype == torch.bfloat16)))


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal):
    """Kernel 2 (``csrc/flash_bwd_dq.cu``): dq like q.  q/k/v/do
    contiguous CUDA tensors of one dtype; ``lse``/``delta`` f32
    [B, Hq, T]."""
    _check_bwd_inputs(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    if q.numel():   # with no keys the kernel writes zeros
        ptrs, ints = _bwd_args(q, k, v, do, lse, delta, causal)
        kernels.call("flash_bwd_dq", *ptrs, dq.data_ptr(), *ints)
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal):
    """Kernel 3 (``csrc/flash_bwd_dkv.cu``): (dk, dv) at Hkv heads, summed
    over each query group in the kernel (no atomics: two launches give
    equal bits), on the instance :func:`_flash_route` picks.  Inputs as
    :func:`_flash_bwd_dq_cuda`."""
    _check_bwd_inputs(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.numel():   # with no queries the kernel writes zeros
        ptrs, ints = _bwd_args(q, k, v, do, lse, delta, causal)
        kernels.call("flash_bwd_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(),
                     *ints, route=_flash_route(q.dtype, q.shape[-1]))
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the counterpart of the reference's
    ``_flash_diff`` / ``_flash_diff_fwd`` / ``_flash_diff_bwd``.  The
    forward saves only ``(q, k, v, out, lse)``; the backward computes
    ``delta = rowsum(dO∘O)`` in plain PyTorch (the reference computes it
    outside its kernels too), then launches kernels 2 and 3 on CUDA
    tensors or runs :func:`flash_attention_bwd_ref` on CPU tensors.  dk
    and dv come back at Hkv heads.

    The reference falls back to differentiating XLA attention when the
    shape does not tile its blocks, and de-groups its dkv kernel when the
    group's panel outgrows VMEM.  Neither has a counterpart here: the
    kernels mask ragged edges themselves, and the dkv kernel streams
    query tiles through shared memory, so no panel has to stay resident.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if not q.is_cuda:
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                 ctx.causal)
            return dq, dk, dv, None
        delta = (do.float() * out.float()).sum(-1)
        dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """Dispatch by device: ``auto`` runs :func:`flash_attention` (the kernel
    on CUDA tensors, the plain version on CPU tensors), through
    :class:`_FlashAttention` when a gradient is wanted; ``plain`` forces
    the plain version (differentiated by autograd), for comparisons."""
    if impl == "auto":
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (q, k, v)):
            return _FlashAttention.apply(q, k, v, causal)
        return flash_attention(q, k, v, causal=causal)
    if impl == "plain":
        return xla_attention(q, k, v, causal=causal)
    raise ValueError(f"attention impl {impl!r} not in ('auto', 'plain')")
