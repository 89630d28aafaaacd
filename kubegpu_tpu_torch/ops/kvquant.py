"""KV-cache quantization: int8 per-token rows and the packed int4 page
format (counterpart of ``kubegpu_tpu/ops/kvquant.py``).

Plain PyTorch on every device, as the reference computes these in XLA
outside any kernel.  The results match the reference byte for byte: the
division stays an f32 ``x / scale`` and ``torch.round`` rounds half to
even, as ``jnp.round`` does.

int8 (:func:`quantize_rows`): symmetric per-token scales over the channel
dim, values in [-127, 127], ``scale = amax / 127`` (1 for an all-zero row,
so unwritten cache slots dequantize to exact zero).

int4 (:func:`quantize_groups_q4` / :func:`dequantize_q4`): two nibbles per
byte along the channel dim, NOT interleaved: byte ``d`` holds channel ``d``
in its low nibble and channel ``d + D/2`` in its high nibble, each the
biased value ``q + 8`` with ``q`` in [-7, 7], plus one f32 scale per group
of ``g`` consecutive tokens (``scale = amax / 7`` over the [g, D] tile).
:data:`Q4_ZERO_BYTE` puts both nibbles at the bias, so a pool filled with
it dequantizes to exact zero under any scale.
"""

from __future__ import annotations

import torch

Q4_BIAS = 8          # stored nibble = q + BIAS, q in [-7, 7]
Q4_ZERO_BYTE = 0x88  # both nibbles at the bias -> dequantizes to 0


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(..., token) symmetric int8 over the channel dim.
    x: [..., T, D] -> (int8 values, f32 scales [..., T])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def q4_pack(q: torch.Tensor) -> torch.Tensor:
    """Integer values in [-7, 7], shape [..., D] -> packed uint8
    [..., D // 2]: byte ``d`` = channel ``d`` (low nibble) | channel
    ``d + D/2`` (high nibble), both biased by :data:`Q4_BIAS`."""
    d = q.shape[-1]
    lo = (q[..., : d // 2] + Q4_BIAS).to(torch.uint8)
    hi = (q[..., d // 2:] + Q4_BIAS).to(torch.uint8)
    return lo | (hi << 4)


def q4_unpack(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`q4_pack`: uint8 [..., D // 2] -> int8 [..., D],
    the low-nibble half in channels [0, D/2), the high-nibble half in
    [D/2, D)."""
    lo = (packed & 0xF).to(torch.int8) - Q4_BIAS
    hi = (packed >> 4).to(torch.int8) - Q4_BIAS
    return torch.cat([lo, hi], dim=-1)


def quantize_groups_q4(x: torch.Tensor, g: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4 with one scale per group of ``g`` consecutive tokens
    (axis -2).  x: [..., T, D] (T divisible by g, D even) -> (packed uint8
    [..., T, D // 2], f32 scales [..., T // g])."""
    lead, t_, d_ = x.shape[:-2], x.shape[-2], x.shape[-1]
    xf = x.float().reshape(*lead, t_ // g, g, d_)
    amax = xf.abs().amax(dim=(-1, -2))
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -7, 7)
    q = q.to(torch.int32).reshape(*lead, t_, d_)
    return q4_pack(q), scale


def dequantize_q4(packed: torch.Tensor, scales: torch.Tensor,
                  g: int) -> torch.Tensor:
    """packed uint8 [..., T, D // 2] + f32 scales [..., T // g] -> f32
    values [..., T, D]."""
    q = q4_unpack(packed).float()
    lead, t_, d_ = q.shape[:-2], q.shape[-2], q.shape[-1]
    q = q.reshape(*lead, t_ // g, g, d_) * scales[..., None, None]
    return q.reshape(*lead, t_, d_)
