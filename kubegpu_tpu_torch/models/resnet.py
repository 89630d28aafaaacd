"""ResNet (counterpart of ``kubegpu_tpu/models/resnet.py``, a flax module
there): bf16 convolutions, f32 batch norm and an f32 head.

The flax modules become ``torch.nn.Module``s whose submodules carry flax's
auto-names (``Conv_0``, ``BatchNorm_0``, ``Bottleneck_k``, ``Dense_0``), so
a state-dict key is the reference's variable path with dots
(:func:`~kubegpu_tpu_torch.convert.convert_resnet_variables`).  What changes
the numbers, and is kept as flax has it:

- parameters are f32; a convolution casts its input and kernel to the
  model's dtype and computes there, the head computes in f32;
- ``padding="SAME"`` pads ``max((out - 1) * s + k - in, 0)`` in all, the
  smaller half before (asymmetric at stride 2, where torch's symmetric
  padding differs); the max pool pads with -inf the same way;
- batch norm (flax's ``BatchNorm``, not ``nn.BatchNorm2d``): f32
  statistics, the variance ``E[x²] - E[x]²`` clipped at zero, eps 1e-5,
  running averages ``0.9 * ra + 0.1 * batch`` with the BIASED variance; the
  last norm of each block starts at scale zero.

Images arrive NHWC, as the reference's; the forward views them as NCHW
without a copy, which is torch's ``channels_last`` memory format, and the
convolutions keep that format.  The reference leaves its convolutions to
XLA: no Pallas kernel is involved, and none is here (the card runs
cuDNN's).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

MOMENTUM = 0.9
BN_EPS = 1e-5


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """Flax's (XLA's) ``"SAME"`` padding of one spatial dim: (lo, hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    (top, bottom), (left, right) = (same_pads(x.shape[2], k, stride),
                                    same_pads(x.shape[3], k, stride))
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _lecun_normal(shape, fan_in: int, device, generator) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at two standard
    deviations, with variance 1 / fan_in."""
    # the std of a unit normal truncated to [-2, 2]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class Conv(nn.Module):
    """``nn.Conv(features, (k, k), strides, padding="SAME",
    use_bias=False, dtype)``: an OIHW f32 ``weight``, computed in
    ``dtype``."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 dtype=torch.bfloat16, device=None, generator=None):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(_lecun_normal(
            (c_out, c_in, k, k), c_in * k * k, device, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pad_same(x.to(self.dtype), self.k, self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, dtype=float32)`` over NCHW: f32
    ``scale`` and ``bias``, running ``mean`` and ``var`` buffers (flax's
    ``batch_stats``).  In training the batch statistics normalise and
    update the running ones in place (no gradient); in evaluation the
    running ones normalise."""

    def __init__(self, c: int, zero_scale: bool = False, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.zeros(c, **kw) if zero_scale
                                  else torch.ones(c, **kw))
        self.bias = nn.Parameter(torch.zeros(c, **kw))
        self.register_buffer("mean", torch.zeros(c, **kw))
        self.register_buffer("var", torch.ones(c, **kw))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                self.mean.mul_(MOMENTUM).add_(mean, alpha=1 - MOMENTUM)
                self.var.mul_(MOMENTUM).add_(var, alpha=1 - MOMENTUM)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        return (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


class Dense(nn.Module):
    """``nn.Dense(features, dtype=float32)``: ``x @ kernel + bias`` with the
    kernel ``[in, out]``, as flax stores it."""

    def __init__(self, c_in: int, c_out: int, device=None, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(_lecun_normal((c_in, c_out), c_in, device,
                                                 generator))
        self.bias = nn.Parameter(torch.zeros(c_out, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.kernel + self.bias


class Bottleneck(nn.Module):
    """1×1 → 3×3 (strided) → 1×1 (4× the filters), each followed by a
    batch norm; a projection (1×1 conv and norm) on the residual where the
    shape changes."""

    def __init__(self, c_in: int, filters: int, strides: int = 1,
                 dtype=torch.bfloat16, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.Conv_0 = Conv(c_in, filters, 1, **kw)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, strides, **kw)
        self.BatchNorm_1 = BatchNorm(filters, device=device)
        self.Conv_2 = Conv(filters, 4 * filters, 1, **kw)
        self.BatchNorm_2 = BatchNorm(4 * filters, zero_scale=True,
                                     device=device)
        # flax projects when residual.shape != y.shape: a change of width,
        # or a stride that shrinks the map (any map wider than one pixel)
        self.project = c_in != 4 * filters or strides != 1
        if self.project:
            self.Conv_3 = Conv(c_in, 4 * filters, 1, strides, **kw)
            self.BatchNorm_3 = BatchNorm(4 * filters, device=device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = x
        if self.project:
            residual = self.BatchNorm_3(self.Conv_3(x), train)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """images [B, H, W, 3] (NHWC) → class logits [B, num_classes] (f32)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, width: int = 64,
                 dtype=torch.bfloat16, device="cuda", seed: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator(device=device).manual_seed(seed)
        self.dtype = dtype
        self.Conv_0 = Conv(3, width, 7, 2, dtype, device, gen)
        self.BatchNorm_0 = BatchNorm(width, device=device)
        c_in, k = width, 0
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                filters = width * 2 ** i
                setattr(self, f"Bottleneck_{k}", Bottleneck(
                    c_in, filters, 2 if j == 0 and i > 0 else 1, dtype,
                    device, gen))
                c_in, k = 4 * filters, k + 1
        self.n_blocks = k
        self.Dense_0 = Dense(c_in, num_classes, device, gen)

    def forward(self, images: torch.Tensor, train: bool = True
                ) -> torch.Tensor:
        # NHWC viewed as NCHW: torch's channels_last, no copy
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        x = F.max_pool2d(_pad_same(x, 3, 2, -math.inf), 3, 2)
        for k in range(self.n_blocks):
            x = getattr(self, f"Bottleneck_{k}")(x, train)
        return self.Dense_0(x.mean(dim=(2, 3)))


def resnet50(num_classes: int = 1000, device="cuda", seed: int = 0) -> ResNet:
    return ResNet(num_classes=num_classes, device=device, seed=seed)


def resnet_tiny(num_classes: int = 10, device="cuda", seed: int = 0
                ) -> ResNet:
    """Structure-preserving test-scale variant."""
    return ResNet(stage_sizes=(1, 1), num_classes=num_classes, width=8,
                  dtype=torch.float32, device=device, seed=seed)


def resnet_variables(model: ResNet) -> tuple[dict, dict]:
    """The model's (params, batch_stats): its parameters and its running
    statistics by state-dict key, the tensors themselves (not copies)."""
    return dict(model.named_parameters()), dict(model.named_buffers())


def make_resnet_train_step(model: ResNet, optimizer):
    """``step(params, batch_stats, opt_state, images, labels) → (params,
    batch_stats, opt_state, loss)``, the reference's signature: the model
    runs on ``params`` and ``batch_stats`` (dicts by state-dict key, as
    :func:`resnet_variables` gives them) through
    ``torch.func.functional_call`` in training mode, which updates the
    running statistics in place; the loss is the mean softmax cross
    entropy against integer labels; ``optimizer`` (``optim.adam``)
    updates the parameters in place."""

    def step(params, batch_stats, opt_state, images, labels):
        names = list(params)
        logits = torch.func.functional_call(
            model, {**params, **batch_stats}, (images,), {"train": True})
        loss = F.cross_entropy(logits.float(), labels.long())
        leaves = [params[n] for n in names]
        grads = torch.autograd.grad(loss, leaves)
        opt_state = optimizer.update(grads, opt_state, leaves)
        return params, batch_stats, opt_state, loss.detach()

    return step
