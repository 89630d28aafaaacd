"""Vision Transformer (counterpart of ``kubegpu_tpu/models/vit.py``).

The reference's construction, parameter tree and arithmetic: encoder
blocks stored stacked ``[L, ...]``; the patch embedding one reshape and
one matmul over flattened patches; pre-norm blocks with a bidirectional
attention through the shared flash attention (``causal=False``: the
Hopper kernels on CUDA tensors, forward and backward, the plain versions on
CPU tensors); a tanh-approximated GELU, as ``jax.nn.gelu``'s default;
f32 logits.  Images arrive NHWC, as the reference's.  Single device: the
reference's ``vit_param_specs`` wait for multi-device support (ROADMAP.md
queue 1, item 9).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from kubegpu_tpu_torch.models.llama import make_train_step, unbind_layers
from kubegpu_tpu_torch.ops import attention


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    n_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dtype: str = "bfloat16"
    attn_impl: str = "auto"   # auto | plain (see ops.attention)

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def base_16(cls) -> "ViTConfig":
        """ViT-B/16."""
        return cls()

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        base = cls(image_size=32, patch_size=8, n_classes=10, d_model=64,
                   n_layers=2, n_heads=4, d_ff=128, dtype="float32")
        return replace(base, **kw)

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def vit_init(cfg: ViTConfig, seed: int = 0, device="cuda",
             generator: torch.Generator | None = None) -> dict:
    """Random parameters with the reference's tree, shapes and scales
    (normal / sqrt(fan_in), the position embedding normal × 0.02, the class
    token, biases and norm biases zero, norm scales one), drawn from
    ``generator`` (default: a generator on ``device`` seeded with
    ``seed``)."""
    gen = generator or torch.Generator(device=device).manual_seed(seed)
    dt = cfg.tdtype
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    patch_dim = cfg.patch_size * cfg.patch_size * 3

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * std).to(dt)

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "patch_embed": normal((patch_dim, d), patch_dim ** -0.5),
        "cls_token": full((1, 1, d), 0.0),
        "pos_embed": normal((1, cfg.n_patches + 1, d), 0.02),
        "layers": {
            "ln1_scale": full((L, d), 1.0),
            "ln1_bias": full((L, d), 0.0),
            "wqkv": normal((L, d, 3 * d), d ** -0.5),
            "wo": normal((L, d, d), d ** -0.5),
            "ln2_scale": full((L, d), 1.0),
            "ln2_bias": full((L, d), 0.0),
            "w_up": normal((L, d, f), d ** -0.5),
            "b_up": full((L, f), 0.0),
            "w_down": normal((L, f, d), f ** -0.5),
            "b_down": full((L, d), 0.0),
        },
        "final_ln_scale": full((d,), 1.0),
        "final_ln_bias": full((d,), 0.0),
        "head": normal((d, cfg.n_classes), d ** -0.5),
    }


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """f32 statistics, the normalised value cast back to x's dtype, THEN
    the scale and bias (the reference's order)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * scale + bias


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] → [B, N, patch * patch * 3] row-major patches."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def vit_forward(params: dict, images: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """images [B, H, W, 3] → class logits [B, n_classes] (f32), on the
    images' device."""
    b = images.shape[0]
    hd, d = cfg.head_dim, cfg.d_model
    x = patchify(images.to(cfg.tdtype), cfg.patch_size) @ params["patch_embed"]
    cls = params["cls_token"].expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    t = x.shape[1]
    for lp in unbind_layers(params["layers"]):
        h = _layernorm(x, lp["ln1_scale"], lp["ln1_bias"])
        qkv = (h @ lp["wqkv"]).view(b, t, 3, cfg.n_heads, hd)
        # [B, H, T, D] contiguous for the attention kernels
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous()
                   for i in range(3))
        o = attention(q, k, v, causal=False, impl=cfg.attn_impl)
        o = o.transpose(1, 2).reshape(b, t, d)
        x = x + (o @ lp["wo"]).to(x.dtype)
        h = _layernorm(x, lp["ln2_scale"], lp["ln2_bias"])
        up = F.gelu(h @ lp["w_up"] + lp["b_up"], approximate="tanh")
        x = x + (up @ lp["w_down"] + lp["b_down"]).to(x.dtype)
    x = _layernorm(x[:, 0], params["final_ln_scale"], params["final_ln_bias"])
    return (x @ params["head"]).float()


def vit_loss(params: dict, images: torch.Tensor, labels: torch.Tensor,
             cfg: ViTConfig) -> torch.Tensor:
    """Mean NLL of an f32 log-softmax over the class logits."""
    logp = torch.log_softmax(vit_forward(params, images, cfg), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def make_vit_train_step(cfg: ViTConfig, optimizer, mesh=None):
    """``step(params, opt_state, images, labels) → (params, opt_state,
    loss)``: Llama's ``make_train_step`` over :func:`vit_loss`, one
    backward and one update, in place.  A mesh waits for multi-device
    support (ROADMAP.md queue 1, item 9)."""
    if mesh is not None:
        raise NotImplementedError("a mesh (sharded ViT) waits for "
                                  "multi-device support: ROADMAP.md queue 1,"
                                  " item 9")
    inner = make_train_step(
        cfg, optimizer,
        loss_fn=lambda params, batch, c: vit_loss(params, *batch, c))

    def step(params, opt_state, images, labels):
        return inner(params, opt_state, (images, labels))
    return step
