"""Llama-3-family decoder in PyTorch (counterpart of
``kubegpu_tpu/models/llama.py``).

The parameter layout is the reference's: layers stacked on a leading ``L``
dim, and ``x @ W`` with ``W`` stored as ``[in, out]``, so converting the
reference's parameters is a copy (:mod:`kubegpu_tpu_torch.convert`).
bf16 params and activations, f32 for norms, softmax and logits.  Attention
dispatches by device: the Hopper flash kernels on CUDA tensors (forward,
and through autograd the backward), the plain versions on CPU tensors.
``remat`` recomputes each layer in the backward, as the reference's
``jax.checkpoint``.  Single device only: no mesh, no ring.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubegpu_tpu_torch.ops import attention
from kubegpu_tpu_torch.tree import tree_leaves


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True        # recompute each layer in the backward
    attn_impl: str = "auto"   # auto | plain (see ops.attention)
    # the head width, pinned apart from d_model / n_heads: the
    # tensor-parallel engine's local config divides the head counts by tp
    # and keeps the physical width
    head_dim_override: int | None = None

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test-scale config with the same structure."""
        base = cls(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, max_seq_len=128,
                   dtype="float32", remat=False)
        return replace(base, **kw)

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def llama_init(cfg: LlamaConfig, seed: int = 0, device="cuda",
               generator: torch.Generator | None = None) -> dict:
    """Stacked-layer random parameters with the reference's shapes and
    scales (normal / sqrt(fan_in), norms at one), drawn from ``generator``
    (default: a generator on ``device`` seeded with ``seed``).  Layers are
    drawn one at a time, so the f32 transient is one layer's leaf."""
    gen = generator or torch.Generator(device=device).manual_seed(seed)
    dt = cfg.tdtype
    hd = cfg.head_dim
    L = cfg.n_layers

    def dense(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * fan_in ** -0.5).to(dt)

    def stacked(shape, fan_in):
        out = torch.empty((L,) + shape, dtype=dt, device=device)
        for i in range(L):
            out[i] = dense(shape, fan_in)
        return out

    d, f = cfg.d_model, cfg.d_ff
    return {
        "embed": dense((cfg.vocab_size, d), d),
        "layers": {
            "attn_norm": torch.ones((L, d), dtype=dt, device=device),
            "wq": stacked((d, cfg.n_heads * hd), d),
            "wk": stacked((d, cfg.n_kv_heads * hd), d),
            "wv": stacked((d, cfg.n_kv_heads * hd), d),
            "wo": stacked((cfg.n_heads * hd, d), cfg.n_heads * hd),
            "mlp_norm": torch.ones((L, d), dtype=dt, device=device),
            "w_gate": stacked((d, f), d),
            "w_up": stacked((d, f), d),
            "w_down": stacked((f, d), f),
        },
        "final_norm": torch.ones((d,), dtype=dt, device=device),
        "lm_head": dense((d, cfg.vocab_size), d),
    }


def unbind_layers(stack: dict) -> list[dict]:
    """Every layer's parameters from the stacked ``[L, ...]`` leaves of
    ``stack``, with one ``unbind`` per leaf.  Under grad, each leaf's
    backward is then one ``stack`` of its L slices: indexing a leaf once
    per layer would build a zero-filled copy of the whole stack for every
    layer and sum the L of them (O(L^2) where the reference's scan is
    O(L)).  Call it once per forward, outside any checkpointed layer."""
    names = list(stack)
    return [dict(zip(names, parts))
            for parts in zip(*(stack[n].unbind(0) for n in names))]


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    # f32 statistics, cast back, THEN the weight (the reference's order)
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * w


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x: [B, T, H, D] — rotate the pairs (d, d + D/2); f32 angles, the
    result cast back to x's dtype.  The frequencies are made on x's
    device: a host-to-device copy here would wait for the stream to drain
    twice per layer."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) / half)
    angles = positions[:, :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding lookup (single device: a plain gather)."""
    return F.embedding(tokens.long(), embed)


def attention_sublayer(x: torch.Tensor, lp: dict, cfg: LlamaConfig,
                       positions: torch.Tensor, attend) -> torch.Tensor:
    """norm → qkv → rope → attention → wo, with residual.  ``lp`` is one
    layer's parameter dict."""
    b, t = x.shape[0], x.shape[1]
    hd = cfg.head_dim
    h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).view(b, t, cfg.n_heads, hd)
    k = (h @ lp["wk"]).view(b, t, cfg.n_kv_heads, hd)
    v = (h @ lp["wv"]).view(b, t, cfg.n_kv_heads, hd)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    # [B, H, T, D] for the attention kernels
    o = attend(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
               v.transpose(1, 2).contiguous())
    o = o.transpose(1, 2).reshape(b, t, cfg.n_heads * hd)
    return x + (o @ lp["wo"]).to(x.dtype)


def llama_forward(params: dict, tokens: torch.Tensor,
                  cfg: LlamaConfig) -> torch.Tensor:
    """tokens [B, T] → logits [B, T, vocab] (f32), on the tokens' device.
    With ``cfg.remat`` and grad enabled, each layer runs under
    ``torch.utils.checkpoint``: the backward recomputes it from its input,
    so only the layer inputs stay alive between forward and backward."""
    b, t = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(t, device=tokens.device).expand(b, t)

    def attend(q, k, v):
        return attention(q, k, v, causal=True, impl=cfg.attn_impl)

    def layer(x, lp):
        x = attention_sublayer(x, lp, cfg, positions, attend)
        h = _rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        up = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
        return x + (up @ lp["w_down"]).to(x.dtype)

    remat = cfg.remat and torch.is_grad_enabled()
    for lp in unbind_layers(params["layers"]):
        if remat:
            # the layer is deterministic: no RNG state to stash
            x = checkpoint(layer, x, lp, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer(x, lp)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()


def next_token_loss(params: dict, tokens: torch.Tensor,
                    cfg: LlamaConfig) -> torch.Tensor:
    """Causal LM loss: predict tokens[:, 1:] from tokens[:, :-1], as the
    mean NLL of an f32 log-softmax.  The forward runs on all T tokens and
    drops the last position's logits rather than slicing the input to
    T - 1: causality makes the first T - 1 logits the same either way."""
    logits = llama_forward(params, tokens, cfg)[:, :-1]
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def _dp_mean(grads, loss, group):
    """The group's mean of ``grads`` and ``loss``: one f32 all-reduce of
    them all, flattened."""
    import torch.distributed as dist

    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [loss.reshape(1).float()])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    return out, flat[at].to(loss.dtype)


def make_train_step(cfg: LlamaConfig, optimizer, loss_fn=None,
                    accum_steps: int = 1, dp_group=None):
    """``step(params, opt_state, tokens) → (params, opt_state, loss)``: the
    counterpart of the reference's ``make_train_step``.  ``params`` are
    leaf tensors with ``requires_grad``; ``optimizer`` is a
    ``kubegpu_tpu_torch.optim.adamw`` (``init`` / ``update``).
    ``loss_fn(params, tokens, cfg)`` defaults to :func:`next_token_loss`.

    ``accum_steps > 1`` splits the batch into that many equal microbatches,
    sums their f32 gradients, divides by the count and makes ONE update:
    activation memory scales with the microbatch while the update stays
    the full batch's.  Unlike the reference's pure step, the update runs in
    place to save memory: the returned params and state are the arguments,
    updated.

    ``dp_group``, a ``torch.distributed`` group of data-parallel workers
    each stepping on its equal share of the batch, is the reference's
    mesh with a dp axis only: the gradients and the loss are averaged over
    the group (one all-reduce a step) before the update, so every worker
    takes the update of the whole batch and returns its mean loss.  The
    reference's fsdp and tp axes wait for multi-device support (ROADMAP.md
    queue 1, item 9)."""
    loss_fn = loss_fn if loss_fn is not None else next_token_loss
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def step(params, opt_state, tokens):
        leaves = tree_leaves(params)
        if accum_steps == 1:
            loss = loss_fn(params, tokens, cfg)
            grads = torch.autograd.grad(loss, leaves)
        else:
            b = tokens.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} not divisible by accum_steps "
                                 f"{accum_steps}")
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            sums = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            for mb in tokens.reshape(accum_steps, b // accum_steps,
                                     *tokens.shape[1:]):
                mb_loss = loss_fn(params, mb, cfg)
                for acc, g in zip(sums, torch.autograd.grad(mb_loss,
                                                            leaves)):
                    acc += g
                loss = loss + mb_loss.detach()
            loss = loss / accum_steps
            grads = [(acc / accum_steps).to(p.dtype)
                     for acc, p in zip(sums, leaves)]
        loss = loss.detach()
        if dp_group is not None:
            grads, loss = _dp_mean(grads, loss, dp_group)
        opt_state = optimizer.update(grads, opt_state, leaves)
        return params, opt_state, loss

    return step
