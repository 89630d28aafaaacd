"""Mixtral-style mixture-of-experts decoder (counterpart of
``kubegpu_tpu/models/moe.py``): the Llama backbone with its feed-forward
sublayer replaced by a routed SwiGLU expert FFN.

Routing is the reference's GShard/Switch algebra, kept static-shaped so a
decode step stays one CUDA graph: top-k by ``k`` rounds of argmax, each
token's place in its expert's buffer by token order plus what the earlier
rounds filled, tokens past the fixed capacity dropped (they pass through
the residual), one-hot dispatch and combine tensors ``[G, T, E, C]``, and
the Switch aux loss on the first choices.  One-hots are comparisons
against an ``arange`` (an out-of-range index gives a zero row, as
``jax.nn.one_hot``), and nothing reads a value back to the host.  The
experts run as one batched product over the stacked ``[E, in, out]``
weights (``torch.matmul`` over ``[E, B·C, d]``), the reference's
``vmap``-ed matmul; there is no Pallas kernel in the reference's MoE, and
none here.

Capacity is per routing group, the first dim of the router logits: a row
of the batch.  The forward routes each sequence whole; the serving hook
(:func:`_moe_decode_ffn`) routes whatever the cached forward hands it: a
prefill's whole (bucket-padded) row, a chunk, or one token a slot in a
decode step.  With a generous ``capacity_factor`` nothing drops and the
cached decode equals the forward; with a tight one drops follow the
groups, as in the reference.  The router weights stay f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubegpu_tpu_torch.models import decode
from kubegpu_tpu_torch.models.llama import (
    LlamaConfig,
    _rmsnorm,
    attention_sublayer,
    embed_lookup,
    make_train_step,
    unbind_layers,
)
from kubegpu_tpu_torch.ops import attention


@dataclass(frozen=True)
class MoEConfig:
    """Llama backbone + routed-expert FFN (frozen and hashable: it keys
    the decode step's graph cache)."""
    base: LlamaConfig = field(default_factory=LlamaConfig)
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    @classmethod
    def mixtral_8x7b_shaped(cls) -> "MoEConfig":
        return cls(base=LlamaConfig(
            vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_seq_len=8192,
            rope_theta=1e6), n_experts=8, top_k=2)

    @classmethod
    def tiny(cls, n_experts: int = 4, top_k: int = 2,
             capacity_factor: float = 1.25, **base_kw) -> "MoEConfig":
        return cls(base=LlamaConfig.tiny(**base_kw), n_experts=n_experts,
                   top_k=top_k, capacity_factor=capacity_factor)

    def capacity(self, tokens_per_group: int) -> int:
        """Per-expert token capacity for a routing group of that size."""
        cap = math.ceil(self.top_k * tokens_per_group
                        * self.capacity_factor / self.n_experts)
        return max(cap, self.top_k)


def moe_init(cfg: MoEConfig, seed: int = 0, device="cuda",
             generator: torch.Generator | None = None) -> dict:
    """Stacked-layer random parameters with the reference's tree: the
    attention leaves and norms as Llama's, the experts ``[L, E, in, out]``
    and the router ``w_router`` ``[L, d, E]`` in f32 (routing decisions
    are precision-critical).  Normal / sqrt(fan_in), norms at one, drawn
    from ``generator`` (default: a generator on ``device`` seeded with
    ``seed``), one expert matrix at a time, so the f32 transient is one
    ``[in, out]`` slice."""
    b = cfg.base
    gen = generator or torch.Generator(device=device).manual_seed(seed)
    dt = b.tdtype
    hd = b.head_dim
    L, E = b.n_layers, cfg.n_experts
    d, f = b.d_model, b.d_ff

    def draw(shape, fan_in, dtype=dt):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * fan_in ** -0.5).to(dtype)

    def stacked(shape, fan_in, dtype=dt):
        # [L, *lead, in, out], filled one trailing [in, out] slice at a time
        out = torch.empty((L,) + shape, dtype=dtype, device=device)
        flat = out.view(-1, *shape[-2:])
        for i in range(flat.shape[0]):
            flat[i] = draw(shape[-2:], fan_in, dtype)
        return out

    return {
        "embed": draw((b.vocab_size, d), d),
        "layers": {
            "attn_norm": torch.ones((L, d), dtype=dt, device=device),
            "wq": stacked((d, b.n_heads * hd), d),
            "wk": stacked((d, b.n_kv_heads * hd), d),
            "wv": stacked((d, b.n_kv_heads * hd), d),
            "wo": stacked((b.n_heads * hd, d), b.n_heads * hd),
            "mlp_norm": torch.ones((L, d), dtype=dt, device=device),
            "w_router": stacked((d, E), d, torch.float32),
            "w_gate": stacked((E, d, f), d),
            "w_up": stacked((E, d, f), d),
            "w_down": stacked((E, f, d), f),
        },
        "final_norm": torch.ones((d,), dtype=dt, device=device),
        "lm_head": draw((d, b.vocab_size), d),
    }


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of integer ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row (``jax.nn.one_hot``'s contract), with no
    range check that would read the index back to the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def route_tokens(router_logits: torch.Tensor, top_k: int, capacity: int):
    """Top-k routing with fixed capacity.  ``router_logits`` [G, T, E] (G
    routing groups).  Returns (dispatch [G, T, E, C] one-hot f32, combine
    [G, T, E, C] gate weights, aux loss f32 scalar).  A token's place in
    its expert's buffer is the count of earlier tokens of its group that
    chose the same expert this round plus what earlier rounds filled; a
    token past capacity gets a zero row.  Kept gates are renormalised to
    sum to one a token."""
    g, t, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    dispatch = torch.zeros((g, t, e, capacity), dtype=torch.float32,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    remaining = probs
    fill = torch.zeros((g, e), dtype=torch.float32, device=probs.device)
    for _ in range(top_k):
        gate = remaining.amax(dim=-1)                 # [G, T]
        choice = remaining.argmax(dim=-1)             # the first maximum
        onehot = _one_hot(choice, e)                  # [G, T, E]
        pos = torch.cumsum(onehot, dim=1) - onehot + fill[:, None, :]
        pos_tok = (pos * onehot).sum(dim=-1)          # [G, T]
        keep = (pos_tok < capacity).float()
        slot = (onehot[..., None] * _one_hot(pos_tok.long(), capacity)
                [:, :, None, :] * keep[:, :, None, None])
        dispatch = dispatch + slot
        combine = combine + slot * gate[:, :, None, None]
        fill = fill + (onehot * keep[..., None]).sum(dim=1)
        remaining = remaining * (1.0 - onehot)
    # Switch aux loss on the first choices: E * sum_e frac_e * mean_p_e
    first = _one_hot(probs.argmax(dim=-1), e)
    aux = e * (first.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum()
    denom = combine.sum(dim=(2, 3), keepdim=True)
    return dispatch, combine / torch.clamp(denom, min=1e-9), aux


def moe_ffn(x: torch.Tensor, lp: dict, cfg: MoEConfig):
    """Routed SwiGLU FFN over one layer's ``lp``: x [B, T, d] → (out [B, T,
    d] in x's dtype, aux loss).  Each row is a routing group of capacity
    ``cfg.capacity(T)``; the dispatch (cast to x's dtype) gathers the
    tokens into ``[E, B·C, d]``, the experts are one batched product, and
    the combine runs in f32 before the cast back."""
    b_, t, d = x.shape
    cap = cfg.capacity(t)
    logits = x.float() @ lp["w_router"]                          # [B,T,E]
    dispatch, combine, aux = route_tokens(logits, cfg.top_k, cap)
    xd = torch.einsum("gtec,gtd->egcd", dispatch.to(x.dtype), x)
    xd = xd.reshape(cfg.n_experts, b_ * cap, d)
    h = F.silu(xd @ lp["w_gate"]) * (xd @ lp["w_up"])
    out = (h @ lp["w_down"]).reshape(cfg.n_experts, b_, cap, d)
    y = torch.einsum("egcd,gtec->gtd", out.float(), combine)
    return y.to(x.dtype), aux


def moe_forward(params: dict, tokens: torch.Tensor, cfg: MoEConfig):
    """tokens [B, T] → (logits [B, T, vocab] f32, the layers' summed aux
    loss), on the tokens' device.  Attention is Llama's sublayer (the
    flash kernel on CUDA tensors); each sequence routes as one group.
    With ``remat`` and grad enabled each layer is checkpointed, as in
    :func:`~kubegpu_tpu_torch.models.llama.llama_forward`."""
    b = cfg.base
    bs, t = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(t, device=tokens.device).expand(bs, t)

    def attend(q, k, v):
        return attention(q, k, v, causal=True, impl=b.attn_impl)

    def layer(x, lp):
        x = attention_sublayer(x, lp, b, positions, attend)
        y, aux = moe_ffn(_rmsnorm(x, lp["mlp_norm"], b.norm_eps), lp, cfg)
        return x + y, aux

    aux_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = b.remat and torch.is_grad_enabled()
    for lp in unbind_layers(params["layers"]):
        if remat:
            x, aux = checkpoint(layer, x, lp, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = layer(x, lp)
        aux_sum = aux_sum + aux
    x = _rmsnorm(x, params["final_norm"], b.norm_eps)
    return (x @ params["lm_head"]).float(), aux_sum


def moe_next_token_loss(params: dict, tokens: torch.Tensor,
                        cfg: MoEConfig) -> torch.Tensor:
    """The causal LM loss over all T positions' forward (the last logit
    dropped) plus ``router_aux_weight`` times the mean layer's aux loss."""
    logits, aux = moe_forward(params, tokens, cfg)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    return -ll.mean() + cfg.router_aux_weight * aux / cfg.base.n_layers


def make_moe_train_step(cfg: MoEConfig, optimizer, mesh=None,
                        accum_steps: int = 1):
    """``step(params, opt_state, tokens) → (params, opt_state, loss)``:
    Llama's :func:`~kubegpu_tpu_torch.models.llama.make_train_step` over
    :func:`moe_next_token_loss` (the LM loss plus the weighted aux loss),
    updating in place.  The gradient reaches the router only through the
    gates: the one-hot dispatch, positions and drops come from ``argmax``
    and comparisons and carry none, the gates flow through ``combine`` and
    its renormalisation, a tie in ``amax`` splits its gradient evenly (as
    JAX's ``max``), and the aux loss differentiates through the mean
    router probabilities only.  A mesh (expert parallelism) waits for
    multi-device support: ROADMAP.md queue 1, item 9."""
    if mesh is not None:
        raise NotImplementedError("a mesh (expert-parallel MoE) waits for "
                                  "multi-device support: ROADMAP.md queue 1,"
                                  " item 9")
    return make_train_step(cfg, optimizer, loss_fn=moe_next_token_loss,
                           accum_steps=accum_steps)


# -- serving: the cached decode with routed experts ---------------------------

def _moe_decode_ffn(cfg: MoEConfig):
    """The routed-FFN hook ``ffn(x, lp) -> x`` of the cached forward and
    the serving engines (residual included, aux discarded).  Routing groups
    are per call: the whole prompt row at prefill, one chunk in a chunk
    step, one token a slot in a decode step."""
    def ffn(x, lp):
        y, _ = moe_ffn(_rmsnorm(x, lp["mlp_norm"], cfg.base.norm_eps), lp,
                       cfg)
        return x + y
    return ffn


def moe_prefill(params: dict, prompt: torch.Tensor, cfg: MoEConfig,
                max_len: int | None = None, kv_int8: bool = False):
    """:func:`~kubegpu_tpu_torch.models.decode.prefill` with routed experts:
    (last-position logits [B, vocab] f32, primed cache)."""
    return decode.prefill(params, prompt, cfg.base, max_len, kv_int8,
                          ffn=_moe_decode_ffn(cfg))


def moe_decode_step(params: dict, cache: dict, token: torch.Tensor, pos,
                    cfg: MoEConfig):
    """One routed decode step: token [B] at position ``pos`` → (logits
    [B, vocab] f32, cache)."""
    return decode.decode_step(params, cache, token, pos, cfg.base,
                              ffn=_moe_decode_ffn(cfg))


def moe_greedy_generate(params: dict, prompt, n_steps: int, cfg: MoEConfig,
                        max_len: int | None = None, kv_int8: bool = False,
                        device="cuda", graphs: bool = True) -> torch.Tensor:
    """Greedy decode for the MoE family: :func:`~kubegpu_tpu_torch.models.
    decode.generate` with the routed FFN passed as the hashable
    ``(_moe_decode_ffn, cfg)`` pair, which keys the decode step's graph.
    Each decode step routes one token a row (capacity ``top_k``)."""
    return decode.generate(params, prompt, n_steps, cfg.base,
                           max_len=max_len, kv_int8=kv_int8,
                           ffn_factory=_moe_decode_ffn, ffn_cfg=cfg,
                           device=device, graphs=graphs)
