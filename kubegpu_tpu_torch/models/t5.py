"""T5-style encoder-decoder family in PyTorch (counterpart of
``kubegpu_tpu/models/t5.py``).

A bidirectional encoder and a causal decoder with cross-attention, T5's
relative-position-bucket bias in place of rope, RMSNorm pre-norm and the
T5.1.1 gated-GELU feed-forward (GELU in its tanh form, as ``jax.nn.gelu``'s
default).  The parameter layout is the reference's: layers stacked on a
leading ``L`` dim, ``W`` stored ``[in, out]``, one ``[buckets, H]`` bias
table per stack, so :func:`kubegpu_tpu_torch.convert.convert_t5_params` is a
copy.  Attention is plain einsum with an additive bias in f32, as the
reference leaves it to XLA, except the paged decoder's self-attention over
its flushed history, which is kernel 7 (``paged_attention_biased``).

Single device only: a ``mesh`` raises (ROADMAP.md queue 1, item 9), and the
reference's sharding specs are not ported.  Caches, pools and parameters
update in place where the reference returns new arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubegpu_tpu_torch.models.llama import (
    _rmsnorm,
    embed_lookup,
    make_train_step,
    unbind_layers,
)
from kubegpu_tpu_torch.ops.flash_attention import NEG_INF
from kubegpu_tpu_torch.ops.paged_attention import (
    merge_partials,
    paged_attention_biased,
    rel_pos_bucket,
)

@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    n_enc_layers: int = 12
    n_dec_layers: int = 12
    n_heads: int = 12
    d_ff: int = 2048
    rel_buckets: int = 32
    rel_max_dist: int = 128
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def tiny(cls, **kw) -> "T5Config":
        base = cls(vocab_size=256, d_model=64, n_enc_layers=2,
                   n_dec_layers=2, n_heads=4, d_ff=128, rel_buckets=8,
                   rel_max_dist=32, dtype="float32")
        return replace(base, **kw)


def _single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("a mesh (sharded T5) waits for multi-device"
                                  " support: ROADMAP.md queue 1, item 9")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def t5_init(cfg: T5Config, seed: int = 0, device="cuda",
            generator: torch.Generator | None = None) -> dict:
    """Random parameters with the reference's shapes and scales (normal /
    sqrt(fan_in), bias tables / sqrt(buckets), norms at one), drawn from
    ``generator`` (default: a generator on ``device`` seeded with
    ``seed``)."""
    gen = generator or torch.Generator(device=device).manual_seed(seed)
    dt, d, f = cfg.tdtype, cfg.d_model, cfg.d_ff
    proj = cfg.n_heads * cfg.head_dim

    def dense(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * fan_in ** -0.5).to(dt)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    def attn(n, prefix):
        return {f"{prefix}q": dense((n, d, proj), d),
                f"{prefix}k": dense((n, d, proj), d),
                f"{prefix}v": dense((n, d, proj), d),
                f"{prefix}o": dense((n, proj, d), proj)}

    def ffn(n):
        return {"wi_0": dense((n, d, f), d), "wi_1": dense((n, d, f), d),
                "wo_ff": dense((n, f, d), f)}

    ne, nd, nb = cfg.n_enc_layers, cfg.n_dec_layers, cfg.rel_buckets
    return {
        "embed": dense((cfg.vocab_size, d), d),
        # one shared bias table per stack ([buckets, H]), as in T5
        "enc_rel": dense((nb, cfg.n_heads), nb),
        "dec_rel": dense((nb, cfg.n_heads), nb),
        "encoder": {"attn_norm": ones((ne, d)), **attn(ne, "w"),
                    "mlp_norm": ones((ne, d)), **ffn(ne)},
        "decoder": {"self_norm": ones((nd, d)), **attn(nd, "s"),
                    "cross_norm": ones((nd, d)), **attn(nd, "c"),
                    "mlp_norm": ones((nd, d)), **ffn(nd)},
        "enc_final_norm": ones((d,)),
        "dec_final_norm": ones((d,)),
        "lm_head": dense((d, cfg.vocab_size), d),
    }


# ---------------------------------------------------------------------------
# Relative position bias
# ---------------------------------------------------------------------------

def _rel_bias(table: torch.Tensor, t: int, s: int, bidirectional: bool,
              cfg: T5Config) -> torch.Tensor:
    """[H, T, S] additive attention bias from the [buckets, H] table."""
    pos = torch.arange(max(t, s), device=table.device)
    bucket = rel_pos_bucket(pos[None, :s] - pos[:t, None], bidirectional,
                            cfg.rel_buckets, cfg.rel_max_dist)
    return table[bucket].permute(2, 0, 1)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _bias_attention(q, k, v, bias, causal: bool) -> torch.Tensor:
    """q [B,T,H,D], k/v [B,S,H,D], bias [H,T,S] (or None) → [B,T,H,D].
    f32 scores/softmax, additive bias before masking."""
    d = q.shape[-1]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * d ** -0.5
    if bias is not None:
        scores = scores + bias[None].float()
    if causal:
        t, s = scores.shape[2], scores.shape[3]
        mask = torch.ones((t, s), dtype=torch.bool,
                          device=q.device).tril(diagonal=s - t)
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, v.float()).to(q.dtype)


def _attn(h, x, lp, prefix, cfg, bias, causal, kv_src=None):
    """Shared attention sublayer: norm'd input ``h`` projects q from itself
    and k/v from ``kv_src`` (cross-attention) or itself."""
    b, t = h.shape[0], h.shape[1]
    hd = cfg.head_dim
    src = h if kv_src is None else kv_src
    s = src.shape[1]
    q = (h @ lp[f"{prefix}q"]).view(b, t, cfg.n_heads, hd)
    k = (src @ lp[f"{prefix}k"]).view(b, s, cfg.n_heads, hd)
    v = (src @ lp[f"{prefix}v"]).view(b, s, cfg.n_heads, hd)
    o = _bias_attention(q, k, v, bias, causal).reshape(b, t, cfg.n_heads * hd)
    return x + (o @ lp[f"{prefix}o"]).to(x.dtype)


def _ffn(x, lp, cfg):
    h = _rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    up = F.gelu(h @ lp["wi_0"], approximate="tanh") * (h @ lp["wi_1"])
    return x + (up @ lp["wo_ff"]).to(x.dtype)


def _run_layers(layer, x, stack: dict, cfg: T5Config):
    """``x = layer(x, lp)`` for each layer's parameters ``lp`` of the
    stacked ``stack`` (unbound once: see ``unbind_layers``); with
    ``cfg.remat`` and grad enabled each runs under
    ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``."""
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in unbind_layers(stack):
        x = checkpoint(layer, x, lp, use_reentrant=False,
                       preserve_rng_state=False) if remat else layer(x, lp)
    return x


def t5_encode(params: dict, tokens: torch.Tensor, cfg: T5Config,
              mesh=None) -> torch.Tensor:
    """tokens [B, S] → encoder states [B, S, d_model]."""
    _single_device(mesh)
    x = embed_lookup(params["embed"], tokens)
    s = tokens.shape[1]
    bias = _rel_bias(params["enc_rel"], s, s, True, cfg)

    def layer(x, lp):
        h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        x = _attn(h, x, lp, "w", cfg, bias, causal=False)
        return _ffn(x, lp, cfg)

    x = _run_layers(layer, x, params["encoder"], cfg)
    return _rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)


def t5_decode_train(params: dict, enc_out: torch.Tensor,
                    dec_tokens: torch.Tensor, cfg: T5Config,
                    mesh=None) -> torch.Tensor:
    """Teacher-forced decoder: [B, T] targets-in → logits [B, T, V] f32."""
    _single_device(mesh)
    x = embed_lookup(params["embed"], dec_tokens)
    t = dec_tokens.shape[1]
    self_bias = _rel_bias(params["dec_rel"], t, t, False, cfg)

    def layer(x, lp):
        h = _rmsnorm(x, lp["self_norm"], cfg.norm_eps)
        x = _attn(h, x, lp, "s", cfg, self_bias, causal=True)
        h = _rmsnorm(x, lp["cross_norm"], cfg.norm_eps)
        x = _attn(h, x, lp, "c", cfg, None, causal=False, kv_src=enc_out)
        return _ffn(x, lp, cfg)

    x = _run_layers(layer, x, params["decoder"], cfg)
    x = _rmsnorm(x, params["dec_final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()


def t5_forward(params: dict, enc_tokens: torch.Tensor,
               dec_tokens: torch.Tensor, cfg: T5Config,
               mesh=None) -> torch.Tensor:
    return t5_decode_train(params, t5_encode(params, enc_tokens, cfg, mesh),
                           dec_tokens, cfg, mesh)


def seq2seq_loss(params: dict, enc_tokens: torch.Tensor,
                 dec_tokens: torch.Tensor, cfg: T5Config,
                 mesh=None) -> torch.Tensor:
    """Teacher-forced next-token loss on the decoder side: predict
    dec_tokens[:, 1:] from dec_tokens[:, :-1] given the encoded input."""
    logits = t5_forward(params, enc_tokens, dec_tokens[:, :-1], cfg, mesh)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, dec_tokens[:, 1:].long()[..., None]).mean()


def make_t5_train_step(cfg: T5Config, optimizer, mesh=None):
    """``step(params, opt_state, enc_tokens, dec_tokens) → (params,
    opt_state, loss)``.  ``params`` are leaf tensors with
    ``requires_grad``; ``optimizer`` is a ``kubegpu_tpu_torch.optim.adamw``.
    The step is Llama's ``make_train_step`` over :func:`seq2seq_loss`: one
    backward and one update, in place."""
    _single_device(mesh)
    inner = make_train_step(
        cfg, optimizer,
        loss_fn=lambda params, batch, c: seq2seq_loss(params, *batch, c))

    def step(params, opt_state, enc_tokens, dec_tokens):
        return inner(params, opt_state, (enc_tokens, dec_tokens))
    return step


# ---------------------------------------------------------------------------
# Serving: cached greedy decode (self-attn KV cache + precomputed
# cross-attention K/V)
# ---------------------------------------------------------------------------

def t5_cross_kv(params: dict, enc_out: torch.Tensor,
                cfg: T5Config) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V projected ONCE from the encoder output (it never
    changes during decode).  Returns ([L, B, H, S_enc, hd], same for v)."""
    b, s = enc_out.shape[0], enc_out.shape[1]
    nd, hd = cfg.n_dec_layers, cfg.head_dim

    def project(w):   # [L, D_model, H*hd] over enc_out [B, S, D_model]
        # the reference dequantizes int8 (QTensor) weights here first; the
        # port has no QTensor yet (ROADMAP.md queue 1, item 8)
        y = torch.einsum("bsd,ldh->lbsh", enc_out, w)
        return y.reshape(nd, b, s, cfg.n_heads, hd).permute(
            0, 1, 3, 2, 4).contiguous()     # [L, B, H, S_enc, hd]

    return project(params["decoder"]["ck"]), project(params["decoder"]["cv"])


def t5_init_decode_state(params: dict, enc_out: torch.Tensor,
                         cfg: T5Config, max_len: int) -> dict:
    """Decoder serving state: zeroed self-attn KV cache [L, B, H, max_len,
    D] plus the precomputed cross K/V."""
    ck, cv = t5_cross_kv(params, enc_out, cfg)
    shape = (cfg.n_dec_layers, enc_out.shape[0], cfg.n_heads, max_len,
             cfg.head_dim)
    zeros = dict(dtype=cfg.tdtype, device=enc_out.device)
    return {"k": torch.zeros(shape, **zeros), "v": torch.zeros(shape, **zeros),
            "cross_k": ck, "cross_v": cv}


def _decode_rel_bias(table: torch.Tensor, pos: int, s: int,
                     cfg: T5Config) -> torch.Tensor:
    """[H, 1, S] causal rel-pos bias for a single query at ``pos``."""
    rel = torch.arange(s, device=table.device) - pos   # memory - query
    bucket = rel_pos_bucket(rel, False, cfg.rel_buckets, cfg.rel_max_dist)
    return table[bucket].T[:, None, :]


def _cross_attend(x, lp, xk, xv, cfg):
    """Cross-attention over the precomputed encoder K/V (no bias), with
    residual.  x: [B, 1, D]; xk/xv: [B, H, S_enc, hd]."""
    b, hd = x.shape[0], cfg.head_dim
    h = _rmsnorm(x, lp["cross_norm"], cfg.norm_eps)
    q = (h @ lp["cq"]).view(b, 1, cfg.n_heads, hd)
    scores = torch.einsum("bthd,bhsd->bhts", q.float(),
                          xk.float()) * hd ** -0.5
    o = torch.einsum("bhts,bhsd->bthd", torch.softmax(scores, dim=-1),
                     xv.float())
    o = o.to(x.dtype).reshape(b, 1, cfg.n_heads * hd)
    return x + (o @ lp["co"]).to(x.dtype)


def t5_decode_step(params: dict, state: dict, token: torch.Tensor, pos: int,
                   cfg: T5Config) -> tuple[torch.Tensor, dict]:
    """One decoder token in, next-token logits [B, V] out.  token: [B];
    pos: the global decoder position of ``token``.  The self-attn cache
    in ``state`` is written in place."""
    b, hd = token.shape[0], cfg.head_dim
    s = state["k"].shape[3]
    x = embed_lookup(params["embed"], token[:, None])   # [B, 1, D]
    self_bias = _decode_rel_bias(params["dec_rel"], pos, s, cfg)
    visible = torch.arange(s, device=token.device) <= pos
    for i, lp in enumerate(unbind_layers(params["decoder"])):
        ck, cv = state["k"][i], state["v"][i]
        # self-attention over the cache (causal via k_pos <= pos)
        h = _rmsnorm(x, lp["self_norm"], cfg.norm_eps)
        q = (h @ lp["sq"]).view(b, 1, cfg.n_heads, hd)
        ck[:, :, pos] = (h[:, 0] @ lp["sk"]).view(b, cfg.n_heads, hd)
        cv[:, :, pos] = (h[:, 0] @ lp["sv"]).view(b, cfg.n_heads, hd)
        scores = torch.einsum("bthd,bhsd->bhts", q.float(),
                              ck.float()) * hd ** -0.5
        scores = (scores + self_bias[None].float()).masked_fill(~visible,
                                                                NEG_INF)
        o = torch.einsum("bhts,bhsd->bthd", torch.softmax(scores, dim=-1),
                         cv.float())
        o = o.to(x.dtype).reshape(b, 1, cfg.n_heads * hd)
        x = x + (o @ lp["so"]).to(x.dtype)
        x = _cross_attend(x, lp, state["cross_k"][i], state["cross_v"][i],
                          cfg)
        x = _ffn(x, lp, cfg)
    x = _rmsnorm(x, params["dec_final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()[:, 0], state


def _validate_steps(n_steps: int) -> None:
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")


def _greedy(logits: torch.Tensor, i: int) -> torch.Tensor:
    return logits.argmax(dim=-1)


def _t5_rollout(params: dict, enc_tokens: torch.Tensor, n_steps: int,
                cfg: T5Config, start_token: int, max_len: int,
                pick) -> torch.Tensor:
    """THE dense decode loop: encode once, then one decode step a token
    from ``start_token``; ``pick(logits, step_index)`` selects each token.
    Returns [B, n_steps]."""
    state = t5_init_decode_state(params, t5_encode(params, enc_tokens, cfg),
                                 cfg, max_len)
    token = torch.full((enc_tokens.shape[0],), start_token, dtype=torch.long,
                       device=enc_tokens.device)
    out = []
    for i in range(n_steps):
        logits, state = t5_decode_step(params, state, token, i, cfg)
        token = pick(logits, i)
        out.append(token)
    return torch.stack(out, dim=1)


@torch.no_grad()
def t5_greedy_generate(params: dict, enc_tokens, n_steps: int,
                       cfg: T5Config, start_token: int = 0,
                       max_len: int | None = None,
                       device="cuda") -> torch.Tensor:
    """Encoder-decoder greedy generation: encode ``enc_tokens`` [B, S]
    (moved to ``device``) once, precompute the cross K/V, then one decode
    step a token from ``start_token`` (T5's decoder-start convention).
    Returns [B, n_steps] (int64)."""
    max_len = max_len or n_steps
    _validate_steps(n_steps)
    if n_steps > max_len:
        raise ValueError(f"n_steps {n_steps} > max_len {max_len}")
    enc_tokens = torch.as_tensor(enc_tokens, dtype=torch.long, device=device)
    return _t5_rollout(params, enc_tokens, n_steps, cfg, start_token,
                       max_len, _greedy)


def _t5_buffer_partials(q0, bk, bv, j: int, bias):
    """Biased softmax partials over the in-block write buffer (valid at
    index <= j).  q0: [B, H, hd]; buffer [B, H, stride, hd]; bias [H,
    stride] (buffer key j' sits at relative offset j' - j whatever the
    global position).  Returns (o [B, H, hd] f32 normalized, m, l)."""
    hd, stride = q0.shape[-1], bk.shape[2]
    s = torch.einsum("bhd,bhsd->bhs", q0.float(),
                     bk.to(q0.dtype).float()) * hd ** -0.5
    s = s + bias[None].float()
    mask = torch.arange(stride, device=q0.device) <= j
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1)
    w = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = w.sum(dim=-1)
    o = torch.einsum("bhs,bhsd->bhd", w.to(bv.dtype).float(), bv.float())
    return o / torch.clamp(l, min=1e-30)[..., None], m, l


def _t5_paged_step(params: dict, cross_k, cross_v, token, pool_k, pool_v, pt,
                   d0, buf_k, buf_v, pos: int, j: int, cfg: T5Config):
    """One T5 decoder token with the flushed self-attn history on the page
    pool (read by :func:`paged_attention_biased`, which computes the causal
    rel-pos bias in-kernel) and this block's keys in a dense write buffer.
    token: [B]; pos: global decoder position; j: in-block index.  Writes
    the buffers in place; returns logits [B, V]."""
    b, hd = token.shape[0], cfg.head_dim
    stride = buf_k.shape[3]
    x = embed_lookup(params["embed"], token[:, None])   # [B, 1, D]
    table = params["dec_rel"]                           # [n_buckets, H]
    # buffer key j' sits at global pos (pos - j + j'): rel = j' - j
    buf_bucket = rel_pos_bucket(torch.arange(stride, device=token.device) - j,
                                False, cfg.rel_buckets, cfg.rel_max_dist)
    buf_bias = table[buf_bucket].T                      # [H, stride]
    table_t = table.T.float().contiguous()              # kernel 7's [H, nb]
    i32 = dict(dtype=torch.int32, device=token.device)
    qpos = torch.full((b,), pos, **i32)
    zeros_b = torch.zeros((b,), **i32)
    for i, lp in enumerate(unbind_layers(params["decoder"])):
        h = _rmsnorm(x, lp["self_norm"], cfg.norm_eps)[:, 0]   # [B, D]
        q0 = (h @ lp["sq"]).view(b, cfg.n_heads, hd)
        bk, bv = buf_k[i], buf_v[i]
        bk[:, :, j] = (h @ lp["sk"]).view(b, cfg.n_heads, hd)
        bv[:, :, j] = (h @ lp["sv"]).view(b, cfg.n_heads, hd)
        o_p, m_p, l_p = paged_attention_biased(
            q0, pool_k, pool_v, pt, i, zeros_b, zeros_b, d0, qpos, table_t,
            bias_max_dist=cfg.rel_max_dist)
        o_b, m_b, l_b = _t5_buffer_partials(q0, bk, bv, j, buf_bias)
        o = merge_partials(o_p, m_p, l_p, o_b, m_b, l_b)
        o = o.to(x.dtype).reshape(b, 1, cfg.n_heads * hd)
        x = x + (o @ lp["so"]).to(x.dtype)
        x = _cross_attend(x, lp, cross_k[i], cross_v[i], cfg)
        x = _ffn(x, lp, cfg)
    x = _rmsnorm(x, params["dec_final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()[:, 0]


def _t5_paged_rollout(params: dict, enc_tokens: torch.Tensor, n_steps: int,
                      cfg: T5Config, start_token: int, page_size: int,
                      pick) -> torch.Tensor:
    """THE paged decode loop (see :func:`t5_greedy_generate_paged`);
    ``pick(logits, step_index)`` selects each token.  Returns [B,
    n_steps]."""
    device = enc_tokens.device
    enc_out = t5_encode(params, enc_tokens, cfg)
    cross_k, cross_v = t5_cross_kv(params, enc_out, cfg)
    b, nd, hd = enc_tokens.shape[0], cfg.n_dec_layers, cfg.head_dim
    stride = page_size
    n_blocks = -(-n_steps // stride)
    kv = dict(dtype=cfg.tdtype, device=device)
    pool_shape = (nd, 1 + b * n_blocks, cfg.n_heads, page_size, hd)
    pool_k, pool_v = torch.zeros(pool_shape, **kv), torch.zeros(pool_shape,
                                                                **kv)
    pt = (1 + torch.arange(b, device=device)[:, None] * n_blocks
          + torch.arange(n_blocks, device=device)[None, :]).to(torch.int32)
    buf_shape = (nd, b, cfg.n_heads, stride, hd)
    buf_k, buf_v = torch.zeros(buf_shape, **kv), torch.zeros(buf_shape, **kv)
    token = torch.full((b,), start_token, dtype=torch.long, device=device)
    out = []
    for bi in range(n_blocks):
        d0 = torch.full((b,), bi * stride, dtype=torch.int32, device=device)
        buf_k.zero_()
        buf_v.zero_()
        for j in range(min(stride, n_steps - bi * stride)):
            logits = _t5_paged_step(params, cross_k, cross_v, token, pool_k,
                                    pool_v, pt, d0, buf_k, buf_v,
                                    bi * stride + j, j, cfg)
            token = pick(logits, bi * stride + j)
            out.append(token)
        if bi + 1 < n_blocks:   # flush the full page into row r's page bi
            pages = pt[:, bi].long()
            pool_k[:, pages] = buf_k
            pool_v[:, pages] = buf_v
    return torch.stack(out, dim=1)


@torch.no_grad()
def t5_greedy_generate_paged(params: dict, enc_tokens, n_steps: int,
                             cfg: T5Config, start_token: int = 0,
                             page_size: int = 128,
                             device="cuda") -> torch.Tensor:
    """:func:`t5_greedy_generate` with the decoder self-attn cache in a
    page pool read by the biased paged kernel; same return contract.
    Cross-attention stays dense (encoder activations, not KV cache).

    The pool is ``[L, 1 + B * n_blocks, H, page_size, hd]`` with page 0 as
    trash; row ``r`` owns pages ``1 + r * n_blocks ...``.  Decoding goes in
    blocks of ``page_size`` steps: each step reads the flushed pages
    through kernel 7 (``t = t_pad = 0``, ``d = block * page_size``) and the
    block's keys from a dense write buffer, merging the two partials; a
    full block is flushed as one page per row."""
    _validate_steps(n_steps)
    enc_tokens = torch.as_tensor(enc_tokens, dtype=torch.long, device=device)
    return _t5_paged_rollout(params, enc_tokens, n_steps, cfg, start_token,
                             page_size, _greedy)
