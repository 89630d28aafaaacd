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
The decode steps read their position from the device, so on the card the
greedy generates replay CUDA graphs of them (one step dense, one block of
``page_size`` steps paged), captured on a shape's first call: the
counterpart of the reference's jitted scan.

Single device only: a ``mesh`` raises (ROADMAP.md queue 1, item 9), and the
reference's sharding specs are not ported.  Caches, pools and parameters
update in place where the reference returns new arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubegpu_tpu_torch import kernels
from kubegpu_tpu_torch.models.llama import (
    _rmsnorm,
    embed_lookup,
    make_train_step,
    unbind_layers,
)
from kubegpu_tpu_torch.models.quant import QTensor
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
        if isinstance(w, QTensor):
            # int8 weights (quantize_t5): einsum takes no QTensor, so
            # dequantize once here, at state init, not in every step
            w = w.dequantize(enc_out.dtype)
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


def _decode_rel_bias(table: torch.Tensor, pos: torch.Tensor, s: int,
                     cfg: T5Config) -> torch.Tensor:
    """[H, 1, S] causal rel-pos bias for a single query at ``pos`` (a [1]
    device tensor)."""
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


def t5_decode_step(params: dict, state: dict, token: torch.Tensor, pos,
                   cfg: T5Config) -> tuple[torch.Tensor, dict]:
    """One decoder token in, next-token logits [B, V] out.  token: [B];
    pos: the global decoder position of ``token``, an int or a [1] int64
    tensor on the device (the form a CUDA graph replays: the position is
    read on the device, never baked in).  The self-attn cache in
    ``state`` is written in place."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((1,), pos, dtype=torch.long, device=token.device)
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
        ck.index_copy_(2, pos, (h @ lp["sk"]).view(b, 1, cfg.n_heads,
                                                   hd).transpose(1, 2))
        cv.index_copy_(2, pos, (h @ lp["sv"]).view(b, 1, cfg.n_heads,
                                                   hd).transpose(1, 2))
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


# Static decode state and CUDA graphs of the generate calls, by call shape
# (dense or paged, batch, encoder length, steps, max_len or page size,
# config, device, the parameter tensors' addresses): a repeated call binds
# the same buffers and replays the same graphs.  An entry holds the
# parameter tensors its graphs read.  The oldest entry goes first.
_graph_cache: dict[tuple, tuple] = {}
_GRAPH_CACHE_SIZE = 4


def clear_graphs() -> None:
    """Drop every cached decode state and graph (and the parameters they
    hold)."""
    _graph_cache.clear()


def _pick_into(out: torch.Tensor, token: torch.Tensor, idx: torch.Tensor,
               logits: torch.Tensor, pick, i: int) -> None:
    """Select the next token (greedy when ``pick`` is None, else
    ``pick(logits, i)``), write it to column ``idx`` ([1] device tensor)
    of ``out`` and make it the current ``token``."""
    nxt = logits.argmax(dim=-1) if pick is None else pick(logits, i)
    out.index_copy_(1, idx, nxt[:, None].to(out.dtype))
    token.copy_(nxt)


def _t5_rollout(params: dict, enc_tokens: torch.Tensor, n_steps: int,
                cfg: T5Config, start_token: int, max_len: int,
                pick=None, graphs: bool = False) -> torch.Tensor:
    """THE dense decode loop: encode once, then one decode step a token
    from ``start_token``; ``pick(logits, step_index)`` selects each token
    (None: greedy).  The step reads its position from the device, so with
    ``graphs`` (greedy only) it is captured once and replayed.  Returns
    [B, n_steps]."""
    b, s_enc = enc_tokens.shape
    dev = enc_tokens.device
    nd, h, hd = cfg.n_dec_layers, cfg.n_heads, cfg.head_dim

    def make() -> dict:
        kv = dict(dtype=cfg.tdtype, device=dev)
        cache, cross = (nd, b, h, max_len, hd), (nd, b, h, s_enc, hd)
        return {"k": torch.zeros(cache, **kv), "v": torch.zeros(cache, **kv),
                "cross_k": torch.empty(cross, **kv),
                "cross_v": torch.empty(cross, **kv),
                "token": torch.empty((b,), dtype=torch.long, device=dev),
                "pos": torch.zeros((1,), dtype=torch.long, device=dev),
                "out": torch.empty((b, n_steps), dtype=torch.long,
                                   device=dev)}

    if graphs:
        st, cached = kernels.graph_state(
            _graph_cache, ("dense", b, s_enc, n_steps, max_len, cfg,
                           str(dev)), params, make, _GRAPH_CACHE_SIZE)
        st["k"].zero_()
        st["v"].zero_()
        st["pos"].zero_()
    else:
        st, cached = make(), None
    ck, cv = t5_cross_kv(params, t5_encode(params, enc_tokens, cfg), cfg)
    st["cross_k"].copy_(ck)
    st["cross_v"].copy_(cv)
    st["token"].fill_(start_token)
    i = 0

    def step() -> None:
        nonlocal i
        logits, _ = t5_decode_step(params, st, st["token"], st["pos"], cfg)
        _pick_into(st["out"], st["token"], st["pos"], logits, pick, i)
        st["pos"].add_(1)
        i += 1

    kernels.run_graph(step, n_steps, cached, "step")
    return st["out"].clone()


@torch.no_grad()
def t5_greedy_generate(params: dict, enc_tokens, n_steps: int,
                       cfg: T5Config, start_token: int = 0,
                       max_len: int | None = None, device="cuda",
                       graphs: bool = True) -> torch.Tensor:
    """Encoder-decoder greedy generation: encode ``enc_tokens`` [B, S]
    (moved to ``device``) once, precompute the cross K/V, then one decode
    step a token from ``start_token`` (T5's decoder-start convention).
    Returns [B, n_steps] (int64).  On the card the decode step runs as a
    CUDA graph, captured on the first call of a shape and replayed
    ``n_steps`` times a call (the reference's jitted scan);
    ``graphs=False`` runs it eagerly."""
    max_len = max_len or n_steps
    _validate_steps(n_steps)
    if n_steps > max_len:
        raise ValueError(f"n_steps {n_steps} > max_len {max_len}")
    enc_tokens = torch.as_tensor(enc_tokens, dtype=torch.long, device=device)
    return _t5_rollout(params, enc_tokens, n_steps, cfg, start_token,
                       max_len, graphs=graphs and enc_tokens.is_cuda)


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
                   d0, buf_k, buf_v, j: int, cfg: T5Config):
    """One T5 decoder token with the flushed self-attn history on the page
    pool (read by :func:`paged_attention_biased`, which computes the causal
    rel-pos bias in-kernel) and this block's keys in a dense write buffer.
    token: [B]; d0: [B] int32, the block's first position (every row
    decodes in step, so the query sits at ``d0 + j``); j: in-block index.
    Writes the buffers in place; returns logits [B, V]."""
    b, hd = token.shape[0], cfg.head_dim
    stride = buf_k.shape[3]
    x = embed_lookup(params["embed"], token[:, None])   # [B, 1, D]
    table = params["dec_rel"]                           # [n_buckets, H]
    # buffer key j' sits at global pos (pos - j + j'): rel = j' - j
    buf_bucket = rel_pos_bucket(torch.arange(stride, device=token.device) - j,
                                False, cfg.rel_buckets, cfg.rel_max_dist)
    buf_bias = table[buf_bucket].T                      # [H, stride]
    table_t = table.T.float().contiguous()              # kernel 7's [H, nb]
    qpos = d0 + j
    zeros_b = torch.zeros_like(d0)
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


def _t5_paged_block(params: dict, st: dict, n_j: int, cfg: T5Config,
                    pick=None, i0: int = 0) -> None:
    """``n_j`` decode steps of the block that starts at ``st["d0"]``, then
    its flush: the buffer becomes each row's page ``d0 / page_size``
    (gathered from the table on the device) and ``d0`` advances a page.
    Nothing is read back to the host, so a full block is one CUDA graph.
    ``pick(logits, i0 + j)`` selects each token (None: greedy)."""
    buf_k, buf_v, d0 = st["buf_k"], st["buf_v"], st["d0"]
    page = buf_k.shape[3]
    buf_k.zero_()
    buf_v.zero_()
    col = d0[:1].long()                 # the output column of step 0
    for j in range(n_j):
        logits = _t5_paged_step(params, st["cross_k"], st["cross_v"],
                                st["token"], st["pool_k"], st["pool_v"],
                                st["pt"], d0, buf_k, buf_v, j, cfg)
        _pick_into(st["out"], st["token"], col + j, logits, pick, i0 + j)
    pages = st["pt"].index_select(1, col // page)[:, 0].long()
    st["pool_k"][:, pages] = buf_k
    st["pool_v"][:, pages] = buf_v
    d0.add_(page)


def _t5_paged_rollout(params: dict, enc_tokens: torch.Tensor, n_steps: int,
                      cfg: T5Config, start_token: int, page_size: int,
                      pick=None, graphs: bool = False) -> torch.Tensor:
    """THE paged decode loop (see :func:`t5_greedy_generate_paged`);
    ``pick(logits, step_index)`` selects each token (None: greedy).  With
    ``graphs`` (greedy only) a full block of ``page_size`` steps is one
    CUDA graph replayed for every full block, and the last, partial block
    one graph of its own.  Returns [B, n_steps]."""
    dev = enc_tokens.device
    b, s_enc = enc_tokens.shape
    nd, h, hd = cfg.n_dec_layers, cfg.n_heads, cfg.head_dim
    n_blocks = -(-n_steps // page_size)

    def make() -> dict:
        kv = dict(dtype=cfg.tdtype, device=dev)
        pool = (nd, 1 + b * n_blocks, h, page_size, hd)
        buf, cross = (nd, b, h, page_size, hd), (nd, b, h, s_enc, hd)
        # row r owns pages 1 + r * n_blocks ...
        pt = (1 + torch.arange(b, device=dev)[:, None] * n_blocks
              + torch.arange(n_blocks, device=dev)[None, :]).to(torch.int32)
        return {"pool_k": torch.zeros(pool, **kv),
                "pool_v": torch.zeros(pool, **kv), "pt": pt,
                "buf_k": torch.zeros(buf, **kv),
                "buf_v": torch.zeros(buf, **kv),
                "cross_k": torch.empty(cross, **kv),
                "cross_v": torch.empty(cross, **kv),
                "token": torch.empty((b,), dtype=torch.long, device=dev),
                "d0": torch.zeros((b,), dtype=torch.int32, device=dev),
                "out": torch.empty((b, n_blocks * page_size),
                                   dtype=torch.long, device=dev)}

    if graphs:
        st, cached = kernels.graph_state(
            _graph_cache, ("paged", b, s_enc, n_steps, page_size, cfg,
                           str(dev)), params, make, _GRAPH_CACHE_SIZE)
        st["pool_k"].zero_()
        st["pool_v"].zero_()
        st["d0"].zero_()
    else:
        st, cached = make(), None
    ck, cv = t5_cross_kv(params, t5_encode(params, enc_tokens, cfg), cfg)
    st["cross_k"].copy_(ck)
    st["cross_v"].copy_(cv)
    st["token"].fill_(start_token)
    full, rest = divmod(n_steps, page_size)
    i0 = 0

    def block(n_j: int):
        def run() -> None:
            nonlocal i0
            _t5_paged_block(params, st, n_j, cfg, pick, i0)
            i0 += n_j
        return run

    kernels.run_graph(block(page_size), full, cached, "block")
    kernels.run_graph(block(rest), 1 if rest else 0, cached, "rest")
    return st["out"][:, :n_steps].clone()


@torch.no_grad()
def t5_greedy_generate_paged(params: dict, enc_tokens, n_steps: int,
                             cfg: T5Config, start_token: int = 0,
                             page_size: int = 128, device="cuda",
                             graphs: bool = True) -> torch.Tensor:
    """:func:`t5_greedy_generate` with the decoder self-attn cache in a
    page pool read by the biased paged kernel; same return contract.
    Cross-attention stays dense (encoder activations, not KV cache).

    The pool is ``[L, 1 + B * n_blocks, H, page_size, hd]`` with page 0 as
    trash; row ``r`` owns pages ``1 + r * n_blocks ...``.  Decoding goes in
    blocks of ``page_size`` steps: each step reads the flushed pages
    through kernel 7 (``t = t_pad = 0``, ``d = block * page_size``) and the
    block's keys from a dense write buffer, merging the two partials; a
    block is flushed as one page per row.  On the card a full block runs
    as one CUDA graph (and the last, partial block as another), captured
    on the first call of a shape and replayed; ``graphs=False`` runs the
    blocks eagerly."""
    _validate_steps(n_steps)
    enc_tokens = torch.as_tensor(enc_tokens, dtype=torch.long, device=device)
    return _t5_paged_rollout(params, enc_tokens, n_steps, cfg, start_token,
                             page_size, graphs=graphs and enc_tokens.is_cuda)
