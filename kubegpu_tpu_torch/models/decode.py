"""KV-cache prefill, greedy and sampled decode for the Llama family
(counterpart of ``kubegpu_tpu/models/decode.py``).

The cache is a stacked ``[L, B, Hkv, max_len, hd]`` pair allocated once, in
the model dtype or (``kv_int8``) as int8 with f32 per-token scales; the
forward writes new K/V rows into it IN PLACE at its positions with
``index_copy_`` (the reference returns an updated copy).  Attention over the
cache is the plain grouped einsum, as in the reference, which has no kernel
there either.  The position may be a device tensor, so on the card
:func:`greedy_generate` runs the prompt eagerly and then replays one decode
step as a CUDA graph, captured on the first call of a shape: the
counterpart of the reference's jitted scan.  :func:`greedy_generate` is the
solo oracle every serving parity check holds the engines to.
:func:`sample_generate` draws its noise on JAX's own threefry key schedule
(:mod:`kubegpu_tpu_torch.prng`), so its tokens equal the reference's for
the same key.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kubegpu_tpu_torch import kernels, prng
from kubegpu_tpu_torch.models.llama import (
    LlamaConfig,
    _rmsnorm,
    _rope,
    embed_lookup,
    unbind_layers,
)
from kubegpu_tpu_torch.ops.flash_attention import NEG_INF
from kubegpu_tpu_torch.ops.kvquant import quantize_rows


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int | None = None,
                  kv_int8: bool = False, device="cuda") -> dict:
    """Zeroed stacked cache; ``max_len`` defaults to cfg.max_seq_len.
    ``kv_int8`` stores K/V as int8 with per-(layer, batch, head, token)
    f32 scales, which start at 1 so unwritten slots dequantize to exact
    zero."""
    s = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, s, cfg.head_dim)
    if not kv_int8:
        return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.tdtype, device=device)}
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.ones(shape[:-1], dtype=torch.float32,
                                  device=device),
            "v_scale": torch.ones(shape[:-1], dtype=torch.float32,
                                  device=device)}


def _reset_kv_cache(cache: dict) -> None:
    """Back to :func:`init_kv_cache`'s state, in place."""
    for name, x in cache.items():
        x.fill_(1 if name.endswith("_scale") else 0)


# the quantizer lives in ops/kvquant.py; the pool write paths import it under
# the reference's historical name
_quantize_rows = quantize_rows


def _cached_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                   q_pos: torch.Tensor) -> torch.Tensor:
    """q: [B, Hq, T, D]; cache k/v: [B, Hkv, S, D]; q_pos: [T] global
    positions.  Masks ``k_pos > q_pos`` (causality and the unwritten tail
    in one predicate).  GQA runs grouped: each cache element is read once,
    with f32 accumulation."""
    b, hq, t, d = q.shape
    hkv, s = ck.shape[1], ck.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, t, d)
    scores = torch.einsum("bkgtd,bksd->bkgts", qg.float(),
                          ck.float()) * d ** -0.5
    visible = torch.arange(s, device=q.device)[None, :] <= q_pos[:, None]
    scores = scores.masked_fill(~visible, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", probs, cv.float())
    return out.reshape(b, hq, t, d).to(q.dtype)


def _cached_attend_q8(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      k_scale: torch.Tensor, v_scale: torch.Tensor,
                      q_pos: torch.Tensor) -> torch.Tensor:
    """:func:`_cached_attend` over an int8 cache: values [B, Hkv, S, D]
    with f32 per-token scales [B, Hkv, S].  The k-scales multiply the f32
    scores after the ``d ** -0.5`` fold, and the v-scales the f32
    probabilities, which are not rounded to q's dtype (the reference's
    ``probs * v_scale`` promotes its einsum to f32).  int8 values are exact
    in q's dtype, so the f32 upcast is the reference's cast."""
    b, hq, t, d = q.shape
    hkv, s = ck.shape[1], ck.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, t, d)
    scores = torch.einsum("bkgtd,bksd->bkgts", qg.float(), ck.float())
    scores = scores * (d ** -0.5 * k_scale[:, :, None, None, :])
    visible = torch.arange(s, device=q.device)[None, :] <= q_pos[:, None]
    scores = scores.masked_fill(~visible, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd",
                       probs * v_scale[:, :, None, None, :], cv.float())
    return out.reshape(b, hq, t, d).to(q.dtype)


def _dense_ffn(x: torch.Tensor, lp: dict, cfg: LlamaConfig) -> torch.Tensor:
    """The SwiGLU feed-forward sublayer, residual included."""
    h = _rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    up = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    return x + (up @ lp["w_down"]).to(x.dtype)


def _project_qkv(h: torch.Tensor, lp: dict, cfg: LlamaConfig,
                 positions: torch.Tensor):
    """Normed input [B, T, D] → rope'd (q, k, v) as [B, H, T, hd]: THE qkv
    block of every decode-path forward, so they agree bit for bit."""
    b, t = h.shape[0], h.shape[1]
    hd = cfg.head_dim
    q = (h @ lp["wq"]).view(b, t, cfg.n_heads, hd)
    k = (h @ lp["wk"]).view(b, t, cfg.n_kv_heads, hd)
    v = (h @ lp["wv"]).view(b, t, cfg.n_kv_heads, hd)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _attn_finish(x: torch.Tensor, o: torch.Tensor, lp: dict,
                 cfg: LlamaConfig, ffn=None) -> torch.Tensor:
    """Attention output [B, H, T, hd] → wo projection + residual +
    feed-forward: ``ffn(x, lp) -> x`` (residual included; the MoE family's
    routed experts), or the dense SwiGLU when it is None."""
    b, t = x.shape[0], x.shape[1]
    o = o.transpose(1, 2).reshape(b, t, cfg.n_heads * cfg.head_dim)
    x = x + (o @ lp["wo"]).to(x.dtype)
    return _dense_ffn(x, lp, cfg) if ffn is None else ffn(x, lp)


def _gathered_head(params: dict, x: torch.Tensor, rows: torch.Tensor,
                   cfg: LlamaConfig) -> torch.Tensor:
    """The LM head at one position a row: hidden states ``x`` [B, T, D]
    → next-token logits [B, vocab] f32 at positions ``rows`` [B].  The
    rows are gathered before the final norm and ``lm_head`` (both act on
    each position alone), so the head never makes the [B, T, vocab]
    logits the reference computes and indexes."""
    h = x[torch.arange(x.shape[0], device=x.device), rows.long()][:, None]
    h = _rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return (h @ params["lm_head"]).float()[:, 0]


def _forward_with_cache(params: dict, tokens: torch.Tensor, cache: dict,
                        pos_offset, cfg: LlamaConfig,
                        last_only: bool = False,
                        head_rows: torch.Tensor | None = None, ffn=None):
    """Run the decoder over ``tokens`` [B, T] starting at global position
    ``pos_offset`` (an int, or a [1] int64 tensor on the device: the form
    a CUDA graph replays), writing K/V into ``cache`` in place, quantized
    per token when the cache is int8.  Returns (logits [B, T, vocab] f32,
    cache); with ``last_only`` the head runs on the last position alone
    ([B, 1, vocab]): the values the reference's prefill keeps of its
    every-position logits, without them (16.8 GB in f32 at batch 32 ×
    1024 × 128256); with ``head_rows`` [B] on position ``head_rows[b]``
    of row b alone ([B, 1, vocab], :func:`_gathered_head`).  ``ffn``
    overrides the feed-forward sublayer (:func:`_attn_finish`)."""
    b, t = tokens.shape
    kv_int8 = "k_scale" in cache
    x = embed_lookup(params["embed"], tokens)
    q_pos = pos_offset + torch.arange(t, device=tokens.device)
    positions = q_pos[None, :].expand(b, t)
    for i, lp in enumerate(unbind_layers(params["layers"])):
        h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg, positions)
        ck, cv = cache["k"][i], cache["v"][i]
        if kv_int8:
            ks, vs = cache["k_scale"][i], cache["v_scale"][i]
            for dst, dst_scale, x_new in ((ck, ks, k), (cv, vs, v)):
                vals, scale = _quantize_rows(x_new)
                dst.index_copy_(2, q_pos, vals)
                dst_scale.index_copy_(2, q_pos, scale)
            o = _cached_attend_q8(q, ck, cv, ks, vs, q_pos)
        else:
            ck.index_copy_(2, q_pos, k.to(ck.dtype))
            cv.index_copy_(2, q_pos, v.to(cv.dtype))
            o = _cached_attend(q, ck, cv, q_pos)
        x = _attn_finish(x, o, lp, cfg, ffn)
    if head_rows is not None:
        return _gathered_head(params, x, head_rows, cfg)[:, None], cache
    if last_only:
        x = x[:, -1:]
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float(), cache


def prefill(params: dict, prompt: torch.Tensor, cfg: LlamaConfig,
            max_len: int | None = None, kv_int8: bool = False, ffn=None):
    """Process the whole prompt [B, T]; returns (last-position logits
    [B, vocab], primed cache).  ``ffn(x, lp) -> x`` overrides the
    feed-forward sublayer (MoE)."""
    cache = init_kv_cache(cfg, prompt.shape[0], max_len, kv_int8,
                          device=prompt.device)
    logits, cache = _forward_with_cache(params, prompt, cache, 0, cfg,
                                        last_only=True, ffn=ffn)
    return logits[:, -1], cache


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos,
                cfg: LlamaConfig, ffn=None):
    """One token in, next-token logits out.  token: [B]; ``pos``: the
    global position of ``token`` (an int or a [1] device tensor)."""
    logits, cache = _forward_with_cache(params, token[:, None], cache, pos,
                                        cfg, ffn=ffn)
    return logits[:, 0], cache


def _nucleus_mask(sorted_l: torch.Tensor, top_p) -> torch.Tensor:
    """Given DESC-sorted logits, NEG_INF-mask everything outside the
    smallest prefix whose EXCLUSIVE cumulative probability is < ``top_p``
    (at least one token stays; ``top_p >= 1`` keeps all)."""
    probs = torch.softmax(sorted_l, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    return torch.where(cum_excl < top_p, sorted_l,
                       torch.full_like(sorted_l, NEG_INF))


def _sample_token(logits: torch.Tensor, key: torch.Tensor, temperature,
                  top_p, top_k: int, nucleus: bool) -> torch.Tensor:
    """One sampling step over [B, V] f32 logits (the reference's
    ``_sample_token``): temperature scaling (clamped at 1e-6), the static
    top-k truncation, the nucleus truncation when ``nucleus``, then
    :func:`prng.categorical` under ``key``, whose noise has the shape the
    reference draws: [B, V] without top-k, [B, k] with it (row i's noise
    depends on the whole shape, so a batch is always drawn whole).  Top-k
    is ``torch.topk``: on logits tied EXACTLY at the k-th place it may
    keep another of the tied tokens than ``lax.top_k`` (which keeps the
    lower index), and among exact ties it may order the kept ones
    differently, which moves their noise; the full-vocab nucleus sort is
    stable, as ``lax.top_k``."""
    l = logits / torch.clamp(temperature, min=1e-6)
    if top_k:
        vals, idx = torch.topk(l, top_k, dim=-1)
        if nucleus:
            vals = _nucleus_mask(vals, top_p)
        choice = prng.categorical(key, vals)
        return idx.gather(1, choice[:, None])[:, 0]
    if not nucleus:
        return prng.categorical(key, l)
    sorted_l, sorted_idx = torch.sort(l, dim=-1, descending=True,
                                      stable=True)
    choice = prng.categorical(key, _nucleus_mask(sorted_l, top_p))
    return sorted_idx.gather(1, choice[:, None])[:, 0]


def _validate_rollout(cfg: LlamaConfig, t: int, n_steps: int,
                      max_len: int | None) -> int:
    """The length contract of greedy and sampled generation; returns the
    resolved ``max_len``."""
    max_len = max_len or cfg.max_seq_len
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if t + n_steps > max_len:
        raise ValueError(f"prompt {t} + steps {n_steps} > max_len {max_len}")
    return max_len


# Static decode state and the CUDA graph of the decode step, by call shape
# (config, batch, max_len, cache format, device, the pick's static knobs,
# the (ffn_factory, ffn_cfg) pair, the parameter tensors' addresses): a
# repeated call binds the same buffers and replays the same graph.  An
# entry holds the parameter tensors its graph reads.
_graph_cache: dict[tuple, tuple] = {}
_GRAPH_CACHE_SIZE = 4


def clear_graphs() -> None:
    """Drop every cached decode state and graph (and the parameters they
    hold)."""
    _graph_cache.clear()


def _rollout(params, prompt, cfg: LlamaConfig, n_steps: int, max_len: int,
             kv_int8: bool, graphs: bool = False,
             sample: dict | None = None,
             ffn_key: tuple = (None, None)) -> torch.Tensor:
    """THE decode loop: prefill, then ``n_steps - 1`` decode steps, each
    reading its position and token from the device and writing its token
    into column ``pos`` of a static output (so the step never changes and,
    with ``graphs``, is captured once and replayed).  The pick is the
    argmax, or with ``sample`` (``key``, ``temperature``, ``top_p``,
    ``top_k``, ``nucleus``) the reference's sampled pick: token i drawn
    under ``split(key, n_steps)[i]``, the key row read at a device step
    index.  ``ffn_key`` is the hashable ``(ffn_factory, ffn_cfg)`` pair
    whose ``ffn_factory(ffn_cfg)`` overrides the feed-forward sublayer
    (:func:`generate`).  Returns [B, n_steps]."""
    b, t = prompt.shape
    dev = prompt.device
    ffn_factory, ffn_cfg = ffn_key
    ffn = ffn_factory(ffn_cfg) if ffn_factory is not None else None

    def make() -> dict:
        st = {"cache": init_kv_cache(cfg, b, max_len, kv_int8, device=dev),
              "token": torch.empty((b,), dtype=torch.long, device=dev),
              "pos": torch.zeros((1,), dtype=torch.long, device=dev),
              "out": torch.empty((b, max_len), dtype=torch.long,
                                 device=dev)}
        if sample is not None:
            st.update(keys=torch.zeros((max_len, 2), dtype=torch.long,
                                       device=dev),
                      step=torch.zeros((1,), dtype=torch.long, device=dev),
                      temp=torch.zeros((), device=dev),
                      top_p=torch.zeros((), device=dev))
        return st

    if graphs:
        knobs = (None if sample is None
                 else (sample["top_k"], sample["nucleus"]))
        st, cached = kernels.graph_state(
            _graph_cache, (cfg, b, max_len, kv_int8, str(dev), knobs,
                           ffn_key),
            params, make, _GRAPH_CACHE_SIZE)
        _reset_kv_cache(st["cache"])
    else:
        st, cached = make(), None
    if sample is not None:
        st["keys"][:n_steps] = prng.split(sample["key"].to(dev), n_steps)
        st["step"].zero_()
        st["temp"].fill_(sample["temperature"])
        st["top_p"].fill_(sample["top_p"])
    logits, _ = _forward_with_cache(params, prompt, st["cache"], 0, cfg,
                                    last_only=True, ffn=ffn)
    st["pos"].fill_(t)

    def emit(logits: torch.Tensor) -> None:
        if sample is None:
            nxt = logits.argmax(dim=-1)
        else:
            key = st["keys"].index_select(0, st["step"])[0]
            nxt = _sample_token(logits, key, st["temp"], st["top_p"],
                                sample["top_k"], sample["nucleus"])
            st["step"].add_(1)
        st["out"].index_copy_(1, st["pos"], nxt[:, None])
        st["token"].copy_(nxt)

    emit(logits[:, -1])

    def step() -> None:
        logits, _ = decode_step(params, st["cache"], st["token"], st["pos"],
                                cfg, ffn=ffn)
        st["pos"].add_(1)
        emit(logits)

    kernels.run_graph(step, n_steps - 1, cached, "step")
    return st["out"][:, t:t + n_steps].clone()


@torch.no_grad()
def generate(params: dict, prompt, n_steps: int, cfg: LlamaConfig,
             max_len: int | None = None, kv_int8: bool = False,
             ffn_factory=None, ffn_cfg=None, device="cuda",
             graphs: bool = True) -> torch.Tensor:
    """Greedy decode with the feed-forward hook: ``ffn_factory(ffn_cfg)``
    (both hashable: the pair keys the decode step's graph, as it keys the
    reference's compile cache) builds the ``ffn(x, lp) -> x`` that replaces
    the dense SwiGLU; how the MoE family rides this loop.  Otherwise as
    :func:`greedy_generate`."""
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    max_len = _validate_rollout(cfg, prompt.shape[1], n_steps, max_len)
    return _rollout(params, prompt, cfg, n_steps, max_len, kv_int8,
                    graphs=graphs and prompt.is_cuda,
                    ffn_key=(ffn_factory, ffn_cfg))


def greedy_generate(params: dict, prompt, n_steps: int, cfg: LlamaConfig,
                    max_len: int | None = None, kv_int8: bool = False,
                    device="cuda", graphs: bool = True) -> torch.Tensor:
    """Greedy decode ``n_steps`` tokens after ``prompt`` [B, T] (moved to
    ``device``).  Returns the generated tokens [B, n_steps] (int64).
    ``kv_int8`` keeps the cache as int8 with per-token scales.  On the card
    the decode step runs as a CUDA graph, captured on the first call of a
    (config, batch, max_len, cache format) and replayed; ``graphs=False``
    runs it eagerly."""
    return generate(params, prompt, n_steps, cfg, max_len=max_len,
                    kv_int8=kv_int8, device=device, graphs=graphs)


@torch.no_grad()
def sample_generate(params: dict, prompt, n_steps: int, cfg: LlamaConfig,
                    key: torch.Tensor, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 1.0,
                    max_len: int | None = None, kv_int8: bool = False,
                    device="cuda", graphs: bool = True) -> torch.Tensor:
    """Stochastic decode (the reference's ``sample_generate``):
    temperature, top-k and top-p (nucleus) sampling over the loop of
    :func:`greedy_generate`, deterministic per ``key`` (a
    :func:`kubegpu_tpu_torch.prng.prng_key`) and equal to the reference's
    tokens for the same key (see :func:`_sample_token` on exact ties).
    ``top_k=0`` and ``top_p=1.0`` turn their truncation off.  On the card
    the decode step, sampling included, runs as a CUDA graph, as in
    :func:`greedy_generate`."""
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    max_len = _validate_rollout(cfg, prompt.shape[1], n_steps, max_len)
    if not 0 <= top_k <= cfg.vocab_size:
        raise ValueError(f"top_k {top_k} not in [0, vocab]")
    if not 0.0 < top_p:
        # top_p <= 0 would mask every token, and the argmax that came out
        # would be an accident of float absorption
        raise ValueError(f"top_p must be > 0, got {top_p}")
    if temperature <= 0:
        raise ValueError(
            f"temperature must be > 0, got {temperature} "
            "(use greedy_generate for argmax decoding)")
    sample = {"key": key, "temperature": float(temperature),
              "top_p": float(top_p), "top_k": int(top_k),
              "nucleus": float(top_p) < 1.0}
    return _rollout(params, prompt, cfg, n_steps, max_len, kv_int8,
                    graphs=graphs and prompt.is_cuda, sample=sample)


def _attend_buffer_partials(q: torch.Tensor, bk: torch.Tensor,
                            bv: torch.Tensor, j: int):
    """Softmax partials over the dense in-block write buffer, valid at
    buffer index <= j.  q: [B, Hq, 1, D]; buffer [B, Hkv, stride, D].
    Returns (o [B, Hq, D] f32 normalized, m [B, Hq], l [B, Hq]) for the
    flash-decoding merge with the paged pool's partials."""
    b, hq, _, d = q.shape
    hkv, stride = bk.shape[1], bk.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(), bk.float()) * d ** -0.5
    mask = torch.arange(stride, device=q.device) <= j
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1)
    w = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = w.sum(dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", w.to(bv.dtype).float(), bv.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def _chunk_causal_partials(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor):
    """Causal softmax partials of a prompt chunk over its OWN keys.  q:
    [B, Hq, C, D]; k/v: [B, Hkv, C, D] (the chunk's unquantized K/V).
    Query i attends keys j <= i, with f32 scores and the weights rounded
    to V's dtype before P.V, as the reference's einsums do.  Returns
    flattened (o [B, Hq·C, D] normalized f32, m, l [B, Hq·C]) in the
    (hkv, group, c)-major order of the paged kernel's folded queries
    (:func:`kubegpu_tpu_torch.ops.paged_attention.fold_chunk_queries`), so
    the two merge positionally."""
    b, hq, c, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, c, d)
    s = torch.einsum("bkgcd,bksd->bkgcs", qg.float(),
                     k.to(q.dtype).float()) * d ** -0.5
    causal = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, NEG_INF)
    m = s.amax(dim=-1)
    w = torch.where(causal, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = w.sum(dim=-1)
    o = torch.einsum("bkgcs,bksd->bkgcd", w.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return (o.reshape(b, hq * c, d), m.reshape(b, hq * c),
            l.reshape(b, hq * c))


def truncate_at_eos(tokens: list, eos_id: int | None) -> bool:
    """Trim a generated-token list IN PLACE at its first EOS (inclusive:
    the terminator is returned like any other token).  Returns True iff an
    EOS was found: the serving engines' finish signal, shared by every
    consume path so each retires a request on the same token."""
    if eos_id is None:
        return False
    try:
        i = tokens.index(eos_id)
    except ValueError:
        return False
    del tokens[i + 1:]
    return True


# -- speculative decoding (greedy, early-exit self-draft) --------------------

def draft_view(params: dict, draft_layers: int) -> dict:
    """The first ``draft_layers`` layers of a stacked-layer tree as a model
    of their own (the early-exit self-draft: no extra parameters); embed,
    final norm and head are shared.  Every stacked leaf (a :class:`QTensor`
    slices values and scales together) becomes a view of its first
    ``draft_layers`` rows, so the draft copies no weights."""
    return {"embed": params["embed"],
            "layers": {k: v[:draft_layers]
                       for k, v in params["layers"].items()},
            "final_norm": params["final_norm"],
            "lm_head": params["lm_head"]}


def spec_acceptance(drafted: torch.Tensor, full: torch.Tensor, cap):
    """THE speculative acceptance rule: ``drafted`` [B, γ] proposals
    against ``full`` [B, >= γ] full-model argmaxes at the same positions.
    Returns ``(matched, take)`` [B] int32: the longest matching prefix a
    row, and that prefix capped by ``cap`` (a scalar, or a [B] vector: the
    engine's per-slot adaptive γ).  A token is only ever emitted if the
    full model argmaxed it, so the cap is a throughput knob, never a
    correctness one."""
    g = drafted.shape[1]
    match = (drafted == full[:, :g]).to(torch.int32)
    matched = match.cumprod(dim=1).sum(dim=1).to(torch.int32)
    if isinstance(cap, torch.Tensor):
        return matched, torch.minimum(matched, cap.to(torch.int32))
    return matched, matched.clamp(max=int(cap))
