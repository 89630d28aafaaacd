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

The search and speculative decoders follow: :func:`beam_generate` over a
two-segment cache (the prompt once a sequence, the generated rows a beam)
and :func:`beam_generate_paged` with the prompt on pages read by the paged
kernel; :func:`spec_generate` (an early-exit self-draft, accepted on the
host once an iteration), :func:`spec_generate_fused`,
:func:`pld_generate_fused` and :func:`pld_generate_paged` (prompt-lookup
drafts), whose acceptance stays on the device.  On the card each replays
CUDA graphs of its step or iteration; a fused loop runs in blocks that
cannot pass its last token and reads its counters once a block, as the
reference's ``lax.while_loop`` has no PyTorch twin.
"""

from __future__ import annotations

from dataclasses import replace

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
from kubegpu_tpu_torch.ops.paged_attention import (
    merge_partials,
    paged_attention,
)
from kubegpu_tpu_torch.parallel.collectives import all_gather_last, all_reduce


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


def _dense_ffn(x: torch.Tensor, lp: dict, cfg: LlamaConfig,
               tp_group=None) -> torch.Tensor:
    """The SwiGLU feed-forward sublayer, residual included.  Under tensor
    parallelism (``tp_group``) w_gate/w_up hold this rank's d_ff columns
    and w_down the matching rows, so the down product is a partial sum,
    all-reduced over the group (the reference's ``lax.psum``)."""
    h = _rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    up = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    down = up @ lp["w_down"]
    if tp_group is not None:
        all_reduce(down, tp_group)
    return x + down.to(x.dtype)


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
                 cfg: LlamaConfig, ffn=None, tp_group=None) -> torch.Tensor:
    """Attention output [B, H, T, hd] → wo projection + residual +
    feed-forward: ``ffn(x, lp) -> x`` (residual included; the MoE family's
    routed experts), or the dense SwiGLU when it is None.  Under tensor
    parallelism (``tp_group``; ``cfg`` is then the rank's LOCAL config)
    ``o`` holds this rank's heads and ``wo`` their rows, so the projection
    is a partial sum, all-reduced over the group, and so is the dense
    SwiGLU's down product."""
    b, t = x.shape[0], x.shape[1]
    o = o.transpose(1, 2).reshape(b, t, cfg.n_heads * cfg.head_dim)
    proj = o @ lp["wo"]
    if tp_group is not None:
        all_reduce(proj, tp_group)
    x = x + proj.to(x.dtype)
    return _dense_ffn(x, lp, cfg, tp_group) if ffn is None else ffn(x, lp)


def _lm_head(params: dict, h: torch.Tensor, tp_group=None) -> torch.Tensor:
    """Normed hidden states [..., D] → f32 logits [..., vocab]; under
    tensor parallelism ``lm_head`` holds this rank's vocabulary shard, and
    the shards' logits are all-gathered, so every rank picks from the
    same full row."""
    logits = (h @ params["lm_head"]).float()
    return logits if tp_group is None else all_gather_last(logits, tp_group)


def _gathered_head(params: dict, x: torch.Tensor, rows: torch.Tensor,
                   cfg: LlamaConfig, tp_group=None) -> torch.Tensor:
    """The LM head at one position a row: hidden states ``x`` [B, T, D]
    → next-token logits [B, vocab] f32 at positions ``rows`` [B].  The
    rows are gathered before the final norm and ``lm_head`` (both act on
    each position alone), so the head never makes the [B, T, vocab]
    logits the reference computes and indexes (:func:`_lm_head` under
    ``tp_group``)."""
    h = x[torch.arange(x.shape[0], device=x.device), rows.long()][:, None]
    h = _rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _lm_head(params, h, tp_group)[:, 0]


def _write_kv(cache: dict, layer: int, k: torch.Tensor, v: torch.Tensor,
              at: torch.Tensor) -> dict:
    """Write K/V rows [B, Hkv, T, D] into layer ``layer`` of a stacked cache
    IN PLACE at positions ``at`` [T], quantized per token when the cache is
    int8.  Returns that layer's leaves (views)."""
    lc = {name: leaf[layer] for name, leaf in cache.items()}
    if "k_scale" in cache:
        for name, x_new in (("k", k), ("v", v)):
            vals, scale = _quantize_rows(x_new)
            lc[name].index_copy_(2, at, vals)
            lc[f"{name}_scale"].index_copy_(2, at, scale)
    else:
        lc["k"].index_copy_(2, at, k.to(lc["k"].dtype))
        lc["v"].index_copy_(2, at, v.to(lc["v"].dtype))
    return lc


def _forward_with_cache(params: dict, tokens: torch.Tensor, cache: dict,
                        pos_offset, cfg: LlamaConfig,
                        last_only: bool = False,
                        head_rows: torch.Tensor | None = None, ffn=None,
                        tp_group=None):
    """Run the decoder over ``tokens`` [B, T] starting at global position
    ``pos_offset`` (an int, or a [1] int64 tensor on the device: the form
    a CUDA graph replays), writing K/V into ``cache`` in place, quantized
    per token when the cache is int8.  Returns (logits [B, T, vocab] f32,
    cache); with ``last_only`` the head runs on the last position alone
    ([B, 1, vocab]): the values the reference's prefill keeps of its
    every-position logits, without them (16.8 GB in f32 at batch 32 ×
    1024 × 128256); with ``head_rows`` [B] on position ``head_rows[b]``
    of row b alone ([B, 1, vocab], :func:`_gathered_head`).  ``ffn``
    overrides the feed-forward sublayer (:func:`_attn_finish`).  Under
    tensor parallelism (``tp_group``) ``cfg`` is the rank's local config,
    the cache holds its KV heads, and the logits are the full vocabulary
    on every rank."""
    b, t = tokens.shape
    kv_int8 = "k_scale" in cache
    x = embed_lookup(params["embed"], tokens)
    q_pos = pos_offset + torch.arange(t, device=tokens.device)
    positions = q_pos[None, :].expand(b, t)
    for i, lp in enumerate(unbind_layers(params["layers"])):
        h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg, positions)
        lc = _write_kv(cache, i, k, v, q_pos)
        if kv_int8:
            o = _cached_attend_q8(q, lc["k"], lc["v"], lc["k_scale"],
                                  lc["v_scale"], q_pos)
        else:
            o = _cached_attend(q, lc["k"], lc["v"], q_pos)
        x = _attn_finish(x, o, lp, cfg, ffn, tp_group)
    if head_rows is not None:
        return (_gathered_head(params, x, head_rows, cfg, tp_group)[:, None],
                cache)
    if last_only:
        x = x[:, -1:]
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _lm_head(params, x, tp_group), cache


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


def _loop_state(key: tuple, params, make, graphs: bool):
    """(static state, graphs by name) of a decode loop: cached by call shape
    and parameter addresses with ``graphs`` (:func:`kernels.graph_state`),
    else made afresh with no graphs."""
    if graphs:
        return kernels.graph_state(_graph_cache, key, params, make,
                                   _GRAPH_CACHE_SIZE)
    return make(), None


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

    knobs = None if sample is None else (sample["top_k"], sample["nucleus"])
    st, cached = _loop_state((cfg, b, max_len, kv_int8, str(dev), knobs,
                              ffn_key), params, make, graphs)
    if graphs:
        _reset_kv_cache(st["cache"])
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


# -- beam search over a two-segment cache ------------------------------------

def _top_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries of each row of ``x`` and their indices, in
    ``lax.top_k``'s order: descending, ties toward the lower index.
    ``torch.topk`` promises neither on CUDA, so this is a stable sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_attend(q: torch.Tensor, pcache: dict, gcache: dict,
                 step_i) -> torch.Tensor:
    """Two-segment beam attention.  q: [B·W, Hq, 1, D].  The PROMPT
    segment (``pcache`` k/v [B, Hkv, T, D], one layer) is read once per
    sequence by all W beams through a batched einsum, never a repeated
    copy; the GEN segment (``gcache`` k/v [B·W, Hkv, G, D]) is per beam,
    and its rows past ``step_i`` (an int or a [1] device tensor) mask out.
    The softmax is joint over both segments.  int8 caches fold their
    per-token scales into the scores (k) and the probabilities (v), as
    :func:`_cached_attend_q8`."""
    bw, hq, _, d = q.shape
    b, hkv, t_p = pcache["k"].shape[:3]
    w, group = bw // b, hq // hkv
    ps = torch.einsum("bwkgd,bksd->bwkgs",
                      q.reshape(b, w, hkv, group, d).float(),
                      pcache["k"].to(q.dtype).float())
    if "k_scale" in pcache:
        ps = ps * pcache["k_scale"][:, None, :, None, :]
    gs = torch.einsum("nkgd,nksd->nkgs", q.reshape(bw, hkv, group, d).float(),
                      gcache["k"].to(q.dtype).float())
    if "k_scale" in gcache:
        gs = gs * gcache["k_scale"][:, :, None, :]
    live = torch.arange(gcache["k"].shape[2], device=q.device) <= step_i
    gs = gs.masked_fill(~live, NEG_INF)
    scores = torch.cat([ps.reshape(bw, hkv, group, t_p), gs],
                       dim=-1) * d ** -0.5
    probs = torch.softmax(scores, dim=-1)
    pp = probs[..., :t_p].reshape(b, w, hkv, group, t_p)
    gp = probs[..., t_p:]
    if "v_scale" in pcache:
        pp = pp * pcache["v_scale"][:, None, :, None, :]
    if "v_scale" in gcache:
        gp = gp * gcache["v_scale"][:, :, None, :]
    out = torch.einsum("bwkgs,bksd->bwkgd", pp,
                       pcache["v"].to(q.dtype).float()).reshape(
        bw, hkv, group, d)
    out = out + torch.einsum("nkgs,nksd->nkgd", gp,
                             gcache["v"].to(q.dtype).float())
    return out.reshape(bw, hq, 1, d).to(q.dtype)


def _beam_inputs(params: dict, tokens: torch.Tensor, step_i, t: int):
    """(the gen write position [1], rope positions [B·W, 1], embeddings) of
    a beam step whose tokens sit at global position ``t + step_i``."""
    at = step_i + torch.arange(1, device=tokens.device)
    positions = (t + at)[None, :].expand(tokens.shape[0], 1)
    return at, positions, embed_lookup(params["embed"], tokens[:, None])


def _logits(params: dict, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Final norm and head of one position a row: [B, 1, D] → [B, V] f32."""
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()[:, 0]


def _beam_decode_step(params: dict, tokens: torch.Tensor, pcache: dict,
                      gcache: dict, step_i, t: int,
                      cfg: LlamaConfig) -> torch.Tensor:
    """One beam decode step over the two-segment cache.  tokens: [B·W] at
    global position ``t + step_i``.  Writes ONLY the gen segment, in place
    at the shared offset ``step_i``; returns logits [B·W, V] f32."""
    at, positions, x = _beam_inputs(params, tokens, step_i, t)
    for i, lp in enumerate(unbind_layers(params["layers"])):
        h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg, positions)
        gc = _write_kv(gcache, i, k, v, at)
        pc = {name: leaf[i] for name, leaf in pcache.items()}
        x = _attn_finish(x, _beam_attend(q, pc, gc, step_i), lp, cfg)
    return _logits(params, x, cfg)


def _beam_paged_decode_step(params: dict, tokens: torch.Tensor, st: dict,
                            step_i, t: int, beams: int,
                            cfg: LlamaConfig) -> torch.Tensor:
    """One beam decode step with the PROMPT segment on the page pool
    ``st["pool"]`` (page tables ``st["pt"]``, ``t = t_pad = t``, ``d = 0``).
    The W beams of a sequence fold into the paged kernel's query group
    ([B·W, Hq, D] → [B, Hkv·W·g, D]), so one row's walk reads its prompt
    pages once for all W beams.  The per-beam GEN segment ``st["gcache"]``
    stays a dense buffer, written in place at ``step_i``, whose partials
    merge with the kernel's.  Returns logits [B·W, V] f32."""
    bw = tokens.shape[0]
    b, hkv, hd = bw // beams, cfg.n_kv_heads, cfg.head_dim
    group = cfg.n_heads // hkv
    at, positions, x = _beam_inputs(params, tokens, step_i, t)

    def unfold(a: torch.Tensor) -> torch.Tensor:
        rest = a.shape[2:]
        return a.reshape(b, hkv, beams, group, *rest).transpose(1, 2) \
            .reshape(bw, hkv * group, *rest)

    for li, lp in enumerate(unbind_layers(params["layers"])):
        h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg, positions)     # [B·W, H, 1, D]
        gc = _write_kv(st["gcache"], li, k, v, at)
        qp = q[:, :, 0].reshape(b, beams, hkv, group, hd).transpose(1, 2) \
            .reshape(b, hkv * beams * group, hd).contiguous()
        o_p, m_p, l_p = map(unfold, paged_attention(
            qp, st["pool"]["k"], st["pool"]["v"], st["pt"], li, st["tvec"],
            st["tvec"], st["d0"]))
        o = merge_partials(o_p, m_p, l_p,
                           *_attend_buffer_partials(q, gc["k"], gc["v"],
                                                    step_i))
        x = _attn_finish(x, o[:, :, None].to(x.dtype), lp, cfg)
    return _logits(params, x, cfg)


def _paginate(panel: torch.Tensor, page_size: int) -> torch.Tensor:
    """A prefill panel [L, B, Hkv, n·P, D] as B·n pool pages [L, B·n, Hkv,
    P, D], row b's pages contiguous from ``b·n``."""
    n_layers, b, hkv, s, hd = panel.shape
    n = s // page_size
    return panel.reshape(n_layers, b, hkv, n, page_size, hd) \
        .transpose(2, 3).reshape(n_layers, b * n, hkv, page_size, hd)


def _page_pool(cfg: LlamaConfig, b: int, n_row: int, page_size: int,
               device) -> dict:
    """A zeroed pool of ``b`` rows of ``n_row`` contiguous pages behind
    trash page 0, with its page tables ``1 + b·n_row + [0, n_row)``, and
    t, t_pad, d vectors of zeros."""
    shape = (cfg.n_layers, 1 + b * n_row, cfg.n_kv_heads, page_size,
             cfg.head_dim)
    i32 = dict(dtype=torch.int32, device=device)
    return {"pool": {name: torch.zeros(shape, dtype=cfg.tdtype, device=device)
                     for name in ("k", "v")},
            "pt": 1 + torch.arange(b, **i32)[:, None] * n_row
            + torch.arange(n_row, **i32),
            "tvec": torch.zeros((b,), **i32),
            "d0": torch.zeros((b,), **i32)}


def _fill_pool(st: dict, params: dict, prompt: torch.Tensor,
               cfg: LlamaConfig, n_row: int, page_size: int) -> torch.Tensor:
    """Prefill ``prompt`` into a panel of ``n_row`` pages a row and copy it
    into ``st["pool"]``'s pages; returns the last position's logits."""
    logits, panel = prefill(params, prompt, cfg, n_row * page_size)
    for name in ("k", "v"):
        st["pool"][name][:, 1:].copy_(_paginate(panel[name], page_size))
    return logits


def _beam_search(params: dict, prompt: torch.Tensor, cfg: LlamaConfig,
                 n_steps: int, beams: int, kv_int8: bool,
                 page_size: int | None, graphs: bool):
    """THE beam loop of :func:`beam_generate` (``page_size`` None) and
    :func:`beam_generate_paged`.  Prefill once on [B, T]: the dense prompt
    segment is exactly the prompt long; the paged one is a pool of
    ``ceil(T/P)`` pages a row.  The first frontier is each sequence's top
    W first tokens; each of the ``n_steps - 1`` steps scores [B, W·V]
    jointly, keeps the top W (:func:`_top_k`), and gathers the gen rows and
    the running outputs of the surviving beams ``b·W + idx // V`` (the
    prompt segment is beam-invariant).  The step reads its index from the
    device, so with ``graphs`` it is captured once and replayed.  Returns
    the best beam [B, n_steps] and its summed log-probability [B]."""
    b, t = prompt.shape
    dev = prompt.device
    bw = b * beams
    n_pp = None if page_size is None else -(-t // page_size)

    def make() -> dict:
        st = {"gcache": init_kv_cache(cfg, bw, max(n_steps - 1, 1),
                                      kv_int8 and n_pp is None, device=dev),
              "scores": torch.zeros((b, beams), device=dev),
              "token": torch.zeros((bw,), dtype=torch.long, device=dev),
              "out": torch.zeros((bw, n_steps), dtype=torch.long,
                                 device=dev),
              "i": torch.zeros((1,), dtype=torch.long, device=dev)}
        if n_pp is None:
            st["pcache"] = init_kv_cache(cfg, b, t, kv_int8, device=dev)
        else:
            st.update(_page_pool(cfg, b, n_pp, page_size, dev))
            st["tvec"].fill_(t)
        return st

    st, cached = _loop_state(("beam", cfg, b, t, n_steps, beams, kv_int8,
                              page_size, str(dev)), params, make, graphs)
    if n_pp is None:
        logits = _forward_with_cache(params, prompt, st["pcache"], 0, cfg,
                                     last_only=True)[0][:, -1]
    else:
        logits = _fill_pool(st, params, prompt, cfg, n_pp, page_size)
    _reset_kv_cache(st["gcache"])
    scores, first = _top_k(F.log_softmax(logits, dim=-1), beams)
    st["scores"].copy_(scores)
    st["token"].copy_(first.reshape(bw))
    st["out"].zero_()
    st["out"][:, 0] = st["token"]
    st["i"].zero_()

    def step() -> None:
        if n_pp is None:
            logits = _beam_decode_step(params, st["token"], st["pcache"],
                                       st["gcache"], st["i"], t, cfg)
        else:
            logits = _beam_paged_decode_step(params, st["token"], st, st["i"],
                                             t, beams, cfg)
        logp = F.log_softmax(logits, dim=-1)
        v = logp.shape[-1]
        joint = st["scores"][:, :, None] + logp.reshape(b, beams, v)
        scores, idx = _top_k(joint.reshape(b, beams * v), beams)
        rows = (torch.arange(b, device=dev)[:, None] * beams
                + idx // v).reshape(bw)
        for leaf in st["gcache"].values():
            leaf.copy_(leaf.index_select(1, rows))
        token = (idx % v).reshape(bw)
        out = st["out"].index_select(0, rows)
        out.index_copy_(1, st["i"] + 1, token[:, None])
        st["out"].copy_(out)
        st["token"].copy_(token)
        st["scores"].copy_(scores)
        st["i"].add_(1)

    kernels.run_graph(step, n_steps - 1, cached, "step")
    # the beams are score-sorted by the top-k: beam 0 is the best
    return (st["out"].reshape(b, beams, n_steps)[:, 0].clone(),
            st["scores"][:, 0].clone())


def _check_beams(cfg: LlamaConfig, beams: int) -> None:
    if not 1 <= beams <= cfg.vocab_size:
        raise ValueError(f"beams must be in [1, vocab_size={cfg.vocab_size}]"
                         f", got {beams}")


@torch.no_grad()
def beam_generate(params: dict, prompt, n_steps: int, cfg: LlamaConfig,
                  beams: int = 4, max_len: int | None = None,
                  kv_int8: bool = False, device="cuda", graphs: bool = True):
    """Beam search over the KV-cache decode loop (:func:`_beam_search`):
    returns (tokens [B, n_steps], the best beam per sequence, and its total
    log-probability [B] f32).  Scores are sums of log-probabilities; all
    beams have equal length, so none is normalized.  ``max_len`` checks the
    caller's length contract but sizes nothing: the cache is two segments
    of exactly T and ``n_steps - 1`` positions.  On the card the step runs
    as a CUDA graph; ``graphs=False`` runs it eagerly."""
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    _validate_rollout(cfg, prompt.shape[1], n_steps, max_len)
    _check_beams(cfg, beams)
    return _beam_search(params, prompt, cfg, n_steps, beams, kv_int8, None,
                        graphs and prompt.is_cuda)


@torch.no_grad()
def beam_generate_paged(params: dict, prompt, n_steps: int, cfg: LlamaConfig,
                        beams: int = 4, page_size: int = 128,
                        max_len: int | None = None, device="cuda",
                        graphs: bool = True):
    """:func:`beam_generate` with the prompt K/V on a page pool read by the
    paged kernel (kernel 4 on the card): the beams of a sequence alias its
    pages, which the kernel reads once per sequence, not once per beam.
    The pool is in the model dtype.  Same return contract and scores as the
    dense version."""
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    _validate_rollout(cfg, prompt.shape[1], n_steps, max_len)
    _check_beams(cfg, beams)
    return _beam_search(params, prompt, cfg, n_steps, beams, False, page_size,
                        graphs and prompt.is_cuda)


def _attend_buffer_partials(q: torch.Tensor, bk: torch.Tensor,
                            bv: torch.Tensor, j):
    """Softmax partials over a dense write buffer, valid at buffer index
    <= j (an int, or a [1] device tensor: the form a CUDA graph replays).
    q: [B, Hq, 1, D]; buffer [B, Hkv, stride, D].  Returns (o [B, Hq, D]
    f32 normalized, m [B, Hq], l [B, Hq]) for the flash-decoding merge
    with the paged pool's partials.  Shared by the serve engine's in-block
    buffer and the paged beam search's gen segment."""
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


def _check_spec(cfg: LlamaConfig, draft_layers: int, gamma: int) -> None:
    if not 1 <= draft_layers <= cfg.n_layers:
        raise ValueError(
            f"draft_layers {draft_layers} not in [1, {cfg.n_layers}]")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")


def _prefill_into(params: dict, prompt: torch.Tensor, cache: dict,
                  cfg: LlamaConfig) -> torch.Tensor:
    """Prefill ``prompt`` into ``cache`` (static state, reset first);
    returns the last position's logits [B, V]."""
    _reset_kv_cache(cache)
    return _forward_with_cache(params, prompt, cache, 0, cfg,
                               last_only=True)[0][:, -1]


@torch.no_grad()
def spec_generate(params: dict, prompt, n_steps: int, cfg: LlamaConfig,
                  draft_layers: int, gamma: int = 4,
                  max_len: int | None = None, kv_int8: bool = False,
                  dparams: dict | None = None, device="cuda",
                  graphs: bool = True):
    """Greedy speculative decoding as a host loop: the first
    ``draft_layers`` of the model (``dparams``, a :func:`draft_view` built
    once by the caller, else here) propose ``g = min(gamma, remaining)``
    tokens, then ONE chunked full-model forward verifies [cur, d_1..d_g];
    the longest matching prefix, capped at ``g - 1`` (the g-th draft was
    never processed by the draft, so accepting it would leave a hole in its
    cache; when all match it comes back as the correction) and by the
    budget, is accepted, plus the full model's argmax after it.  The batch
    runs in lockstep on the smallest acceptance, read on the host once an
    iteration (the reference's design).  Every emitted token is the full
    model's argmax: the output equals :func:`greedy_generate`'s, up to
    rounding of the chunked forward in bf16.  On the card each iteration's
    draft steps and verify are one CUDA graph (one a ``g``).  Returns
    (tokens [B, n_steps], {"iterations": full-model forwards,
    "acceptance_rate": accepted / acceptable slots})."""
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    b, t = prompt.shape
    max_len = _validate_rollout(cfg, t, n_steps, max_len)
    _check_spec(cfg, draft_layers, gamma)
    if dparams is None:
        dparams = draft_view(params, draft_layers)
    dcfg = replace(cfg, n_layers=draft_layers)
    dev = prompt.device

    def make() -> dict:
        long = dict(dtype=torch.long, device=dev)
        return {"fcache": init_kv_cache(cfg, b, max_len, kv_int8, device=dev),
                "dcache": init_kv_cache(dcfg, b, max_len, kv_int8,
                                        device=dev),
                "cur": torch.zeros((b,), **long),
                "pos": torch.zeros((1,), **long),
                "drafted": torch.zeros((b, gamma), **long),
                "f": torch.zeros((b, gamma + 1), **long)}

    st, cached = _loop_state(
        ("spec", cfg, draft_layers, b, max_len, gamma, kv_int8, str(dev)),
        {"full": params, "draft": dparams}, make, graphs and prompt.is_cuda)
    st["cur"].copy_(_prefill_into(params, prompt, st["fcache"],
                                  cfg).argmax(dim=-1))
    _prefill_into(dparams, prompt, st["dcache"], dcfg)
    st["pos"].fill_(t)

    def draft_and_verify(g: int) -> None:
        tok = st["cur"]
        for i in range(g):
            dlogits, _ = decode_step(dparams, st["dcache"], tok,
                                     st["pos"] + i, dcfg)
            tok = dlogits.argmax(dim=-1)
            st["drafted"][:, i] = tok
        chunk = torch.cat([st["cur"][:, None], st["drafted"][:, :g]], dim=1)
        vlogits, _ = _forward_with_cache(params, chunk, st["fcache"],
                                         st["pos"], cfg)
        st["f"][:, :g + 1] = vlogits.argmax(dim=-1)

    out = [st["cur"].clone()]
    iterations = proposed = accepted = 0
    while len(out) < n_steps:
        if n_steps - len(out) == 1:
            # a draft cannot help (take caps at 0): one full-model step
            vlogits, _ = _forward_with_cache(params, st["cur"][:, None],
                                             st["fcache"], st["pos"], cfg)
            out.append(vlogits[:, 0].argmax(dim=-1))
            iterations += 1
            break
        g = min(gamma, n_steps - len(out))
        kernels.run_graph(lambda: draft_and_verify(g), 1, cached, f"iter{g}")
        matched, _ = spec_acceptance(st["drafted"][:, :g], st["f"], g)
        j = int(matched.min())                      # the host read
        take = min(j, g - 1, n_steps - len(out) - 1)
        out.extend(st["drafted"][:, i].clone() for i in range(take))
        st["cur"].copy_(st["f"][:, take])
        out.append(st["cur"].clone())
        st["pos"].add_(take + 1)
        iterations += 1
        # g - 1 acceptable slots: the g-th draft is only ever emitted as
        # the correction, so a perfect draft reads 1.0
        proposed += g - 1
        accepted += take
    return torch.stack(out[:n_steps], dim=1), {
        "iterations": iterations,
        "acceptance_rate": accepted / proposed if proposed else 0.0}


# -- the fused loops: acceptance on the device, replayed in blocks ----------

def _read_loop_state(st: dict) -> list[int]:
    """The fused loop's counters ``[n_out, iterations, accepted,
    proposed]``: its one host read a block."""
    return st["ctr"].tolist()


def _fused_loop(st: dict, body, n_steps: int, max_emit: int,
                cached: dict | None) -> dict:
    """Run ``body`` (one iteration, acceptance on the device) until
    ``n_steps`` tokens are out: the reference's ``lax.while_loop``, replayed
    in blocks.  An iteration emits at least one token and at most
    ``max_emit``, so a block of ``ceil(remaining / max_emit)`` iterations
    cannot reach ``n_steps`` before its last one starts: no iteration runs
    past the end, and the host reads the counters once a block.  With
    ``cached`` the body is a CUDA graph (``"iter"``).  Returns the stats."""
    n_out, iterations, accepted, proposed = 1, 0, 0, 0
    while n_out < n_steps:
        kernels.run_graph(body, -(-(n_steps - n_out) // max_emit), cached,
                          "iter")
        n_out, iterations, accepted, proposed = _read_loop_state(st)
    return {"iterations": iterations,
            "acceptance_rate": accepted / proposed if proposed else 0.0}


def _fused_state(b: int, width: int, dev) -> dict:
    long = dict(dtype=torch.long, device=dev)
    return {"out": torch.zeros((b, width), **long),
            "cur": torch.zeros((b,), **long),
            "pos": torch.zeros((1,), **long),
            "ctr": torch.zeros((4,), **long)}


def _start(st: dict, logits: torch.Tensor, t: int) -> None:
    """The loop's state after the prefill: token 0 = the prefill's argmax
    at position ``t``, one token out, the counters at zero."""
    st["cur"].copy_(logits.argmax(dim=-1))
    st["out"].zero_()
    st["out"][:, 0] = st["cur"]
    st["pos"].fill_(t)
    st["ctr"].zero_()
    st["ctr"][0] = 1


def _advance(st: dict, drafted: torch.Tensor, f: torch.Tensor,
             take: torch.Tensor, prop_i: torch.Tensor) -> None:
    """End of a fused iteration: write the fixed γ+1 slab at ``n_out`` into
    ``st["out"]`` (the ``take`` accepted drafts, then the correction
    ``f[:, take]`` as filler to the end: the next slab starts after the
    accepted prefix and overwrites it), move ``cur`` and ``pos`` and the
    counters ``[n_out, iterations, accepted, proposed]``.  ``take`` and
    ``prop_i`` are [1] device tensors."""
    b, gamma = drafted.shape
    slots = torch.arange(gamma + 1, device=f.device)
    corr = f.gather(1, take.expand(b)[:, None])                  # [B, 1]
    emit = torch.where(slots < take,
                       torch.cat([drafted, drafted[:, -1:]], dim=1), corr)
    st["out"].index_copy_(1, st["ctr"][0:1] + slots, emit)
    st["cur"].copy_(corr[:, 0])
    st["pos"].add_(take + 1)
    st["ctr"].add_(torch.cat([take + 1, torch.ones_like(take), take,
                              prop_i]))


def _spec_fused(params: dict, dparams: dict, prompt: torch.Tensor,
                cfg: LlamaConfig, n_steps: int, max_len: int,
                draft_layers: int, gamma: int, kv_int8: bool, graphs: bool):
    """The loop of :func:`spec_generate_fused`; ``graphs`` captures its
    iteration and replays it (:func:`_fused_loop`)."""
    b, t = prompt.shape
    dev = prompt.device
    dcfg = replace(cfg, n_layers=draft_layers)
    # a verify chunk writes cache rows up to pos + γ, up to γ - 1 past the
    # last emitted token; the out slab may overhang by γ + 1
    clen = max_len + gamma

    def make() -> dict:
        st = _fused_state(b, n_steps + gamma + 1, dev)
        st["fcache"] = init_kv_cache(cfg, b, clen, kv_int8, device=dev)
        st["dcache"] = init_kv_cache(dcfg, b, clen, kv_int8, device=dev)
        return st

    st, cached = _loop_state(
        ("spec_fused", cfg, draft_layers, b, t, n_steps, max_len, gamma,
         kv_int8, str(dev)), {"full": params, "draft": dparams}, make, graphs)
    logits = _prefill_into(params, prompt, st["fcache"], cfg)
    _prefill_into(dparams, prompt, st["dcache"], dcfg)
    _start(st, logits, t)

    def body() -> None:
        pos, n_out = st["pos"], st["ctr"][0:1]
        tok, drafted = st["cur"], []
        for i in range(gamma):
            dlogits, _ = decode_step(dparams, st["dcache"], tok, pos + i,
                                     dcfg)
            tok = dlogits.argmax(dim=-1)
            drafted.append(tok)
        drafted = torch.stack(drafted, dim=1)                     # [B, γ]
        chunk = torch.cat([st["cur"][:, None], drafted], dim=1)
        vlogits, _ = _forward_with_cache(params, chunk, st["fcache"], pos,
                                         cfg)
        f = vlogits.argmax(dim=-1)
        matched, _ = spec_acceptance(drafted, f, gamma)
        # lockstep: the batch's smallest match, capped at γ - 1 (as the
        # host loop) and by the budget
        take = torch.minimum(matched.min().clamp(max=gamma - 1).long(),
                             n_steps - 1 - n_out)
        # the host loop's g - 1 with g = min(γ, remaining)
        _advance(st, drafted, f, take,
                 (n_steps - n_out).clamp(max=gamma) - 1)

    stats = _fused_loop(st, body, n_steps, gamma, cached)
    return st["out"][:, :n_steps].clone(), stats


@torch.no_grad()
def spec_generate_fused(params: dict, prompt, n_steps: int, cfg: LlamaConfig,
                        draft_layers: int, gamma: int = 4,
                        max_len: int | None = None, kv_int8: bool = False,
                        dparams: dict | None = None, device="cuda",
                        graphs: bool = True):
    """:func:`spec_generate` with the acceptance on the device: each
    iteration writes a fixed slab of γ+1 tokens at offset ``n_out`` (the
    accepted drafts, then the correction as filler that the next slab
    overwrites) and counts iterations, accepted and acceptable slots there.
    The loop runs in blocks that cannot pass ``n_steps``
    (:func:`_fused_loop`), the counters read once a block: on the card the
    iteration is one CUDA graph, replayed.  Same contract, tokens and stats
    as :func:`spec_generate`."""
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    max_len = _validate_rollout(cfg, prompt.shape[1], n_steps, max_len)
    _check_spec(cfg, draft_layers, gamma)
    if dparams is None:
        dparams = draft_view(params, draft_layers)
    return _spec_fused(params, dparams, prompt, cfg, n_steps, max_len,
                       draft_layers, gamma, kv_int8,
                       graphs and prompt.is_cuda)


# -- prompt-lookup decoding ---------------------------------------------------

def _pld_lookup(seq: torch.Tensor, pos: torch.Tensor, ngram: int,
                gamma: int) -> torch.Tensor:
    """The prompt-lookup draft [B, γ]: the γ tokens of ``seq`` [B, S] that
    followed the LATEST position i < ``pos`` whose ``ngram``-window (ending
    at i) equals the window ending at ``pos`` ([1] device tensor); with no
    match, the token at ``pos`` repeated.  Windows are cut as JAX's
    ``dynamic_slice`` cuts them: a start out of range is clamped into it,
    so at ``pos < ngram - 1`` the window is ``seq[:, :ngram]``."""
    b, s = seq.shape
    ar = torch.arange(s, device=seq.device)
    w = seq.index_select(1, (pos - ngram + 1).clamp(0, s - ngram)
                         + ar[:ngram])                             # [B, n]
    m = torch.ones_like(seq, dtype=torch.bool)
    for k in range(ngram):
        shift = ngram - 1 - k
        shifted = F.pad(seq, (shift, 0))[:, :s] if shift else seq
        m &= shifted == w[:, k:k + 1]
    cand = (ar >= ngram - 1) & (ar < pos)
    i_match = torch.where(m & cand, ar, -1).amax(dim=1)            # [B]
    start = (i_match + 1).clamp(0, s - gamma)
    cont = seq.gather(1, start[:, None] + ar[:gamma])
    last = seq.index_select(1, pos.clamp(0, s - 1))
    return torch.where((i_match >= 0)[:, None], cont, last)


def _paged_chunk_forward(params: dict, chunk: torch.Tensor, st: dict,
                         pos: torch.Tensor, cfg: LlamaConfig,
                         page_size: int) -> torch.Tensor:
    """The verify forward with the KV history on the page pool
    ``st["pool"]``: the serving engine's ``verify_forward`` at ``t = t_pad
    = 0`` and ``d = pos``.  The chunk's C = γ+1 queries fold into the paged
    kernel's group over the history ``[0, pos)``; its K/V is written in
    place at ``[pos, pos + C)`` through the row's page table (a rejected
    entry is masked by the next iteration's smaller ``d`` and overwritten);
    in-chunk causality comes from the causal partials.  Returns logits [B,
    C, V] f32."""
    from kubegpu_tpu_torch.models.serve import verify_forward  # imports us
    b = chunk.shape[0]
    rows = pos.expand(b)
    return verify_forward(params, chunk, st["pool"], st["pt"], st["tvec"],
                          st["tvec"], rows.to(torch.int32), rows, cfg,
                          page_size)


def _check_pld(gamma: int, ngram: int) -> None:
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")


def _pld(params: dict, prompt: torch.Tensor, cfg: LlamaConfig, n_steps: int,
         max_len: int, gamma: int, ngram: int, kv_int8: bool,
         page_size: int | None, graphs: bool):
    """The loop of :func:`pld_generate_fused` (``page_size`` None: the dense
    cache) and :func:`pld_generate_paged` (a pool of ``ceil(clen/P) + 1``
    contiguous pages a row: the spare page keeps the chunk's writes on the
    row).  Each iteration looks the draft up over ``[prompt, out]``
    (:func:`_pld_lookup`), verifies [cur, draft] in one chunked forward and
    accepts the batch's smallest match with NO γ - 1 cap (there is no draft
    cache to keep whole; a full match yields γ+1 tokens), capped by the
    budget."""
    b, t = prompt.shape
    dev = prompt.device
    clen = max_len + gamma
    n_row = None if page_size is None else -(-clen // page_size) + 1

    def make() -> dict:
        st = _fused_state(b, n_steps + gamma + 1, dev)
        st["prompt"] = torch.zeros((b, t), dtype=torch.long, device=dev)
        if n_row is None:
            st["fcache"] = init_kv_cache(cfg, b, clen, kv_int8, device=dev)
        else:
            st.update(_page_pool(cfg, b, n_row, page_size, dev))
        return st

    st, cached = _loop_state(("pld", cfg, b, t, n_steps, max_len, gamma,
                              ngram, kv_int8, page_size, str(dev)), params,
                             make, graphs)
    st["prompt"].copy_(prompt)
    if n_row is None:
        logits = _prefill_into(params, prompt, st["fcache"], cfg)
    else:
        logits = _fill_pool(st, params, prompt, cfg, n_row, page_size)
    _start(st, logits, t)

    def body() -> None:
        pos, n_out = st["pos"], st["ctr"][0:1]
        # cur sits at sequence index pos = t + n_out - 1
        drafted = _pld_lookup(torch.cat([st["prompt"], st["out"]], dim=1),
                              pos, ngram, gamma)
        chunk = torch.cat([st["cur"][:, None], drafted], dim=1)
        if n_row is None:
            vlogits, _ = _forward_with_cache(params, chunk, st["fcache"], pos,
                                             cfg)
        else:
            vlogits = _paged_chunk_forward(params, chunk, st, pos, cfg,
                                           page_size)
        f = vlogits.argmax(dim=-1)
        matched, _ = spec_acceptance(drafted, f, gamma)
        budget = n_steps - 1 - n_out
        _advance(st, drafted, f, torch.minimum(matched.min().long(), budget),
                 budget.clamp(max=gamma))

    stats = _fused_loop(st, body, n_steps, gamma + 1, cached)
    return st["out"][:, :n_steps].clone(), stats


@torch.no_grad()
def pld_generate_fused(params: dict, prompt, n_steps: int, cfg: LlamaConfig,
                       gamma: int = 8, ngram: int = 3,
                       max_len: int | None = None, kv_int8: bool = False,
                       device="cuda", graphs: bool = True):
    """Prompt-lookup (n-gram) speculative decoding, acceptance on the
    device (:func:`_pld`): the draft is the continuation of the latest
    earlier occurrence of the sequence's trailing ``ngram``, so there is no
    draft model and every iteration costs one chunked (γ+1) forward.  Every
    emitted token is the full model's argmax (the lookup decides how many
    each forward yields, never which).  The loop runs in blocks that cannot
    pass ``n_steps`` (:func:`_fused_loop`); on the card the iteration is one
    CUDA graph.  Returns (tokens [B, n_steps], {"iterations",
    "acceptance_rate"})."""
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    max_len = _validate_rollout(cfg, prompt.shape[1], n_steps, max_len)
    _check_pld(gamma, ngram)
    return _pld(params, prompt, cfg, n_steps, max_len, gamma, ngram, kv_int8,
                None, graphs and prompt.is_cuda)


@torch.no_grad()
def pld_generate_paged(params: dict, prompt, n_steps: int, cfg: LlamaConfig,
                       gamma: int = 8, ngram: int = 3,
                       max_len: int | None = None, page_size: int = 128,
                       device="cuda", graphs: bool = True):
    """:func:`pld_generate_fused` with the KV history on a page pool of the
    model dtype, read by the paged kernel (kernel 4 on the card) with the
    chunk's queries folded into its group.  Same contract and stats.
    ``gamma > page_size`` raises ``ValueError``: the reference writes the
    chunk into a two-page window whose ``dynamic_update_slice`` clamps, so
    there a chunk that starts late in a page lands shifted over the
    history."""
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    max_len = _validate_rollout(cfg, prompt.shape[1], n_steps, max_len)
    _check_pld(gamma, ngram)
    if gamma > page_size:
        raise ValueError(f"gamma {gamma} > page_size {page_size}: the "
                         "verify chunk would not fit its two-page window")
    return _pld(params, prompt, cfg, n_steps, max_len, gamma, ngram, False,
                page_size, graphs and prompt.is_cuda)
