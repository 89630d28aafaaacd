"""KV-cache prefill and greedy decode for the Llama family (counterpart of
``kubegpu_tpu/models/decode.py``).

The cache is a stacked ``[L, B, Hkv, max_len, hd]`` pair allocated once;
the forward writes new K/V rows into it IN PLACE (the reference returns an
updated copy).  Attention over the cache is the plain grouped einsum — the
reference has no kernel there either.  :func:`greedy_generate` is the solo
oracle every serving parity check holds the engine to.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kubegpu_tpu_torch.models.llama import (
    LlamaConfig,
    _rmsnorm,
    _rope,
    embed_lookup,
    layer_params,
)
from kubegpu_tpu_torch.ops.flash_attention import NEG_INF


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int | None = None,
                  device="cuda") -> dict:
    """Zeroed stacked cache in the model dtype; ``max_len`` defaults to
    cfg.max_seq_len.  (The int8 cache waits for the KV-quant slice.)"""
    s = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, s, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.tdtype, device=device)}


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
                 cfg: LlamaConfig) -> torch.Tensor:
    """Attention output [B, H, T, hd] → wo projection + residual +
    feed-forward."""
    b, t = x.shape[0], x.shape[1]
    o = o.transpose(1, 2).reshape(b, t, cfg.n_heads * cfg.head_dim)
    x = x + (o @ lp["wo"]).to(x.dtype)
    return _dense_ffn(x, lp, cfg)


def _forward_with_cache(params: dict, tokens: torch.Tensor, cache: dict,
                        pos_offset: int, cfg: LlamaConfig):
    """Run the decoder over ``tokens`` [B, T] starting at global position
    ``pos_offset``, writing K/V into ``cache`` in place.  Returns (logits
    [B, T, vocab] f32, cache)."""
    b, t = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    q_pos = pos_offset + torch.arange(t, device=tokens.device)
    positions = q_pos[None, :].expand(b, t)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg, positions)
        ck, cv = cache["k"][i], cache["v"][i]
        ck[:, :, pos_offset:pos_offset + t] = k.to(ck.dtype)
        cv[:, :, pos_offset:pos_offset + t] = v.to(cv.dtype)
        x = _attn_finish(x, _cached_attend(q, ck, cv, q_pos), lp, cfg)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float(), cache


def prefill(params: dict, prompt: torch.Tensor, cfg: LlamaConfig,
            max_len: int | None = None):
    """Process the whole prompt [B, T]; returns (last-position logits
    [B, vocab], primed cache)."""
    cache = init_kv_cache(cfg, prompt.shape[0], max_len,
                          device=prompt.device)
    logits, cache = _forward_with_cache(params, prompt, cache, 0, cfg)
    return logits[:, -1], cache


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos: int,
                cfg: LlamaConfig):
    """One token in, next-token logits out.  token: [B]; ``pos``: the
    global position of ``token``."""
    logits, cache = _forward_with_cache(params, token[:, None], cache, pos,
                                        cfg)
    return logits[:, 0], cache


def _validate_rollout(cfg: LlamaConfig, t: int, n_steps: int,
                      max_len: int | None) -> int:
    max_len = max_len or cfg.max_seq_len
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if t + n_steps > max_len:
        raise ValueError(f"prompt {t} + steps {n_steps} > max_len {max_len}")
    return max_len


def _rollout(params, prompt, cfg: LlamaConfig, t: int, n_steps: int,
             max_len: int, pick) -> torch.Tensor:
    """THE decode loop: prefill, then ``n_steps - 1`` decode forwards.
    ``pick(logits, step_index)`` selects each token."""
    logits, cache = prefill(params, prompt, cfg, max_len)
    token = pick(logits, 0)
    toks = [token]
    for i in range(n_steps - 1):
        logits, cache = decode_step(params, cache, token, t + i, cfg)
        token = pick(logits, i + 1)
        toks.append(token)
    return torch.stack(toks, dim=1)


@torch.no_grad()
def greedy_generate(params: dict, prompt, n_steps: int, cfg: LlamaConfig,
                    max_len: int | None = None, device="cuda"
                    ) -> torch.Tensor:
    """Greedy decode ``n_steps`` tokens after ``prompt`` [B, T] (moved to
    ``device``).  Returns the generated tokens [B, n_steps] (int64)."""
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    t = prompt.shape[1]
    max_len = _validate_rollout(cfg, t, n_steps, max_len)
    return _rollout(params, prompt, cfg, t, n_steps, max_len,
                    pick=lambda logits, i: logits.argmax(dim=-1))


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
