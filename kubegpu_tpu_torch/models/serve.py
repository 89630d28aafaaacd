"""Continuous batching (counterpart of the greedy core of
``kubegpu_tpu/models/serve.py``): the dense slot engine (``paged=False``,
the default) and the paged one.

The dense engine keeps one ``[L, n_slots, Hkv, max_len, D]`` cache row a
slot.  A wave's prompts prefill into a ``max_len``-wide panel whose rows are
copied whole into their slots; each tick runs ``stride`` decode steps for
every slot, attending over the row's flushed history (``k_pos <
flush_pos``) and this block's keys in a write buffer, and then flushes the
buffer at each row's block-start position.  An inactive row holds its
position, so its garbage flush may start past ``max_len - stride``: the
start is clamped there, as ``lax.dynamic_update_slice`` clamps it in the
reference, and lands in the row's own cache, which the next admission
overwrites whole.

In the paged engine the KV history lives in a page pool ``[L, n_pages,
Hkv, P, D]`` shared by every slot; page 0 is a trash page that is never
allocated.  A request is prefilled in a wave (a ``[k, bucket]`` batch of
same-bucket prompts), its prompt K/V copied page by page into the pages it
was given, and then every engine tick runs ``stride`` decode steps for all slots: the flushed history
through the paged-attention kernel, this block's keys through a dense write
buffer, merged as flash-decoding partials.  At the end of the block the
buffer is flushed into each row's current decode page.

Two fast paths of the paged engine share one executable, the chunk step
(:func:`chunk_body`): one page-aligned chunk of C prompt positions of
one slot, its K/V written straight into the slot's pages, attending the
history ``[0, s)`` through the paged kernel (the chunk's C queries folded
into its query-head dim) merged with the chunk's own causal partials.
``chunked_prefill`` admits a prompt longer than ``prefill_chunk`` as such
chunks, one a slot and ``step()``, between decode ticks; ``prefix_cache``
keeps every full prompt page under a key of the prompt up to its end, so
a later request with the same leading pages aliases them (a refcount a
page; registered pages stay at refcount 0 until an allocation needs them,
least recently used first) and prefills its tail through chunks.

Speculative decoding (``spec_gamma=γ``; the reference's batched
early-exit self-draft) replaces the tick: the first ``draft_layers`` layers
of the same weights (:func:`draft_view`, views) propose γ tokens a slot
through :func:`_paged_row_step`, reading the shared pool, and one
full-model :func:`verify_forward` scores all ``[n_slots, γ+1]`` positions:
their K/V written into each row's 2-page window through its page table,
the history through the paged kernel over folded queries (the chunk
step's composition, batched), the chunk's own part through causal
partials.  Each slot keeps its longest full-model-agreed prefix, capped by
an adaptive per-slot γ, plus the correction token, so every token is the
full model's argmax; rejected entries roll back by validity alone.

The pool may hold int8 pages with per-token scales (``kv_bits=8``) or packed
int4 pages with one scale per ``kv_group`` tokens (``kv_bits=4``); every
write path quantizes through :mod:`kubegpu_tpu_torch.ops.kvquant`, while the
in-block buffer stays in the model dtype.  ``evict_policy`` drops cold
prompt pages in the middle of decoding ("window": below a trailing window;
"mass": below an EMA of the per-page attention mass the paged kernel
reports) and turns them into page-id-0 holes the kernel skips.

The reference's executables (``decode_block``, ``prefill_wave``,
``adopt_wave``, ``prefill_chunk`` as :func:`chunk_body`, ``activate_slot``)
are plain functions
here; its ``lax.scan`` over the stride steps is a Python loop.  The cache or pool and the per-slot device vectors
are updated IN PLACE (the reference donates and rebinds them), and so are
the page tables and per-slot scalars the tick reads, which live in device
buffers allocated once and refreshed by one copy from pinned host memory a
dispatch.  On the card the tick (:func:`tick_body`: ``decode_block``
inside the reference's lane freeze; :func:`spec_tick_body` on a
speculative engine; :func:`dense_tick_body` on the dense engine) is
captured once into
a CUDA graph (:class:`kubegpu_tpu_torch.kernels.Graph`), the counterpart
of the reference's compiled executable, and every tick replays it;
``fused_ticks=K`` replays it K times a dispatch with one host fetch.  The
chunk step (:func:`chunk_body`) is a second graph, of one shape, reading
its chunk, start, length and page-table row from a device buffer that one
copy a call fills.  Prefill waves and admission stay eager.
``graphs=False`` runs the same bodies eagerly on the card (for A/B runs);
on the CPU they are called directly.

Greedy tokens are bit-identical to a solo :func:`greedy_generate` at the
tested f32 configurations; at other batch shapes a near-tied argmax may
flip, as the reference documents.  A ``sampling=True`` engine draws its
temperature-scaled top-k samples on the reference's key schedule
(:mod:`kubegpu_tpu_torch.prng`), so sampled tokens equal the reference's
too.

The request lifecycle is the reference single engine's and lives on the
host: tier-strict EDF admission with preemption of lower-tier greedy
decoders, deadlines, ``cancel``, tenant quotas, and self-defense (chaos
injection, the quarantine of a slot whose logits went non-finite and the
replay of its request as prompt + accepted tokens, dispatch retries, a
watchdog).

The engine also serves the MoE family: handed a
:class:`~kubegpu_tpu_torch.models.moe.MoEConfig`, it runs the config's
Llama backbone (``cfg`` is ``cfg.base``) with the routed experts as the
feed-forward of every body that reaches the FFN (``ffn``): a prefill
wave's row, a chunk and a decode step's token each route as one group, as
in the reference.  Speculative decoding is refused for it, as there.

Page chains migrate between engines (``migrate_out``, ``import_chain``),
and :class:`DataParallelServePool` and :class:`DisaggServePool` run several
engines behind one queue: routing by prefix affinity, failover by replay,
the scale surface, and prefill/decode disaggregation.

The engine keeps the reference's host-side accounting whatever the knobs
(prefill waves, per-tick decode stall, busy ticks and the chip-tick cost
ledger, the readout's and the host's wall a step, live state bytes) and,
given a ``tracer``, its request spans; none of it runs inside a captured
graph, and no traced value feeds device math.
"""

from __future__ import annotations

import functools
import hashlib
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from kubegpu_tpu_torch.models.decode import (
    _attend_buffer_partials,
    _attn_finish,
    _chunk_causal_partials,
    _forward_with_cache,
    _gathered_head,
    _lm_head,
    _project_qkv,
    _quantize_rows,
    _sample_token,
    draft_view,
    init_kv_cache,
    spec_acceptance,
    truncate_at_eos,
)
from kubegpu_tpu_torch.models.llama import (
    LlamaConfig,
    _rmsnorm,
    embed_lookup,
    unbind_layers,
)
from kubegpu_tpu_torch.models.moe import MoEConfig, _moe_decode_ffn
from kubegpu_tpu_torch.models.quant import QTensor
from kubegpu_tpu_torch import kernels, prng
from kubegpu_tpu_torch.kubemeta.codec import pod_gang_spec
from kubegpu_tpu_torch.obs.chaos import (
    DispatchFailure,
    ReplicaDeadError,
    TickStallError,
)
from kubegpu_tpu_torch.obs.cost import CostLedger
from kubegpu_tpu_torch.obs.metrics import LiveBytesTracker
from kubegpu_tpu_torch.ops.flash_attention import NEG_INF
from kubegpu_tpu_torch.ops.kvquant import (
    Q4_ZERO_BYTE,
    dequantize_q4,
    quantize_groups_q4,
)
from kubegpu_tpu_torch.ops.paged_attention import (
    decode_capacity,
    fold_chunk_queries,
    gather_pages,
    merge_partials,
    page_table_size,
    paged_attention,
    scatter_pages,
)
from kubegpu_tpu_torch.parallel.collectives import (
    all_gather_dim,
    broadcast_float,
)

# Reference knobs this slice does not port: name -> (default, ROADMAP.md
# queue-1 item that brings it).  The default is accepted; any other value
# raises.  Every knob is ported (``mesh`` since the tensor-parallel
# engine, with page-chain migration under it and the pools at tp > 1).
_LATER: dict = {}

# The same for ``submit``'s keywords: every one is ported.
_LATER_SUBMIT: dict = {}


# per-tick accounting window (entries a list keeps), as the reference's
_ACCT_CAP = 32768


def _trim_acct(xs: list) -> None:
    """Once an accounting list (``stall_ms``, ``wave_sizes``,
    ``_tick_log``, ...) exceeds ``_ACCT_CAP`` entries, drop its oldest
    entries down to half the cap, so an engine serving indefinitely holds
    a bounded recent window (the reference's sweep)."""
    if len(xs) > _ACCT_CAP:
        del xs[:len(xs) - _ACCT_CAP // 2]


def _refuse_later(table: dict, given: dict) -> None:
    """Accept each of ``given``'s knobs at its reference default in
    ``table``; raise ``NotImplementedError`` naming its ROADMAP.md item
    at any other value (and ``TypeError`` for a name the reference does
    not have)."""
    for name, value in given.items():
        if name not in table:
            raise TypeError(f"unexpected keyword argument {name!r}")
        default, item = table[name]
        if value != default:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet "
                f"(ROADMAP.md queue 1: {item})")


# the page cap a single-tick dispatch uploads: the reference's K = 1 tick has
# no lane freeze, so no lane of one may stall on its pages
_NO_CAP = np.iinfo(np.int32).max // 2


def _gamma_from_accept(ema: np.ndarray, gamma: int) -> np.ndarray:
    """Adaptive per-slot draft depth: the rolling acceptance EMA mapped
    monotonically onto [0, γ] (``floor(ema·(γ+1))`` clipped).  A slot at
    0 emits one full-model token a tick, while its EMA keeps updating from
    the UNCAPPED match length, so it can recover its depth."""
    return np.clip(np.floor(ema * (gamma + 1)).astype(np.int32), 0, gamma)


def _pick_token(logits: torch.Tensor, temps: torch.Tensor | None = None,
                key: torch.Tensor | None = None, top_k: int = 0,
                sampling: bool = False) -> torch.Tensor:
    """Per-slot greedy or sampled selection over [B, V] logits (the
    reference's ``_pick_token``).  Without ``sampling`` (static, as the
    reference's flag: a greedy engine never draws noise) the argmax; with
    it, rows whose temperature ``temps`` [B] is positive draw
    :func:`_sample_token` under ``key`` with the engine's ``top_k`` and no
    nucleus, and the others keep the argmax."""
    greedy = logits.argmax(dim=-1)
    if not sampling:
        return greedy
    sampled = _sample_token(logits, key, temps[:, None], 1.0, top_k,
                            nucleus=False)
    return torch.where(temps > 0, sampled, greedy)


def _step_pick(sample: dict | None, j: int):
    """The pick of step ``j`` of a block: greedy without ``sample``, else
    the sampled pick under the block's key row ``j`` (``sample``: the
    slots' ``temps``, the block's ``keys``, the engine's ``top_k``)."""
    if sample is None:
        return _pick_token
    return lambda logits: _pick_token(logits, sample["temps"],
                                      sample["keys"][j], sample["top_k"],
                                      True)


def _paged_row_step(params: dict, tokens: torch.Tensor, pool: dict,
                    pt: torch.Tensor, tvec: torch.Tensor, tpad: torch.Tensor,
                    d0: torch.Tensor, buf: dict, pos: torch.Tensor, j: int,
                    cfg: LlamaConfig, collect_mass: bool = False, ffn=None,
                    tp_group=None):
    """One decode step for every slot against the paged pool: flushed
    history via the paged kernel, this block's keys via the write buffer
    (written in place at index ``j``), merged with the flash-decoding
    logsumexp merge.  Returns next-token logits [B, V] f32 and, with
    ``collect_mass``, the per-page attention mass [B, max_pages] averaged
    over layers.  ``ffn`` overrides the feed-forward sublayer (MoE: each
    slot's one token is a routing group).

    Under tensor parallelism (``tp_group``) ``cfg`` is the rank's LOCAL
    config, the pool and buffer hold its KV heads, the paged kernel walks
    those alone, the row-split projections are all-reduced, and the
    vocabulary shards of the logits are all-gathered: the returned logits
    are the full [B, V] on every rank, so every rank picks the same
    token."""
    x = embed_lookup(params["embed"], tokens)[:, None, :]        # [B,1,D]
    positions = pos[:, None]
    k_scale, v_scale = pool.get("k_scale"), pool.get("v_scale")
    masses = []
    for li, lp in enumerate(unbind_layers(params["layers"])):
        h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg, positions)            # [B,H,1,D]
        bk, bv = buf["k"][li], buf["v"][li]
        bk[:, :, j] = k[:, :, 0].to(bk.dtype)
        bv[:, :, j] = v[:, :, 0].to(bv.dtype)
        parts = paged_attention(
            q[:, :, 0, :].contiguous(), pool["k"], pool["v"], pt, li, tvec,
            tpad, d0, k_scale, v_scale, collect_mass)
        o_p, m_p, l_p = parts[:3]
        masses += parts[3:]
        o_b, m_b, l_b = _attend_buffer_partials(q, bk, bv, j)
        o = merge_partials(o_p, m_p, l_p, o_b, m_b, l_b)
        x = _attn_finish(x, o[:, :, None, :].to(x.dtype), lp, cfg, ffn,
                         tp_group)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _lm_head(params, x, tp_group)[:, 0]
    if collect_mass:
        return logits, torch.stack(masses).mean(dim=0)
    return logits


def _quantize_like(pool: dict, kv: dict, page_size: int) -> dict:
    """Rate model-dtype K/V ``[..., T, D]`` into ``pool``'s format in one
    vectorized pass: int8 per token, or packed int4 per group of
    ``P / k_scale.shape[3]`` tokens along T (the callers' writes are
    group-aligned, so a group never straddles two writes).  A bf16/f32
    pool takes the values as they are."""
    if "k_scale" not in pool:
        return kv
    out = {}
    for name in ("k", "v"):
        if pool["k"].dtype == torch.uint8:
            vals, sc = quantize_groups_q4(
                kv[name], page_size // pool["k_scale"].shape[3])
        else:
            vals, sc = _quantize_rows(kv[name])
        out[name], out[f"{name}_scale"] = vals, sc
    return out


def _flush_buffer_paged(pool: dict, buf: dict, pt: torch.Tensor,
                        tpad: torch.Tensor, d0: torch.Tensor,
                        page_size: int) -> None:
    """Scatter the block buffer [L, B, Hkv, stride, D] into each row's
    CURRENT decode page of the pool, IN PLACE.  The decode region is
    page-aligned and stride divides P, so a block never splits a page --
    until a speculative engine degrades to this tick: its rows' positions
    are then not stride-aligned, and a block that would pass its page's
    end starts earlier, clamped as the reference's
    ``lax.dynamic_update_slice`` clamps it.  Retired rows carry a zeroed
    page-table row, so their garbage lands in trash page 0; the page-index
    clamp keeps stale positions in the table.  A quantized pool gets the
    whole buffer quantized once, and its scales scattered beside the
    values."""
    phys0 = tpad + d0
    pidx = torch.clamp(phys0 // page_size, 0, pt.shape[1] - 1)
    page = pt.gather(1, pidx[:, None].long())                    # [B, 1]
    for name, x in _quantize_like(pool, buf, page_size).items():
        # x: [L, B, Hkv, n, ...]: n tokens (values, int8 scales) or n
        # groups (int4 scales) of each row's block, written from the
        # block's offset in its decode page
        n = x.shape[3]
        per = page_size // pool[name].shape[3]   # tokens per entry
        first = torch.clamp((phys0 % page_size) // per,
                            max=pool[name].shape[3] - n)
        off = first[:, None] + torch.arange(n, device=pt.device)  # [B, n]
        # advanced indices around a slice: value dims are [B, n, L, Hkv, ...]
        pool[name][:, page.long().expand_as(off), :, off.long()] = \
            x.permute(1, 3, 0, 2, *range(4, x.dim())).to(pool[name].dtype)


@torch.no_grad()
def decode_block(params: dict, pool: dict, pt, tvec, tpad,
                 tokens: torch.Tensor, pos: torch.Tensor,
                 active: torch.Tensor, cfg: LlamaConfig, stride: int,
                 collect_mass: bool = False, sample: dict | None = None,
                 ffn=None, tp_group=None):
    """``stride`` decode steps for every slot, then the buffer flush.
    ``tokens``/``pos`` advance in place for active rows; the flushed
    decode count is ``pos - tvec`` for active rows and 0 for inactive
    ones.  Step j picks greedily, or with ``sample`` (see
    :func:`_step_pick`) under the block's key row j.  Returns (token block
    [stride, B], per-slot non-finite flag) and, with ``collect_mass``, the
    per-page attention mass averaged over the block's steps [B,
    max_pages], the signal mass eviction reads.  ``tp_group``: see
    :func:`_paged_row_step`."""
    d0 = torch.where(active, pos - tvec, torch.zeros_like(pos)).to(torch.int32)
    n_layers, _, hkv = pool["k"].shape[:3]
    b = tokens.shape[0]
    # the buffer stays in the model dtype whatever the pool's (a quantized
    # pool quantizes at the flush); an int4 pool's rows are D/2 wide, so
    # the buffer sizes off the config
    buf = {n: torch.zeros((n_layers, b, hkv, stride, cfg.head_dim),
                          dtype=cfg.tdtype, device=tokens.device)
           for n in ("k", "v")}
    bad = torch.zeros(b, dtype=torch.bool, device=tokens.device)
    macc = torch.zeros(pt.shape, dtype=torch.float32, device=tokens.device)
    block = []
    for j in range(stride):
        out = _paged_row_step(params, tokens, pool, pt, tvec, tpad, d0, buf,
                              pos, j, cfg, collect_mass, ffn, tp_group)
        if collect_mass:
            logits, pmass = out
            macc += pmass
        else:
            logits = out
        bad |= ~torch.isfinite(logits).all(dim=-1)
        nxt = torch.where(active, _step_pick(sample, j)(logits), tokens)
        tokens.copy_(nxt)
        pos.add_(active.to(pos.dtype))
        block.append(nxt)
    _flush_buffer_paged(pool, buf, pt, tpad, d0, pool["k"].shape[3])
    if collect_mass:
        return torch.stack(block), bad, macc / stride
    return torch.stack(block), bad


@torch.no_grad()
def tick_body(params: dict, tables: dict, st: dict, cfg: LlamaConfig,
              stride: int, eos_id: int | None = None,
              sampler: dict | None = None, ffn=None, tp_group=None) -> None:
    """ONE engine tick: :func:`decode_block` inside the reference's lane
    freeze (its ``_fused_body``), over the engine's ``tables`` (page
    table, lengths, page caps, token budgets, active mask) and state
    ``st`` (pool, slot vectors, freeze state, output views).  A lane runs
    while it is active, owes tokens (``emitted < budget``) and has never
    gone non-finite; a lane whose flush would pass its page cap raises
    ``stall`` and freezes, and (with an ``eos_id``) a lane whose block
    holds the EOS token latches ``dead``.  The block, the bad flags, the
    stalls, the
    first tokens and (with mass eviction) the block's page mass land in
    the output views at the dispatch's tick index ``tk``, which then
    advances.  A dispatch runs it K times; K = 1 is the plain tick, whose
    lanes never freeze (an active slot owes tokens and its pages cover
    its next block).  A sampling engine's ``sampler`` (``key0`` =
    ``fold_in(base, 0)``, ``top_k``) keys the tick ``tick + tk`` from the
    device tables, the reference's ``tick0 + tk``, so K fused ticks draw
    what K single ticks draw.  ``ffn`` is the engine's feed-forward
    override (MoE), ``tp_group`` its tensor-parallel group (``cfg`` then
    the local config).  The graph engine captures exactly this."""
    t, f, out = tables, st["freeze"], st["out"]
    act = (t["active"] != 0) & (f["emitted"] < t["budget"]) & (
        f["dead"] == 0)
    overrun = act & (st["pos"] - t["tvec"] + stride > t["cap"])
    f["stall"].logical_or_(overrun)
    act = act & ~overrun
    outs = decode_block(params, st["pool"], t["pt"], t["tvec"], t["tpad"],
                        st["tokens"], st["pos"], act, cfg, stride,
                        collect_mass=st["mass"] is not None,
                        sample=_tick_sample(sampler, t, f, st, stride),
                        ffn=ffn, tp_group=tp_group)
    block, bad = outs[:2]
    if eos_id is not None:
        f["dead"].logical_or_(act & (block == eos_id).any(dim=0))
    f["dead"].logical_or_(bad)
    f["emitted"].add_(act.to(torch.int32) * stride)
    tk = f["tk"].long()
    out["blocks"].index_copy_(0, tk, block[None])
    out["bads"].index_copy_(0, tk, bad.long()[None])
    out["stall"].copy_(f["stall"])
    out["firsts"].copy_(st["first_toks"])
    f["tk"].add_(1)
    if st["mass"] is not None:
        st["mass"].copy_(outs[2])


def _tick_sample(sampler: dict | None, tables: dict, freeze: dict,
                 st: dict, stride: int) -> dict | None:
    """A tick's sampling inputs (None on a greedy engine): the slots'
    temperatures and the keys of its ``stride`` steps, the reference's
    ``split(fold_in(fold_in(base, 0), tick), stride)`` with ``key0 =
    fold_in(base, 0)`` and the tick ``tables["tick"] + freeze["tk"]`` read
    on the device."""
    if sampler is None:
        return None
    tick = tables["tick"] + freeze["tk"]
    return {"temps": st["temps"], "top_k": sampler["top_k"],
            "keys": prng.split(prng.fold_in(sampler["key0"], tick), stride)}


# -- speculative decoding: early-exit self-draft and one batched verify -------

def _window_slots(pt: torch.Tensor, phys0: torch.Tensor, c: int,
                  page_size: int):
    """Pool page and in-page offset of each of the C positions ``phys0[b]
    + [0, C)`` of each row ([B, C] each).  A row-local page index past the
    table goes to trash page 0 (never a clamped index: at the table's
    edge the clamped index would be the row's live last page)."""
    n_wide = pt.shape[1]
    phys = phys0.long()[:, None] + torch.arange(c, device=pt.device)
    rl = phys // page_size
    pid = torch.where(rl < n_wide,
                      pt.long().gather(1, rl.clamp(max=n_wide - 1)), 0)
    return pid, phys % page_size


def _write_window(pool: dict, li: int, kv: dict, pt: torch.Tensor,
                  phys0: torch.Tensor, page_size: int) -> None:
    """Write each row's verify K/V ``kv`` ([B, Hkv, C, D] in the model
    dtype) into layer ``li`` of the pool at phys ``[phys0, phys0 + C)``
    through its page table, IN PLACE, with the reference's bytes (its
    ``put_win`` / ``put_win_q4``).  Model-dtype and int8 pools (rows
    quantized per token, scales beside them) take the C positions one by
    one.  A packed int4 pool requantizes the row's whole 2-page window
    ``(pid0, pid1)`` per group: dequantize, splice the segment in,
    requantize; the ``pid1`` halves are written before the ``pid0`` ones,
    in two writes, so at the table's edge (``pid1 == pid0``) the first
    half wins, as in the reference."""
    b, _, c, _ = kv["k"].shape
    if pool["k"].dtype != torch.uint8:
        pid, off = _window_slots(pt, phys0, c, page_size)
        for name, x in _quantize_like(pool, kv, page_size).items():
            # [B, Hkv, C, ...] -> the index's [B, C, Hkv, ...]
            pool[name][li, pid, :, off] = x.transpose(1, 2).to(
                pool[name].dtype)
        return
    n_wide = pt.shape[1]
    p0 = torch.clamp(phys0.long() // page_size, 0, n_wide - 1)
    p1 = torch.clamp(p0 + 1, max=n_wide - 1)
    pid0 = pt.long().gather(1, p0[:, None])[:, 0]
    pid1 = pt.long().gather(1, p1[:, None])[:, 0]
    rows = torch.arange(b, device=pt.device)[:, None]
    at = (phys0.long() % page_size)[:, None] + torch.arange(
        c, device=pt.device)                                     # [B, C]
    for name in ("k", "v"):
        vals, scales = pool[name][li], pool[f"{name}_scale"][li]
        hkv, g = vals.shape[1], page_size // scales.shape[-1]
        # [B, 2, Hkv, P, ...] -> the window [B, Hkv, 2P, ...]
        win = torch.stack([vals[pid0], vals[pid1]], 1).transpose(1, 2)
        sc = torch.stack([scales[pid0], scales[pid1]], 1).transpose(1, 2)
        f = dequantize_q4(win.reshape(b, hkv, 2 * page_size, -1),
                          sc.reshape(b, hkv, -1), g)
        f[rows, :, at] = kv[name].transpose(1, 2).float()
        wq, wsc = quantize_groups_q4(f, g)
        wq = wq.reshape(b, hkv, 2, page_size, -1).transpose(1, 2)
        wsc = wsc.reshape(b, hkv, 2, -1).transpose(1, 2)
        for half, pid in ((1, pid1), (0, pid0)):
            vals[pid] = wq[:, half]
            scales[pid] = wsc[:, half]


@torch.no_grad()
def verify_forward(params: dict, chunk: torch.Tensor, pool: dict,
                   pt: torch.Tensor, tvec: torch.Tensor, tpad: torch.Tensor,
                   d0: torch.Tensor, pos: torch.Tensor, cfg: LlamaConfig,
                   page_size: int, tp_group=None) -> torch.Tensor:
    """The full model's verify forward (the reference's ``_verify_fwd``):
    C = γ+1 positions of EVERY slot, ``chunk`` [B, C] at positions
    ``pos[b] + [0, C)``.  Per layer: q/k/v at those positions; the
    chunk's K/V written into the row's 2-page window at phys ``[t_pad +
    d0, t_pad + d0 + γ]`` (:func:`_write_window`); the paged kernel over
    the folded queries (:func:`fold_chunk_queries`: a group of Hq·C/Hkv a
    kv head) with the history ``phys < t ∪ [t_pad, t_pad + d0)``, which
    ends before the entries just written; merged with the chunk's causal
    partials over its own UNQUANTIZED K/V.  Rejected entries need no
    rollback: the next tick's ``d0`` does not cover them, and its verify
    overwrites them.  Returns f32 logits [B, C, vocab] (the head runs on
    every position; under ``tp_group`` the full vocabulary on every rank,
    as :func:`_paged_row_step`'s)."""
    b, c = chunk.shape
    positions = pos.long()[:, None] + torch.arange(c, device=chunk.device)
    phys0 = tpad + d0
    k_scale, v_scale = pool.get("k_scale"), pool.get("v_scale")
    x = embed_lookup(params["embed"], chunk)                     # [B,C,D]
    for li, lp in enumerate(unbind_layers(params["layers"])):
        h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg, positions)            # [B,H,C,hd]
        _write_window(pool, li, {"k": k, "v": v}, pt, phys0, page_size)
        o_p, m_p, l_p = paged_attention(
            fold_chunk_queries(q).contiguous(), pool["k"], pool["v"], pt, li,
            tvec, tpad, d0, k_scale, v_scale)
        o_c, m_c, l_c = _chunk_causal_partials(q, k, v)
        o = merge_partials(o_p, m_p, l_p, o_c, m_c, l_c)
        o = o.reshape(b, cfg.n_heads, c, cfg.head_dim).to(x.dtype)
        x = _attn_finish(x, o, lp, cfg, None, tp_group)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _lm_head(params, x, tp_group)


@torch.no_grad()
def spec_block(params: dict, dparams: dict, pool: dict, pt, tvec, tpad,
               tokens: torch.Tensor, pos: torch.Tensor, active: torch.Tensor,
               gcap: torch.Tensor, cfg: LlamaConfig, gamma: int,
               tp_group=None):
    """One speculative tick for every slot (the reference's
    ``_spec_tick_body``): the draft ``dparams`` (a :func:`draft_view`)
    proposes γ tokens a slot through :func:`_paged_row_step` -- it reads
    the SHARED pool history (its layer-i K/V is the full model's) and
    keeps its own keys in a γ-wide buffer of the model dtype -- then ONE
    :func:`verify_forward` scores all [B, γ+1] positions, and each slot
    keeps its longest full-model-agreed prefix, capped by ``gcap``, plus
    the full model's correction token.  ``tokens``/``pos`` advance in
    place for active rows (``pos`` by take + 1).  Returns (emit [B, γ+1]:
    accepted drafts, then the correction, then filler; take and matched
    [B], 0 on inactive rows; the per-slot non-finite flag over every
    verify position).  Under ``tp_group`` the draft and the verify run on
    the rank's shards (``dparams`` cut by the same specs) and pick from
    the full logits."""
    dev = tokens.device
    d0 = torch.where(active, pos - tvec, torch.zeros_like(pos)).to(torch.int32)
    n_draft = next(iter(dparams["layers"].values())).shape[0]
    buf = {n: torch.zeros((n_draft, tokens.shape[0], pool["k"].shape[2],
                           gamma, cfg.head_dim), dtype=cfg.tdtype, device=dev)
           for n in ("k", "v")}
    tok, drafted = tokens, []
    for i in range(gamma):
        tok = _pick_token(_paged_row_step(dparams, tok, pool, pt, tvec, tpad,
                                          d0, buf, pos + i, i, cfg,
                                          tp_group=tp_group))
        drafted.append(tok)
    drafted = torch.stack(drafted, dim=1)                        # [B, γ]
    chunk = torch.cat([tokens[:, None], drafted], dim=1)
    vlogits = verify_forward(params, chunk, pool, pt, tvec, tpad, d0, pos,
                             cfg, pool["k"].shape[3], tp_group)
    bad = ~torch.isfinite(vlogits).flatten(1).all(dim=1)
    full = _pick_token(vlogits)                                  # [B, γ+1]
    matched, take = spec_acceptance(drafted, full, gcap)
    corr = full.gather(1, take.long()[:, None])[:, 0]
    padded = torch.cat([drafted, drafted[:, -1:]], dim=1)
    emit = torch.where(torch.arange(gamma + 1, device=dev)[None, :]
                       < take[:, None], padded, corr[:, None])
    take = torch.where(active, take, 0)
    matched = torch.where(active, matched, 0)
    tokens.copy_(torch.where(active, corr, tokens))
    pos.copy_(torch.where(active, pos + take + 1, pos))
    return emit, take, matched, bad


@torch.no_grad()
def spec_tick_body(params: dict, dparams: dict, tables: dict, st: dict,
                   cfg: LlamaConfig, gamma: int,
                   eos_id: int | None = None, tp_group=None) -> None:
    """ONE speculative engine tick: :func:`spec_block` inside the
    reference's lane freeze (its ``_fused_spec_body``), in the shape of
    :func:`tick_body`.  A lane runs while it is active, owes tokens and is
    not dead; the overrun guard reserves the worst case γ+1 positions, so
    a stalled lane never opens its window past its pages; an EOS among a
    lane's ``emit[:take+1]`` latches ``dead``; ``emitted`` counts what a
    tick lands (take + 1).  The emit slab, take, matched, the bad flags,
    the stalls and the first tokens land in the spec slab's views
    (``st["spec_out"]``) at the tick index ``tk``, which then advances.
    A dispatch runs it K times; the graph engine captures exactly this."""
    t, f, out = tables, st["freeze"], st["spec_out"]
    act = (t["active"] != 0) & (f["emitted"] < t["budget"]) & (
        f["dead"] == 0)
    overrun = act & (st["pos"] - t["tvec"] + gamma + 1 > t["cap"])
    f["stall"].logical_or_(overrun)
    act = act & ~overrun
    emit, take, matched, bad = spec_block(
        params, dparams, st["pool"], t["pt"], t["tvec"], t["tpad"],
        st["tokens"], st["pos"], act, t["gcap"], cfg, gamma, tp_group)
    if eos_id is not None:
        landed = (torch.arange(gamma + 1, device=emit.device)[None, :]
                  <= take[:, None])
        f["dead"].logical_or_(act & ((emit == eos_id) & landed).any(dim=1))
    f["dead"].logical_or_(bad)
    f["emitted"].add_(torch.where(act, take + 1, 0))
    tk = f["tk"].long()
    for name, x in (("emit", emit), ("take", take), ("matched", matched),
                    ("bads", bad)):
        out[name].index_copy_(0, tk, x.long()[None])
    out["stall"].copy_(f["stall"])
    out["firsts"].copy_(st["first_toks"])
    f["tk"].add_(1)


# -- the dense slot engine ---------------------------------------------------

def _attend_rows_buffered(q: torch.Tensor, ck: torch.Tensor,
                          cv: torch.Tensor, bk: torch.Tensor,
                          bv: torch.Tensor, flush_pos: torch.Tensor,
                          j: int) -> torch.Tensor:
    """Grouped attention with per-row positions over a dense cache plus the
    in-block write buffer.  q: [B, Hq, 1, D]; cache [B, Hkv, S, D], valid
    where ``k_pos < flush_pos[b]`` (everything flushed before this block);
    buffer [B, Hkv, stride, D], valid at index ``<= j``.  One softmax over
    both key sets, f32 scores."""
    b, hq, t, d = q.shape
    hkv, s = ck.shape[1], ck.shape[2]
    stride = bk.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, t, d).float()
    sc = torch.einsum("bkgtd,bksd->bkgts", qg, ck.float())
    sb = torch.einsum("bkgtd,bksd->bkgts", qg, bk.float())
    scores = torch.cat([sc, sb], dim=-1) * d ** -0.5
    mask = torch.cat(
        [torch.arange(s, device=q.device)[None, :] < flush_pos[:, None],
         (torch.arange(stride, device=q.device) <= j)[None, :].expand(
             b, stride)], dim=-1)
    scores = scores.masked_fill(~mask[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = (torch.einsum("bkgts,bksd->bkgtd", probs[..., :s], cv.float())
           + torch.einsum("bkgts,bksd->bkgtd", probs[..., s:], bv.float()))
    return out.reshape(b, hq, t, d).to(q.dtype)


def _row_step_buffered(params: dict, tokens: torch.Tensor, cache: dict,
                       buf: dict, flush_pos: torch.Tensor,
                       pos: torch.Tensor, j: int,
                       cfg: LlamaConfig, ffn=None) -> torch.Tensor:
    """One decode step for every slot at its own position ``pos`` [B],
    its new K/V written into the block buffer at the shared index ``j``
    (in place).  Returns next-token logits [B, V] f32."""
    x = embed_lookup(params["embed"], tokens)[:, None, :]        # [B,1,D]
    positions = pos[:, None]
    for li, lp in enumerate(unbind_layers(params["layers"])):
        h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg, positions)            # [B,H,1,D]
        bk, bv = buf["k"][li], buf["v"][li]
        bk[:, :, j] = k[:, :, 0].to(bk.dtype)
        bv[:, :, j] = v[:, :, 0].to(bv.dtype)
        o = _attend_rows_buffered(q, cache["k"][li], cache["v"][li], bk, bv,
                                  flush_pos, j)
        x = _attn_finish(x, o, lp, cfg, ffn)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()[:, 0]


def _flush_buffer(cache: dict, buf: dict, flush_pos: torch.Tensor) -> None:
    """Scatter the block buffer [L, B, Hkv, stride, D] into the dense cache
    [L, B, Hkv, S, D] IN PLACE: row b's segment lands at ``flush_pos[b]``,
    clamped to ``S - stride`` as ``lax.dynamic_update_slice`` clamps its
    start (only an inactive row holding its position gets there)."""
    n_slots, s = cache["k"].shape[1], cache["k"].shape[3]
    stride = buf["k"].shape[3]
    start = torch.clamp(flush_pos.long(), 0, s - stride)
    idx = start[:, None] + torch.arange(stride, device=start.device)
    rows = torch.arange(n_slots, device=start.device)[:, None]
    for name in ("k", "v"):
        # advanced indices around a slice: value dims are [B, stride, L,
        # Hkv, D]
        cache[name][:, rows, :, idx] = buf[name].permute(1, 3, 0, 2, 4).to(
            cache[name].dtype)


@torch.no_grad()
def decode_block_dense(params: dict, cache: dict, tokens: torch.Tensor,
                       pos: torch.Tensor, active: torch.Tensor,
                       cfg: LlamaConfig, stride: int,
                       sample: dict | None = None, ffn=None):
    """``stride`` decode steps for every slot over the dense cache, then
    the buffer flush at the block-start positions.  ``tokens``/``pos``
    advance in place for active rows; inactive rows hold both.  Step j
    picks as :func:`decode_block`'s.  Returns (token block [stride, B],
    per-slot non-finite flag)."""
    flush_pos = pos.clone()
    n_layers, b, hkv = cache["k"].shape[:3]
    buf = {n: torch.zeros((n_layers, b, hkv, stride, cfg.head_dim),
                          dtype=cache[n].dtype, device=tokens.device)
           for n in ("k", "v")}
    bad = torch.zeros(b, dtype=torch.bool, device=tokens.device)
    block = []
    for j in range(stride):
        logits = _row_step_buffered(params, tokens, cache, buf, flush_pos,
                                    pos, j, cfg, ffn)
        bad |= ~torch.isfinite(logits).all(dim=-1)
        nxt = torch.where(active, _step_pick(sample, j)(logits), tokens)
        tokens.copy_(nxt)
        pos.add_(active.to(pos.dtype))
        block.append(nxt)
    _flush_buffer(cache, buf, flush_pos)
    return torch.stack(block), bad


@torch.no_grad()
def dense_tick_body(params: dict, tables: dict, st: dict, cfg: LlamaConfig,
                    stride: int, sampler: dict | None = None,
                    ffn=None) -> None:
    """ONE tick of the dense engine: :func:`decode_block_dense` over the
    slots the ``tables``' active mask names (keyed as :func:`tick_body`'s
    with a ``sampler``), its block, bad flags and the first tokens written
    to the output views of ``st``.  The dense engine has no fused ticks,
    so no lane freeze; the graph engine captures exactly this."""
    block, bad = decode_block_dense(
        params, st["cache"], st["tokens"], st["pos"],
        tables["active"] != 0, cfg, stride,
        sample=_tick_sample(sampler, tables, st["freeze"], st, stride),
        ffn=ffn)
    out = st["out"]
    out["blocks"][0].copy_(block)
    out["bads"][0].copy_(bad)
    out["firsts"].copy_(st["first_toks"])


@torch.no_grad()
def adopt_wave_dense(cache: dict, cache_w: dict, slots: torch.Tensor,
                     firsts: torch.Tensor, plens: torch.Tensor,
                     first_toks: torch.Tensor, tokens: torch.Tensor,
                     pos: torch.Tensor, temps: torch.Tensor | None = None,
                     temps_w: torch.Tensor | None = None) -> None:
    """Admit a wave into the dense cache IN PLACE: each row of the
    ``max_len``-wide panel becomes its slot's whole cache row, and the
    slots' first token, current token, position and (given ``temps_w``)
    temperature are set."""
    for name in cache:
        cache[name][:, slots] = cache_w[name]
    _adopt_vectors(slots, firsts, plens, first_toks, tokens, pos, temps,
                   temps_w)


def _adopt_vectors(slots, firsts, plens, first_toks, tokens, pos, temps,
                   temps_w) -> None:
    first_toks[slots] = firsts
    tokens[slots] = firsts
    pos[slots] = plens.to(pos.dtype)
    if temps_w is not None:
        temps[slots] = temps_w


# -- prefill waves (both engines) ---------------------------------------------

@torch.no_grad()
def prefill_wave(params: dict, padded_prompts: torch.Tensor,
                 true_lens: torch.Tensor, cfg: LlamaConfig,
                 max_len: int | None = None, sample: dict | None = None,
                 ffn=None, tp_group=None):
    """Batch-k prefill of bucket-padded prompts into a dense
    [L, k, Hkv, max_len or bucket, D] panel (the dense engine's rows are
    ``max_len`` wide, the paged engine copies the bucket's pages); returns
    (first tokens [k], panel).  The LM head runs at position
    ``true_lens - 1`` of each row only.  With ``sample`` (the rows'
    ``temps``, the wave's ``key`` = ``fold_in(fold_in(base, 1), rid0)``,
    ``top_k``) the first tokens are the reference's per-row pick, the
    whole wave drawn under the one key.  With an ``ffn`` (MoE) each row
    routes whole, pad positions after the prompt included, as in the
    reference.  Under ``tp_group`` (``cfg`` the local config) the panel
    holds the rank's KV heads and the first tokens are picked from the
    all-gathered logits."""
    k, bucket = padded_prompts.shape
    cache_w = init_kv_cache(cfg, k, max_len or bucket,
                            device=padded_prompts.device)
    # the head runs on each row's last prompt position alone: the row the
    # reference keeps of its [k, bucket, vocab] logits
    logits, cache_w = _forward_with_cache(params, padded_prompts, cache_w, 0,
                                          cfg, head_rows=true_lens - 1,
                                          ffn=ffn, tp_group=tp_group)
    if sample is None:
        return _pick_token(logits[:, 0]), cache_w
    return _pick_token(logits[:, 0], sample["temps"], sample["key"],
                       sample["top_k"], True), cache_w


@torch.no_grad()
def adopt_wave(pool: dict, cache_w: dict, page_dst: torch.Tensor,
               slots: torch.Tensor, firsts: torch.Tensor,
               plens: torch.Tensor, first_toks: torch.Tensor,
               tokens: torch.Tensor, pos: torch.Tensor,
               page_size: int, temps: torch.Tensor | None = None,
               temps_w: torch.Tensor | None = None) -> None:
    """Admit a wave IN PLACE: copy each row's prompt panel page by page
    into its pool pages (``page_dst`` [k, bucket/P] page ids) and set the
    slots' first token, current token, position and (given ``temps_w``)
    temperature.  A quantized pool gets the whole panel quantized once
    first (the bucket is a page multiple and the int4 group divides P, so
    groups never straddle pages)."""
    n_layers, k, hkv = cache_w["k"].shape[:3]
    npp = cache_w["k"].shape[3] // page_size
    dst = page_dst.reshape(-1).long()
    for name, x in _quantize_like(pool, cache_w, page_size).items():
        # [L, k, Hkv, npp * n, ...] -> [L, k * npp, Hkv, n, ...]
        x = x.reshape(n_layers, k, hkv, npp, -1, *x.shape[4:]).transpose(2, 3)
        pool[name][:, dst] = x.reshape(n_layers, k * npp, hkv,
                                       *x.shape[4:]).to(pool[name].dtype)
    _adopt_vectors(slots, firsts, plens, first_toks, tokens, pos, temps,
                   temps_w)


# -- the chunk step (prefix caching and chunked prefill) ----------------------

@torch.no_grad()
def prefill_chunk_logits(params: dict, pool: dict, chunk: torch.Tensor,
                         pt_row: torch.Tensor, s, tlen: torch.Tensor,
                         cfg: LlamaConfig, page_size: int,
                         ffn=None, tp_group=None) -> torch.Tensor:
    """One page-aligned PROMPT CHUNK of one slot, straight into the pool
    (the reference's ``_chunk_body``): chunk tokens [1, C] at global
    positions ``[s, s + C)``, ``s`` a page multiple ([1] int32 on the
    device, or an int) and C a page multiple; ``pt_row`` [1, max_pages]
    int32 the slot's page-table row; ``tlen`` [1] the prompt's length.
    Per layer: q/k/v at those positions; the chunk's K/V (quantized first
    for an int8 or int4 pool) written IN PLACE into the pages
    ``pt_row[s/P + j]``, a row-local index past the table landing in trash
    page 0; the paged kernel over the folded queries
    (:func:`fold_chunk_queries`) with the history ``[0, s)`` (``t = t_pad
    = s``, ``d = 0``) merged with the chunk's causal partials over its
    UNQUANTIZED K/V (:func:`_chunk_causal_partials`).  The final chunk
    right-pads past ``tlen``: its pad K/V lands at positions >= ``tlen``
    in the slot's own pages (or trash page 0), never attended.  The LM
    head runs at row ``clip(tlen - s - 1, 0, C - 1)`` only: returns its
    logits [1, vocab] f32, the request's first-token logits on its final
    chunk (:func:`chunk_body` picks from them).  With an ``ffn`` (MoE) the
    chunk is one routing group.  Under ``tp_group`` (``cfg`` the local
    config) the chunk writes and attends the rank's KV heads and the
    logits are the full vocabulary."""
    c = chunk.shape[1]
    dev = chunk.device
    n_wide = pt_row.shape[1]
    i32 = dict(dtype=torch.int32, device=dev)
    svec = (s.to(torch.int32) if isinstance(s, torch.Tensor)
            else torch.full((1,), s, **i32))
    zeros1 = torch.zeros((1,), **i32)
    positions = (svec.long() + torch.arange(c, device=dev))[None, :]
    # the chunk's pages: row-local s/P + j, past the table trash page 0
    # (never a clamped index: the row's last entry may be a live page)
    rl = svec.long() // page_size + torch.arange(c // page_size, device=dev)
    page_ids = torch.where(rl < n_wide,
                           pt_row[0].long()[rl.clamp(max=n_wide - 1)], 0)
    k_scale, v_scale = pool.get("k_scale"), pool.get("v_scale")
    x = embed_lookup(params["embed"], chunk)                     # [1,C,D]
    for li, lp in enumerate(unbind_layers(params["layers"])):
        h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg, positions)            # [1,H,C,hd]
        for name, val in _quantize_like(pool, {"k": k, "v": v},
                                        page_size).items():
            # [1, Hkv, C, ...] -> [C/P, Hkv, P, ...] (values) or
            # [C/P, Hkv, P/g] (group scales)
            hkv = val.shape[1]
            val = val.reshape(hkv, page_ids.shape[0], -1,
                              *val.shape[3:]).transpose(0, 1)
            pool[name][li, page_ids] = val.to(pool[name].dtype)
        o_p, m_p, l_p = paged_attention(
            fold_chunk_queries(q).contiguous(), pool["k"], pool["v"],
            pt_row, li, svec, svec, zeros1, k_scale, v_scale)
        o_c, m_c, l_c = _chunk_causal_partials(q, k, v)
        o = merge_partials(o_p, m_p, l_p, o_c, m_c, l_c)
        o = o.reshape(1, cfg.n_heads, c, cfg.head_dim).to(x.dtype)
        x = _attn_finish(x, o, lp, cfg, ffn, tp_group)
    row = torch.clamp(tlen.long() - svec.long() - 1, 0, c - 1)
    return _gathered_head(params, x, row, cfg, tp_group)


@torch.no_grad()
def chunk_body(params: dict, pool: dict, inp: dict, out: torch.Tensor,
               cfg: LlamaConfig, page_size: int,
               sampler: dict | None = None, ffn=None, tp_group=None) -> None:
    """ONE chunk step over the engine's static chunk input ``inp`` (views
    of one int32 buffer: ``tokens`` [1, C], ``s``, ``tlen``, ``rid`` [1],
    ``temp`` [1] (its f32 view), ``pt`` [1, max_pages]) into ``pool``, the
    pick of :func:`prefill_chunk_logits` (the request's first token on its
    final chunk) written to ``out`` [1]: greedy, or with a ``sampler``
    (``key1`` = ``fold_in(base, 1)``, ``top_k``) the reference's pick
    under ``fold_in(key1, rid)``; the graph engine captures exactly
    this."""
    logits = prefill_chunk_logits(
        params, pool, inp["tokens"].long(), inp["pt"], inp["s"], inp["tlen"],
        cfg, page_size, ffn, tp_group)
    if sampler is None:
        out.copy_(_pick_token(logits))
        return
    out.copy_(_pick_token(logits, inp["temp"],
                          prng.fold_in(sampler["key1"], inp["rid"]),
                          sampler["top_k"], True))


@torch.no_grad()
def activate_slot(first_toks: torch.Tensor, tokens: torch.Tensor,
                  pos: torch.Tensor, slot: int, tok: torch.Tensor,
                  plen: int, temps: torch.Tensor | None = None,
                  temp: float | None = None) -> None:
    """Flip a chunk-prefilled slot live IN PLACE (the chunk path's
    counterpart of :func:`adopt_wave`'s vector updates): its first token,
    current token, position and (given ``temp``) temperature."""
    first_toks[slot:slot + 1].copy_(tok)
    tokens[slot:slot + 1].copy_(tok)
    pos[slot:slot + 1].fill_(plen)
    if temp is not None:
        temps[slot:slot + 1].fill_(temp)


def _captured(fn, eager_s: float, mode: str = "global"):
    """(``fn`` captured as a :class:`kernels.Graph` in capture error mode
    ``mode``, its stats: ``eager_s``, the eager run before the capture,
    which loaded the libraries and sized the kernels' scratch; the
    capture's and the instantiation's seconds; the bytes the graph
    reserved; its tally of launches)."""
    graph = kernels.Graph(fn)
    graph.capture_error_mode = mode
    graph.capture()
    return graph, {"eager_s": eager_s, "capture_s": graph.capture_s,
                   "instantiate_s": graph.instantiate_s,
                   "pool_bytes": graph.pool_bytes, "tally": dict(graph.tally)}


def make_serve_mesh(tp: int, device_type: str | None = None):
    """A 1-axis ``("tp",)`` :class:`~torch.distributed.device_mesh.
    DeviceMesh` over this process's group of ``tp`` ranks: the port's
    counterpart of the reference's ``make_serve_mesh`` over tp devices.
    Every rank calls it after ``init_process_group``
    (:func:`kubegpu_tpu_torch.parallel.launch` starts the ranks and the
    group) and hands it to its ``ContinuousBatcher(mesh=...)``.  dp
    scale-out does not live on this mesh: dp replicas are independent
    engines.  ``device_type`` defaults to "cuda" where a card is
    visible, else "cpu"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_serve_mesh needs an initialized process "
                           "group (kubegpu_tpu_torch.parallel.launch)")
    n = dist.get_world_size()
    if n != tp:
        raise ValueError(f"need {tp} ranks for tp={tp}, got {n}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (tp,), mesh_dim_names=("tp",))


class _AdmissionQueue(deque):
    """The admission queue with an incremental queued-prompt-token total
    (``prompt_tokens``) that every mutation the engine makes keeps equal
    to ``sum(r.prompt_len for r, _ in q)``: each of the deque's
    mutations (``append``, ``appendleft``, ``extend``, ``popleft``,
    ``pop``, ``remove``, ``clear``, ``del q[i]``) adjusts it, as the
    reference's queue does, so a caller that rebuilds the queue (the
    sorted rebuild of :meth:`ContinuousBatcher._sort_queue`, a simulated
    replica's ``clear`` + ``extend``) leaves the pool router's tiebreak
    exact.  Items are ``(request, padded_prompt)`` pairs."""

    def __init__(self, items=()):
        super().__init__()
        self.prompt_tokens = 0
        for item in items:
            self.append(item)

    def append(self, item) -> None:
        super().append(item)
        self.prompt_tokens += item[0].prompt_len

    def appendleft(self, item) -> None:
        super().appendleft(item)
        self.prompt_tokens += item[0].prompt_len

    def extend(self, items) -> None:
        for item in items:
            self.append(item)

    def popleft(self):
        item = super().popleft()
        self.prompt_tokens -= item[0].prompt_len
        return item

    def pop(self):
        item = super().pop()
        self.prompt_tokens -= item[0].prompt_len
        return item

    def remove(self, item) -> None:
        super().remove(item)
        self.prompt_tokens -= item[0].prompt_len

    def clear(self) -> None:
        super().clear()
        self.prompt_tokens = 0

    def __delitem__(self, i) -> None:
        self.prompt_tokens -= self[i][0].prompt_len
        super().__delitem__(i)


def page_keys(prompt, page_size: int) -> tuple:
    """The prefix registry's keys of a prompt's cacheable pages: one a
    whole leading page but the page holding token ``t - 1``, each a 64-bit
    blake2b of the int64 prompt up to that page's end.  The reference keys
    on Python's ``hash`` of the same bytes, which is salted per process;
    a digest keys the same way in every process, so the router of a pool
    and its replicas' rank processes compare keys.  Only equality of keys
    matters: routing and aliasing decide as the reference's do."""
    p = np.ascontiguousarray(prompt, np.int64)
    return tuple(
        int.from_bytes(hashlib.blake2b(p[:(i + 1) * page_size].tobytes(),
                                       digest_size=8).digest(), "little",
                       signed=True)
        for i in range((int(p.shape[0]) - 1) // page_size))


def _on_engine_device(method):
    """Run an engine method with the engine's card current: the kernels
    launch on the current device's stream, and the graphs capture and
    replay there, so an engine on another card than the current one
    (a pool's replica on card 1) runs on its own."""
    @functools.wraps(method)
    def run(self, *args, **kw):
        if self.device.type != "cuda":
            return method(self, *args, **kw)
        with torch.cuda.device(self.device):
            return method(self, *args, **kw)
    return run


def _chain_digest(chain: dict, t: int) -> str:
    """Content hash of an exported page chain: the reference's sha256 over
    the prompt length, then each leaf's name, shape (a tuple's text), dtype
    name and bytes, in sorted leaf order, so a chain hashes to the same hex
    string in either package.  The leaves are host tensors; a bf16 leaf's
    bits go through an int16 view (numpy has no bf16) under the name
    ``bfloat16``.  The importer recomputes it before touching its pool, so
    a torn or corrupted transfer fails loudly."""
    h = hashlib.sha256(str(t).encode())
    for name in sorted(chain):
        a = chain[name].detach().cpu().contiguous()
        h.update(name.encode())
        h.update(str(tuple(a.shape)).encode())
        h.update(str(a.dtype).removeprefix("torch.").encode())
        bits = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        h.update(bits.numpy().tobytes())
    return h.hexdigest()


@dataclass
class _Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    temperature: float = 0.0     # 0 = greedy
    tokens: list[int] = field(default_factory=list)   # generated so far
    done: bool = False
    prefix_keys: tuple = ()      # registry keys of its full prompt pages
    # the prompt stays on the host for the request's life, so a quarantine
    # or a preemption replays it as prompt + accepted tokens; admit_len is
    # the current admission's prompt length (the grown one at a replay)
    prompt: object = None        # np.ndarray, set at submit
    admit_len: int = 0
    retries: int = 0             # quarantine replays so far
    not_before_tick: int = 0     # replay backoff gate (a step count)
    deadline: float | None = None   # time.monotonic() cutoff
    error: str | None = None     # set when the request FAILED
    # admission order: tier strictly (0 most critical), then the step-count
    # deadline (EDF), then seq, the enqueue order, drawn anew at a requeue
    tier: int = 0
    tenant: str = ""             # quota bucket ("" = unmetered)
    seq: int = 0
    deadline_tick: int | None = None   # step-count cutoff
    preemptions: int = 0         # park/resume cycles survived
    resuming: bool = False       # parked; its next admission resumes it
    # engine-tick stamps: submit, first token consumed, finish
    submit_tick: int = -1
    first_tick: int = -1
    finish_tick: int = -1

    @property
    def remaining_new(self) -> int:
        return self.max_new_tokens - len(self.tokens)


class ContinuousBatcher:
    """Slot-based continuous-batching engine, over a dense cache row a slot
    (``paged=False``, the reference's default) or a paged KV pool
    (``paged=True``).  ``submit()`` enqueues a request; ``step()``
    collects the previous tick's token block, retires finishers, admits
    queued requests into free slots (prefill waves), and dispatches the
    next stride block for every slot; ``drain()`` runs to completion.
    ``warmup()`` runs every shape once on scratch state, before a timed
    window.

    Requests are greedy unless ``submit`` gives a positive
    ``temperature``, which needs a ``sampling=True`` engine: such a
    request samples with the engine's ``top_k`` truncation, on the
    reference's key schedule from ``seed`` (:mod:`kubegpu_tpu_torch.prng`,
    JAX's own threefry), so its tokens equal the reference engine's.
    A tick's stride steps draw under ``split(fold_in(fold_in(base, 0),
    tick), stride)`` (the tick a device scalar in the tables, advanced by
    each fused replay), a prefill wave under ``fold_in(fold_in(base, 1),
    rid0)``, a chunk under ``fold_in(fold_in(base, 1), rid)``.  A greedy
    engine (``sampling=False``) draws nothing and captures the same
    graphs as before sampling existed.

    The dense engine takes no ``kv_int8``/``kv_bits`` (the static path's
    ``greedy_generate(kv_int8=True)`` is the dense int8 cache), no
    ``evict_policy`` and no ``fused_ticks > 1``: each raises ``ValueError``
    as in the reference.  ``kv_bits`` picks the paged pool's format: 16
    (the model dtype), 8 (int8 pages with per-token scales; ``kv_int8=True``
    is its alias) or 4 (packed int4 pages with one scale per ``kv_group``
    tokens, default ``stride``; the group must divide both ``stride`` and
    ``page_size``).
    ``evict_policy`` ("window" or "mass", with ``evict_param`` a token
    window, default ``2 * page_size``, or a mass threshold, default 0.02)
    drops cold prompt pages of decoding slots after each collected block
    (:meth:`_maybe_evict`); ``pages_evicted`` counts them.

    ``prefix_cache`` and ``chunked_prefill`` (paged only; ``ValueError``
    otherwise) are the reference's serving fast path: a request whose
    leading full prompt pages are registered aliases them and prefills
    its tail, and with ``chunked_prefill`` a prompt whose bucket exceeds
    ``prefill_chunk`` (default ``2 * page_size``, a page multiple) admits
    as chunks; both run :func:`chunk_body`, one chunk a prefilling slot
    a ``step()``, before the tick.  ``prefix_hits``, ``pages_aliased``,
    ``prefill_tokens_saved``, ``chunks_run`` and ``prefill_tokens`` (waves
    and chunks) count them.  ``max_wave`` caps a prefill wave.

    ``spec_gamma=γ`` (paged only) makes each tick speculative: a draft of
    the first ``draft_layers`` layers (default ``max(1, L // 4)``)
    proposes γ tokens a slot and one verify forward of the full model
    scores them; ``spec_adaptive`` caps each slot's accepted depth by an
    EMA of its acceptance, and ``spec_degrade_after=N`` switches the engine
    to the plain tick for good after N ticks in a row in which no active
    slot matched a draft.  ``spec_ticks``, ``spec_drafts_proposed`` and
    ``spec_drafts_accepted`` count them (``spec_acceptance_rate``,
    ``spec_tokens_per_tick``).  ``eos_id`` ends a request at the first
    EOS it emits (kept in its tokens), on every engine and path.

    ``fused_ticks=K`` (the reference's fused decode, plain or speculative)
    dispatches K complete ticks at once when nothing waits in the queue,
    with one host fetch at the end; each lane freezes on the device once
    it has its tokens or its next flush would pass its pages
    (``fused_dispatches``, ``fused_ticks_run`` and ``fused_stalls`` count
    them).  It excludes ``evict_policy``, as in the reference.

    On the card the tick runs as one CUDA graph, captured by
    :meth:`warmup` (or the first dispatch) after one eager run on scratch
    state; ``graph_stats`` then holds the seconds of that run, of the
    capture and of the instantiation, and the bytes the graph reserved
    (a spec engine with ``spec_degrade_after`` also captures the plain
    tick it degrades to).
    The chunk step is a graph of its own (``chunk_graph_stats``), captured
    the same way.  ``graphs=False`` runs both eagerly on the card instead.
    A capture or replay that fails raises.

    Accounting, as the reference's: ``prefill_waves``, ``wave_sizes`` and
    ``wave_log`` (k, bucket) a wave; a tick that dispatches appends its
    host wall of eviction, admission and chunk work to ``stall_ms`` (and
    its work to ``_tick_log``), adds its device ticks to ``busy_ticks``
    and charges them to ``cost`` (a :class:`CostLedger`; prefilling slots
    weigh the prompt tokens they prefilled this tick, decoding slots one);
    every ``step()`` appends its wall less the readout's to
    ``host_overhead_ms``, and a fused block's readout wall goes to
    ``fused_block_ms``.  The tick is a graph replay on the card, so these
    walls time the host's enqueue and its one sync, not device work, as
    the reference's async dispatch does.  Every list keeps a bounded
    window (:func:`_trim_acct`).  ``hbm`` (a
    :class:`LiveBytesTracker`) samples, at every dispatch, the bytes of
    the state tensors: the pool or cache leaves plus the slot vectors.
    The ticks write that state in place; with ``donate=True`` (the
    default) the public ``pool``/``cache`` ARE that state, so
    ``hbm_pool_bytes`` sits at 1x (the reference's donation gives the
    same 1x).  ``donate=False`` is the reference's debug mode: each
    dispatch rebinds the public ``pool``/``cache`` leaves to fresh copies
    of the live state (the graphs keep binding the live buffers), so a
    handle taken before a step keeps the values it had, and the leaves
    count twice.  ``note_kv_quality`` records a measured
    ``kv_quality_delta``.

    ``collect_overlap=True`` double-buffers the steady state (nothing
    queued, no chunk prefilling): tick N+1 is dispatched before the host
    reads tick N, so the card computes through the readout instead of
    idling behind it; ``overlap_ms`` (and ``serve_collect_overlap_ms``)
    holds each overlapped readout's wall.  Every dispatch's slab (and
    mass) is copied into one of two pinned host buffers, used in turn,
    with an event, and a collect reads that copy, never the live slab.

    The request lifecycle, as the reference's single engine: ``submit``
    takes a wall-clock ``deadline_s`` and a step-count ``deadline_ticks``
    (expired requests are pruned from the queue before any prefill, as
    ``deadline`` sheds, or cancelled mid-decode with their partial
    tokens; ``deadline_misses``), a ``tier`` (0 most critical: once any
    request has a tier or a tick deadline the queue is tier-strict and
    EDF within a tier, and a more critical request preempts strictly
    lower-tier greedy decoders, which park host-side and resume through
    the bit-exact replay of prompt + accepted tokens:
    ``requests_preempted``, ``requests_resumed``) and a ``tenant``
    (``tenant_quotas`` caps each tenant's in-flight requests; an
    over-quota submit is shed at the door).  ``cancel(rid)`` removes a
    request wherever it is.  Failed requests (``error`` set) come back
    from the next ``step()``; ``requests_shed`` and ``shed_by_reason``
    count the sheds.  Self-defense: a slot whose logits go non-finite is
    quarantined (``slots_quarantined``) and its request replayed bit for
    bit after a jittered backoff, at most ``max_retries`` times
    (``requests_retried``); ``chaos`` (a
    :class:`kubegpu_tpu_torch.obs.chaos.ChaosInjector`) injects faults at
    each dispatch; a failed dispatch is retried in place
    (``dispatch_failures``) and three in a row kill the engine;
    ``tick_deadline_s`` is a watchdog on each step's wall.  A dead engine
    (``dead``) raises :class:`ReplicaDeadError` from every later
    ``step()``; ``take_orphans()`` returns the requests that finished in
    the step that killed it.

    ``tracer`` (a :class:`kubegpu_tpu_torch.obs.spans.Tracer`) records
    the reference's spans: ``engine.start`` (under ``trace_ctx``, a
    decoded :class:`SpanContext`, when given), a ``request`` span a
    request from ``submit`` to retirement (queue wait, TTFT, tokens and
    per-token time as attributes), ``request.admit`` and
    ``request.prefill_chunk`` instants, and an ``engine.tick`` span a
    dispatching step with its ``engine.collect``, ``engine.admit`` and
    ``engine.dispatch`` (``engine.verify``) children.  Each site is one
    host-side ``is not None`` branch.

    ``metrics`` (a :class:`kubegpu_tpu_torch.obs.metrics.MetricsRegistry`)
    receives every counter, gauge and histogram the reference engine
    feeds, under its names, from the host (the walls are the port's own).

    Page-chain migration (disaggregated serving): ``submit(...,
    migrate_out=True)`` exports the request's page-aligned prompt pages to
    host tensors at its retirement (:meth:`take_export`, with a
    :func:`_chain_digest`), and :meth:`import_chain` adopts such a chain
    into a free slot mid-decode (``chains_exported``, ``chains_imported``,
    ``pages_migrated_out``, ``pages_migrated_in``).  Both run eagerly, as
    index copies outside every graph.

    ``cfg`` may be a :class:`~kubegpu_tpu_torch.models.moe.MoEConfig`:
    the engine then runs ``cfg.base`` (``self.cfg``) with the routed
    experts as every tick's, wave's and chunk's feed-forward; every knob
    above works with it except ``spec_gamma > 0`` (``ValueError``, as in
    the reference).

    Knobs of the reference engine outside this slice (``_LATER``) are
    accepted at the reference's default and raise ``NotImplementedError``
    naming their ROADMAP.md item at any other value."""

    def __init__(self, params: dict, cfg: LlamaConfig | MoEConfig,
                 n_slots: int = 8,
                 max_len: int | None = None, stride: int = 16,
                 prompt_buckets: tuple[int, ...] = (128, 512, 1024),
                 sampling: bool = False, top_k: int = 0, seed: int = 0,
                 max_wave: int = 8, paged: bool = False,
                 page_size: int = 128, total_pages: int | None = None,
                 debug_invariants: bool = False, kv_int8: bool = False,
                 kv_bits: int | None = None, kv_group: int | None = None,
                 evict_policy: str | None = None,
                 evict_param: float | None = None,
                 prefix_cache: bool = False, chunked_prefill: bool = False,
                 prefill_chunk: int | None = None, fused_ticks: int = 1,
                 spec_gamma: int = 0, draft_layers: int | None = None,
                 spec_adaptive: bool = True,
                 spec_degrade_after: int | None = None,
                 eos_id: int | None = None, tracer=None, trace_ctx=None,
                 chaos=None, tick_deadline_s: float | None = None,
                 max_retries: int = 2, tenant_quotas: dict | None = None,
                 metrics=None, donate: bool = True,
                 collect_overlap: bool = False, graphs: bool = True,
                 device="cuda", mesh=None, **later):
        _refuse_later(_LATER, later)
        # a MoEConfig serves through this engine: its Llama backbone sizes
        # attention and the pool, its routed experts ride the ffn hook
        self._ffn = None
        if isinstance(cfg, MoEConfig):
            self._ffn = _moe_decode_ffn(cfg)
            cfg = cfg.base
        elif not isinstance(cfg, LlamaConfig):
            raise TypeError(
                f"unsupported engine config {type(cfg).__name__}")
        self.donate = bool(donate)
        self.collect_overlap = bool(collect_overlap)
        self.device = torch.device(device)
        # under a mesh the tree may lie anywhere: the cut moves only this
        # rank's shard to the engine's device (_shard_for_mesh)
        if mesh is None and params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.params = params
        self.cfg = cfg
        # the config the device bodies run: the whole model's, or under a
        # mesh the rank's local one (set with the mesh below)
        self._lcfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len or cfg.max_seq_len
        self.stride = stride
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        if self.prompt_buckets[-1] >= self.max_len:
            raise ValueError("largest prompt bucket must be < max_len")
        self.max_wave = max(1, int(max_wave))
        self.paged = bool(paged)
        if not 0 <= top_k <= cfg.vocab_size:
            raise ValueError(
                f"top_k {top_k} not in [0, vocab_size={cfg.vocab_size}]")
        # -- sampling: a static flag, as the reference's (a greedy engine
        # never draws noise); the engine-wide top_k, per-request
        # temperatures in ``temps``, keys from ``seed``
        self.sampling = bool(sampling)
        self.top_k = int(top_k)
        # -- speculative decoding (spec_gamma > 0): each tick the first
        # draft_layers layers of the SAME weights propose γ tokens a slot
        # and one full-model verify scores all [n_slots, γ+1] positions;
        # γ = 0 is the plain tick
        self.spec_gamma = int(spec_gamma)
        self.draft_layers = 0
        if self.spec_gamma:
            if not paged:
                raise ValueError(
                    "speculative serving (spec_gamma > 0) requires "
                    "paged=True — the draft reads the shared page pool "
                    "(its layer-i K/V IS the full model's) and the "
                    "verify writes through the page tables")
            if sampling:
                raise ValueError(
                    "speculative serving is greedy-only (acceptance "
                    "compares argmaxes); build a sampling=False engine "
                    "or set spec_gamma=0")
            if self._ffn is not None:
                raise ValueError(
                    "speculative serving supports the dense Llama family "
                    "only (the draft_view slice has no story for routed "
                    "experts)")
            if self.spec_gamma + 1 > page_size:
                raise ValueError(
                    f"spec_gamma {self.spec_gamma} + 1 must be <= "
                    f"page_size {page_size} (the verify writes a "
                    "2-page window)")
            self.draft_layers = (draft_layers if draft_layers is not None
                                 else max(1, cfg.n_layers // 4))
            if not 1 <= self.draft_layers <= cfg.n_layers:
                raise ValueError(
                    f"draft_layers {self.draft_layers} not in "
                    f"[1, {cfg.n_layers}]")
        self.spec_adaptive = bool(spec_adaptive)
        self.spec_degrade_after = spec_degrade_after
        self.eos_id = eos_id
        # -- fused multi-tick decode: K complete ticks a dispatch when no
        # admission is pending, the lane freeze on the device
        self.fused_ticks = int(fused_ticks)
        if self.fused_ticks < 1:
            raise ValueError(f"fused_ticks {fused_ticks} must be >= 1")
        if self.fused_ticks > 1 and not paged:
            raise ValueError(
                "fused_ticks > 1 requires paged=True — the fused block "
                "advances page-pool state on device; the dense slot cache "
                "has no multi-tick story")
        # -- tensor-parallel serving: ``mesh`` is a ("tp",) DeviceMesh
        # (make_serve_mesh) over this process's group; the pool and the
        # paged kernels shard over KV heads, the host state stays
        # replicated.  Validated here, so a bad degree fails at
        # construction.
        self.mesh = mesh
        self.tp, self.tp_rank, self._tp_group = 1, 0, None
        # an NCCL group's watchdog thread queries events while the tick is
        # captured: its graphs take CUDA's thread-local capture mode
        self._capture_mode = "global"
        if mesh is not None:
            if not paged:
                raise ValueError(
                    "mesh (tensor-parallel) serving requires paged=True — "
                    "the sharded engine is the page-pool engine; the dense "
                    "slot cache has no mesh story")
            if self._ffn is not None:
                raise ValueError(
                    "tensor-parallel serving supports the dense Llama "
                    "family only; MoE scales out on dp replicas "
                    "(DataParallelServePool)")
            names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
            if names != ("tp",):
                raise ValueError(
                    f"serving mesh must have exactly the ('tp',) axis, got "
                    f"{names} — dp replicas are separate engines "
                    "(DataParallelServePool)")
            self.tp = int(mesh.size())
            for name, val in (("n_kv_heads", cfg.n_kv_heads),
                              ("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff),
                              ("vocab_size", cfg.vocab_size)):
                if val % self.tp:
                    raise ValueError(
                        f"tp={self.tp} must divide cfg.{name}={val} (KV "
                        "heads shard the pool; q heads/d_ff/vocab shard "
                        "the weights)")
            self._tp_group = mesh.get_group("tp")
            self.tp_rank = int(mesh.get_local_rank("tp"))
        if kv_int8 and not paged:
            raise ValueError(
                "kv_int8=True requires paged=True (the dense engine's int8 "
                "cache is the static decode path's kv_int8)")
        # -- KV bit width: 16 = model dtype, 8 = int8 pages (kv_int8's
        # alias), 4 = packed int4 with one scale per kv_group tokens; the
        # group divides stride and page_size so every write is
        # group-aligned
        if kv_bits is None:
            kv_bits = 8 if kv_int8 else 16
        if kv_bits not in (16, 8, 4):
            raise ValueError(f"kv_bits {kv_bits} not in (16, 8, 4)")
        if kv_bits == 8 and not paged:
            raise ValueError("kv_bits=8 requires paged=True")
        if kv_bits == 4:
            if kv_int8:
                raise ValueError(
                    "kv_int8=True and kv_bits=4 are exclusive — pick one "
                    "pool quantization")
            if not paged:
                raise ValueError(
                    "kv_bits=4 requires paged=True (the packed int4 format "
                    "is a page-pool layout)")
            if cfg.head_dim % 2:
                raise ValueError(
                    f"kv_bits=4 needs an even head_dim, got {cfg.head_dim} "
                    "(two channels pack per byte)")
            kv_group = int(kv_group) if kv_group else stride
            if stride % kv_group or page_size % kv_group:
                raise ValueError(
                    f"kv_group {kv_group} must divide both stride {stride} "
                    f"and page_size {page_size} (group-aligned writes are "
                    "the exactly-once contract)")
        else:
            if kv_group:
                raise ValueError("kv_group only applies to kv_bits=4")
            kv_group = 0
        self.kv_bits = int(kv_bits)
        self.kv_group = int(kv_group)
        # -- page eviction: "window" drops prompt pages wholly below the
        # trailing evict_param-token window, "mass" those whose EMA of the
        # paged kernel's attention mass fell below evict_param
        if evict_policy is not None:
            if evict_policy not in ("window", "mass"):
                raise ValueError(f"evict_policy {evict_policy!r} not in "
                                 "('window', 'mass')")
            if not paged:
                raise ValueError("evict_policy requires paged=True")
            if mesh is not None:
                raise ValueError(
                    "evict_policy requires mesh=None (the mass signal is a "
                    "chip-local head-shard statistic)")
            if self.spec_gamma or self.fused_ticks > 1:
                raise ValueError(
                    "evict_policy rides the plain K=1 decode path "
                    "(spec/fused blocks have no per-tick mass signal)")
            if evict_param is None:
                evict_param = (2.0 * page_size if evict_policy == "window"
                               else 0.02)
        self.evict_policy = evict_policy
        self.evict_param = float(evict_param or 0.0)
        if (prefix_cache or chunked_prefill) and not paged:
            raise ValueError(
                "prefix_cache / chunked_prefill require paged=True — both "
                "are page-pool structural levers (aliased pages, "
                "page-aligned chunk writes)")
        self.prefix_cache_enabled = bool(prefix_cache)
        self.chunked_prefill = bool(chunked_prefill)
        self.prefill_chunk = int(prefill_chunk or 2 * page_size)
        if paged and self.prefill_chunk % page_size:
            raise ValueError(
                f"prefill_chunk {self.prefill_chunk} must be a multiple of "
                f"page_size {page_size} (chunks write whole pages)")
        self.page_size = page_size
        # the dense engine has no pages: its tables are the active mask
        self.max_pages = self.total_pages = 0
        if paged:
            if page_size % stride:
                raise ValueError(f"page_size {page_size} must be a multiple "
                                 f"of stride {stride} (block flushes must "
                                 "not split a page)")
            if any(b % page_size for b in self.prompt_buckets):
                raise ValueError(f"prompt buckets {self.prompt_buckets} must "
                                 f"be multiples of page_size {page_size}")
            self.max_pages = page_table_size(
                self.prompt_buckets[-1] + self.max_len, page_size)
            self.total_pages = (total_pages if total_pages is not None
                                else n_slots * self.max_pages)
        self.debug_invariants = bool(debug_invariants)
        self.graphs = bool(graphs)
        if mesh is not None:
            self._shard_for_mesh(mesh)
        # the live state the ticks write in place (``_live``); with
        # donate=False the public ``pool``/``cache`` are rebound to copies
        # of it at every dispatch (:meth:`_rebind_public`)
        self.pool = self._empty_pool() if paged else None
        self.cache = (None if paged else
                      init_kv_cache(cfg, n_slots, self.max_len,
                                    device=self.device))
        # the draft: a view of the first draft_layers layers, made once
        # (under a mesh, of this rank's shards: a view cut by the same specs)
        self._draft_params = (draft_view(self.params, self.draft_layers)
                              if self.spec_gamma else None)
        self._free_pages = list(range(1, self.total_pages + 1))
        # every allocated page -> the slots whose table holds it; a page
        # registered in the prefix cache stays at refcount 0 when its last
        # owner leaves (reclaimable by _alloc_pages, least recently used
        # first), any other goes back to the free list
        self._page_refs: dict[int, int] = {}
        self._prefix_cache: OrderedDict[int, int] = OrderedDict()
        self._page_key: dict[int, int] = {}      # page -> registry key
        # slot -> its chunked prefill: request, padded prompt, next start
        self._prefilling: dict[int, dict] = {}
        self._pt = np.zeros((n_slots, self.max_pages), np.int32)
        self._tvec = np.zeros((n_slots,), np.int32)
        self._tpad = np.zeros((n_slots,), np.int32)
        # decode positions each slot's pages hold past its prompt region:
        # a fused lane freezes before its flush would pass them
        self._cap = np.zeros((n_slots,), np.int32)
        self._slot_pages: dict[int, list[int]] = {}
        dev = self.device
        self.tokens = torch.zeros(n_slots, dtype=torch.long, device=dev)
        self.pos = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        self.first_toks = torch.zeros(n_slots, dtype=torch.long, device=dev)
        self.temps = torch.zeros(n_slots, dtype=torch.float32, device=dev)
        # deterministic sampling: the reference's base key and its two
        # fold-in domains (0: the tick's stride steps, 1: prefill by rid),
        # made once; no generator state on the device
        self._sampler = None
        if self.sampling:
            base = prng.prng_key(seed, device=dev)
            self._sampler = {"key0": prng.fold_in(base, 0),
                             "key1": prng.fold_in(base, 1),
                             "top_k": self.top_k}
        self.active = np.zeros((n_slots,), bool)
        # -- the tick's static device state, allocated once: the tables it
        # reads and the lane-freeze state it writes share one int32 buffer,
        # refreshed by one copy from pinned staging a dispatch (which also
        # zeroes the freeze state); its outputs share one int64 slab
        cuda = dev.type == "cuda"
        self._tables = torch.zeros(self._table_words(), dtype=torch.int32,
                                   device=dev)
        self._staging = torch.zeros(self._table_words(), dtype=torch.int32,
                                    pin_memory=cuda)
        self._staged = torch.cuda.Event() if cuda else None
        tv = self._table_views(self._tables)
        self._pt_dev, self._tvec_dev, self._tpad_dev, self._active_dev = (
            tv["pt"], tv["tvec"], tv["tpad"], tv["active"])
        self._slab = torch.zeros(self._slab_words(), dtype=torch.long,
                                 device=dev)
        self._mass_out = (torch.zeros((n_slots, self.max_pages),
                                      dtype=torch.float32, device=dev)
                          if evict_policy == "mass" else None)
        # the host's copies of a dispatch's slab (and mass): two pinned
        # buffers used in turn, each filled by one non-blocking copy
        # enqueued after its dispatch's ticks and guarded by an event, so
        # a collect reads a finished copy, never the live slab that the
        # next dispatch rewrites (collect_overlap reads tick N after tick
        # N+1 went out)
        self._slab_host = [torch.zeros(self._slab_words(), dtype=torch.long,
                                       pin_memory=cuda) for _ in range(2)]
        self._mass_host = ([torch.zeros((n_slots, self.max_pages),
                                        dtype=torch.float32,
                                        pin_memory=cuda) for _ in range(2)]
                           if self._mass_out is not None else None)
        self._slab_ready = ([torch.cuda.Event() for _ in range(2)]
                            if cuda else None)
        self._slab_turn = 0
        self._tv = tv
        self._live = {"pool": self.pool, "cache": self.cache,
                      "tokens": self.tokens, "temps": self.temps,
                      "pos": self.pos, "first_toks": self.first_toks,
                      "freeze": tv, "out": self._slab_views(self._slab),
                      "spec_out": (self._spec_slab_views(self._slab)
                                   if self.spec_gamma else None),
                      "mass": self._mass_out}
        # the tick graphs by kind ("spec", "plain") and their stats
        self._graphs: dict[str, kernels.Graph] = {}
        self._graph_stats: dict[str, dict] = {}
        # -- the chunk step's static input (one int32 buffer: the chunk,
        # its start, the prompt length and the slot's page-table row),
        # filled by one copy a call from the slot's row of pinned staging
        # (an event a row guards its reuse), and its output token; only an
        # engine that can run a chunk holds them
        self._chunk_graph: kernels.Graph | None = None
        self.chunk_graph_stats: dict | None = None
        if self.paged and (self.prefix_cache_enabled or self.chunked_prefill):
            words = self.prefill_chunk + 4 + self.max_pages
            self._chunk_in = torch.zeros(words, dtype=torch.int32, device=dev)
            self._chunk_staging = torch.zeros(
                (n_slots, words), dtype=torch.int32, pin_memory=cuda)
            self._chunk_staged = ([torch.cuda.Event() for _ in range(n_slots)]
                                  if cuda else None)
            self._chunk_views = self._chunk_in_views(self._chunk_in)
            self._chunk_tok = torch.zeros(1, dtype=torch.long, device=dev)
        self.slot_req: dict[int, _Request] = {}
        self.queue = _AdmissionQueue()
        # the host buffer (0 or 1) of the dispatch not yet collected
        self._inflight: int | None = None
        self._inflight_k = 1
        self._inflight_spec = False
        self._inflight_budget: np.ndarray | None = None
        self._await_first: set[int] = set()
        self._next_rid = 0
        self._tick = 0
        self.emitted_tokens = 0      # all generated tokens (incl. first)
        self.prefill_tokens = 0      # prompt tokens prefilled (waves, chunks)
        self.prefill_tokens_saved = 0   # prompt tokens aliased, not run
        self.pages_aliased = 0
        self.prefix_hits = 0         # admissions that aliased >= 1 page
        self.chunks_run = 0          # prefill chunks dispatched
        self._decode_tokens = 0      # tokens produced by decode steps
        self.slot_steps = 0          # decode slot-steps spent
        self.prefill_waves = 0       # admission waves dispatched
        self.wave_sizes: list[int] = []              # k of each wave
        self.wave_log: list[tuple[int, int]] = []    # (k, bucket)
        # per dispatching tick: the host wall (ms) of its eviction,
        # admission and chunk work, and that work ("wave", k, bucket) /
        # ("chunk", C)
        self.stall_ms: list[float] = []
        self._tick_log: list[dict] = []
        self._tick_work: list = []
        # chip-tick cost: each dispatch charges its k device ticks (one
        # device) to the resident slots, a prefilling slot weighing the
        # prompt tokens it prefilled this tick (filled at wave and chunk
        # time), a decoding slot one unit
        self.cost = CostLedger()
        self.busy_ticks = 0
        self._tick_prefill_tokens: dict[int, int] = {}
        # the readout's wall a fused block, and each step()'s wall less its
        # readout's (``_sync_ms_last``)
        self.fused_block_ms: list[float] = []
        self.host_overhead_ms: list[float] = []
        # collect_overlap: the host wall of each overlapped readout (tick
        # N read while tick N+1 runs)
        self.overlap_ms: list[float] = []
        self._sync_ms_last = 0.0
        self._metrics = metrics
        if metrics is not None:
            metrics.set_gauge("serve_kv_bits",
                              self.kv_bits if paged else 16)
        self.hbm = LiveBytesTracker(metrics)
        self.kv_quality_delta = 0.0
        # -- page-chain migration: the rids whose chain is exported at
        # retirement (a disaggregated pool's prefill leg), and the exports
        # awaiting take_export (host tensors: they outlive this engine)
        self._migrate_out: set[int] = set()
        self._exports: dict[int, dict] = {}
        # slots an import activated after the in-flight block's dispatch:
        # that block holds nothing of theirs
        self._imported: set[int] = set()
        self.chains_exported = 0
        self.chains_imported = 0
        self.pages_migrated_out = 0
        self.pages_migrated_in = 0
        # -- fault injection and self-defense: ``chaos`` is consulted at
        # every dispatch, ``tick_deadline_s`` bounds a step's wall (the
        # watchdog), ``max_retries`` a request's quarantine replays
        self.chaos = chaos
        self.tick_deadline_s = tick_deadline_s
        self.max_retries = int(max_retries)
        self.dead: str | None = None      # the death reason, once dead
        self.slots_quarantined = 0
        self.requests_retried = 0
        self.requests_shed = 0
        self.dispatch_failures = 0
        # -- SLO-guarded admission: the queue turns tier-strict and EDF at
        # the first submit with a tier or a tick deadline (until then it is
        # the FIFO it always was); tenant quotas bound each tenant's
        # in-flight (queued + resident) requests
        self._seq = 0
        self._tier_mode = False
        self.tenant_quotas = dict(tenant_quotas or {})
        self._tenant_load: dict[str, int] = {}
        self._rid_tenant: dict[int, str] = {}
        self.requests_preempted = 0
        self.requests_resumed = 0
        self.deadline_misses = 0
        self.shed_by_reason: dict[str, int] = {}
        self._jseed = seed
        # advances every step(), dispatching or not (``_tick`` does not:
        # an idle engine would never clear a replay's backoff gate)
        self._step_count = 0
        # shed, failed and deadline-cancelled requests the next step()
        # returns, and the requests that finished in the step that killed
        # the engine (for a failover's harvest)
        self._failed: list[_Request] = []
        self._orphans: list[_Request] = []
        # eviction: pages released so far; per-(slot, row-local page) EMA of
        # the attention mass; the in-flight block's mass, fetched in
        # _maybe_evict after the tick's one host sync
        self.pages_evicted = 0
        self._page_mass = np.zeros((n_slots, self.max_pages))
        self._mass_pending: np.ndarray | None = None
        self.fused_dispatches = 0     # fused blocks dispatched
        self.fused_ticks_run = 0      # device ticks covered by them
        self.fused_stalls = 0         # lanes frozen by the page cap
        # -- speculative accounting: ``_gcap`` is the per-slot cap the next
        # verify applies, ``_accept_ema`` the rolling match fraction
        # driving it (optimistic for a new request); ``_spec_active`` the
        # active mask at dispatch, so collect credits the slots that
        # drafted; ``spec_degrade_after`` zero-match ticks in a row (over
        # every active slot) degrade the engine to the plain tick for good
        self._gcap = np.full((n_slots,), self.spec_gamma, np.int32)
        self._accept_ema = np.ones((n_slots,), np.float64)
        self._spec_active: np.ndarray | None = None
        self.spec_ticks = 0
        self.spec_drafts_proposed = 0
        self.spec_drafts_accepted = 0
        self.spec_degraded = False
        self._spec_reject_streak = 0
        # -- request tracing: the anchor span roots the engine's tree,
        # under the decoded inbound context when there is one
        self._tracer = tracer
        self._engine_anchor = None
        if tracer is not None:
            with tracer.span("engine.start", parent=trace_ctx,
                             attrs={"n_slots": n_slots, "paged": paged,
                                    "tp": self.tp,
                                    "spec_gamma": self.spec_gamma}) as sp:
                self._engine_anchor = sp.context
        self._req_spans: dict[int, object] = {}   # rid -> open Span
        self._submit_ts: dict[int, float] = {}    # rid -> submit wall
        self._first_tok_ts: dict[int, float] = {}  # rid -> TTFT wall

    def _shard_for_mesh(self, mesh) -> None:
        """Lay the engine out over its ("tp",) mesh ONCE, at construction
        (the reference's ``device_put_tree``): this rank's weight shards cut
        Megatron-style (:func:`serve_param_specs`; int8 weights' scales
        with their values on a column split), and the local config the
        device bodies run (the head counts and d_ff divided by tp, the
        physical head width kept).  The pool is made at its local shape,
        ``Hkv / tp`` heads (:meth:`_empty_pool`).  A gloo group moves CUDA
        tensors through the host, which no CUDA graph can capture, so on
        the card it needs ``graphs=False``.  The tree is cut where it lies
        (the host, this card or another one) and only the shard lands on
        the engine's device."""
        import torch.distributed as dist

        # (kubegpu_tpu_torch.parallel imports the models package)
        from kubegpu_tpu_torch.parallel.sharding import (
            serve_param_specs,
            shard_tree,
        )
        if mesh.device_type != self.device.type:
            raise ValueError(f"mesh devices are {mesh.device_type!r}, the "
                             f"engine's {self.device.type!r}")
        backend = dist.get_backend(self._tp_group)
        if self.graphs and self.device.type == "cuda" and backend != "nccl":
            raise ValueError(
                f"graphs=True needs an NCCL tp group: {backend} moves CUDA "
                "tensors through the host and cannot be captured in a CUDA "
                "graph; build this engine with graphs=False")
        self._capture_mode = ("thread_local" if backend == "nccl"
                              else "global")
        cfg, tp = self.cfg, self.tp
        self._lcfg = replace(cfg, n_heads=cfg.n_heads // tp,
                             n_kv_heads=cfg.n_kv_heads // tp,
                             d_ff=cfg.d_ff // tp,
                             head_dim_override=cfg.head_dim)
        quant = isinstance(self.params["layers"]["wq"], QTensor)
        self.params = shard_tree(self.params, serve_param_specs(quant),
                                 self.tp_rank, tp, self.device)

    def _clock(self) -> float:
        """The wall clock a host decision reads (a ``deadline_s``): this
        process's, or under a mesh rank 0's, broadcast, so every rank
        takes the same decision and the replicated host state never
        parts."""
        now = time.monotonic()
        if self._tp_group is None:
            return now
        return broadcast_float(now, self._tp_group)

    def host_digest(self) -> str:
        """A sha256 of the engine's host state: page tables, lengths and
        caps, the free list, page refcounts, the prefix registry, slot
        occupancy, the queue and the counters.  Under a mesh every rank
        runs the same host code on the same submits and picks from the same
        all-gathered logits, so every rank must hold the same digest."""
        h = hashlib.sha256()
        for a in (self._pt, self._tvec, self._tpad, self._cap, self.active,
                  self._gcap):
            h.update(np.ascontiguousarray(a).tobytes())
        state = (self._free_pages, sorted(self._page_refs.items()),
                 list(self._prefix_cache.values()),
                 sorted((s, r.rid) for s, r in self.slot_req.items()),
                 [r.rid for r, _ in self.queue], sorted(self._prefilling),
                 self._tick, self._step_count, self._next_rid,
                 self.emitted_tokens, self.prefill_tokens, self.prefix_hits,
                 self.pages_aliased, self.chunks_run, self.prefill_waves,
                 self.slot_steps, self.requests_shed, self.deadline_misses,
                 self.spec_ticks, self.spec_drafts_proposed,
                 self.spec_drafts_accepted, self.fused_dispatches,
                 self.fused_ticks_run)
        h.update(repr(state).encode())
        return h.hexdigest()

    # -- the tick's static buffers ---------------------------------------

    _TABLES = ("tvec", "tpad", "cap", "budget", "active", "gcap", "emitted",
               "stall", "dead")

    def _table_words(self) -> int:
        n = self.n_slots
        return n * self.max_pages + n * len(self._TABLES) + 2

    def _table_views(self, buf: torch.Tensor) -> dict:
        """Named views of an int32 table buffer: ``pt`` [n_slots,
        max_pages], the per-slot vectors of ``_TABLES`` (the tables the
        host uploads, then the lane freeze the tick writes: tokens emitted
        this dispatch, page-cap stalls, latched non-finite lanes),
        ``tick``, the engine tick the dispatch starts at (its first
        tick's sampling key), and ``tk``, the dispatch's tick index."""
        n, mp = self.n_slots, self.max_pages
        out = {"pt": buf[:n * mp].view(n, mp)}
        for i, name in enumerate(self._TABLES):
            out[name] = buf[n * mp + i * n:n * mp + (i + 1) * n]
        out["tick"] = buf[-2:-1]
        out["tk"] = buf[-1:]
        return out

    def _slab_words(self) -> int:
        """Words of the host fetch: its plain layout's, or its spec
        layout's when that is longer (a spec engine that degrades fetches
        both through one slab)."""
        n, k = self.n_slots, self.fused_ticks
        spec = k * (self.spec_gamma + 4) + 2 if self.spec_gamma else 0
        return n * max(k * (self.stride + 1) + 2, spec)

    def _slab_views(self, slab: torch.Tensor) -> dict:
        """The host fetch's plain layout: ``[K·stride·B token blocks, K·B
        bad flags, B stall flags, B first tokens]`` with K =
        ``fused_ticks`` (the reference's fused layout; K = 1 is its plain
        one)."""
        n, k, s = self.n_slots, self.fused_ticks, self.stride
        nb = k * s * n
        return {"blocks": slab[:nb].view(k, s, n),
                "bads": slab[nb:nb + k * n].view(k, n),
                "stall": slab[nb + k * n:nb + k * n + n],
                "firsts": slab[nb + k * n + n:nb + k * n + 2 * n]}

    def _spec_slab_views(self, slab: torch.Tensor) -> dict:
        """The host fetch's spec layout (the reference's fused spec one):
        ``[K·B·(γ+1) emit, K·B take, K·B matched, K·B bad flags, B stall
        flags, B first tokens]``."""
        n, k, g = self.n_slots, self.fused_ticks, self.spec_gamma
        ne, kb = k * n * (g + 1), k * n
        views = {"emit": slab[:ne].view(k, n, g + 1)}
        for i, name in enumerate(("take", "matched", "bads")):
            views[name] = slab[ne + i * kb:ne + (i + 1) * kb].view(k, n)
        views["stall"] = slab[ne + 3 * kb:ne + 3 * kb + n]
        views["firsts"] = slab[ne + 3 * kb + n:ne + 3 * kb + 2 * n]
        return views

    def _chunk_in_views(self, buf: torch.Tensor) -> dict:
        """Named views of the chunk step's int32 input: ``tokens`` [1, C],
        ``s``, ``tlen`` and ``rid`` [1], ``temp`` [1] (a float32 view of
        its word), ``pt`` [1, max_pages]."""
        c = self.prefill_chunk
        return {"tokens": buf[:c].view(1, c), "s": buf[c:c + 1],
                "tlen": buf[c + 1:c + 2], "rid": buf[c + 2:c + 3],
                "temp": buf[c + 3:c + 4].view(torch.float32),
                "pt": buf[c + 4:].view(1, -1)}

    def _empty_pool(self) -> dict:
        """A pool of ``total_pages + 1`` pages in this engine's format,
        every page empty: zeros in the model dtype, int8 zeros with scales
        1, or packed int4 :data:`Q4_ZERO_BYTE` with scales 1; each
        dequantizes to exact zero.  Under a mesh the pool holds this rank's
        ``Hkv / tp`` heads (dim 2, :func:`~kubegpu_tpu_torch.parallel.
        sharding.pool_specs`)."""
        cfg, dev = self._lcfg, self.device
        shape = (cfg.n_layers, self.total_pages + 1, cfg.n_kv_heads,
                 self.page_size, cfg.head_dim)
        if self.kv_bits == 16:
            return {n: torch.zeros(shape, dtype=cfg.tdtype, device=dev)
                    for n in ("k", "v")}
        if self.kv_bits == 8:
            vals = torch.zeros(shape, dtype=torch.int8, device=dev)
            n_scale = self.page_size
        else:
            vals = torch.full(shape[:-1] + (cfg.head_dim // 2,),
                              Q4_ZERO_BYTE, dtype=torch.uint8, device=dev)
            n_scale = self.page_size // self.kv_group
        scales = torch.ones(shape[:3] + (n_scale,), dtype=torch.float32,
                            device=dev)
        return {"k": vals, "v": vals.clone(), "k_scale": scales,
                "v_scale": scales.clone()}

    # -- requests -------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0, deadline_s: float | None = None,
               migrate_out: bool = False, tier: int = 0, tenant: str = "",
               deadline_ticks: int | None = None) -> int:
        """Enqueue a request (``prompt``: 1-D int sequence).
        ``temperature`` 0 decodes greedily, > 0 samples (a
        ``sampling=True`` engine only).  ``deadline_s`` fails the request
        (``error='deadline exceeded'``, partial tokens kept) if it has not
        finished that many seconds from now; ``deadline_ticks`` does so
        after that many ``step()`` calls and also orders it within its
        tier (EDF; the wall clock only prunes).  ``tier`` is the priority
        (0 most critical), ``tenant`` the quota bucket: an over-quota
        submit is shed at the door, returned FAILED by the next
        ``step()``.  ``migrate_out`` (paged only) exports the request's
        page chain at retirement, before its pages return (the prefill
        leg of disaggregated serving; :meth:`take_export`).
        With ``prefix_cache`` the request keeps one registry key a full
        leading prompt page (a digest of the prompt up to that page's end,
        :func:`page_keys`, the same in every process); the page holding
        token ``t - 1`` is never cached."""
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if tier < 0:
            raise ValueError(f"tier must be >= 0, got {tier}")
        if deadline_ticks is not None and deadline_ticks < 1:
            raise ValueError(
                f"deadline_ticks must be >= 1, got {deadline_ticks}")
        if migrate_out and not self.paged:
            raise ValueError(
                "migrate_out needs the paged pool (page chains are "
                "the migration transfer unit)")
        if temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {temperature}")
        if temperature > 0 and not self.sampling:
            raise ValueError(
                "temperature > 0 needs a sampling-enabled engine "
                "(ContinuousBatcher(..., sampling=True)) — greedy-only "
                "engines compile argmax-only decode steps")
        prompt_np = np.asarray(prompt, np.int64)
        t = int(prompt_np.shape[0])
        if t < 1:
            raise ValueError("prompt must have at least one token")
        bucket = next((b for b in self.prompt_buckets if b >= t), None)
        if bucket is None:
            raise ValueError(f"prompt length {t} exceeds largest bucket "
                             f"{self.prompt_buckets[-1]}")
        # how far past the last consumed token the engine may write: a
        # stride block, or a verify tick's γ+1 positions
        overhang = max(self.stride, self.spec_gamma + 1
                       if self.spec_gamma else 0)
        if t + max_new_tokens + overhang > self.max_len:
            raise ValueError(
                f"prompt {t} + max_new {max_new_tokens} + overhang "
                f"{overhang} (stride/γ+1) > max_len {self.max_len}")
        need = self._pages_needed(max_new_tokens, bucket) if self.paged else 0
        if need > self.total_pages:
            raise ValueError(
                f"request needs {need} pages (bucket {bucket} + "
                f"{max_new_tokens} new tokens) but the pool has only "
                f"{self.total_pages}")
        req = _Request(rid=self._next_rid, prompt_len=t,
                       max_new_tokens=max_new_tokens,
                       temperature=float(temperature), prompt=prompt_np,
                       admit_len=t, tier=int(tier), tenant=str(tenant),
                       deadline=(self._clock() + deadline_s
                                 if deadline_s is not None else None),
                       deadline_tick=(self._step_count + deadline_ticks
                                      if deadline_ticks is not None
                                      else None))
        self._next_rid += 1
        req.submit_tick = self._tick
        if tier > 0 or deadline_ticks is not None:
            self._tier_mode = True
        if self._tracer is not None or self._metrics is not None:
            self._submit_ts[req.rid] = time.perf_counter()
        if self._tracer is not None:
            self._req_spans[req.rid] = self._tracer.start_span(
                "request", parent=self._engine_anchor,
                attrs={"rid": req.rid, "prompt_len": t,
                       "max_new_tokens": max_new_tokens, "tier": int(tier)})
        quota = self.tenant_quotas.get(req.tenant) if req.tenant else None
        if (quota is not None
                and self._tenant_load.get(req.tenant, 0) >= quota):
            # over quota: rejected at the door, never queued or prefilled
            self._shed(req, f"tenant {req.tenant!r} over quota "
                       f"({quota} in flight)", reason="quota")
            return req.rid
        if req.tenant:
            self._rid_tenant[req.rid] = req.tenant
            self._tenant_load[req.tenant] = \
                self._tenant_load.get(req.tenant, 0) + 1
        if migrate_out:
            self._migrate_out.add(req.rid)
        self._enqueue(req, prompt_np)
        return req.rid

    def _enqueue(self, req: _Request, prompt_np: np.ndarray) -> None:
        """Queue ``req`` for admission with ``prompt_np`` as its prompt
        (the original, or prompt + accepted tokens at a requeue): its
        bucket-padded row, its prefix keys (``prefix_cache``; see
        :meth:`submit`) and a fresh enqueue ``seq``.  The caller has
        checked that a bucket holds it."""
        t = int(prompt_np.shape[0])
        bucket = next(b for b in self.prompt_buckets if b >= t)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :t] = prompt_np
        keys: tuple = ()
        if self.paged and self.prefix_cache_enabled:
            keys = page_keys(prompt_np, self.page_size)
        req.prefix_keys = keys
        req.admit_len = t
        req.seq = self._seq
        self._seq += 1
        self.queue.append((req, padded))

    # -- pages ----------------------------------------------------------

    def _pages_needed(self, max_new_tokens: int, bucket: int) -> int:
        """Pool pages a request holds for its lifetime: its prompt bucket
        plus the decode extent its full stride blocks flush; a speculative
        engine's extent is ``max_new + γ`` (a verify's rejected tail may
        pass the accepted frontier by up to γ positions)."""
        if self.spec_gamma:
            dec_pages = -(-(max_new_tokens + self.spec_gamma)
                          // self.page_size)
        else:
            blocks = -(-(max_new_tokens - 1) // self.stride)
            dec_pages = -(-(blocks * self.stride) // self.page_size)
        return bucket // self.page_size + dec_pages

    # -- the prefix registry (refcounted pages) --------------------------

    def _prefix_hit_run(self, req: _Request) -> int:
        """Longest run of the request's leading page keys present in the
        registry (from page 0 on: a reclaim drops single pages, so key i
        alone does not imply the keys before it)."""
        if not self.prefix_cache_enabled:
            return 0
        h = 0
        for key in req.prefix_keys:
            if key not in self._prefix_cache:
                break
            h += 1
        return h

    def _available_pages(self) -> int:
        """Pages an admission can claim: the free list plus the registered
        pages no slot holds (reclaimable)."""
        return len(self._free_pages) + sum(
            1 for p in self._prefix_cache.values()
            if self._page_refs.get(p, 0) == 0)

    def _alloc_pages(self, n: int) -> list[int]:
        """Claim n pages at refcount 1, reclaiming the least recently used
        unreferenced registered page when the free list is empty (the
        admission gate guarantees they exist)."""
        out = []
        for _ in range(n):
            p = (self._free_pages.pop() if self._free_pages
                 else self._evict_cached_page())
            self._page_refs[p] = 1
            out.append(p)
        return out

    def _evict_cached_page(self) -> int:
        for key, p in self._prefix_cache.items():      # LRU first
            if self._page_refs.get(p, 0) == 0:
                del self._prefix_cache[key]
                del self._page_key[p]
                del self._page_refs[p]
                return p
        raise RuntimeError("page pool exhausted past the admission gate")

    def _alias_pages(self, req: _Request, hits: int) -> list[int]:
        """Take a reference on each of the request's first ``hits``
        registered pages (and mark them most recently used)."""
        pages = []
        for key in req.prefix_keys[:hits]:
            p = self._prefix_cache[key]
            self._prefix_cache.move_to_end(key)
            self._page_refs[p] += 1
            pages.append(p)
        return pages

    def _register_prefix(self, req: _Request, pages: list[int]) -> None:
        """Publish a finished prefill's full prompt pages under their keys:
        the first writer of a key wins, and a page aliased from the
        registry is already there."""
        if not self.prefix_cache_enabled:
            return
        for key, p in zip(req.prefix_keys, pages):
            if key in self._prefix_cache or p in self._page_key:
                continue
            self._prefix_cache[key] = p
            self._page_key[p] = key

    def _release_pages(self, slot: int) -> None:
        """Drop one reference on each of the slot's pages and zero its
        table row, length scalars and mass, so its per-block garbage flush
        retargets trash page 0 (nothing on the dense engine).  A page
        frees on its last owner's release, unless it is registered: then
        it stays at refcount 0, aliasable until an allocation reclaims
        it."""
        if not self.paged:
            return
        for p in self._slot_pages.pop(slot, []):
            if p == 0:
                continue          # eviction hole: already released
            self._page_refs[p] -= 1
            if self._page_refs[p] == 0 and p not in self._page_key:
                del self._page_refs[p]
                self._free_pages.append(p)
        self._pt[slot, :] = 0
        self._tvec[slot] = self._tpad[slot] = self._cap[slot] = 0
        self._page_mass[slot] = 0.0

    def _upload_tables(self, budget: np.ndarray, k: int) -> None:
        """Refresh the tick's device tables from the host's (page table,
        lengths, page caps, this dispatch's token ``budget``, the active
        mask, the speculative caps, the engine tick) and zero the
        lane-freeze state: one
        non-blocking copy from pinned staging into the buffers the graph
        binds.  A dispatch of ``k = 1`` tick uploads no page cap: the
        reference's single tick has no lane freeze (a degraded spec
        engine's pages cover ``max_new + γ``, which a stride block may
        pass).  The staging is rewritten only once the previous copy has
        left it (an event; by then ``_collect`` has synchronized
        anyway)."""
        if self._staged is not None:
            self._staged.synchronize()
        host = self._table_views(self._staging)
        host["pt"].numpy()[:] = self._pt
        for name, x in (("tvec", self._tvec), ("tpad", self._tpad),
                        ("cap", self._cap if k > 1 else _NO_CAP),
                        ("budget", budget), ("active", self.active),
                        ("gcap", self._gcap), ("tick", self._tick)):
            host[name].numpy()[:] = x
        self._tables.copy_(self._staging, non_blocking=True)
        if self._staged is not None:
            self._staged.record()

    # -- the engine tick ------------------------------------------------

    def _admit(self) -> None:
        """Admission into free slots, in queue order: FIFO, or in tier mode
        tier-strict and EDF within a tier (:meth:`_sort_queue`).  The
        queue front waits out its replay backoff, and a front waiting for
        pages blocks everything behind it (its registered prefix pages do
        not count against its ask, unreferenced registered pages count as
        free); a front that could never fit the pool is shed.  In tier
        mode a front short of a slot or of pages first preempts strictly
        lower-tier decoders (:meth:`_maybe_preempt`).  The dense engine
        needs only a free slot.  A request that
        hits the prefix registry, or (``chunked_prefill``) whose bucket
        exceeds ``prefill_chunk``, admits alone onto the chunk path
        (:meth:`_admit_chunked`); otherwise consecutive queue-front
        requests sharing one prompt bucket prefill as one [k, bucket] wave
        (k a power of two up to ``max_wave``; on the paged engine shrunk
        until the wave's pages fit).  With ``prefix_cache`` a wave stops
        before a request that hits, or that shares its leading page key
        with an earlier member: it should alias that member's pages, which
        are registered right after the wave's adoption."""
        free = deque(s for s in range(self.n_slots) if s not in self.slot_req)
        if self._tier_mode:
            self._sort_queue()
            if self.queue and not free:
                # slot pressure: the most critical queued request outranks
                # a resident lower-tier decoder
                req0, p0 = self.queue[0]
                if req0.not_before_tick <= self._step_count:
                    need = 0
                    if self.paged:
                        need = (self._pages_needed(req0.remaining_new,
                                                   p0.shape[1])
                                - self._prefix_hit_run(req0))
                    free.extend(sorted(
                        self._maybe_preempt(req0, need, need_slot=True)))
        while free and self.queue:
            req0, p0 = self.queue[0]
            if req0.not_before_tick > self._step_count:
                break        # a replay's backoff: it waits at the front
            bucket = p0.shape[1]
            if self.paged:
                hits0 = self._prefix_hit_run(req0)
                need0 = self._pages_needed(req0.remaining_new, bucket)
                if need0 - hits0 > self.total_pages:
                    # a replay whose prompt grew past the pool can never
                    # fit: shed it instead of blocking the queue behind it
                    self.queue.popleft()
                    self._shed(req0, f"shed: needs {need0 - hits0} "
                               f"pages, pool has {self.total_pages}")
                    continue
                if need0 - hits0 > self._available_pages():
                    if self._tier_mode:
                        freed = self._maybe_preempt(req0, need0 - hits0,
                                                    need_slot=False)
                        if freed:
                            free.extend(sorted(freed))
                            # the parked victims re-entered the queue
                            self._sort_queue()
                            continue
                    break
                if hits0 or (self.chunked_prefill
                             and bucket > self.prefill_chunk):
                    self._admit_chunked(free.popleft(), hits0)
                    continue
            n_same = 1
            # (prefix keys exist only with the prefix cache on)
            seen_lead = set(req0.prefix_keys[:1])
            for r, p in list(self.queue)[1:min(len(self.queue), len(free))]:
                if p.shape[1] != bucket:
                    break
                if r.prefix_keys:
                    if (self._prefix_hit_run(r)
                            or r.prefix_keys[0] in seen_lead):
                        break
                    seen_lead.add(r.prefix_keys[0])
                n_same += 1
            k = 1
            while k * 2 <= min(n_same, len(free), self.max_wave):
                k *= 2
            while self.paged and k > 1 and sum(
                    self._pages_needed(r.remaining_new, bucket)
                    for r, _ in list(self.queue)[:k]
                    ) > self._available_pages():
                k //= 2
            wave = [self.queue.popleft() for _ in range(k)]
            slots = [free.popleft() for _ in range(k)]
            padded = torch.from_numpy(
                np.concatenate([p for _, p in wave])).to(self.device)
            true_lens = torch.tensor([r.admit_len for r, _ in wave],
                                     device=self.device)
            temps_w = (torch.tensor([r.temperature for r, _ in wave],
                                    dtype=torch.float32, device=self.device)
                       if self.sampling else None)
            firsts, cache_w = self._prefill(padded, true_lens, temps_w,
                                            wave[0][0].rid)
            self.prefill_waves += 1
            self.wave_sizes.append(k)
            page_dst = None
            if self.paged:
                n_prompt_pages = bucket // self.page_size
                page_dst = np.zeros((k, n_prompt_pages), np.int64)
                for i, (slot, (req, _)) in enumerate(zip(slots, wave)):
                    need = self._pages_needed(req.remaining_new, bucket)
                    pages = self._alloc_pages(need)
                    self._slot_pages[slot] = pages
                    self._pt[slot, :] = 0
                    self._pt[slot, :need] = pages
                    self._tvec[slot] = req.admit_len
                    self._tpad[slot] = bucket
                    self._cap[slot] = decode_capacity(need, bucket,
                                                      self.page_size)
                    page_dst[i] = pages[:n_prompt_pages]
                page_dst = torch.from_numpy(page_dst).to(self.device)
            self._adopt(self._live, cache_w, page_dst,
                        torch.tensor(slots, device=self.device), firsts,
                        true_lens, temps_w)
            self._sample_hbm()
            self.wave_log.append((k, bucket))
            self._tick_work.append(("wave", k, bucket))
            self.prefill_tokens += sum(r.admit_len for r, _ in wave)
            for slot, (req, _) in zip(slots, wave):
                remaining = req.remaining_new
                self.active[slot] = remaining > 1
                self.slot_req[slot] = req
                self._tick_prefill_tokens[slot] = req.admit_len
                self._await_first.add(slot)
                self.emitted_tokens += 1
                self._note_resume(req, slot)
                if remaining <= 1:
                    req.done = True
                if self._tracer is not None or self._metrics is not None:
                    self._trace_admit(req, slot, "wave")
                if self.paged:
                    # the adoption is ordered before any later read, so the
                    # next request of this loop may alias the pages already
                    self._register_prefix(req, self._slot_pages[slot])

    def _admit_chunked(self, slot: int, hits: int) -> None:
        """Admit the queue-front request onto ``slot`` without a wave:
        alias its ``hits`` registered prefix pages, allocate the rest, and
        queue its prompt from the first unaliased page as chunks that
        :meth:`_run_prefill_chunks` runs one a step.  The slot stays
        inactive until its final chunk; its per-block garbage flush lands
        in its own first decode page (never aliased), which its first real
        flush overwrites before a position there becomes valid."""
        req, padded = self.queue.popleft()
        bucket = padded.shape[1]
        need = self._pages_needed(req.remaining_new, bucket)
        pages = self._alias_pages(req, hits) + self._alloc_pages(need - hits)
        self._slot_pages[slot] = pages
        self._pt[slot, :] = 0
        self._pt[slot, :need] = pages
        self._tvec[slot] = req.admit_len
        self._tpad[slot] = bucket
        self._cap[slot] = decode_capacity(need, bucket, self.page_size)
        if hits:
            self.prefix_hits += 1
            self.pages_aliased += hits
            self.prefill_tokens_saved += hits * self.page_size
        # padded by one chunk, so the final chunk's slice is whole: its pad
        # keys land past the prompt, in the slot's own pages or page 0
        self._prefilling[slot] = {
            "req": req, "next": hits * self.page_size,
            "padded": np.pad(padded[0], (0, self.prefill_chunk))}
        self.slot_req[slot] = req
        self.active[slot] = False
        self._note_resume(req, slot)
        if self._tracer is not None or self._metrics is not None:
            self._trace_admit(req, slot, "chunk")

    def _run_prefill_chunks(self) -> None:
        """One prefill chunk for each prefilling slot, in slot order; a
        slot whose chunk held its last prompt position goes live (its
        first token is the chunk's pick) and registers its pages."""
        for slot in sorted(self._prefilling):
            st = self._prefilling[slot]
            req = st["req"]
            t, c, start = req.admit_len, self.prefill_chunk, st["next"]
            self._run_chunk(slot, st["padded"][start:start + c], start, t,
                            req.rid, req.temperature)
            self._sample_hbm()
            self.chunks_run += 1
            self._tick_work.append(("chunk", c))
            if self._tracer is not None:
                self._tracer.instant(
                    "request.prefill_chunk", self._req_spans.get(req.rid),
                    attrs={"rid": req.rid, "slot": slot, "start": start,
                           "chunk": c})
            self.prefill_tokens += min(t - start, c)
            self._tick_prefill_tokens[slot] = (
                self._tick_prefill_tokens.get(slot, 0) + min(t - start, c))
            st["next"] = start + c
            if st["next"] >= t:
                activate_slot(self.first_toks, self.tokens, self.pos, slot,
                              self._chunk_tok, t, self.temps,
                              req.temperature if self.sampling else None)
                del self._prefilling[slot]
                self._register_prefix(req, self._slot_pages[slot])
                remaining = req.remaining_new
                self.active[slot] = remaining > 1
                self._await_first.add(slot)
                self.emitted_tokens += 1
                if remaining <= 1:
                    req.done = True

    def _run_chunk(self, slot: int, chunk: np.ndarray, start: int,
                   tlen: int, rid: int = 0, temp: float = 0.0,
                   st: dict | None = None) -> None:
        """Stage one chunk of ``slot`` (its tokens, start, prompt length,
        the request's rid and temperature, and the slot's host page-table
        row: the tick's device tables are refreshed only at dispatch) into
        the chunk step's device input by one copy, then run the step over
        ``st``'s pool (default: the live one): a replay of its graph, or
        the body itself off the graph path.  Without :meth:`warmup`, the
        first chunk runs eagerly and the graph is captured after it."""
        c = self.prefill_chunk
        if self._chunk_staged is not None:
            self._chunk_staged[slot].synchronize()
        row = self._chunk_staging[slot].numpy()
        row[:c] = chunk
        row[c], row[c + 1], row[c + 2] = start, tlen, rid
        row[c + 3] = np.float32(temp).view(np.int32)
        # warmup's scratch run writes through a zero row: trash page 0
        row[c + 4:] = self._pt[slot] if st is None else 0
        self._chunk_in.copy_(self._chunk_staging[slot], non_blocking=True)
        if self._chunk_staged is not None:
            self._chunk_staged[slot].record()
        if st is None and self._chunk_graph is not None:
            self._chunk_graph.replay()
            return
        t0 = time.perf_counter()
        self._chunk_on(self._live["pool"] if st is None else st["pool"])
        if st is None and self._use_graph():
            self._capture_chunk(time.perf_counter() - t0)

    def _chunk_on(self, pool: dict) -> None:
        chunk_body(self.params, pool, self._chunk_views, self._chunk_tok,
                   self._lcfg, self.page_size, self._sampler, self._ffn,
                   self._tp_group)

    def _capture_chunk(self, eager_s: float) -> None:
        """Capture the chunk step over the live pool (nothing runs)."""
        # as in _capture: the graph's function must not refer to the engine
        params, pool, views, out, cfg, page, sampler, ffn, group = (
            self.params, self._live["pool"], self._chunk_views,
            self._chunk_tok, self._lcfg, self.page_size, self._sampler,
            self._ffn, self._tp_group)
        self._chunk_graph, self.chunk_graph_stats = _captured(
            lambda: chunk_body(params, pool, views, out, cfg, page, sampler,
                               ffn, group),
            eager_s, self._capture_mode)

    @_on_engine_device
    def warmup(self) -> None:
        """Run every shape this engine can hit -- each power-of-two wave
        size up to ``max_wave`` per prompt bucket through prefill and
        adoption, the chunk step (with ``prefix_cache`` or
        ``chunked_prefill``), then one tick of each kind the engine can
        dispatch (the spec tick, and the plain one a spec engine degrades
        to when ``spec_degrade_after`` is set) -- on scratch copies of the
        pool and slot vectors, so no engine state or counter changes; on
        the card, then capture the ticks' and the chunk step's CUDA graphs
        (which runs nothing).  Every eager run comes before every capture:
        the folded queries of the chunk step and of the verify grow the
        paged kernels' shared scratch, which must not grow under a
        capture.  Call it before a timed window: otherwise the first call
        at each shape (cuBLAS's algorithm choice, the caching allocator's
        growth) and the captures land inside it."""
        scratch = self._scratch_state()
        for bucket in self.prompt_buckets:
            k = 1
            while k <= min(self.n_slots, self.max_wave):
                lens = torch.ones(k, dtype=torch.long, device=self.device)
                temps_w = (torch.zeros(k, device=self.device)
                           if self.sampling else None)
                firsts, cache_w = self._prefill(
                    torch.zeros((k, bucket), dtype=torch.long,
                                device=self.device), lens, temps_w, 0)
                # page ids 0: every prompt page lands in the trash page
                page_dst = (torch.zeros((k, bucket // self.page_size),
                                        dtype=torch.long, device=self.device)
                            if self.paged else None)
                self._adopt(scratch, cache_w, page_dst,
                            torch.arange(k, device=self.device), firsts, lens,
                            temps_w)
                k *= 2
        chunk_s = None
        if self.paged and (self.prefix_cache_enabled or self.chunked_prefill):
            t0 = time.perf_counter()
            self._run_chunk(0, np.zeros(self.prefill_chunk, np.int64), 0, 1,
                            st=scratch)
            self._sync()
            chunk_s = time.perf_counter() - t0
        eager_s = {}
        for kind in self._tick_kinds():
            # each kind's run starts from a zeroed freeze state (tk = 0)
            scratch["freeze"] = self._table_views(
                torch.zeros_like(self._tables))
            t0 = time.perf_counter()
            self._tick_on(scratch, kind)
            self._sync()
            eager_s[kind] = time.perf_counter() - t0
        if not self._use_graph():
            return
        for kind, seconds in eager_s.items():
            if kind not in self._graphs:
                self._capture(kind, seconds)
        if chunk_s is not None and self._chunk_graph is None:
            self._capture_chunk(chunk_s)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill(self, padded: torch.Tensor, true_lens: torch.Tensor,
                 temps_w: torch.Tensor | None, rid0: int):
        """A wave's prefill: a bucket-wide panel for the paged engine's
        pages, a ``max_len``-wide one for the dense engine's rows; a
        sampling engine's first tokens drawn under the wave's key
        ``fold_in(fold_in(base, 1), rid0)`` at the rows' ``temps_w``."""
        sample = None
        if self._sampler is not None:
            sample = {"temps": temps_w, "top_k": self.top_k,
                      "key": prng.fold_in(self._sampler["key1"], rid0)}
        return prefill_wave(self.params, padded, true_lens, self._lcfg,
                            None if self.paged else self.max_len, sample,
                            self._ffn, self._tp_group)

    def _adopt(self, st: dict, cache_w: dict, page_dst, slots, firsts,
               lens, temps_w) -> None:
        """Adopt a prefilled wave into ``st`` (the live state or warmup's
        scratch): into the pages ``page_dst`` names, or into the dense
        cache rows of ``slots``; a sampling engine also writes the rows'
        temperatures ``temps_w``."""
        if self.paged:
            adopt_wave(st["pool"], cache_w, page_dst, slots, firsts, lens,
                       st["first_toks"], st["tokens"], st["pos"],
                       self.page_size, st["temps"], temps_w)
        else:
            adopt_wave_dense(st["cache"], cache_w, slots, firsts, lens,
                             st["first_toks"], st["tokens"], st["pos"],
                             st["temps"], temps_w)

    def _scratch_state(self) -> dict:
        """Zeroed stand-ins for everything the tick body writes."""
        slab = torch.zeros_like(self._slab)
        return {"pool": self._empty_pool() if self.paged else None,
                "cache": (None if self.paged else
                          {n: torch.zeros_like(x)
                           for n, x in self._live["cache"].items()}),
                "tokens": torch.zeros_like(self.tokens),
                "temps": torch.zeros_like(self.temps),
                "pos": torch.zeros_like(self.pos),
                "first_toks": torch.zeros_like(self.first_toks),
                "freeze": self._table_views(torch.zeros_like(self._tables)),
                "out": self._slab_views(slab),
                "spec_out": (self._spec_slab_views(slab)
                             if self.spec_gamma else None),
                "mass": (None if self._mass_out is None
                         else torch.zeros_like(self._mass_out))}

    def _use_graph(self) -> bool:
        return self.graphs and self.device.type == "cuda"

    def _tick_kinds(self) -> tuple[str, ...]:
        """The ticks this engine may dispatch: the spec tick (and, with
        ``spec_degrade_after``, the plain one it degrades to), or the
        plain tick."""
        if not self.spec_gamma:
            return ("plain",)
        return ("spec", "plain") if self.spec_degrade_after is not None \
            else ("spec",)

    def _tick_fn(self, kind: str):
        """The tick body of ``kind`` as a function of the state it runs
        on.  It refers to what the tick reads, not to the engine: a graph
        holding it would otherwise keep the engine (and its parameters)
        alive past its last reference."""
        params, tv, cfg, stride, eos, sampler, ffn, group = (
            self.params, self._tv, self._lcfg, self.stride, self.eos_id,
            self._sampler, self._ffn, self._tp_group)
        if kind == "spec":
            dparams, gamma = self._draft_params, self.spec_gamma
            return lambda st: spec_tick_body(params, dparams, tv, st, cfg,
                                             gamma, eos, group)
        if not self.paged:
            return lambda st: dense_tick_body(params, tv, st, cfg, stride,
                                              sampler, ffn)
        return lambda st: tick_body(params, tv, st, cfg, stride, eos,
                                    sampler, ffn, group)

    def _capture(self, kind: str, eager_s: float) -> None:
        """Capture the tick body of ``kind`` over the live state (nothing
        runs: the live state is untouched).  ``eager_s`` is the eager run
        before it, which loaded the libraries and sized the kernels'
        scratch."""
        fn, live = self._tick_fn(kind), self._live
        self._graphs[kind], self._graph_stats[kind] = _captured(
            lambda: fn(live), eager_s, self._capture_mode)

    @property
    def _graph(self) -> kernels.Graph | None:
        """The graph of the engine's own tick (the spec tick on a spec
        engine)."""
        return self._graphs.get(self._tick_kinds()[0])

    @property
    def graph_stats(self) -> dict | None:
        """The warmup costs of the engine's own tick graph (see
        :func:`_captured`), or None before its capture."""
        return self._graph_stats.get(self._tick_kinds()[0])

    def _tick_on(self, st: dict, kind: str) -> None:
        self._tick_fn(kind)(st)

    def _run_tick(self, kind: str) -> None:
        """One tick of ``kind`` over the live state: a replay of its
        graph, or the body itself off the graph path.  Without
        :meth:`warmup`, the first tick of a kind runs eagerly and its
        graph is captured after it."""
        graph = self._graphs.get(kind)
        if graph is not None:
            graph.replay()
            return
        t0 = time.perf_counter()
        self._tick_on(self._live, kind)
        if self._use_graph():
            self._capture(kind, time.perf_counter() - t0)

    def _fused_k_now(self) -> int:
        """How many ticks the next dispatch may fuse: K > 1 only in the
        steady state, as in the reference (a queued request would be
        admitted, a pending chunk run, K - 1 ticks late)."""
        if (self.fused_ticks <= 1 or self.queue or self._prefilling
                or not self.slot_req):
            return 1
        return self.fused_ticks

    def _dispatch_tick(self) -> None:
        """Dispatch k ticks for the current slot state (k from
        :meth:`_fused_k_now`; speculative ticks unless the engine has none
        or degraded): upload the tables with each slot's token budget
        (what its request still owes, less a pending first token), run the
        tick k times back to back, and enqueue the copy of the static slab
        (and mass) into the next of the two host buffers
        (:meth:`_stage_out`) for the single host fetch, with the active
        mask (``_spec_active``) and the budgets the dispatch ran on.  The
        slab and the mass are the graph's outputs, rewritten by the next
        dispatch; the host copy is not, so a collect may come after the
        next dispatch (``collect_overlap``).  A dead engine raises; the
        chaos events due at this tick apply first, before anything is
        uploaded, so a failed dispatch is retried from the same state."""
        if self.dead is not None:
            raise ReplicaDeadError(self.dead)
        self._chaos_gate()
        k = self._fused_k_now()
        spec = bool(self.spec_gamma) and not self.spec_degraded
        budget = np.zeros((self.n_slots,), np.int32)
        for slot, req in self.slot_req.items():
            want = req.max_new_tokens - len(req.tokens)
            if slot in self._await_first:
                want -= 1
            budget[slot] = max(want, 0)
        self._upload_tables(budget, k)
        for _ in range(k):
            self._run_tick("spec" if spec else "plain")
        if not self.donate:
            self._rebind_public()
        self._sample_hbm()
        self._inflight, self._inflight_k = self._stage_out(), k
        self._inflight_spec, self._inflight_budget = spec, budget
        self._spec_active = self.active.copy() if spec else None
        if k > 1:
            self.fused_dispatches += 1
            self.fused_ticks_run += k
        self._tick += k

    def _stage_out(self) -> int:
        """Enqueue the copy of the slab (and the mass) the ticks just
        wrote into the next host buffer, then its event; returns the
        buffer's index.  The copy runs after the ticks in stream order,
        so nothing waits here."""
        i = self._slab_turn
        self._slab_turn ^= 1
        self._slab_host[i].copy_(self._slab, non_blocking=True)
        if self._mass_host is not None:
            self._mass_host[i].copy_(self._mass_out, non_blocking=True)
        if self._slab_ready is not None:
            self._slab_ready[i].record()
        return i

    def _read_out(self, i: int) -> np.ndarray:
        """Wait for host buffer ``i``'s copy (its event: the dispatch's
        ticks and the copy, nothing later) and return the slab; the mass,
        if any, becomes ``_mass_pending`` for :meth:`_maybe_evict`."""
        if self._slab_ready is not None:
            self._slab_ready[i].synchronize()
        if self._mass_host is not None:
            self._mass_pending = self._mass_host[i].numpy().copy()
        return self._slab_host[i].numpy().copy()

    def _rebind_public(self) -> None:
        """``donate=False``: rebind the public ``pool`` (or ``cache``)
        leaves to fresh copies of the live state the ticks write in place
        (the graphs keep binding the live buffers).  A handle taken from
        the public dict before a step keeps the values it had; the
        previous copies are released before the new ones are made, so the
        state's bytes peak at two pools (and at a caller's held copies)."""
        name = "pool" if self.paged else "cache"
        setattr(self, name, None)
        setattr(self, name, {n: x.clone()
                             for n, x in self._live[name].items()})

    def _overlap_step(self, t_tick: float) -> list[_Request]:
        """The steady state with ``collect_overlap``: dispatch tick N+1
        on the pre-collect state, then read tick N's host copy while N+1
        runs.  Dispatching before the readout is safe by the engine's
        standing contracts: a slot that finished in tick N runs one
        garbage tick (its writes land in its own pages or trash page 0,
        and the next collect skips its vacated slot), its stale budget
        only lets lanes run longer than needed (the host clamps), and
        admission waits for the next step, so a freed slot is never
        refilled under a stale tick.  If the dispatch kills the engine,
        the unread tick N still holds real tokens: they are consumed and
        what finished goes to the orphans, so a failover never loses
        them."""
        prev = (self._inflight, self._inflight_k, self._inflight_spec,
                self._inflight_budget, self._spec_active)
        try:
            self._dispatch_with_retry()     # tick N+1, before N's readout
        except ReplicaDeadError:
            self._orphans.extend(self._collect_slab(*prev) + self._failed)
            self._failed.clear()
            raise
        self._charge_chip_ticks()
        t0 = time.perf_counter()
        finished = self._collect_slab(*prev)
        dt = self._sync_ms_last
        self.overlap_ms.append(dt)
        if self._metrics is not None:
            self._metrics.observe("serve_collect_overlap_ms", dt)
        finished.extend(self._failed)
        self._failed.clear()
        if self._tracer is not None:
            tick = self._tracer.add_span(
                "engine.tick", t_tick, time.perf_counter(),
                parent=self._engine_anchor,
                attrs={"tick": self._tick - 1, "overlap": True,
                       "spec": prev[2], "fused_k": prev[1],
                       "slots": len(self.slot_req)}).context
            self._tracer.add_span(
                "engine.verify" if self._inflight_spec
                else "engine.dispatch", t_tick, t0, parent=tick)
            self._tracer.add_span(
                "engine.collect", t0, t0 + dt / 1e3, parent=tick,
                attrs={"overlap_ms": round(dt, 3),
                       "finished": len(finished)})
        self._note_host_overhead(t_tick, dt)
        self._watchdog(t_tick, finished)
        for xs in (self.overlap_ms, self.fused_block_ms,
                   self.host_overhead_ms):
            _trim_acct(xs)
        return finished

    @_on_engine_device
    def step(self) -> list[_Request]:
        """One engine tick: collect the previous block, retire finishers,
        expire deadlines, evict cold pages (with an ``evict_policy``),
        admit into freed slots, run one prefill chunk for each prefilling
        slot, dispatch the next block (without waiting for it), and
        account the step (see the class docstring).  With
        ``collect_overlap``, a step in the steady state (nothing queued,
        no chunk prefilling, slots resident) dispatches the next block
        first and collects the previous one after (:meth:`_overlap_step`).
        Returns the requests that finished, then those that failed this
        step (shed, out of retries, past their deadline).  A dead engine
        raises :class:`ReplicaDeadError`; the requests that finished in
        the step that killed it go to ``take_orphans()``."""
        if self.dead is not None:
            raise ReplicaDeadError(self.dead)
        self._step_count += 1
        self._sync_ms_last = 0.0
        t_tick = time.perf_counter()
        if (self.collect_overlap and self._inflight is not None
                and not self.queue and not self._prefilling
                and self.slot_req):
            return self._overlap_step(t_tick)
        finished = self._collect()
        t_col = time.perf_counter() if self._tracer is not None else 0.0
        try:
            self._expire_deadlines(finished)
            t_adm = time.perf_counter()
            self._tick_work = []
            if self.evict_policy is not None:
                self._maybe_evict()
            self._admit()
            if self.paged:
                self._run_prefill_chunks()
            # the host wall of the work decode slots waited behind this tick
            stall = (time.perf_counter() - t_adm) * 1e3
            if self.slot_req:
                t_d0 = time.perf_counter() if self._tracer is not None else 0.0
                self._dispatch_with_retry()
                self._charge_chip_ticks()
                self.stall_ms.append(stall)
                self._tick_log.append({"tick": self._tick - 1,
                                       "work": self._tick_work})
                # a DECODE stall: only ticks where a slot past its prefill
                # with more than one token to make waited count
                if self._metrics is not None and any(
                        s not in self._prefilling
                        and self.slot_req[s].max_new_tokens > 1
                        for s in self.slot_req):
                    self._metrics.observe("serve_decode_stall_ms", stall)
                    self._metrics.observe("serve_decode_stall_work",
                                          float(len(self._tick_work)))
                if self._tracer is not None:
                    self._trace_tick(t_tick, t_col, t_adm, stall, t_d0,
                                     len(finished))
        except ReplicaDeadError:
            # what finished in this step survives the death, for the
            # failover's harvest (a completed request is never replayed)
            self._orphans.extend(finished + self._failed)
            self._failed.clear()
            raise
        finished.extend(self._failed)
        self._failed.clear()
        if self.debug_invariants:
            self.check_page_invariants()
        self._note_host_overhead(t_tick, self._sync_ms_last)
        self._watchdog(t_tick, finished)
        for xs in (self.stall_ms, self.wave_sizes, self.wave_log,
                   self.fused_block_ms, self.host_overhead_ms,
                   self._tick_log):
            _trim_acct(xs)
        return finished

    # -- the request lifecycle: sheds, tiers, preemption, deadlines, cancel

    def _shed(self, req: _Request, why: str,
              reason: str = "pressure") -> None:
        """Fail ONE request instead of letting it block the queue; it comes
        back FAILED from the next ``step()``.  ``reason`` tags the cause in
        ``shed_by_reason``: ``pressure`` (pool or bucket exhaustion),
        ``quota`` (its tenant over quota) or ``deadline`` (pruned from the
        queue before prefill)."""
        req.done = True
        req.error = why
        self.requests_shed += 1
        self.shed_by_reason[reason] = self.shed_by_reason.get(reason, 0) + 1
        if self._metrics is not None:
            self._metrics.inc("serve_requests_shed")
            self._metrics.inc("serve_requests_shed" + f"_{reason}")
            if self._tier_mode:
                self._metrics.inc("serve_requests_shed" + f"_t{req.tier}")
        self._failed.append(req)
        self._finish_request_trace(req)

    def _note_resume(self, req: _Request, slot: int) -> None:
        """A parked (preempted) request re-entered a slot: its replay
        prefill of prompt + accepted tokens is the bit-exact greedy
        resume.  Counted once a park/resume cycle."""
        if not req.resuming:
            return
        req.resuming = False
        self.requests_resumed += 1
        if self._metrics is not None:
            self._metrics.inc("serve_requests_resumed")
        if self._tracer is not None:
            self._tracer.instant(
                "request.resume", self._req_spans.get(req.rid),
                attrs={"rid": req.rid, "slot": slot, "tier": req.tier,
                       "preemptions": req.preemptions})

    def _sort_queue(self) -> None:
        """Tier-strict, EDF-within-tier admission order: sort the queue by
        (tier, deadline_tick, seq).  Requests without a tick deadline sort
        after those with one, in enqueue order, so an untiered engine's
        schedule stays FIFO; the wall-clock ``deadline_s`` never orders
        anything (wall time must not drive the schedule)."""
        if len(self.queue) > 1:
            self.queue = _AdmissionQueue(sorted(
                self.queue,
                key=lambda e: (e[0].tier,
                               e[0].deadline_tick
                               if e[0].deadline_tick is not None
                               else float("inf"),
                               e[0].seq)))

    def _requeue_host(self, req: _Request, what: str) -> bool:
        """Put ``req`` back on the queue as prompt + accepted tokens, the
        re-admission shared by quarantine replays and preemption (both
        resume through the same bit-exact greedy path).  False = the
        grown prompt fits no bucket: the request is shed instead."""
        replay = (np.concatenate([req.prompt,
                                  np.asarray(req.tokens, np.int64)])
                  if req.tokens else req.prompt)
        t = int(replay.shape[0])
        if t > self.prompt_buckets[-1]:
            self._shed(req, f"{what} prompt {t} exceeds largest "
                       f"bucket {self.prompt_buckets[-1]}")
            return False
        self._enqueue(req, replay)
        return True

    def _preempt_slot(self, slot: int, req: _Request) -> None:
        """Park a lower-priority DECODING request on the host so its slot
        and pages serve a more critical admission: release them and
        requeue prompt + accepted tokens.  The resume is the standing
        bit-exact greedy replay, so a preempted request's tokens equal an
        unpreempted run's; it spends no retry (being outranked is policy,
        not a fault), and it waits one step, so it never bounces straight
        back into the slot it left ahead of the request it left it for."""
        self.requests_preempted += 1
        req.preemptions += 1
        if self._metrics is not None:
            self._metrics.inc("serve_requests_preempted")
            self._metrics.inc("serve_requests_preempted" + f"_t{req.tier}")
        if self._tracer is not None:
            self._tracer.instant(
                "request.preempt", self._req_spans.get(req.rid),
                attrs={"rid": req.rid, "slot": slot, "tier": req.tier,
                       "tokens": len(req.tokens)})
        self._vacate(slot)
        req.resuming = True
        req.not_before_tick = max(req.not_before_tick, self._step_count + 1)
        self._requeue_host(req, "parked")

    def _maybe_preempt(self, req0: _Request, need_pages: int,
                       need_slot: bool) -> list[int]:
        """Free capacity for ``req0`` by preempting strictly lower-tier
        decoding slots (lowest tier first, newest first within a tier).
        Victims are greedy (a sampled resume is not bit-exact), past
        their chunked prefill and their first token, not a migrate-out
        leg, and replayable (the
        grown prompt still fits the largest bucket).  Returns the freed
        slots; none when no victim qualifies or all of them could not
        free enough pages (then nobody is parked in vain)."""
        victims = sorted(
            ((s, r) for s, r in self.slot_req.items()
             if r.tier > req0.tier and not r.done
             and s not in self._prefilling
             and s not in self._await_first
             and r.temperature == 0.0
             and r.rid not in self._migrate_out
             and int(r.prompt.shape[0]) + len(r.tokens)
             <= self.prompt_buckets[-1]),
            key=lambda sr: (-sr[1].tier, -sr[1].seq))
        if not victims:
            return []
        if self.paged and need_pages > self._available_pages() + sum(
                sum(1 for p in self._slot_pages.get(s, ()) if p)
                for s, _ in victims):
            return []
        freed: list[int] = []
        for s, r in victims:
            fits = not self.paged or need_pages <= self._available_pages()
            if fits and (freed or not need_slot):
                break
            self._preempt_slot(s, r)
            freed.append(s)
        return freed

    def _cancel_req(self, req: _Request, why: str) -> None:
        """Remove a request from wherever it is (queue, slot, chunked
        prefill) and mark it failed with its partial tokens."""
        req.done = True
        req.error = why
        self._finish_request_trace(req)
        self._dequeue(req.rid)
        for slot, r in list(self.slot_req.items()):
            if r.rid == req.rid:
                self._vacate(slot)
                break

    def _dequeue(self, rid: int) -> None:
        """Drop request ``rid`` from the admission queue, if it is there."""
        for i, (r, _) in enumerate(self.queue):
            if r.rid == rid:
                del self.queue[i]
                return

    def cancel(self, rid: int, reason: str = "canceled"):
        """Cancel a queued or resident request.  Returns it (done,
        ``error`` set, partial tokens kept), here and not from a later
        ``step()``; None for an unknown or finished rid."""
        for r in [r for r, _ in self.queue] + list(self.slot_req.values()):
            if r.rid == rid:
                self._cancel_req(r, reason)
                return r
        return None

    def _expire_deadlines(self, finished: list) -> None:
        """Fail the requests whose deadline (``deadline_s`` or
        ``deadline_ticks``) passed; they come back from this step.  It runs
        before admission, so a QUEUED expiry is pruned before any prefill
        (a ``deadline`` shed), while a resident one is cancelled mid-decode
        with its partial tokens."""
        reqs = [r for r, _ in self.queue] + list(self.slot_req.values())
        if not any(r.deadline is not None or r.deadline_tick is not None
                   for r in reqs):
            return
        now = self._clock()

        def expired(r: _Request) -> bool:
            return ((r.deadline is not None and now > r.deadline)
                    or (r.deadline_tick is not None
                        and self._step_count > r.deadline_tick))

        for req, _ in [e for e in self.queue if expired(e[0])]:
            self._note_deadline_miss(req)
            self._dequeue(req.rid)
            self._shed(req, "deadline exceeded", reason="deadline")
        for req in [r for r in self.slot_req.values() if expired(r)]:
            self._note_deadline_miss(req)
            self._cancel_req(req, "deadline exceeded")
            finished.append(req)

    def _note_deadline_miss(self, req: _Request) -> None:
        self.deadline_misses += 1
        if self._metrics is not None:
            self._metrics.inc("serve_deadline_miss")
            if self._tier_mode:
                self._metrics.inc("serve_deadline_miss" + f"_t{req.tier}")

    # -- self-defense: chaos, quarantine and replay, the watchdog -----------

    def _die(self, reason: str) -> None:
        """Mark the engine dead and raise; every later ``step()`` raises
        again.  The host-side request state stays for a failover."""
        self.dead = reason
        if self._metrics is not None:
            self._metrics.inc("serve_replica_deaths")
        raise ReplicaDeadError(reason)

    def _chaos_gate(self) -> None:
        """Apply every chaos event due at this tick, before the dispatch
        touches any state (so a failed dispatch retries the same call)."""
        if self.chaos is None:
            return
        due = self.chaos.take(self._tick)
        for i, ev in enumerate(due):
            if ev.kind == "kill_replica":
                self._die(f"chaos: replica killed at tick {self._tick}")
            elif ev.kind == "stall_tick":
                time.sleep(ev.stall_s)
            elif ev.kind == "nan_logits":
                if not self._poison_one_slot():
                    self.chaos.defer(ev, self._tick + 1)
            elif ev.kind == "fail_dispatch":
                for rest in due[i + 1:]:
                    self.chaos.defer(rest, self._tick)
                raise DispatchFailure(
                    f"chaos: dispatch failed at tick {self._tick}")

    def poison_slot(self, slot: int) -> None:
        """Chaos hook: NaN one slot's K/V history.  Paged: its first decode
        page (never prefix-registered, so no other request can alias the
        poison), in ``k`` or, for int8 and int4 pages, ``k_scale``; dense:
        its cache row.  That slot's next logits go non-finite while its
        neighbours stay exact."""
        if self.paged:
            pool = self._live["pool"]
            pid = int(self._pt[slot, int(self._tpad[slot]) // self.page_size])
            leaf = "k_scale" if "k_scale" in pool else "k"
            pool[leaf][:, pid] = float("nan")
        else:
            self._live["cache"]["k"][:, slot] = float("nan")

    def _poison_one_slot(self) -> bool:
        """Poison the lowest eligible slot (active and, paged, past its
        first decode flush, so the paged kernel reads the poisoned page);
        False defers the event to the next tick."""
        pos = self.pos.cpu().numpy() if self.paged else None
        for slot in sorted(self.slot_req):
            if slot in self._prefilling or not self.active[slot]:
                continue
            if self.paged and int(pos[slot]) - int(self._tvec[slot]) < 1:
                continue
            self.poison_slot(slot)
            return True
        return False

    def _backoff_ticks(self, req: _Request) -> int:
        """Exponential backoff in steps with a deterministic jitter a
        (rid, attempt), the reference's, so replays spread out."""
        base = min(1 << (req.retries - 1), 8)
        j = int(np.random.default_rng(
            abs(hash((self._jseed, req.rid, req.retries)))
        ).integers(0, base + 1))
        return base + j

    def _replay(self, req: _Request, why: str) -> None:
        """Re-admit a faulted request as its prompt + accepted tokens with
        what it still owes: a greedy replay is bit-exact (the accepted
        prefix conditions the same continuation), and with the prefix
        cache the original prompt's registered pages make its prefill
        mostly aliasing.  At most ``max_retries`` times, after a jittered
        backoff; an unfittable replay is shed."""
        req.retries += 1
        if req.retries > self.max_retries:
            req.done = True
            req.error = f"failed after {req.retries - 1} retries: {why}"
            self._failed.append(req)
            self._finish_request_trace(req)
            return
        if self._tracer is not None:
            self._tracer.instant(
                "request.replay", self._req_spans.get(req.rid),
                attrs={"rid": req.rid, "retries": req.retries, "why": why})
        req.not_before_tick = self._step_count + self._backoff_ticks(req)
        if self._requeue_host(req, "replay"):
            self.requests_retried += 1
            if self._metrics is not None:
                self._metrics.inc("serve_requests_retried")

    def _quarantine(self, slot: int, req: _Request) -> None:
        """Non-finite logits: pull the slot out of the batch (its rows
        never mixed with its neighbours'), drop the poisoned tick's
        tokens, release its pages and replay the request from its last
        good token."""
        self.slots_quarantined += 1
        if self._metrics is not None:
            self._metrics.inc("serve_slots_quarantined")
        if self._tracer is not None:
            self._tracer.instant(
                "request.quarantine", self._req_spans.get(req.rid),
                attrs={"rid": req.rid, "slot": slot})
        self._vacate(slot)
        self._replay(req, "non-finite logits quarantined")

    def take_orphans(self) -> list[_Request]:
        """The requests that FINISHED in the step that killed this engine,
        so a failover never replays a completed request."""
        out, self._orphans = self._orphans, []
        return out

    def _watchdog(self, t0: float, finished: list) -> None:
        """A step whose wall passed ``tick_deadline_s`` declares the engine
        stalled (after the fact: a hung sync cannot be interrupted from
        its own thread); the policy is failover, not waiting."""
        if self.tick_deadline_s is None or self.dead is not None:
            return
        dt = time.perf_counter() - t0
        if self._tp_group is not None:
            # rank 0's wall decides for every rank
            dt = broadcast_float(dt, self._tp_group)
        if dt > self.tick_deadline_s:
            self._orphans.extend(finished)
            self.dead = (f"watchdog: tick {self._tick - 1} took "
                         f"{dt * 1e3:.0f} ms > deadline "
                         f"{self.tick_deadline_s * 1e3:.0f} ms")
            if self._metrics is not None:
                self._metrics.inc("serve_tick_stalls")
            raise TickStallError(self.dead)

    def _dispatch_with_retry(self) -> None:
        """Retry a dispatch that failed transiently, in place (the chaos
        gate raises before the dispatch touches state); three failures in
        a row kill the engine."""
        for _ in range(3):
            try:
                return self._dispatch_tick()
            except DispatchFailure:
                self.dispatch_failures += 1
                if self._metrics is not None:
                    self._metrics.inc("serve_dispatch_failures")
        self._die("dispatch failed 3 times in a row")

    def _charge_chip_ticks(self) -> None:
        """Charge the dispatch that just went out (``_inflight_k`` device
        ticks on each of the engine's ``tp`` devices) to the resident
        slots, pro rata by work units: a prefilling slot weighs the prompt
        tokens it prefilled this tick, a decoding slot one unit; each
        charge goes to the request's (tenant, tier)."""
        self.busy_ticks += self._inflight_k
        entries = [(req.tenant, req.tier,
                    self._tick_prefill_tokens.get(slot, 0) or 1)
                   for slot, req in sorted(self.slot_req.items())]
        self.cost.charge(entries, self.tp * self._inflight_k)
        self._tick_prefill_tokens.clear()

    def _note_host_overhead(self, t_tick: float, sync_ms: float) -> None:
        """This step's wall less its readout's: the host work a fused
        dispatch amortizes over K ticks."""
        wall = (time.perf_counter() - t_tick) * 1e3
        overhead = max(wall - min(sync_ms, wall), 0.0)
        self.host_overhead_ms.append(overhead)
        if self._metrics is not None and wall > 0:
            self._metrics.set_gauge("serve_host_overhead_pct",
                                    round(100.0 * overhead / wall, 3))

    def _state_bytes(self) -> tuple[int, int]:
        """(pool or cache leaves' bytes, slot vectors' bytes) of the
        engine's state; with ``donate=False`` the leaves count twice, the
        live ones and the public copies :meth:`_rebind_public` made."""
        name = "pool" if self.paged else "cache"
        store = self._live[name]
        leaves = sum(x.numel() * x.element_size() for x in store.values())
        if getattr(self, name) is not store:
            leaves *= 2
        mirrors = sum(x.numel() * x.element_size()
                      for x in (self.first_toks, self.tokens, self.pos,
                                self.temps))
        return leaves, mirrors

    def _sample_hbm(self) -> None:
        self.hbm.sample(sum(self._state_bytes()))

    @property
    def hbm_pool_bytes(self) -> int:
        """Live state bytes at the most recent dispatch (``serve_hbm_pool
        _bytes``): the pool or cache leaves plus the slot vectors, 1x the
        state, the leaves twice with ``donate=False`` (0 before the first
        dispatch)."""
        return self.hbm.live

    @property
    def hbm_peak_bytes(self) -> int:
        """Peak of :attr:`hbm_pool_bytes` over the engine's lifetime
        (``serve_hbm_peak_bytes``)."""
        return self.hbm.peak

    def note_kv_quality(self, delta: float) -> None:
        """Record the measured KV-compression quality delta (the fraction
        of greedy tokens that diverge from a bf16 engine's over the same
        traffic; a harness measures it, the engine reports it)."""
        self.kv_quality_delta = float(delta)
        if self._metrics is not None:
            self._metrics.set_gauge("serve_kv_quality_delta",
                                    round(float(delta), 6))

    # -- request tracing and metrics (the callers of the first two check
    # ``self._tracer is not None or self._metrics is not None``)

    def _trace_admit(self, req: _Request, slot: int, how: str) -> None:
        """Queue wait ends here: the request owns a slot.  Observes
        ``serve_queue_wait_ms`` and its tick twin ``serve_queue_wait_ticks``
        (per tier too in tier mode)."""
        now = time.perf_counter()
        t_sub = self._submit_ts.get(req.rid)
        wait_ms = (now - t_sub) * 1e3 if t_sub is not None else None
        if self._metrics is not None and wait_ms is not None:
            wait_ticks = float(self._tick - req.submit_tick)
            self._metrics.observe("serve_queue_wait_ms", wait_ms)
            self._metrics.observe("serve_queue_wait_ticks", wait_ticks)
            if self._tier_mode:
                self._metrics.observe(
                    "serve_queue_wait_ticks" + f"_t{req.tier}", wait_ticks)
        if self._tracer is None:
            return
        sp = self._req_spans.get(req.rid)
        if sp is not None and wait_ms is not None:
            sp.set_attr("queue_wait_ms", round(wait_ms, 3))
        self._tracer.instant(
            "request.admit", sp, attrs={"rid": req.rid, "slot": slot,
                                        "how": how})

    def _trace_first_token(self, req: _Request) -> None:
        """TTFT: the first generated token consumed on the host (once: a
        replayed request keeps its first stamp); ``serve_ttft_ms`` and
        ``serve_ttft_ticks``."""
        if req.first_tick < 0:
            req.first_tick = self._tick
        if req.rid in self._first_tok_ts:
            return
        now = time.perf_counter()
        self._first_tok_ts[req.rid] = now
        t_sub = self._submit_ts.get(req.rid)
        if t_sub is None:
            return
        ttft = (now - t_sub) * 1e3
        if self._metrics is not None:
            self._metrics.observe("serve_ttft_ms", ttft)
            self._metrics.observe("serve_ttft_ticks",
                                  float(self._tick - req.submit_tick))
        sp = self._req_spans.get(req.rid)
        if sp is not None:
            sp.set_attr("ttft_ms", round(ttft, 3))

    def _finish_request_trace(self, req: _Request) -> None:
        """A request reached a terminal state (retired, shed, cancelled,
        failed): stamp its finish tick, free its tenant's quota slot, and
        close its span with its token count, per-output-token time and
        error.  Pops its state, so a second call does nothing."""
        if req.finish_tick < 0:
            req.finish_tick = self._tick
        ten = self._rid_tenant.pop(req.rid, None)
        if ten is not None:
            left = self._tenant_load.get(ten, 1) - 1
            if left > 0:
                self._tenant_load[ten] = left
            else:
                self._tenant_load.pop(ten, None)
        t_first = self._first_tok_ts.pop(req.rid, None)
        self._submit_ts.pop(req.rid, None)
        sp = self._req_spans.pop(req.rid, None)
        if sp is None and (self._metrics is None or t_first is None):
            return
        now = time.perf_counter()
        tok_ms = None
        if t_first is not None and len(req.tokens) > 1:
            tok_ms = (now - t_first) * 1e3 / (len(req.tokens) - 1)
            if self._metrics is not None:
                self._metrics.observe("serve_token_ms", tok_ms)
        if sp is None:
            return
        sp.set_attr("tokens", len(req.tokens))
        if tok_ms is not None:
            sp.set_attr("token_ms", round(tok_ms, 4))
        if req.error is not None:
            sp.set_attr("error", req.error)
        sp.end(now)

    def _trace_tick(self, t_tick: float, t_col: float, t_adm: float,
                    stall: float, t_d0: float, n_finished: int) -> None:
        """One ``engine.tick`` span a dispatching step, with its collect,
        admit and dispatch (or verify) children, built from the phase
        timestamps the step takes anyway."""
        tr = self._tracer
        now = time.perf_counter()
        tick = tr.add_span(
            "engine.tick", t_tick, now, parent=self._engine_anchor,
            attrs={"tick": self._tick - 1, "spec": self._inflight_spec,
                   "fused_k": self._inflight_k,
                   "slots": len(self.slot_req)}).context
        tr.add_span("engine.collect", t_tick, t_col, parent=tick,
                    attrs={"finished": n_finished})
        tr.add_span("engine.admit", t_adm, t_adm + stall / 1e3,
                    parent=tick, attrs={"work": len(self._tick_work)})
        tr.add_span("engine.verify" if self._inflight_spec
                    else "engine.dispatch", t_d0, now, parent=tick)

    def _collect(self) -> list[_Request]:
        """Collect the dispatch in flight, if any (:meth:`_collect_slab`)."""
        if self._inflight is None:
            return []
        finished = self._collect_slab(
            self._inflight, self._inflight_k, self._inflight_spec,
            self._inflight_budget, self._spec_active)
        self._inflight = None
        self._spec_active = None
        return finished

    def _collect_slab(self, i: int, k: int, spec: bool, budget,
                      spec_active) -> list[_Request]:
        """Read host buffer ``i`` (THE host sync: its event) and consume
        the ``k`` ticks it holds with the dispatch's own ``spec``,
        ``budget`` and ``spec_active``.  Slots imported after that
        dispatch sat it out."""
        t0 = time.perf_counter()
        fused = self._read_out(i)
        self._sync_ms_last = (time.perf_counter() - t0) * 1e3
        if k > 1:
            self.fused_block_ms.append(self._sync_ms_last)
            if self._metrics is not None:
                self._metrics.observe("serve_fused_block_ms",
                                      self._sync_ms_last)
        finished = self._consume(fused, k, spec, spec_active, budget)
        self._imported.clear()
        return finished

    def _check_eos(self, req: _Request) -> bool:
        """Trim ``req.tokens`` at its first EOS; True = finished."""
        return truncate_at_eos(req.tokens, self.eos_id)

    def _consume(self, fused: np.ndarray, k: int, spec: bool = False,
                 spec_active: np.ndarray | None = None,
                 budget: np.ndarray | None = None) -> list[_Request]:
        """Account one fetched slab of ``k`` ticks (its plain or, with
        ``spec``, its spec layout: :meth:`_slab_views`,
        :meth:`_spec_slab_views`), replaying the device's lane freeze as
        the reference's ``_consume_fused`` does: a slot stops consuming
        the tick its request is satisfied or its tokens hold the EOS,
        before it looks at any later bad flag (K single ticks would have
        retired it first), and is quarantined at its first bad tick, its
        tokens from that tick on discarded (:meth:`_quarantine`).  A
        speculative tick lands ``take + 1`` tokens of a slot that was
        active at dispatch; its statistics are replayed by
        :meth:`_spec_stats`."""
        finished: list[_Request] = []
        slab = torch.from_numpy(fused)
        out = (self._spec_slab_views if spec else self._slab_views)(slab)
        bad_np, firsts_np = out["bads"].numpy(), out["firsts"].numpy()
        if spec:
            emit_np, take_np = out["emit"].numpy(), out["take"].numpy()
            self.slot_steps += k * (self.spec_gamma + 1) * self.n_slots
            self.spec_ticks += k
            self._spec_stats(k, emit_np, take_np, out["matched"].numpy(),
                             bad_np, spec_active, budget)
        else:
            block_np = out["blocks"].numpy()
            self.slot_steps += k * self.stride * self.n_slots
        if k > 1:
            self.fused_stalls += int((out["stall"].numpy() != 0).sum())
        for slot, req in list(self.slot_req.items()):
            if slot in self._prefilling or slot in self._imported:
                continue    # chunk-prefilling, or imported after dispatch
            if slot in self._await_first:
                req.tokens.append(int(firsts_np[slot]))
                self._await_first.discard(slot)
                if self._tracer is not None or self._metrics is not None:
                    self._trace_first_token(req)
                if self._check_eos(req):
                    self._retire(slot, req, finished)
                    continue
            if req.done:   # single-token request: retires without decode
                self._retire(slot, req, finished)
                continue
            quarantined = hit_eos = False
            for kk in range(k):
                want = req.max_new_tokens - len(req.tokens)
                if want <= 0:
                    break
                if bad_np[kk, slot]:
                    self._quarantine(slot, req)
                    quarantined = True
                    break
                if spec:
                    avail = int(take_np[kk, slot]) + 1 \
                        if spec_active[slot] else 0
                    take = min(avail, want)
                    req.tokens.extend(int(x) for x in emit_np[kk, slot, :take])
                else:
                    take = min(self.stride, want)
                    req.tokens.extend(int(x) for x in block_np[kk, :take, slot])
                self.emitted_tokens += take
                self._decode_tokens += take
                if self._check_eos(req):
                    hit_eos = True
                    break
            if quarantined:
                continue
            if hit_eos or len(req.tokens) >= req.max_new_tokens:
                self._retire(slot, req, finished)
        return finished

    def _spec_stats(self, k: int, emit_np: np.ndarray, take_np: np.ndarray,
                    matched_np: np.ndarray, bad_np: np.ndarray,
                    spec_active: np.ndarray, budget: np.ndarray) -> None:
        """Speculative accounting of a fetched block (the reference's
        ``_spec_stats_fused``; K = 1 is its plain tick's): replay the
        device's per-tick active mask (budget, EOS and bad-flag freezes)
        so the acceptance EMA, the draft counters and the degrade streak
        see exactly the ticks each slot drafted.  The caps adapt once per
        block (the device held them fixed across it)."""
        if spec_active is None or not spec_active.any():
            return
        g = self.spec_gamma
        emitted = np.zeros((self.n_slots,), np.int64)
        dead = np.zeros((self.n_slots,), bool)
        for kk in range(k):
            act = spec_active & (emitted < budget) & ~dead
            if act.any():
                self.spec_drafts_proposed += g * int(act.sum())
                self.spec_drafts_accepted += int(take_np[kk][act].sum())
                frac = matched_np[kk][act] / g
                self._accept_ema[act] = (0.7 * self._accept_ema[act]
                                         + 0.3 * frac)
                if self._metrics is not None:
                    for f_ in frac:
                        self._metrics.observe("serve_spec_accept",
                                              float(f_))
                    for t_ in take_np[kk][act]:
                        self._metrics.observe("serve_spec_tokens_per_tick",
                                              float(t_) + 1.0)
                if (self.spec_degrade_after is not None
                        and not self.spec_degraded):
                    if int(matched_np[kk][act].sum()) == 0:
                        self._spec_reject_streak += 1
                    else:
                        self._spec_reject_streak = 0
                    if self._spec_reject_streak >= self.spec_degrade_after:
                        self.spec_degraded = True
                        if self._metrics is not None:
                            self._metrics.inc("serve_spec_degraded")
            if self.eos_id is not None:
                hit = ((emit_np[kk] == self.eos_id)
                       & (np.arange(g + 1)[None, :]
                          <= take_np[kk][:, None])).any(axis=1)
                dead |= act & hit
            emitted += np.where(act, take_np[kk] + 1, 0)
            dead |= bad_np[kk] != 0
        if self.spec_adaptive:
            self._gcap = _gamma_from_accept(self._accept_ema, g)

    def _retire(self, slot: int, req: _Request,
                finished: list[_Request]) -> None:
        if (req.rid in self._migrate_out and req.error is None
                and req.tokens):
            # before the pages return: the gather must read this request's
            # bytes, not a later owner's
            self._export_chain_slot(slot, req)
        self._migrate_out.discard(req.rid)
        req.done = True
        finished.append(req)
        self._finish_request_trace(req)
        self._vacate(slot)

    def _vacate(self, slot: int) -> None:
        """Free ``slot`` for the next admission: drop its request and
        chunk-prefill state, release its pages, and reset its draft depth
        (the next occupant starts optimistic, at full γ)."""
        del self.slot_req[slot]
        self.active[slot] = False
        self._prefilling.pop(slot, None)
        self._await_first.discard(slot)
        self._imported.discard(slot)
        self._release_pages(slot)
        if self.spec_gamma:
            self._accept_ema[slot] = 1.0
            self._gcap[slot] = self.spec_gamma

    # -- page-chain migration (disaggregated serving) -------------------

    def _export_chain_slot(self, slot: int, req: _Request) -> None:
        """Gather the retiring request's page chain, the page-aligned
        prompt region ``[0, tpad)`` (under the prefill leg's
        ``max_new_tokens == 1`` nothing was flushed past it), into host
        tensors and keep it for :meth:`take_export` with its digest, the
        prompt, its prefix keys and the first token.  The export lives on
        the host, so it survives this engine's death.  Under a mesh each
        rank gathers its ``Hkv / tp`` heads of the chain and the ranks
        all-gather them along the KV-head dim the pool is cut on
        (``pool_specs``), so every rank exports the full-head chain, digest
        and all, as one engine would."""
        n_chain = int(self._tpad[slot]) // self.page_size
        ids = torch.from_numpy(self._pt[slot, :n_chain].astype(np.int64))
        local = gather_pages(self._live["pool"], ids.to(self.device))
        if self._tp_group is not None:
            local = {name: all_gather_dim(leaf, 2, self._tp_group)
                     for name, leaf in local.items()}
        chain = {name: leaf.cpu() for name, leaf in local.items()}
        t = int(self._tvec[slot])
        self._exports[req.rid] = {
            "rid": req.rid, "t": t, "tpad": int(self._tpad[slot]),
            "pages": n_chain, "page_size": self.page_size,
            "prefix_keys": tuple(req.prefix_keys),
            "first_token": int(req.tokens[0]), "prompt": req.prompt,
            "chain": chain, "digest": _chain_digest(chain, t),
        }
        self.chains_exported += 1
        self.pages_migrated_out += n_chain

    def take_export(self, rid: int) -> dict | None:
        """Pop one finished export, exactly once (a second call returns
        None); callable on a dead engine (the exports are host state)."""
        return self._exports.pop(rid, None)

    def take_exports(self) -> dict[int, dict]:
        """Pop every finished export at once."""
        out, self._exports = self._exports, {}
        return out

    @_on_engine_device
    def import_chain(self, export: dict, max_new_tokens: int,
                     temperature: float = 0.0, tier: int = 0,
                     tenant: str = "") -> int | None:
        """Adopt a migrated page chain: verify its digest, allocate pages,
        upload and scatter the chain into them (eagerly, outside any graph
        replay, synchronized before the pages are registered), activate a
        slot mid-decode with the export's first token, and register the
        prompt pages in the prefix registry, so later shared-prefix
        requests alias them.  ``max_new_tokens`` is this leg's whole
        budget, the first token included.  Returns the local rid, or None
        when no slot or pages are free now (the caller retries later).
        Raises ``ValueError`` for a dense engine, a budget below 2, a
        sampled request on a greedy engine, another page size, a digest
        mismatch, or a request that exceeds ``max_len`` or the pool, and
        :class:`ReplicaDeadError` on a dead engine.  Under a mesh the
        digest is checked on the full-head chain and each rank scatters its
        own heads, cut as ``pool_specs`` cuts the pool."""
        if not self.paged:
            raise ValueError("import_chain needs the paged pool")
        if self.dead is not None:
            raise ReplicaDeadError(f"replica dead: {self.dead}")
        if max_new_tokens < 2:
            raise ValueError(
                "import_chain needs max_new_tokens >= 2 — a satisfied "
                "request retires at its prefill replica")
        if temperature > 0 and not self.sampling:
            raise ValueError(
                "temperature > 0 needs a sampling-enabled engine")
        if int(export["page_size"]) != self.page_size:
            raise ValueError(
                f"page-size mismatch: chain {export['page_size']} vs "
                f"pool {self.page_size}")
        chain = export["chain"]
        t = int(export["t"])
        if _chain_digest(chain, t) != export["digest"]:
            raise ValueError(
                "chain digest mismatch — torn or corrupted transfer")
        bucket = int(export["tpad"])
        n_chain = int(export["pages"])
        overhang = max(self.stride, self.spec_gamma + 1
                       if self.spec_gamma else 0)
        if t + max_new_tokens + overhang > self.max_len:
            raise ValueError(
                f"prompt {t} + max_new {max_new_tokens} + overhang "
                f"{overhang} > max_len {self.max_len}")
        need = self._pages_needed(max_new_tokens, bucket)
        if need > self.total_pages:
            raise ValueError(
                f"import needs {need} pages but the pool has only "
                f"{self.total_pages}")
        slot = next((s for s in range(self.n_slots)
                     if s not in self.slot_req), None)
        if slot is None or self._available_pages() < need:
            return None
        req = _Request(rid=self._next_rid, prompt_len=t,
                       max_new_tokens=max_new_tokens,
                       temperature=float(temperature),
                       prefix_keys=tuple(export["prefix_keys"]),
                       prompt=np.asarray(export["prompt"], np.int64),
                       admit_len=t, tier=int(tier), tenant=str(tenant))
        self._next_rid += 1
        req.submit_tick = self._tick
        req.seq = self._seq
        self._seq += 1
        if tier > 0:
            self._tier_mode = True
        req.tokens = [int(export["first_token"])]
        pages = self._alloc_pages(need)
        self._slot_pages[slot] = pages
        self._pt[slot, :] = 0
        self._pt[slot, :need] = pages
        self._tvec[slot] = t
        self._tpad[slot] = bucket
        self._cap[slot] = decode_capacity(need, bucket, self.page_size)
        dev = self.device
        if self._tp_group is not None:
            # (kubegpu_tpu_torch.parallel imports the models package)
            from kubegpu_tpu_torch.parallel.sharding import (
                pool_specs,
                shard_tree,
            )
            chain = shard_tree(chain, pool_specs(chain), self.tp_rank,
                               self.tp)
        scatter_pages(self._live["pool"],
                      {name: leaf.to(dev) for name, leaf in chain.items()},
                      torch.tensor(pages[:n_chain], device=dev))
        activate_slot(self.first_toks, self.tokens, self.pos, slot,
                      torch.full((1,), req.tokens[0], dtype=torch.long,
                                 device=dev), t, self.temps,
                      req.temperature if self.sampling else None)
        self._sync()
        self._sample_hbm()
        self.slot_req[slot] = req
        self._register_prefix(req, pages)
        # the first token was consumed (and its TTFT stamped) at the
        # prefill replica: the slot awaits no first token, and a block in
        # flight was dispatched without it (the reference consumes that
        # block's column for the slot: ROADMAP.md queue 3)
        self.active[slot] = True
        if self._inflight is not None:
            self._imported.add(slot)
        if self.spec_gamma:
            self._accept_ema[slot] = 1.0
            self._gcap[slot] = self.spec_gamma
        self.chains_imported += 1
        self.pages_migrated_in += n_chain
        return req.rid

    @property
    def spec_acceptance_rate(self) -> float:
        """Accepted draft tokens per proposal, over every verify tick's
        active slots (0.0 on an engine that never drafted)."""
        return (self.spec_drafts_accepted / self.spec_drafts_proposed
                if self.spec_drafts_proposed else 0.0)

    @property
    def spec_tokens_per_tick(self) -> float:
        """Mean tokens a slot banks a verify tick (accepted drafts + the
        correction); 0.0 on an engine that never drafted."""
        if not self.spec_drafts_proposed:
            return 0.0
        ticks_slots = self.spec_drafts_proposed / self.spec_gamma
        return 1.0 + self.spec_drafts_accepted / ticks_slots

    def _maybe_evict(self) -> None:
        """Drop cold PROMPT pages from decoding slots.

        ``window``: a prompt page wholly below the trailing
        ``evict_param``-token window of the prompt is dropped; ``mass``:
        pages whose EMA (0.8 / 0.2 per tick) of the paged kernel's
        attention mass fell below ``evict_param``, coldest first.  A
        dropped page goes back to the free list and its table entry
        becomes a page-id-0 HOLE the kernels skip; positions keep their
        rope phases.

        Rails: never row-local page 0 (the attention sink), never a page
        whose refcount is not 1 (an aliased prefix is another slot's live
        context), never a prefix-registered page, never a slot that is
        still prefilling, awaits its first token, exports a migration
        chain at retirement (``_migrate_out``) or is inactive, and at
        least two real prompt pages stay."""
        if self.evict_policy == "mass" and self._mass_pending is not None:
            # the collected block's mass, read with its slab
            mass = self._mass_pending
            self._mass_pending = None
            live = self.active & np.isfinite(mass).all(axis=1)
            self._page_mass[live] = (0.8 * self._page_mass[live]
                                     + 0.2 * mass[live])
        p = self.page_size
        for slot, req in list(self.slot_req.items()):
            if (slot in self._prefilling or slot in self._await_first
                    or req.rid in self._migrate_out
                    or not self.active[slot]):
                continue
            n_prompt = int(self._tpad[slot]) // p
            if n_prompt <= 2:
                continue
            row = self._pt[slot]
            live_idx = [pi for pi in range(n_prompt) if row[pi] != 0]
            if self.evict_policy == "window":
                horizon = int(self._tvec[slot]) - int(self.evict_param)
                cand = [pi for pi in live_idx
                        if pi >= 1 and (pi + 1) * p <= horizon]
            else:
                cand = sorted(
                    (pi for pi in live_idx
                     if pi >= 1
                     and self._page_mass[slot, pi] < self.evict_param),
                    key=lambda pi: self._page_mass[slot, pi])
            remaining = len(live_idx)
            for pi in cand:
                if remaining <= 2:
                    break
                page = int(row[pi])
                if (self._page_refs.get(page, 0) != 1
                        or page in self._page_key):
                    continue    # shared or prefix-registered: keep
                self._pt[slot, pi] = 0
                self._slot_pages[slot][pi] = 0
                del self._page_refs[page]
                self._free_pages.append(page)
                self._page_mass[slot, pi] = 0.0
                self.pages_evicted += 1
                remaining -= 1
                if self._metrics is not None:
                    self._metrics.inc("serve_pages_evicted_total")

    def drain(self, max_ticks: int = 10_000) -> list[_Request]:
        """Run until queue and slots are empty; returns every finished
        (and failed) request in completion order.  Work left after
        ``max_ticks`` raises an error naming every stuck slot and queued
        request (:meth:`_drain_diagnosis`)."""
        out: list[_Request] = []
        for _ in range(max_ticks):
            if not self.queue and not self.slot_req:
                return out
            out.extend(self.step())
        raise RuntimeError(
            f"drain did not converge after {max_ticks} ticks; "
            f"stuck work: {self._drain_diagnosis()}")

    def _drain_diagnosis(self) -> str:
        """Who is stuck and why: the payload ``drain()`` raises with."""
        parts = []
        for slot in sorted(self.slot_req):
            req = self.slot_req[slot]
            state = ("prefilling" if slot in self._prefilling
                     else "active" if self.active[slot] else "inactive")
            parts.append(
                f"slot {slot}: rid={req.rid} {state} "
                f"tokens={len(req.tokens)}/{req.max_new_tokens} "
                f"retries={req.retries}")
        for req, _ in self.queue:
            parts.append(
                f"queued rid={req.rid} admit_len={req.admit_len} "
                f"not_before_tick={req.not_before_tick} "
                f"(engine step {self._step_count})")
        return "; ".join(parts) or "none visible (bookkeeping bug)"

    def check_page_invariants(self) -> None:
        """Page-leak detector: free and allocated pages partition
        {1..total_pages}, trash page 0 is in neither (nor registered),
        every allocated page has exactly its owners as refcount (eviction
        holes own nothing), a page at refcount 0 is one the prefix registry
        retains (any other is a leak), the registry's two maps agree, and
        each table row matches its slot's pages (retired rows are all
        zero).  The dense engine has no pages to check."""
        if not self.paged:
            return

        def fail(msg: str) -> None:
            raise RuntimeError(f"page invariant violated: {msg}")

        allocated = set(self._page_refs)
        free = set(self._free_pages)
        if 0 in allocated or 0 in free or 0 in self._page_key:
            fail("trash page 0 allocated, free or registered")
        if len(free) != len(self._free_pages):
            fail("a page is on the free list twice")
        if free & allocated:
            fail(f"pages both free and allocated: {sorted(free & allocated)}")
        if free | allocated != set(range(1, self.total_pages + 1)):
            fail("free ∪ allocated is not {1..total_pages}")
        owners: dict[int, int] = {}
        for slot, pages in self._slot_pages.items():
            real = [p for p in pages if p]   # 0 = eviction hole
            if len(real) != len(set(real)):
                fail(f"slot {slot} references a page twice")
            for p in real:
                owners[p] = owners.get(p, 0) + 1
        for p in allocated:
            if self._page_refs[p] != owners.get(p, 0):
                fail(f"page {p}: refcount {self._page_refs[p]} != "
                     f"{owners.get(p, 0)} owners")
            if self._page_refs[p] == 0 and p not in self._page_key:
                fail(f"page {p} unreferenced but not prefix-retained "
                     "(leaked)")
        for p, key in self._page_key.items():
            if self._prefix_cache.get(key) != p:
                fail(f"page {p} registry back-pointer broken")
        for slot in range(self.n_slots):
            pages = self._slot_pages.get(slot, [])
            row = self._pt[slot]
            if list(row[:len(pages)]) != pages or (row[len(pages):] != 0).any():
                fail(f"slot {slot} table row disagrees with its pages")

    @property
    def occupancy(self) -> float:
        """Fraction of decode slot-steps whose token a request consumed."""
        return (self._decode_tokens / self.slot_steps
                if self.slot_steps else 0.0)


def _params_on(tree, device: torch.device):
    """A copy of a parameter tree (dicts of tensors and ``QTensor``s) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: _params_on(v, device) for k, v in tree.items()}
    return tree.to(device)


def _torch_device(d) -> torch.device:
    """``d`` as a torch device, a bare "cuda" pinned to its index."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass
class _PoolEntry:
    """Host-side record of one pool request: everything needed to replay
    it on another replica after a fault."""
    rid: int
    prompt: np.ndarray
    max_new: int
    temperature: float
    deadline: float | None
    replica: int
    local: int                    # engine-local rid on `replica`
    prefix: list = field(default_factory=list)   # accepted tokens
    retries: int = 0              # failover replays consumed
    tier: int = 0                 # priority tier (survives failover)
    tenant: str = ""              # quota bucket (survives failover)


# -- a pool replica over tp devices: a gang of rank processes ----------------

# the engine's errors that reach the pool as themselves (failover, retire, a
# rejected replay or migration); any other error in a rank ends its gang
_PASSED = (ValueError, TypeError, NotImplementedError, ReplicaDeadError)
_SCALARS = (int, float, bool, str, type(None))


class _MetricsLog:
    """The write surface of a metrics registry (``inc``, ``set_gauge``,
    ``delete_gauge``, ``observe``), recording each write: a rank's engine
    feeds one, and its replica replays rank 0's writes into the pool's
    registry, in their order, at the end of each call."""

    def __init__(self) -> None:
        self.ops: list = []

    def inc(self, name: str, delta: float = 1.0) -> None:
        self.ops.append(("inc", name, delta))

    def set_gauge(self, name: str, value: float) -> None:
        self.ops.append(("set_gauge", name, value))

    def delete_gauge(self, name: str) -> None:
        self.ops.append(("delete_gauge", name))

    def observe(self, name: str, value: float) -> None:
        self.ops.append(("observe", name, value))

    def take(self) -> list:
        ops, self.ops = self.ops, []
        return ops


def _engine_view(state: dict) -> dict:
    """What a replica's host view holds of its rank's engine: every scalar
    attribute (counters, knobs, ``dead``, ``_tick``), the state bytes, the
    queued and resident requests, the prefix registry's keys, the
    chunk-prefilling slots, the failed requests not yet returned, the cost
    ledger, the sheds by reason, the free pages, the trace anchor, and the
    ``stall_ms`` samples since the last view (all of them, under
    ``stall_reset``, once the engine trimmed its list)."""
    eng = state["engine"]
    scalars = {k: v for k, v in vars(eng).items() if type(v) in _SCALARS}
    scalars.update(hbm_pool_bytes=eng.hbm_pool_bytes,
                   hbm_peak_bytes=eng.hbm_peak_bytes)
    sent = state.get("stall_sent", 0)
    reset = len(eng.stall_ms) < sent
    state["stall_sent"] = len(eng.stall_ms)
    return {"scalars": scalars, "queue": [r for r, _ in eng.queue],
            "slot_req": dict(eng.slot_req),
            "prefix_cache": list(eng._prefix_cache),
            "prefilling": list(eng._prefilling),
            "failed": list(eng._failed), "cost": eng.cost,
            "shed_by_reason": dict(eng.shed_by_reason),
            "stall_new": eng.stall_ms[0 if reset else sent:],
            "stall_reset": reset,
            "available_pages": eng._available_pages(),
            "anchor": eng._engine_anchor}


def _gang_reply(state: dict, value=None, exc=None, wall: float = 0.0) -> dict:
    """A rank's answer to a replica call: its host digest and the type of
    the engine error it passed on; rank 0 adds the value, the error, the
    call's wall on its clock, the engine's host view, and the metric
    writes and finished spans since the last call."""
    eng, log, tracer = (state.get(k) for k in ("engine", "metrics",
                                                "tracer"))
    ops = log.take() if log is not None else []
    spans = tracer.take_finished() if tracer is not None else ([], [])
    out = {"digest": None if eng is None else eng.host_digest(),
           "raised": None if exc is None else type(exc).__name__}
    if state["rank"] == 0:
        out.update(value=value, exc=exc, wall=wall, metrics=ops, spans=spans,
                   view=None if eng is None else _engine_view(state))
    return out


def _gang_build(state: dict, params: dict, cfg, engine_kw: dict,
                metered: bool, traced: bool, trace_ctx, chaos) -> dict:
    """Rank body: this rank's engine on its device over a ("tp",) mesh of
    its gang, cut from ``params`` where they lie."""
    from kubegpu_tpu_torch.obs.spans import Tracer
    dev = torch.device(state["device"])
    state["metrics"] = _MetricsLog() if metered else None
    state["tracer"] = Tracer() if traced else None
    try:
        state["engine"] = ContinuousBatcher(
            params, cfg, device=dev,
            mesh=make_serve_mesh(state["tp"], dev.type),
            metrics=state["metrics"], tracer=state["tracer"],
            trace_ctx=trace_ctx, chaos=chaos, **engine_kw)
    except _PASSED as exc:
        return _gang_reply(state, exc=exc)
    return _gang_reply(state)


def _gang_call(state: dict, method: str, args: tuple, kw: dict) -> dict:
    """Rank body: ``engine.method(*args, **kw)``."""
    t0 = time.perf_counter()
    try:
        value = getattr(state["engine"], method)(*args, **kw)
    except _PASSED as exc:
        return _gang_reply(state, exc=exc, wall=time.perf_counter() - t0)
    return _gang_reply(state, value, wall=time.perf_counter() - t0)


def _gang_getattr(state: dict, name: str) -> dict:
    """Rank body: the value of one of the engine's attributes or
    properties (a method raises ``AttributeError``: the replica's methods
    are its own)."""
    value = getattr(state["engine"], name, _gang_getattr)
    if value is _gang_getattr or callable(value):
        return _gang_reply(state, exc=AttributeError(
            f"a tp replica has no value {name!r}"))
    return _gang_reply(state, value)


def _gang_setattr(state: dict, name: str, value) -> dict:
    setattr(state["engine"], name, value)
    return _gang_reply(state)


class _GangReplica:
    """One replica of a pool at ``tp > 1``: a started
    :class:`~kubegpu_tpu_torch.parallel.launch.Gang` of ``tp`` rank
    processes, each serving its shard of one engine over a ("tp",) mesh,
    behind the engine surface the pools read and write.

    Each call runs on every rank (the replicated host state stays
    replicated) and every rank answers with its host digest: digests that
    part, or ranks that disagree on an error, raise ``RuntimeError``.
    Rank 0's answer refreshes the host view the pool reads between calls
    (``queue``, ``slot_req``, ``_prefix_cache``, ``_prefilling``,
    ``_failed``, ``cost``, ``shed_by_reason``, ``stall_ms``,
    ``_available_pages()``, ``_engine_anchor`` and every scalar attribute;
    any other value is fetched from rank 0 when it is read), replays its
    metric writes into ``metrics`` and lands its finished spans in
    ``tracer``.  An engine error of ``_PASSED``'s types
    (:class:`ReplicaDeadError` and ``ValueError`` among them) is raised
    here as itself.  A rank that raises anything else or dies ends the
    gang, and the call raises :class:`ReplicaDeadError` (a
    ``RuntimeError``) with the rank's traceback: the replica is dead, its
    last host view stays readable and ``take_orphans()`` returns nothing,
    so the pool replays every request that view holds.
    ``round_trip_ms`` keeps, for each ``step``, this process's wall minus
    rank 0's own wall for the step: the cost of the round trip."""

    def __init__(self, gang, params: dict, cfg, engine_kw: dict,
                 metrics=None, chaos=None, tracer=None, trace_ctx=None):
        self._metrics, self._tracer = metrics, tracer
        self._attrs: dict = {}
        self.round_trip_ms: list[float] = []
        self.stall_ms: list[float] = []
        self._gang = gang
        self.devices = gang.devices
        try:
            self._call(_gang_build, params, cfg, engine_kw,
                       metrics is not None, tracer is not None, trace_ctx,
                       chaos)
        except BaseException:
            self.close()
            raise

    def _call(self, fn, *args, step: bool = False):
        t0 = time.perf_counter()
        try:
            replies = self._gang.call(fn, *args)
        except RuntimeError as exc:
            # a rank raised or died, and the gang is closed
            reason = f"tp gang on {self.devices} failed: {exc}"
            self._attrs = dict(self._attrs,
                               dead=self._attrs.get("dead") or reason)
            raise ReplicaDeadError(reason) from exc
        wall = time.perf_counter() - t0
        head = replies[0]
        if any((r["digest"], r["raised"]) != (head["digest"], head["raised"])
               for r in replies):
            self.close()
            raise RuntimeError(
                f"the tp ranks' host state parted ({fn.__name__}"
                f"{args[:1]}): digests {[r['digest'] for r in replies]}, "
                f"errors {[r['raised'] for r in replies]}")
        self._digest = head["digest"]
        if head["view"] is not None:
            self._absorb(head["view"])
        if self._metrics is not None:
            for op, *a in head["metrics"]:
                getattr(self._metrics, op)(*a)
        if self._tracer is not None:
            self._tracer.add_finished(*head["spans"])
        if step:
            self.round_trip_ms.append((wall - head["wall"]) * 1e3)
            _trim_acct(self.round_trip_ms)
        if head["exc"] is not None:
            raise head["exc"]
        return head["value"]

    def _absorb(self, view: dict) -> None:
        self._attrs = view["scalars"]
        self.queue = _AdmissionQueue((r, None) for r in view["queue"])
        self.slot_req = view["slot_req"]
        self._prefix_cache = dict.fromkeys(view["prefix_cache"])
        self._prefilling = dict.fromkeys(view["prefilling"])
        self._failed = view["failed"]
        self.cost = view["cost"]
        self.shed_by_reason = view["shed_by_reason"]
        if view["stall_reset"]:
            self.stall_ms.clear()
        self.stall_ms.extend(view["stall_new"])
        _trim_acct(self.stall_ms)
        self._free = view["available_pages"]
        self._engine_anchor = view["anchor"]

    def __getattr__(self, name: str):
        attrs = self.__dict__.get("_attrs", {})
        if name in attrs:
            return attrs[name]
        if name.startswith("__") or "_digest" not in self.__dict__:
            raise AttributeError(name)
        return self._call(_gang_getattr, name)

    @property
    def dead(self):
        return self._attrs.get("dead")

    @dead.setter
    def dead(self, reason) -> None:
        if self._gang.alive:
            try:
                self._call(_gang_setattr, "dead", reason)
                return
            except ReplicaDeadError:
                pass
        self._attrs = dict(self._attrs, dead=reason)

    def _method(self, name: str, *args, **kw):
        return self._call(_gang_call, name, args, kw, step=name == "step")

    def submit(self, *args, **kw) -> int:
        return self._method("submit", *args, **kw)

    def step(self) -> list[_Request]:
        return self._method("step")

    def warmup(self) -> None:
        self._method("warmup")

    def drain(self, *args, **kw) -> list[_Request]:
        return self._method("drain", *args, **kw)

    def cancel(self, *args, **kw):
        return self._method("cancel", *args, **kw)

    def take_orphans(self) -> list[_Request]:
        # a failed gang's unread finished requests died with it; its last
        # view still holds them as resident, so they replay
        if not self._gang.alive:
            return []
        return self._method("take_orphans")

    def take_export(self, rid: int) -> dict | None:
        return self._method("take_export", rid)

    def take_exports(self) -> dict[int, dict]:
        return self._method("take_exports")

    def import_chain(self, export: dict, *args, **kw) -> int | None:
        # the chain reaches the ranks in shared memory, which moves a host
        # tensor's storage: send copies, so the caller's export stays as
        # it was
        export = dict(export, chain={k: v.clone()
                                     for k, v in export["chain"].items()})
        return self._method("import_chain", export, *args, **kw)

    def check_page_invariants(self) -> None:
        self._method("check_page_invariants")

    def host_digest(self) -> str:
        """Rank 0's host digest after the last call (every rank's was
        equal to it)."""
        return self._digest

    def _available_pages(self) -> int:
        return self._free

    def on_ranks(self, fn, *args) -> list:
        """``fn(state, *args)`` on every rank (``state["engine"]`` is the
        rank's engine); every rank's result, in rank order.  For
        measurement (a rank's memory, its kernel counters): it changes no
        host view."""
        return self._gang.call(fn, *args)

    def close(self) -> None:
        """End the gang's processes (idempotent)."""
        self._gang.close()


class DataParallelServePool:
    """``dp`` independent engine replicas behind one admission queue (the
    reference's pool at ``tp=1``: each replica a :class:`ContinuousBatcher`
    on one torch device, sharing nothing on the device but, where two
    replicas share a device, the weight tensors; each has its own pool).
    ``devices`` lists the replicas' devices, by default the first ``dp``
    CUDA devices; a device may repeat (``["cuda:0"] * dp``, or ``["cpu"] *
    dp`` in tests).  The weights are copied once to each other device.

    ``submit()`` routes a request (``routing="affinity"``, the default:
    the replica already holding the longest leading run of the prompt's
    prefix-page chain, unless its load outweighs that run; with no such
    run, or ``routing="least_loaded"``, the replica with the fewest queued
    and resident requests, then the fewest queued prompt tokens, then the
    lowest index).  ``route_log`` keeps (rid, replica, affinity pages).

    Failover: every request's prompt and accepted tokens live on the
    host, so when a replica dies (its ``step()`` raises
    :class:`ReplicaDeadError`: a chaos kill, the watchdog, or a
    control-plane eviction seen through :meth:`observe_gang_eviction` or
    :meth:`watch_health`) the pool collects what finished in the dying
    step (``take_orphans``) and replays every other resident request on
    the least-loaded live replica as prompt + accepted tokens with what it
    still owes (bit-exact for greedy requests), at most ``max_replays``
    times a request; a request past that bound, past its ``deadline_s``
    or left with no live replica comes back FAILED (``error`` set,
    partial tokens kept).  ``failovers``, ``replay_ms``,
    ``requests_retried`` and ``dead_replicas`` count it.

    The scale surface: :meth:`add_replica` builds one more replica on a
    free device (through :meth:`_build_engine`, the one construction
    seam, which a subclass may override), :meth:`retire_replica` drains
    one through the same replay parking at the next ``step()`` without
    spending any request's replay budget.  With a ``metrics`` registry
    every engine feeds it, and the pool adds ``serve_failover_total``,
    ``serve_replay_ms``, ``serve_requests_retried``,
    ``serve_routing_affinity_hits``, ``serve_autoscale_events``,
    ``serve_replicas_active``, ``serve_replica_queue_depth_r<i>`` (deleted
    when replica i dies) and ``serve_chip_ticks_total``.  A dead or
    retired replica keeps its engine object, and with it its pool.

    ``cfg`` may be a :class:`~kubegpu_tpu_torch.models.moe.MoEConfig`:
    each replica's engine serves the MoE family (it scales out on dp
    replicas; page chains hold attention K/V only, so migration is the
    same).

    ``tp > 1``: each replica is a tensor-parallel engine on its block of
    ``tp`` devices (replica i on ``devices[b·tp:(b+1)·tp]``, b its block),
    one process a rank (:class:`_GangReplica`; NCCL where the block's
    devices are distinct cards, gloo where they share a card or are the
    CPU).  Each rank cuts its shard from ``params`` where they lie; the
    routing, failover, scaling and migration above are the same.  The
    pool owns the gangs' processes: :meth:`close` (or leaving a ``with``
    block) ends them.  A MoE config at ``tp > 1`` raises the engine's
    ``ValueError``, as the reference's does."""

    def __init__(self, params: dict, cfg: LlamaConfig | MoEConfig,
                 dp: int = 1,
                 tp: int = 1, devices=None, metrics=None,
                 max_replays: int = 2, chaos=None, tracer=None,
                 trace_ctx=None, routing: str = "affinity", **engine_kw):
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())][:dp * tp]
        devs = [_torch_device(d) for d in devices]
        if len(devs) < dp * tp:
            raise ValueError(
                f"dp={dp} x tp={tp} needs {dp * tp} devices, "
                f"have {len(devs)}")
        if routing not in ("affinity", "least_loaded"):
            raise ValueError(
                f"routing must be 'affinity' or 'least_loaded', "
                f"got {routing!r}")
        engine_kw.setdefault("paged", True)
        self.dp, self.tp = dp, tp
        self.routing = routing
        # what add_replica needs to build an engine as __init__ did
        self._params, self._cfg = params, cfg
        self._params_by_dev: dict[torch.device, dict] = {}
        self._devs = devs
        self._chaos = chaos or {}
        self._engine_kw = engine_kw
        self._trace_ctx = trace_ctx
        self._blocks = list(range(dp))    # replica -> device index
        self._metrics = metrics
        # one tracer for every replica: a replayed request's spans share
        # the timeline of its first life
        self._tracer = tracer
        self._unsub = None
        # at tp > 1 every replica's rank processes start at once (a gang
        # takes seconds to reach its devices); _build_engine takes them
        self._starting = {i: self._start_gang(i) for i in range(dp)
                          if tp > 1}
        self.replicas = []
        try:
            for i in range(dp):
                self.replicas.append(self._build_engine(i))
        except BaseException:
            self.close()     # the replicas built so far
            raise
        finally:
            for gang in self._starting.values():
                gang.close()
            self._starting = {}
        self.max_replays = int(max_replays)
        # the host-side record: pool rid -> entry, (replica, local rid) ->
        # pool rid
        self._entries: dict[int, _PoolEntry] = {}
        self._local: dict[tuple[int, int], int] = {}
        self._next_rid = 0
        self.dead_replicas: dict[int, str] = {}
        self.failovers = 0
        self.replay_ms: list[float] = []
        self.requests_retried = 0
        # control-plane glue: serving gang -> replica, and the evictions
        # observed that the next step() turns into failovers
        self._gang_replica: dict[str, int] = {}
        self._pending_deaths: deque[tuple[int, str]] = deque()
        # prefix-affinity routing: each replica's set of chain keys,
        # registered or inbound (queued or resident requests'), rebuilt
        # every step() and warmed at each submit; host-side only
        self._digests: list[set] = [set() for _ in range(dp)]
        self.routing_affinity_hits = 0
        self.route_log: list[tuple[int, int, int]] = []  # (rid, rep, aff)
        # the scale surface: retires drain through the replay parking
        self._pending_retire: deque[int] = deque()
        self.autoscale_events = 0
        self.drains = 0
        self.drain_replays = 0
        self.replicas_active_min = dp
        self.replicas_active_max = dp

    def _replica_params(self, dev: torch.device) -> dict:
        """The weights on ``dev``: the caller's tensors where they lie
        there, else one copy a device, shared by its replicas."""
        if self._params["embed"].device == dev:
            return self._params
        if dev not in self._params_by_dev:
            self._params_by_dev[dev] = _params_on(self._params, dev)
        return self._params_by_dev[dev]

    def _build_engine(self, i: int) -> "ContinuousBatcher | _GangReplica":
        """Build replica ``i``'s engine on its device block: the only place
        a replica is constructed (``__init__`` and :meth:`add_replica`), so
        a subclass that overrides it inherits the routing, failover and
        scaling above it.  At ``tp > 1`` the replica is a gang of rank
        processes on the block's devices."""
        if self.tp > 1:
            return _GangReplica(
                self._starting.pop(i, None) or self._start_gang(i),
                self._params, self._cfg, self._engine_kw,
                metrics=self._metrics, chaos=self._chaos.get(i),
                tracer=self._tracer, trace_ctx=self._trace_ctx)
        dev = self._devs[self._blocks[i]]
        return ContinuousBatcher(
            self._replica_params(dev), self._cfg, device=dev,
            metrics=self._metrics, chaos=self._chaos.get(i),
            tracer=self._tracer, trace_ctx=self._trace_ctx,
            **self._engine_kw)

    def _start_gang(self, i: int):
        """Start the rank processes of replica ``i``'s device block."""
        from kubegpu_tpu_torch.parallel.launch import Gang
        b, tp = self._blocks[i], self.tp
        return Gang(self._devs[b * tp:(b + 1) * tp])

    def warmup(self) -> None:
        """Warm every replica, one after the other (each captures its own
        graphs)."""
        for eng in self.replicas:
            eng.warmup()

    def _load(self, eng: ContinuousBatcher) -> int:
        return len(eng.queue) + len(eng.slot_req)

    def _route_key(self, j: int):
        """The least-loaded key: requests, then queued prompt tokens (the
        queue's running total), then the index."""
        eng = self.replicas[j]
        return (self._load(eng), eng.queue.prompt_tokens, j)

    def _alive(self) -> list[int]:
        return [i for i in range(self.dp) if i not in self.dead_replicas]

    # -- prefix-affinity routing ------------------------------------------

    def _chain_keys(self, prompt_np: np.ndarray) -> tuple:
        """The registry keys of the prompt's leading whole pages, in the
        engine's own scheme (:meth:`ContinuousBatcher._enqueue`)."""
        eng = self.replicas[0]
        if not (eng.paged and eng.prefix_cache_enabled):
            return ()
        return page_keys(prompt_np, eng.page_size)

    def _affinity(self, j: int, keys: tuple) -> int:
        """The longest leading run of ``keys`` in replica ``j``'s digest
        (as the engine's ``_prefix_hit_run``: key i alone aliases
        nothing)."""
        d = self._digests[j]
        h = 0
        for key in keys:
            if key not in d:
                break
            h += 1
        return h

    def _route(self, candidates: list[int],
               prompt_np: np.ndarray) -> tuple[int, int]:
        """(replica, affinity pages) for ``prompt_np`` among
        ``candidates``: with affinity, the least ``(load - affinity,
        load, queued tokens, index)``; zero affinity everywhere is exactly
        the least-loaded key.  The chosen replica's digest takes the
        prompt's keys at once, so a burst of one prefix stays together."""
        if self.routing != "affinity":
            return min(candidates, key=self._route_key), 0
        keys = self._chain_keys(prompt_np)
        aff = ({j: self._affinity(j, keys) for j in candidates}
               if keys else {})
        if keys and any(aff.values()):
            i = min(candidates, key=lambda j: (
                self._load(self.replicas[j]) - aff[j],)
                + self._route_key(j))
            hit = aff[i]
        else:
            i = min(candidates, key=self._route_key)
            hit = 0
        if keys:
            self._digests[i].update(keys)
        return i, hit

    def _record_route(self, rid: int, i: int, aff: int) -> None:
        self.route_log.append((rid, i, aff))
        _trim_acct(self.route_log)
        if aff > 0:
            self.routing_affinity_hits += 1
            if self._metrics is not None:
                self._metrics.inc("serve_routing_affinity_hits")
        if self._tracer is not None:
            sp = self._tracer.start_span(
                "request.route",
                parent=self.replicas[i]._engine_anchor,
                attrs={"rid": rid, "replica": i, "affinity_pages": aff,
                       "load": self._load(self.replicas[i])})
            sp.end()

    def _refresh_digests(self) -> None:
        """Rebuild every live replica's digest from its registry and its
        queued and resident requests' keys (an LRU reclaim's stale key
        heals here)."""
        for j, eng in enumerate(self.replicas):
            if j in self.dead_replicas:
                self._digests[j] = set()
                continue
            d = (set(eng._prefix_cache)
                 if eng.paged and eng.prefix_cache_enabled else set())
            for req in eng.slot_req.values():
                d.update(req.prefix_keys)
            for req, _ in eng.queue:
                d.update(req.prefix_keys)
            self._digests[j] = d

    @property
    def routing_affinity_hit_rate(self) -> float:
        """The share of routed submits (recent window) that landed on a
        replica already holding a page of the prompt's chain."""
        if not self.route_log:
            return 0.0
        return (sum(1 for _, _, a in self.route_log if a > 0)
                / len(self.route_log))

    # -- the scale surface -------------------------------------------------

    def add_replica(self, gang: str | None = None) -> int:
        """Scale up: build one more replica on a device no live replica
        holds (a dead replica's device is reused), bound to ``gang`` when
        given.  Returns its index; ``ValueError`` when every device is in
        use."""
        n_blocks = len(self._devs) // self.tp
        used = {self._blocks[j] for j in range(len(self.replicas))
                if j not in self.dead_replicas}
        free = [b for b in range(n_blocks) if b not in used]
        if not free:
            raise ValueError(
                f"no spare devices for a new replica: tp={self.tp}, "
                f"{len(self._devs)} devices, {len(used)} blocks in use")
        i = len(self.replicas)
        self._blocks.append(free[0])
        eng = self._build_engine(i)
        self.replicas.append(eng)
        self._digests.append(set())
        self.dp = len(self.replicas)
        if gang is not None:
            self.bind_replica_gang(i, gang)
        self.autoscale_events += 1
        n = len(self._alive())
        self.replicas_active_max = max(self.replicas_active_max, n)
        if self._metrics is not None:
            self._metrics.inc("serve_autoscale_events")
            self._metrics.set_gauge("serve_replicas_active", float(n))
        if self._tracer is not None:
            sp = self._tracer.start_span(
                "pool.scale", parent=eng._engine_anchor,
                attrs={"direction": "up", "replica": i,
                       "replicas_active": n})
            sp.end()
        return i

    def retire_replica(self, i: int) -> None:
        """Graceful scale-down: the next ``step()`` parks replica ``i``'s
        requests on the others through the replay (prompt + accepted
        tokens), spending no request's replay budget."""
        if not 0 <= i < self.dp:
            raise ValueError(f"no replica {i} (dp={self.dp})")
        if i in self.dead_replicas:
            raise ValueError(
                f"replica {i} is already dead: {self.dead_replicas[i]}")
        if i in self._pending_retire:
            return
        survivors = [j for j in self._alive()
                     if j != i and j not in self._pending_retire]
        if not survivors:
            raise ValueError("cannot retire the last healthy replica")
        self._pending_retire.append(i)

    def _scale_down(self, i: int, done: list) -> None:
        eng = self.replicas[i]
        sp = None
        if self._tracer is not None:
            sp = self._tracer.start_span(
                "pool.scale", parent=eng._engine_anchor,
                attrs={"direction": "down", "replica": i})
        eng.dead = "retired (scale-down)"
        before = self.drain_replays
        self._failover(i, "scale-down drain", done, drain=True)
        self.autoscale_events += 1
        n = len(self._alive())
        self.replicas_active_min = min(self.replicas_active_min, n)
        if self._metrics is not None:
            self._metrics.inc("serve_autoscale_events")
            self._metrics.set_gauge("serve_replicas_active", float(n))
        if sp is not None:
            sp.set_attr("replicas_active", n)
            sp.set_attr("drain_replays", self.drain_replays - before)
            sp.end()

    def _new_entry(self, i: int, local: int, prompt_np: np.ndarray,
                   max_new_tokens: int, temperature: float,
                   deadline_s: float | None, tier: int, tenant: str,
                   aff: int) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._entries[rid] = _PoolEntry(
            rid=rid, prompt=prompt_np, max_new=max_new_tokens,
            temperature=float(temperature),
            deadline=(time.monotonic() + deadline_s
                      if deadline_s is not None else None),
            replica=i, local=local, tier=int(tier), tenant=str(tenant))
        self._local[(i, local)] = rid
        self._record_route(rid, i, aff)
        return rid

    def _no_replica_left(self) -> ReplicaDeadError:
        return ReplicaDeadError(
            "no healthy replicas left: "
            + "; ".join(f"replica {i}: {r}"
                        for i, r in self.dead_replicas.items()))

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               deadline_s: float | None = None, tier: int = 0,
               tenant: str = "") -> int:
        """Route and enqueue a request; returns its pool rid.  Raises
        :class:`ReplicaDeadError` when no replica is alive."""
        alive = self._alive()
        if not alive:
            raise self._no_replica_left()
        prompt_np = np.asarray(prompt, np.int64)
        i, aff = self._route(alive, prompt_np)
        local = self.replicas[i].submit(prompt, max_new_tokens, temperature,
                                        tier=tier, tenant=tenant)
        return self._new_entry(i, local, prompt_np, max_new_tokens,
                               temperature, deadline_s, tier, tenant, aff)

    # -- control-plane integration -----------------------------------------

    def bind_replica_gang(self, replica: int, gang: str) -> None:
        """Declare that ``replica`` is backed by serving gang ``gang``, the
        link a health controller's evictions resolve through."""
        self._gang_replica[gang] = replica

    def observe_gang_eviction(self, gang: str,
                              reason: str = "gang evicted") -> None:
        """A serving gang died in the control plane: its replica is marked
        for death, and the next ``step()`` fails its requests over."""
        i = self._gang_replica.pop(gang, None)
        if i is not None and i not in self.dead_replicas:
            self._pending_deaths.append((i, f"{reason} (gang {gang})"))

    def watch_health(self, api) -> None:
        """Subscribe to an apiserver's watch stream (``api.watch(cb)``
        returning an unsubscribe function): a DELETED pod of a bound
        serving gang marks its replica dead."""

        def _cb(ev) -> None:
            if ev.kind != "Pod" or ev.type != "DELETED":
                return
            gs = pod_gang_spec(ev.obj)
            if gs is not None and gs.name in self._gang_replica:
                self.observe_gang_eviction(gs.name, "pod evicted")

        self._unsub = api.watch(_cb)

    def close(self) -> None:
        """Stop watching the apiserver and end every replica's rank
        processes (the replicas of a pool at ``tp > 1``); idempotent."""
        if self._unsub is not None:
            self._unsub()
            self._unsub = None
        for eng in self.replicas:
            if isinstance(eng, _GangReplica):
                eng.close()

    def __enter__(self) -> "DataParallelServePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- failover ----------------------------------------------------------

    def _fail_entry(self, e: _PoolEntry, why: str, done: list) -> None:
        r = _Request(rid=e.rid, prompt_len=int(e.prompt.shape[0]),
                     max_new_tokens=e.max_new, temperature=e.temperature,
                     prompt=e.prompt)
        r.tokens = list(e.prefix)
        r.done = True
        r.error = why
        self._entries.pop(e.rid, None)
        done.append(r)

    def _finish(self, replica: int, r: _Request, done: list) -> None:
        rid = self._local.pop((replica, r.rid), None)
        if rid is None:
            return   # already completed or failed over
        e = self._entries.pop(rid, None)
        if e is not None and e.prefix:
            r.tokens = e.prefix + r.tokens
        r.rid = rid
        done.append(r)

    def _replay_submit(self, replay, remaining: int,
                       e: _PoolEntry) -> tuple[int, int]:
        """Place one replay (prompt + accepted tokens, what it still
        owes) on the least-loaded live replica: ``(replica, local rid)``;
        the engine's ``ValueError`` propagates."""
        j = min(self._alive(), key=self._route_key)
        return j, self.replicas[j].submit(replay, remaining, e.temperature,
                                          tier=e.tier, tenant=e.tenant)

    def _failover(self, i: int, reason: str, done: list,
                  drain: bool = False) -> None:
        """Replay every request resident on dead replica ``i`` on the live
        ones.  ``drain=True`` is a retire: the same parking, but no
        failover counters and no replay spent."""
        self.dead_replicas[i] = reason
        if drain:
            self.drains += 1
        else:
            self.failovers += 1
            if self._metrics is not None:
                self._metrics.inc("serve_failover_total")
        t0 = time.perf_counter()
        eng = self.replicas[i]
        fo_span = None
        if self._tracer is not None and not drain:
            fo_span = self._tracer.start_span(
                "pool.failover", parent=eng._engine_anchor,
                attrs={"replica": i, "reason": reason})
        # what finished in the dying step completes, exactly once
        for r in eng.take_orphans():
            self._finish(i, r, done)
        resident: dict[int, _Request] = {}
        for req in list(eng.slot_req.values()) + [r for r, _ in eng.queue]:
            resident[req.rid] = req
        alive = self._alive()
        n_replayed = 0
        for local in sorted(resident):
            req = resident[local]
            rid = self._local.pop((i, local), None)
            if rid is None:
                continue
            e = self._entries[rid]
            e.prefix = e.prefix + list(req.tokens)
            remaining = e.max_new - len(e.prefix)
            if remaining < 1:    # finished exactly at the fault
                r = _Request(rid=rid, prompt_len=int(e.prompt.shape[0]),
                             max_new_tokens=e.max_new,
                             temperature=e.temperature, prompt=e.prompt)
                r.tokens = list(e.prefix)
                r.done = True
                self._entries.pop(rid, None)
                done.append(r)
                continue
            if not drain:
                e.retries += 1
                if e.retries > self.max_replays:
                    self._fail_entry(
                        e, f"exceeded {self.max_replays} failovers "
                        f"(last: {reason})", done)
                    continue
            if not alive:
                self._fail_entry(
                    e, f"no healthy replicas left ({reason})", done)
                continue
            replay = (np.concatenate([e.prompt,
                                      np.asarray(e.prefix, np.int64)])
                      if e.prefix else e.prompt)
            try:
                j, new_local = self._replay_submit(replay, remaining, e)
            except ValueError as err:
                self._fail_entry(e, f"replay rejected: {err}", done)
                continue
            e.replica, e.local = j, new_local
            self._local[(j, new_local)] = rid
            n_replayed += 1
            if drain:
                self.drain_replays += 1
            else:
                self.requests_retried += 1
                if self._metrics is not None:
                    self._metrics.inc("serve_requests_retried")
        dt = (time.perf_counter() - t0) * 1e3
        if n_replayed or resident:
            self.replay_ms.append(dt)
            _trim_acct(self.replay_ms)
            if self._metrics is not None:
                self._metrics.observe("serve_replay_ms", dt)
        # the dead engine never steps again: no digest, and no depth gauge
        # left on the scrape surface
        self._digests[i] = set()
        if self._metrics is not None:
            self._metrics.delete_gauge("serve_replica_queue_depth" + f"_r{i}")
        if fo_span is not None:
            fo_span.set_attr("replayed", n_replayed)
            fo_span.set_attr("resident", len(resident))
            fo_span.end()

    def _expire_deadlines(self, done: list) -> None:
        if not any(e.deadline is not None for e in self._entries.values()):
            return
        now = time.monotonic()
        for e in list(self._entries.values()):
            if e.deadline is None or now <= e.deadline:
                continue
            partial = None
            if e.replica not in self.dead_replicas:
                partial = self.replicas[e.replica].cancel(
                    e.local, "deadline exceeded")
            self._local.pop((e.replica, e.local), None)
            if partial is not None and partial.tokens:
                e.prefix = e.prefix + list(partial.tokens)
            self._fail_entry(e, "deadline exceeded", done)

    def cancel(self, rid: int, reason: str = "canceled"):
        """Cancel a pool request wherever it lives: the failed request
        (partial tokens kept), or None for an unknown rid."""
        e = self._entries.get(rid)
        if e is None:
            return None
        if e.replica not in self.dead_replicas:
            partial = self.replicas[e.replica].cancel(e.local, reason)
            if partial is not None and partial.tokens:
                e.prefix = e.prefix + list(partial.tokens)
        self._local.pop((e.replica, e.local), None)
        sink: list = []
        self._fail_entry(e, reason, sink)
        return sink[0]

    def step(self) -> list[_Request]:
        """Retires first (a retire whose gang eviction also arrives is not
        a fault), then observed deaths, deadlines, and one ``step()`` of
        every live replica (a replica that raises
        :class:`ReplicaDeadError` fails over); returns the requests that
        finished or failed, under their pool rids."""
        done: list[_Request] = []
        while self._pending_retire:
            i = self._pending_retire.popleft()
            if i not in self.dead_replicas:
                self._scale_down(i, done)
        while self._pending_deaths:
            i, reason = self._pending_deaths.popleft()
            if i in self.dead_replicas:
                continue
            self.replicas[i].dead = reason   # the engine refuses new work
            self._failover(i, reason, done)
        self._expire_deadlines(done)
        for i, eng in enumerate(self.replicas):
            if i in self.dead_replicas:
                continue
            try:
                rs = eng.step()
            except ReplicaDeadError as e:
                self._failover(i, str(e), done)
                continue
            for r in rs:
                self._finish(i, r, done)
        if self.routing == "affinity":
            self._refresh_digests()
        n_alive = len(self._alive())
        self.replicas_active_min = min(self.replicas_active_min, n_alive)
        self.replicas_active_max = max(self.replicas_active_max, n_alive)
        if self._metrics is not None:
            # one depth gauge a live replica; a dead one's is deleted
            # again here (idempotent), whatever path killed it
            for i in self.dead_replicas:
                self._metrics.delete_gauge(
                    "serve_replica_queue_depth" + f"_r{i}")
            for i, eng in enumerate(self.replicas):
                if i not in self.dead_replicas:
                    self._metrics.set_gauge(
                        "serve_replica_queue_depth" + f"_r{i}",
                        float(len(eng.queue)))
            self._metrics.set_gauge("serve_replicas_active", float(n_alive))
            self._metrics.set_gauge(
                "serve_chip_ticks_total",
                float(sum(e.cost.busy_chip_ticks for e in self.replicas)))
        return done

    def drain(self, max_ticks: int = 10_000) -> list[_Request]:
        """Step until every request finished or failed; raises naming the
        stuck work after ``max_ticks``."""
        out: list[_Request] = []
        for _ in range(max_ticks):
            if (not self._entries and not self._pending_deaths
                    and not self._pending_retire):
                return out
            out.extend(self.step())
        diag = "; ".join(
            f"replica {e.replica}"
            f"{' (DEAD)' if e.replica in self.dead_replicas else ''}: "
            f"rid={rid} prefix={len(e.prefix)}/{e.max_new} "
            f"retries={e.retries}"
            for rid, e in sorted(self._entries.items()))
        raise RuntimeError(
            f"drain did not converge after {max_ticks} ticks; "
            f"stuck work: {diag or 'none visible (bookkeeping bug)'}")

    # -- aggregates: the single engine's surface, summed over replicas -----

    @property
    def emitted_tokens(self) -> int:
        return sum(e.emitted_tokens for e in self.replicas)

    @property
    def occupancy(self) -> float:
        steps = sum(e.slot_steps for e in self.replicas)
        toks = sum(e._decode_tokens for e in self.replicas)
        return toks / steps if steps else 0.0

    @property
    def prefill_waves(self) -> int:
        return sum(e.prefill_waves for e in self.replicas)

    @property
    def slot_steps(self) -> int:
        return sum(e.slot_steps for e in self.replicas)

    @property
    def stall_ms(self) -> list[float]:
        return [s for e in self.replicas for s in e.stall_ms]

    @property
    def slots_quarantined(self) -> int:
        return sum(e.slots_quarantined for e in self.replicas)

    @property
    def dispatch_failures(self) -> int:
        return sum(e.dispatch_failures for e in self.replicas)

    @property
    def requests_retried_total(self) -> int:
        """Failover replays plus the engines' quarantine replays."""
        return self.requests_retried + sum(
            e.requests_retried for e in self.replicas)

    @property
    def requests_shed(self) -> int:
        return sum(e.requests_shed for e in self.replicas)

    @property
    def requests_preempted(self) -> int:
        return sum(e.requests_preempted for e in self.replicas)

    @property
    def requests_resumed(self) -> int:
        return sum(e.requests_resumed for e in self.replicas)

    @property
    def deadline_misses(self) -> int:
        return sum(e.deadline_misses for e in self.replicas)

    @property
    def shed_by_reason(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.replicas:
            for k, v in e.shed_by_reason.items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def spec_acceptance_rate(self) -> float:
        prop = sum(e.spec_drafts_proposed for e in self.replicas)
        acc = sum(e.spec_drafts_accepted for e in self.replicas)
        return acc / prop if prop else 0.0

    @property
    def spec_tokens_per_tick(self) -> float:
        gamma = self.replicas[0].spec_gamma
        if not gamma:
            return 0.0
        prop = sum(e.spec_drafts_proposed for e in self.replicas)
        acc = sum(e.spec_drafts_accepted for e in self.replicas)
        return 1.0 + acc / (prop / gamma) if prop else 0.0

    @property
    def hbm_pool_bytes(self) -> int:
        """Live state bytes summed over the live replicas (a dead one's
        pool drops out of the sum, though its engine keeps it)."""
        return sum(e.hbm_pool_bytes for e in self.replicas
                   if e.dead is None)

    @property
    def hbm_peak_bytes(self) -> int:
        return sum(e.hbm_peak_bytes for e in self.replicas)

    @property
    def cost(self) -> CostLedger:
        """Every replica's ledger merged (dead ones keep theirs: the
        chip-ticks they burned were spent)."""
        led = CostLedger()
        for e in self.replicas:
            led.merge(e.cost)
        return led

    @property
    def busy_ticks(self) -> int:
        return sum(e.busy_ticks for e in self.replicas)


class DisaggServePool(DataParallelServePool):
    """Disaggregated prefill/decode serving: ``prefill`` replicas prefill
    a prompt and make its first token, ``decode`` replicas adopt the
    migrated page chains and decode.

    A request, step by step: ``submit`` routes the prompt to a prefill
    replica as a ``max_new_tokens=1, migrate_out=True`` request; at its
    retirement, before its pages return, the prefill engine exports the
    page-aligned prompt region of its pool (every leaf, int8 and int4
    scales with their values) to host tensors with a sha256 digest, the
    prompt, its prefix keys and the first token; the pool takes the
    export (exactly once) and hands it to the least-loaded decode replica,
    whose ``import_chain`` checks the digest, scatters the chain into its
    own pages, activates a slot mid-decode and registers the prompt pages
    for later shared-prefix requests.  Decode then reads the same pool
    bytes the prefill wrote, so greedy tokens equal a symmetric pool's.
    A full decode side defers the migration to the next step; a rejected
    chain fails its request.  ``migrations``, ``migrated_pages`` and
    ``migration_ms`` (with a registry: ``serve_migrated_pages_total``,
    ``serve_migration_ms``) count them.

    Failover composes: an export is host memory, so a prefill replica
    dying mid-migration still hands over its finished chains (from the
    orphans), an unexported prefill replays on a live prefill replica, a
    decode death replays prompt + accepted tokens through a prefill leg
    again; with a whole role dead the pool serves symmetrically on what
    is left.  At ``tp > 1`` each role's replica is a gang (see
    :class:`DataParallelServePool`): the prefill gang's ranks all-gather
    their heads of a chain, so the export is the full-head chain on the
    host, and the decode gang's ranks each scatter their own heads."""

    def __init__(self, params: dict, cfg: LlamaConfig | MoEConfig,
                 prefill: int = 1,
                 decode: int = 1, tp: int = 1, **kw):
        if prefill < 1 or decode < 1:
            raise ValueError(
                f"need at least one replica per role, got "
                f"prefill={prefill} decode={decode}")
        kw.setdefault("paged", True)
        super().__init__(params, cfg, dp=prefill + decode, tp=tp, **kw)
        self.n_prefill, self.n_decode = prefill, decode
        self.roles = ["prefill"] * prefill + ["decode"] * decode
        # (pool rid, export) pairs awaiting decode capacity
        self._pending_migrations: deque = deque()
        self.migrations = 0
        self.migrated_pages = 0
        self.migration_ms: list[float] = []

    def _role_replicas(self, role: str, alive: list[int]) -> list[int]:
        return [i for i in alive if self.roles[i] == role]

    def add_replica(self, gang: str | None = None,
                    role: str = "decode") -> int:
        """Scale up one role (the autoscaler grows the decode side)."""
        if role not in ("prefill", "decode"):
            raise ValueError(
                f"role must be 'prefill' or 'decode', got {role!r}")
        i = super().add_replica(gang)
        self.roles.append(role)
        if role == "prefill":
            self.n_prefill += 1
        else:
            self.n_decode += 1
        return i

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               deadline_s: float | None = None, tier: int = 0,
               tenant: str = "") -> int:
        alive = self._alive()
        if not alive:
            raise self._no_replica_left()
        pref = self._role_replicas("prefill", alive)
        dec = self._role_replicas("decode", alive)
        prompt_np = np.asarray(prompt, np.int64)
        if pref and dec and max_new_tokens > 1:
            # the prefill leg makes one token; affinity scores the prefill
            # role, where the prompt's chain pages alias
            i, aff = self._route(pref, prompt_np)
            local = self.replicas[i].submit(
                prompt, 1, temperature, migrate_out=True, tier=tier,
                tenant=tenant)
        elif pref and max_new_tokens == 1:
            # satisfied by the prefill alone: nothing migrates
            i, aff = self._route(pref, prompt_np)
            local = self.replicas[i].submit(prompt, 1, temperature,
                                            tier=tier, tenant=tenant)
        else:
            # a whole role is dead: serve symmetrically on what is left
            i, aff = self._route(alive, prompt_np)
            local = self.replicas[i].submit(prompt, max_new_tokens,
                                            temperature, tier=tier,
                                            tenant=tenant)
        return self._new_entry(i, local, prompt_np, max_new_tokens,
                               temperature, deadline_s, tier, tenant, aff)

    def _replay_submit(self, replay, remaining: int,
                       e: _PoolEntry) -> tuple[int, int]:
        """Unfinished work goes back through a prefill replica as a new
        migrate-out leg, or symmetrically when a whole role is dead."""
        alive = self._alive()
        pref = self._role_replicas("prefill", alive)
        dec = self._role_replicas("decode", alive)
        if pref and dec and remaining > 1:
            j = min(pref, key=self._route_key)
            return j, self.replicas[j].submit(
                replay, 1, e.temperature, migrate_out=True, tier=e.tier,
                tenant=e.tenant)
        j = min(alive, key=self._route_key)
        return j, self.replicas[j].submit(replay, remaining, e.temperature,
                                          tier=e.tier, tenant=e.tenant)

    def _finish(self, replica: int, r: _Request, done: list) -> None:
        """A prefill replica's finisher whose budget is not met is a
        hand-off: its export queues for a decode replica.  Everything else
        (decode finishers, one-token requests, an EOS first token, failed
        requests) completes as in the symmetric pool."""
        rid = self._local.get((replica, r.rid))
        if (rid is not None and self.roles[replica] == "prefill"
                and r.error is None):
            e = self._entries[rid]
            eng = self.replicas[replica]
            exp = eng.take_export(r.rid)
            hit_eos = (eng.eos_id is not None and r.tokens
                       and r.tokens[-1] == eng.eos_id)
            needs_more = e.max_new > len(e.prefix) + len(r.tokens)
            if needs_more and not hit_eos:
                self._local.pop((replica, r.rid))
                if exp is not None:
                    # the first token rides inside the export: e.prefix
                    # stays, so the budget stays exact
                    self._pending_migrations.append((rid, exp))
                else:
                    # no chain (a degraded-mode leg landed here): bank the
                    # tokens and replay the rest
                    e.prefix = e.prefix + list(r.tokens)
                    remaining = e.max_new - len(e.prefix)
                    replay = np.concatenate(
                        [e.prompt, np.asarray(e.prefix, np.int64)])
                    try:
                        j, new_local = self._replay_submit(
                            replay, remaining, e)
                    except ValueError as err:
                        self._fail_entry(e, f"replay rejected: {err}", done)
                        return
                    e.replica, e.local = j, new_local
                    self._local[(j, new_local)] = rid
                return
        super()._finish(replica, r, done)

    def _drain_migrations(self, done: list) -> None:
        """Hand every pending export to the least-loaded decode replica
        (any live one when the decode role is dead); a full or dying
        decode side defers it to the next step, a rejected chain fails its
        request."""
        if not self._pending_migrations:
            return
        alive = self._alive()
        dec = self._role_replicas("decode", alive) or alive
        pending, self._pending_migrations = \
            self._pending_migrations, deque()
        for rid, exp in pending:
            e = self._entries.get(rid)
            if e is None:
                continue   # cancelled or expired in flight
            if not dec:
                self._fail_entry(
                    e, "no healthy replicas left for migration", done)
                continue
            j = min(dec, key=self._route_key)
            eng = self.replicas[j]
            remaining = e.max_new - len(e.prefix)
            sp = None
            if self._tracer is not None:
                sp = self._tracer.start_span(
                    "request.migrate", parent=eng._engine_anchor,
                    attrs={"rid": rid, "pages": exp["pages"],
                           "to_replica": j})
            t0 = time.perf_counter()
            try:
                local = eng.import_chain(exp, remaining, e.temperature,
                                         tier=e.tier, tenant=e.tenant)
            except ReplicaDeadError:
                local, outcome = None, "replica_dead"
            except ValueError as err:
                self._fail_entry(e, f"migration rejected: {err}", done)
                if sp is not None:
                    sp.set_attr("outcome", "rejected")
                    sp.end()
                continue
            else:
                outcome = "deferred"
            if local is None:
                self._pending_migrations.append((rid, exp))
                if sp is not None:
                    sp.set_attr("outcome", outcome)
                    sp.end()
                continue
            dt = (time.perf_counter() - t0) * 1e3
            self.migrations += 1
            self.migrated_pages += int(exp["pages"])
            self.migration_ms.append(dt)
            _trim_acct(self.migration_ms)
            if self._metrics is not None:
                self._metrics.inc("serve_migrated_pages_total",
                                  float(exp["pages"]))
                self._metrics.observe("serve_migration_ms", dt)
            if sp is not None:
                sp.set_attr("outcome", "migrated")
                sp.set_attr("ms", round(dt, 3))
                sp.end()
            e.replica, e.local = j, local
            self._local[(j, local)] = rid

    def step(self) -> list[_Request]:
        done = super().step()
        self._drain_migrations(done)
        return done
