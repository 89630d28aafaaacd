"""Continuous batching over a paged KV pool (counterpart of the paged,
greedy core of ``kubegpu_tpu/models/serve.py``).

The KV history lives in a page pool ``[L, n_pages, Hkv, P, D]`` shared by
every slot; page 0 is a trash page that is never allocated.  A request is
prefilled in a wave (a ``[k, bucket]`` batch of same-bucket prompts), its
prompt K/V copied page by page into the pages it was given, and then every
engine tick runs ``stride`` decode steps for all slots: the flushed history
through the paged-attention kernel, this block's keys through a dense write
buffer, merged as flash-decoding partials.  At the end of the block the
buffer is flushed into each row's current decode page.

The reference's executables (``decode_block``, ``prefill_wave``,
``adopt_wave``) are plain functions here; its ``lax.scan`` over the stride
steps is a Python loop.  The pool and the per-slot device vectors are
updated IN PLACE (the reference donates and rebinds them).

Tokens are greedy and bit-identical to a solo :func:`greedy_generate` at
the tested f32 configurations; at other batch shapes a near-tied argmax
may flip, as the reference documents.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from kubegpu_tpu_torch.models.decode import (
    _attend_buffer_partials,
    _attn_finish,
    _forward_with_cache,
    _project_qkv,
    init_kv_cache,
)
from kubegpu_tpu_torch.models.llama import (
    LlamaConfig,
    _rmsnorm,
    embed_lookup,
    layer_params,
)
from kubegpu_tpu_torch.ops.paged_attention import (
    merge_partials,
    page_table_size,
    paged_attention,
)

# Largest prefill wave (the reference's ``max_wave`` default).
MAX_WAVE = 8

# Reference knobs this slice does not port: name -> (default, ROADMAP.md
# queue-1 item that brings it).  A non-default value raises.
_LATER = {
    "paged": (True, "the dense slot engine (paged=False)"),
    "sampling": (False, "sampling"),
    "seed": (0, "sampling"),
    "top_k": (0, "sampling"),
    "kv_int8": (False, "KV quantization + eviction"),
    "kv_bits": (None, "KV quantization + eviction"),
    "kv_group": (None, "KV quantization + eviction"),
    "evict_policy": (None, "KV quantization + eviction"),
    "evict_param": (None, "KV quantization + eviction"),
    "prefix_cache": (False, "prefix cache and chunked prefill"),
    "chunked_prefill": (False, "prefix cache and chunked prefill"),
    "prefill_chunk": (None, "prefix cache and chunked prefill"),
    "spec_gamma": (0, "speculative decode and fused ticks"),
    "draft_layers": (None, "speculative decode and fused ticks"),
    "fused_ticks": (1, "speculative decode and fused ticks"),
    "eos_id": (None, "speculative decode and fused ticks"),
    "collect_overlap": (False, "speculative decode and fused ticks"),
    "mesh": (None, "multi-device"),
    "chaos": (None, "pools, fleet and llama_serve"),
    "tick_deadline_s": (None, "pools, fleet and llama_serve"),
    "tenant_quotas": (None, "pools, fleet and llama_serve"),
    "metrics": (None, "pools, fleet and llama_serve"),
    "tracer": (None, "pools, fleet and llama_serve"),
    "trace_ctx": (None, "pools, fleet and llama_serve"),
}


def _pick_token(logits: torch.Tensor) -> torch.Tensor:
    """Greedy selection (the only branch of the reference's per-slot pick
    this slice serves)."""
    return logits.argmax(dim=-1)


def _paged_row_step(params: dict, tokens: torch.Tensor, pool: dict,
                    pt: torch.Tensor, tvec: torch.Tensor, tpad: torch.Tensor,
                    d0: torch.Tensor, buf: dict, pos: torch.Tensor, j: int,
                    cfg: LlamaConfig) -> torch.Tensor:
    """One decode step for every slot against the paged pool: flushed
    history via the paged kernel, this block's keys via the write buffer
    (written in place at index ``j``), merged with the flash-decoding
    logsumexp merge.  Returns next-token logits [B, V] f32."""
    x = embed_lookup(params["embed"], tokens)[:, None, :]        # [B,1,D]
    positions = pos[:, None]
    for li in range(cfg.n_layers):
        lp = layer_params(params, li)
        h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(h, lp, cfg, positions)            # [B,H,1,D]
        bk, bv = buf["k"][li], buf["v"][li]
        bk[:, :, j] = k[:, :, 0].to(bk.dtype)
        bv[:, :, j] = v[:, :, 0].to(bv.dtype)
        o_p, m_p, l_p = paged_attention(
            q[:, :, 0, :].contiguous(), pool["k"], pool["v"], pt, li, tvec,
            tpad, d0)
        o_b, m_b, l_b = _attend_buffer_partials(q, bk, bv, j)
        o = merge_partials(o_p, m_p, l_p, o_b, m_b, l_b)
        x = _attn_finish(x, o[:, :, None, :].to(x.dtype), lp, cfg)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()[:, 0]


def _flush_buffer_paged(pool: dict, buf: dict, pt: torch.Tensor,
                        tpad: torch.Tensor, d0: torch.Tensor,
                        page_size: int) -> None:
    """Scatter the block buffer [L, B, Hkv, stride, D] into each row's
    CURRENT decode page of the pool, IN PLACE.  The decode region is
    page-aligned and stride divides P, so a block never splits a page.
    Retired rows carry a zeroed page-table row, so their garbage lands in
    trash page 0; the page-index clamp keeps stale positions in the
    table."""
    stride = buf["k"].shape[3]
    phys0 = tpad + d0
    pidx = torch.clamp(phys0 // page_size, 0, pt.shape[1] - 1)
    page = pt.gather(1, pidx[:, None].long())                    # [B, 1]
    off = (phys0 % page_size)[:, None] + torch.arange(
        stride, device=pt.device)                                # [B, stride]
    page = page.long().expand_as(off)
    for name in ("k", "v"):
        # advanced indices around a slice: value dims are [B, stride, L, Hkv, D]
        pool[name][:, page, :, off.long(), :] = \
            buf[name].permute(1, 3, 0, 2, 4).to(pool[name].dtype)


@torch.no_grad()
def decode_block(params: dict, pool: dict, pt, tvec, tpad,
                 tokens: torch.Tensor, pos: torch.Tensor,
                 active: torch.Tensor, cfg: LlamaConfig, stride: int):
    """``stride`` decode steps for every slot, then the buffer flush.
    ``tokens``/``pos`` advance in place for active rows; the flushed
    decode count is ``pos - tvec`` for active rows and 0 for inactive
    ones.  Returns (token block [stride, B], per-slot non-finite flag)."""
    d0 = torch.where(active, pos - tvec, torch.zeros_like(pos)).to(torch.int32)
    n_layers, _, hkv, _, hd = pool["k"].shape
    b = tokens.shape[0]
    buf = {n: torch.zeros((n_layers, b, hkv, stride, hd), dtype=cfg.tdtype,
                          device=tokens.device) for n in ("k", "v")}
    bad = torch.zeros(b, dtype=torch.bool, device=tokens.device)
    block = []
    for j in range(stride):
        logits = _paged_row_step(params, tokens, pool, pt, tvec, tpad, d0,
                                 buf, pos, j, cfg)
        bad |= ~torch.isfinite(logits).all(dim=-1)
        nxt = torch.where(active, _pick_token(logits), tokens)
        tokens.copy_(nxt)
        pos.add_(active.to(pos.dtype))
        block.append(nxt)
    _flush_buffer_paged(pool, buf, pt, tpad, d0, pool["k"].shape[3])
    return torch.stack(block), bad


@torch.no_grad()
def prefill_wave(params: dict, padded_prompts: torch.Tensor,
                 true_lens: torch.Tensor, cfg: LlamaConfig):
    """Batch-k prefill of bucket-padded prompts into a dense
    [L, k, Hkv, bucket, D] panel; returns (first tokens [k], panel)."""
    k, bucket = padded_prompts.shape
    cache_w = init_kv_cache(cfg, k, bucket, device=padded_prompts.device)
    logits, cache_w = _forward_with_cache(params, padded_prompts, cache_w, 0,
                                          cfg)
    last = logits[torch.arange(k, device=logits.device), true_lens - 1]
    return _pick_token(last), cache_w


@torch.no_grad()
def adopt_wave(pool: dict, cache_w: dict, page_dst: torch.Tensor,
               slots: torch.Tensor, firsts: torch.Tensor,
               plens: torch.Tensor, first_toks: torch.Tensor,
               tokens: torch.Tensor, pos: torch.Tensor,
               page_size: int) -> None:
    """Admit a wave IN PLACE: copy each row's prompt panel page by page
    into its pool pages (``page_dst`` [k, bucket/P] page ids) and set the
    slots' first token, current token and position."""
    n_layers, k, hkv, bucket, hd = cache_w["k"].shape
    npp = bucket // page_size
    dst = page_dst.reshape(-1).long()
    for name in ("k", "v"):
        pages = cache_w[name].view(n_layers, k, hkv, npp, page_size, hd) \
            .permute(0, 1, 3, 2, 4, 5).reshape(n_layers, k * npp, hkv,
                                               page_size, hd)
        pool[name][:, dst] = pages.to(pool[name].dtype)
    first_toks[slots] = firsts
    tokens[slots] = firsts
    pos[slots] = plens.to(pos.dtype)


class _AdmissionQueue(deque):
    """The admission queue with an incremental queued-prompt-token total
    (``prompt_tokens``).  Items are ``(request, padded_prompt)`` pairs."""

    def __init__(self, items=()):
        super().__init__()
        self.prompt_tokens = 0
        for item in items:
            self.append(item)

    def append(self, item) -> None:
        super().append(item)
        self.prompt_tokens += item[0].prompt_len

    def popleft(self):
        item = super().popleft()
        self.prompt_tokens -= item[0].prompt_len
        return item


@dataclass
class _Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    tokens: list[int] = field(default_factory=list)   # generated so far
    done: bool = False
    prompt: object = None        # np.ndarray, set at submit
    admit_len: int = 0

    @property
    def remaining_new(self) -> int:
        return self.max_new_tokens - len(self.tokens)


class ContinuousBatcher:
    """Slot-based continuous-batching engine over a paged KV pool
    (greedy).  ``submit()`` enqueues a request; ``step()`` collects the
    previous tick's token block, retires finishers, admits queued
    requests into free slots (prefill waves), and dispatches the next
    stride block for every slot; ``drain()`` runs to completion.
    ``warmup()`` runs every shape once on scratch state, before a timed
    window.

    Knobs of the reference engine outside this slice raise
    ``NotImplementedError`` naming their ROADMAP.md item."""

    def __init__(self, params: dict, cfg: LlamaConfig, n_slots: int = 8,
                 max_len: int | None = None, stride: int = 16,
                 prompt_buckets: tuple[int, ...] = (128, 512, 1024),
                 paged: bool = False, page_size: int = 128,
                 total_pages: int | None = None,
                 debug_invariants: bool = False, device="cuda", **later):
        later["paged"] = paged
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"unexpected keyword argument {name!r}")
            default, item = _LATER[name]
            if value != default:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet "
                    f"(ROADMAP.md queue 1: {item})")
        self.device = torch.device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len or cfg.max_seq_len
        self.stride = stride
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        if self.prompt_buckets[-1] >= self.max_len:
            raise ValueError("largest prompt bucket must be < max_len")
        if page_size % stride:
            raise ValueError(f"page_size {page_size} must be a multiple of "
                             f"stride {stride} (block flushes must not "
                             "split a page)")
        if any(b % page_size for b in self.prompt_buckets):
            raise ValueError(f"prompt buckets {self.prompt_buckets} must be "
                             f"multiples of page_size {page_size}")
        self.page_size = page_size
        self.max_pages = page_table_size(
            self.prompt_buckets[-1] + self.max_len, page_size)
        self.total_pages = (total_pages if total_pages is not None
                            else n_slots * self.max_pages)
        self.debug_invariants = bool(debug_invariants)
        shape = (cfg.n_layers, self.total_pages + 1, cfg.n_kv_heads,
                 page_size, cfg.head_dim)
        self.pool = {n: torch.zeros(shape, dtype=cfg.tdtype,
                                    device=self.device) for n in ("k", "v")}
        self._free_pages = list(range(1, self.total_pages + 1))
        self._page_refs: dict[int, int] = {}
        self._pt = np.zeros((n_slots, self.max_pages), np.int32)
        self._tvec = np.zeros((n_slots,), np.int32)
        self._tpad = np.zeros((n_slots,), np.int32)
        self._slot_pages: dict[int, list[int]] = {}
        self._tables_dirty = True
        self._pt_dev = self._tvec_dev = self._tpad_dev = None
        self.tokens = torch.zeros(n_slots, dtype=torch.long,
                                  device=self.device)
        self.pos = torch.zeros(n_slots, dtype=torch.int32, device=self.device)
        self.first_toks = torch.zeros(n_slots, dtype=torch.long,
                                      device=self.device)
        self.active = np.zeros((n_slots,), bool)
        self.slot_req: dict[int, _Request] = {}
        self.queue = _AdmissionQueue()
        self._inflight: torch.Tensor | None = None
        self._await_first: set[int] = set()
        self._next_rid = 0
        self._tick = 0
        self.emitted_tokens = 0      # all generated tokens (incl. first)
        self._decode_tokens = 0      # tokens produced by decode steps
        self.slot_steps = 0          # decode slot-steps spent
        # k of each recent wave (a bounded window, as the reference trims it)
        self.wave_sizes: deque[int] = deque(maxlen=32768)

    # -- requests -------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0) -> int:
        """Enqueue a request (``prompt``: 1-D int sequence); greedy only."""
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if temperature != 0.0:
            raise NotImplementedError(
                "temperature > 0 is not ported yet (ROADMAP.md queue 1: "
                "sampling)")
        prompt_np = np.asarray(prompt, np.int64)
        t = int(prompt_np.shape[0])
        if t < 1:
            raise ValueError("prompt must have at least one token")
        bucket = next((b for b in self.prompt_buckets if b >= t), None)
        if bucket is None:
            raise ValueError(f"prompt length {t} exceeds largest bucket "
                             f"{self.prompt_buckets[-1]}")
        if t + max_new_tokens + self.stride > self.max_len:
            raise ValueError(
                f"prompt {t} + max_new {max_new_tokens} + overhang "
                f"{self.stride} (stride) > max_len {self.max_len}")
        need = self._pages_needed(max_new_tokens, bucket)
        if need > self.total_pages:
            raise ValueError(
                f"request needs {need} pages (bucket {bucket} + "
                f"{max_new_tokens} new tokens) but the pool has only "
                f"{self.total_pages}")
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :t] = prompt_np
        req = _Request(rid=self._next_rid, prompt_len=t,
                       max_new_tokens=max_new_tokens, prompt=prompt_np,
                       admit_len=t)
        self._next_rid += 1
        self.queue.append((req, padded))
        return req.rid

    # -- pages ----------------------------------------------------------

    def _pages_needed(self, max_new_tokens: int, bucket: int) -> int:
        """Pool pages a request holds for its lifetime: its prompt bucket
        plus the decode extent its full stride blocks flush."""
        blocks = -(-(max_new_tokens - 1) // self.stride)
        dec_pages = -(-(blocks * self.stride) // self.page_size)
        return bucket // self.page_size + dec_pages

    def _alloc_pages(self, n: int) -> list[int]:
        """Claim n free pages at refcount 1 (the admission gate guarantees
        they exist)."""
        if n > len(self._free_pages):
            raise RuntimeError("page pool exhausted past the admission gate")
        out = [self._free_pages.pop() for _ in range(n)]
        for p in out:
            self._page_refs[p] = 1
        return out

    def _release_pages(self, slot: int) -> None:
        """Return the slot's pages and zero its table row and length
        scalars, so its per-block garbage flush retargets trash page 0."""
        for p in self._slot_pages.pop(slot, []):
            self._page_refs[p] -= 1
            if self._page_refs[p] == 0:
                del self._page_refs[p]
                self._free_pages.append(p)
        self._pt[slot, :] = 0
        self._tvec[slot] = self._tpad[slot] = 0
        self._tables_dirty = True

    def _sync_tables(self) -> None:
        if self._tables_dirty:
            self._pt_dev = torch.from_numpy(self._pt).to(self.device)
            self._tvec_dev = torch.from_numpy(self._tvec).to(self.device)
            self._tpad_dev = torch.from_numpy(self._tpad).to(self.device)
            self._tables_dirty = False

    # -- the engine tick ------------------------------------------------

    def _admit(self) -> None:
        """Wave admission: consecutive queue-front requests sharing one
        prompt bucket prefill as one [k, bucket] batch (k a power of two,
        shrunk until the wave's pages fit).  FIFO: a request waiting for
        pages blocks everything behind it."""
        free = deque(s for s in range(self.n_slots) if s not in self.slot_req)
        while free and self.queue:
            req0, p0 = self.queue[0]
            bucket = p0.shape[1]
            if (self._pages_needed(req0.remaining_new, bucket)
                    > len(self._free_pages)):
                break
            n_same = 1
            for _, p in list(self.queue)[1:min(len(self.queue), len(free))]:
                if p.shape[1] != bucket:
                    break
                n_same += 1
            k = 1
            while k * 2 <= min(n_same, len(free), MAX_WAVE):
                k *= 2
            while k > 1 and sum(
                    self._pages_needed(r.remaining_new, bucket)
                    for r, _ in list(self.queue)[:k]) > len(self._free_pages):
                k //= 2
            wave = [self.queue.popleft() for _ in range(k)]
            slots = [free.popleft() for _ in range(k)]
            padded = torch.from_numpy(
                np.concatenate([p for _, p in wave])).to(self.device)
            true_lens = torch.tensor([r.admit_len for r, _ in wave],
                                     device=self.device)
            firsts, cache_w = prefill_wave(self.params, padded, true_lens,
                                           self.cfg)
            self.wave_sizes.append(k)
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
                page_dst[i] = pages[:n_prompt_pages]
            self._tables_dirty = True
            adopt_wave(self.pool, cache_w,
                       torch.from_numpy(page_dst).to(self.device),
                       torch.tensor(slots, device=self.device), firsts,
                       true_lens, self.first_toks, self.tokens, self.pos,
                       self.page_size)
            for slot, (req, _) in zip(slots, wave):
                remaining = req.remaining_new
                self.active[slot] = remaining > 1
                self.slot_req[slot] = req
                self._await_first.add(slot)
                self.emitted_tokens += 1
                if remaining <= 1:
                    req.done = True

    def warmup(self) -> None:
        """Run every shape this engine can hit -- each power-of-two wave
        size per prompt bucket through prefill and adoption, then one
        decode block -- on scratch copies of the pool and slot vectors, so
        no engine state or counter changes.  Call it before a timed
        window: otherwise the first call at each shape (cuBLAS's algorithm
        choice, the caching allocator's growth) lands inside it."""
        scratch = {n: torch.zeros_like(x) for n, x in self.pool.items()}
        sft, stok = (torch.zeros_like(self.first_toks),
                     torch.zeros_like(self.tokens))
        spos = torch.zeros_like(self.pos)
        for bucket in self.prompt_buckets:
            k = 1
            while k <= min(self.n_slots, MAX_WAVE):
                lens = torch.ones(k, dtype=torch.long, device=self.device)
                firsts, cache_w = prefill_wave(
                    self.params, torch.zeros((k, bucket), dtype=torch.long,
                                             device=self.device),
                    lens, self.cfg)
                # page ids 0: every prompt page lands in the trash page
                adopt_wave(scratch, cache_w,
                           torch.zeros((k, bucket // self.page_size),
                                       dtype=torch.long, device=self.device),
                           torch.arange(k, device=self.device), firsts, lens,
                           sft, stok, spos, self.page_size)
                k *= 2
        self._sync_tables()
        decode_block(self.params, scratch, self._pt_dev, self._tvec_dev,
                     self._tpad_dev, stok, spos,
                     torch.from_numpy(self.active).to(self.device), self.cfg,
                     self.stride)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dispatch_tick(self) -> None:
        """Dispatch one stride block for the current slot state and keep
        one fused device tensor (token block, per-slot bad flags, pending
        first tokens) for the next tick's single host fetch."""
        self._sync_tables()
        active = torch.from_numpy(self.active).to(self.device)
        block, bad = decode_block(
            self.params, self.pool, self._pt_dev, self._tvec_dev,
            self._tpad_dev, self.tokens, self.pos, active, self.cfg,
            self.stride)
        self._inflight = torch.cat([block.reshape(-1), bad.long(),
                                    self.first_toks])
        self._tick += 1

    def step(self) -> list[_Request]:
        """One engine tick: collect the previous block, retire finishers,
        admit into freed slots, dispatch the next block (without waiting
        for it).  Returns the requests that finished."""
        finished = self._collect()
        self._admit()
        if self.slot_req:
            self._dispatch_tick()
        if self.debug_invariants:
            self.check_page_invariants()
        return finished

    def _collect(self) -> list[_Request]:
        if self._inflight is None:
            return []
        fused = self._inflight.cpu().numpy()    # THE host sync
        self._inflight = None
        return self._consume(fused)

    def _consume(self, fused: np.ndarray) -> list[_Request]:
        """Account one fetched block: ``[stride·B token block, B bad
        flags, B first tokens]``."""
        finished: list[_Request] = []
        nb = self.stride * self.n_slots
        block_np = fused[:nb].reshape(self.stride, self.n_slots)
        bad_np = fused[nb:nb + self.n_slots]
        firsts_np = fused[nb + self.n_slots:]
        self.slot_steps += nb
        for slot, req in list(self.slot_req.items()):
            if slot in self._await_first:
                req.tokens.append(int(firsts_np[slot]))
                self._await_first.discard(slot)
            if req.done:   # single-token request: retires without decode
                self._retire(slot, req, finished)
                continue
            if bad_np[slot]:
                raise RuntimeError(
                    f"non-finite logits in slot {slot} (rid {req.rid}); "
                    "quarantine and replay are not ported yet (ROADMAP.md "
                    "queue 1: pools, fleet and llama_serve)")
            take = min(self.stride, req.max_new_tokens - len(req.tokens))
            req.tokens.extend(int(x) for x in block_np[:take, slot])
            self.emitted_tokens += take
            self._decode_tokens += take
            if len(req.tokens) >= req.max_new_tokens:
                self._retire(slot, req, finished)
        return finished

    def _retire(self, slot: int, req: _Request,
                finished: list[_Request]) -> None:
        req.done = True
        finished.append(req)
        del self.slot_req[slot]
        self.active[slot] = False
        self._release_pages(slot)

    def drain(self, max_ticks: int = 10_000) -> list[_Request]:
        """Run until queue and slots are empty; returns every finished
        request in completion order."""
        out: list[_Request] = []
        for _ in range(max_ticks):
            if not self.queue and not self.slot_req:
                return out
            out.extend(self.step())
        raise RuntimeError(f"drain did not converge after {max_ticks} ticks")

    def check_page_invariants(self) -> None:
        """Page-leak detector: free and allocated pages partition
        {1..total_pages}, trash page 0 is in neither, every allocated page
        has exactly its owners as refcount, and each table row matches
        its slot's pages (retired rows are all zero)."""
        def fail(msg: str) -> None:
            raise RuntimeError(f"page invariant violated: {msg}")

        allocated = set(self._page_refs)
        free = set(self._free_pages)
        if 0 in allocated or 0 in free:
            fail("trash page 0 allocated or free")
        if len(free) != len(self._free_pages):
            fail("a page is on the free list twice")
        if free & allocated:
            fail(f"pages both free and allocated: {sorted(free & allocated)}")
        if free | allocated != set(range(1, self.total_pages + 1)):
            fail("free ∪ allocated is not {1..total_pages}")
        owners: dict[int, int] = {}
        for pages in self._slot_pages.values():
            for p in pages:
                owners[p] = owners.get(p, 0) + 1
        for p in allocated:
            if self._page_refs[p] != owners.get(p, 0):
                fail(f"page {p}: refcount {self._page_refs[p]} != "
                     f"{owners.get(p, 0)} owners")
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
