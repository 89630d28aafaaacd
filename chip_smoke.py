#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs a CUDA card and ``nvcc``; it builds the port's kernels from
``kubegpu_tpu_torch/csrc`` into ``build/kernels/`` itself.  Phases, each
printed as it ends (any failed check exits non-zero):

1. device   — the card's name and power limit (nvidia-smi);
2. build    — every kernel, one nvcc per source, all at once;
3. kernels  — each kernel against its plain PyTorch version on the card at
   its path's shapes (bf16) and at small f32 edge cases, with times, the
   card's bound and a library yardstick where one call computes the same
   function: flash forward, paged decode over bf16, int8 and packed-int4
   pages (kernels 4-6, each also with its per-page attention mass; two
   launches must give equal bits, and on a bf16 case with V = 1 each must
   round its P.V weights as the plain version does, within 1e-5), the
   biased paged decode of the T5 decoder (kernel 7, at T5 v1.1-base's
   serving shape; two launches must give equal bits), and the flash
   backward's dq and dk/dv kernels (at the training shape, [4, 32, 2048,
   128]).  Kernels 1-3 run their tensor-core instances in bf16 (TFLOP/s
   and share of the bound printed at each shape; dq and dk/dv must give
   equal bits on two launches) and their CUDA-core instances in the f32
   edge cases;
4. forward  — ``llama_forward`` at Llama-3-8B full width, bf16, [1, 512];
5. serving  — the paged ``ContinuousBatcher`` at the same width:
   ``warmup()``, then five timed windows of 12 staggered requests (median
   tokens/s);
5b. quantized serving — the same engine with int8 pages, int4 pages, and
   int4 pages with mass eviction, in turn: ``warmup()`` and two windows
   each (the first on phase 5's first prompts: the share of greedy tokens
   equal to the bf16 engine's is printed), every request finished, no page
   leaked, pages evicted, the pool's bytes per format;
6. parity   — a narrow f32 engine token for token against the port's own
   ``greedy_generate``, and the full-width first decode step's logits
   against the plain dense path;
7. training — Llama-3-8B at full width cut to 8 layers (remat on), bf16:
   first one step's loss and gradients at batch 1 through the kernels
   against ``attn_impl="plain"``, then ``make_train_step`` with the port's
   ``adamw(1e-3)`` on one [4, 2048] batch: one warm step and three timed
   steps (median step ms, tokens/s, model-FLOP utilisation, peak memory,
   falling losses);
8. t5       — T5 v1.1-base at full width (``T5Config()``), bf16: the dense
   and the paged greedy generate on 8 encoder inputs of 512 tokens, 384
   decode steps over pages of 128 (one warm call, then the median of three
   timed calls each; the paged one runs kernel 7 once per decoder layer and
   step); parity of the paged tokens with the dense ones on a narrow f32
   config and of the full-width paged step's logits with the dense step's
   after two flushed pages; ``make_t5_train_step`` with ``adamw(1e-3)`` on
   one fixed batch (encoder [8, 512], decoder [8, 128]): one warm and three
   timed steps.

Four paths are driven: serving (phases 4-5), quantized serving (5b),
training (phase 7's steps) and T5 paged serving (phase 8's paged calls).
Launch counters are zeroed just before each and read just after; the
serving and training paths must run kernels 1-3 on their tensor-core
instances only.  The line before the last is one JSON object per kernel;
the last line is ``{"ok": true, "device": {...}}``.
``--details PATH`` writes every phase's numbers to PATH as JSON.  With
``--profile`` it also traces one steady tick of the bf16 engine after phase
5 and of the int8 engine in phase 5b, and one train step after phase 7
(device time by kernel, idle share).
"""

from __future__ import annotations

import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

# H100 SXM published peaks (dense): HBM bytes/s and FLOP/s by input type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SEED = 0
# cuBLAS's GEMM kernels by name (nvjet on Hopper, older sm90 xmma/cutlass)
GEMM_KERNEL = re.compile(r"nvjet|gemm|xmma|cutlass", re.IGNORECASE)
# the port's kernels in a trace, by a piece of their (demangled) names
PORT_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_split")


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` with a cold L2, over ``reps``
    launches, each between two CUDA events.  Before each launch a 256 MB
    buffer is zeroed, which evicts the card's 50 MB L2 as the main path's
    weight reads do between two attention calls.  The card first spins in
    ``torch.cuda._sleep`` while the host enqueues all of it, so the events
    time the device alone and not the host's launch rate; if the spin
    ended before the host was done (the first event already passed), it
    doubles and the timing is taken again."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    cycles = 1 << 25
    for _ in range(8):
        evs = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
               for _ in range(reps)]
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        for start, end in evs:
            flush.zero_()
            start.record()
            fn()
            end.record()
        queued_in_time = not evs[0][0].query()
        torch.cuda.synchronize()
        if queued_in_time:
            return sum(s.elapsed_time(e) for s, e in evs) / reps
        cycles *= 2
    raise SmokeFailure("cuda_ms: the host never got ahead of the device")


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# -- phase 3: kernels against their plain versions -------------------------

def flash_checks(torch, gen) -> dict:
    fa = importlib.import_module("kubegpu_tpu_torch.ops.flash_attention")
    dev = "cuda"
    out = {}
    # the forward's shape: [1, 32, 512, 128] vs [1, 8, 512, 128], causal
    q = torch.randn(1, 32, 512, 128, generator=gen, device=dev).bfloat16()
    k = torch.randn(1, 8, 512, 128, generator=gen, device=dev).bfloat16()
    v = torch.randn(1, 8, 512, 128, generator=gen, device=dev).bfloat16()
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    ref = fa.xla_attention(q, k, v, causal=True)
    ref_lse = fa._xla_lse(q, k, True, 128 ** -0.5)
    torch.cuda.synchronize()
    err, lse_err = max_err(o, ref), max_err(lse, ref_lse)
    # bf16: the plain version rounds probabilities to bf16 before P.V and
    # both round the output; lse is f32 on both sides
    check(err <= 2e-2, f"flash bf16 max |err| {err} > 2e-2")
    check(lse_err <= 1e-3, f"flash bf16 lse max |err| {lse_err} > 1e-3")
    log("kernels", kernel="flash_fwd", case="bf16 [1,32,512,128] causal",
        max_abs_err=err, tol=2e-2, lse_err=lse_err, lse_tol=1e-3)
    out["max_abs_err"] = err
    # f32 edge cases: ragged T/S, end-aligned causal, non-causal, group 4,
    # and head dims that run the padded instances (16: LlamaConfig.tiny())
    for causal, t, s, hd in ((True, 37, 70, 64), (False, 64, 40, 64),
                             (True, 33, 33, 64), (True, 37, 70, 16),
                             (False, 20, 45, 80)):
        qf = torch.randn(2, 8, t, hd, generator=gen, device=dev)
        kf = torch.randn(2, 2, s, hd, generator=gen, device=dev)
        vf = torch.randn(2, 2, s, hd, generator=gen, device=dev)
        of, lf = fa.flash_attention(qf, kf, vf, causal=causal,
                                    return_lse=True)
        e = max(max_err(of, fa.xla_attention(qf, kf, vf, causal)),
                max_err(lf, fa._xla_lse(qf, kf, causal, hd ** -0.5)))
        check(e <= 1e-4, f"flash f32 t={t} s={s} hd={hd} causal={causal}: "
              f"{e}")
        log("kernels", kernel="flash_fwd",
            case=f"f32 [2,8,{t},{hd}] s={s} causal={causal}",
            max_abs_err=e, tol=1e-4)
    # times at the forward's shape
    out["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    out["plain_ms"] = cuda_ms(lambda: fa.xla_attention(q, k, v, True))
    try:
        import torch.nn.functional as F
        out["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    except (TypeError, RuntimeError) as exc:   # older torch: no GQA call
        log("kernels", kernel="flash_fwd", library="unavailable",
            why=type(exc).__name__)
        out["library_ms"] = None
    pairs = sum(min(512, i + 1) for i in range(512))
    n_bytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2
    out["bound_ms"], out["bound_by"] = bound_ms(
        n_bytes, 4 * 32 * 128 * pairs, q.dtype)
    rate_line(out, 4 * 32 * 128 * pairs, "flash_fwd", "serving shape "
              "[1,32,512,128]")
    return out


def rate_line(r: dict, flops: float, kernel: str, case: str) -> None:
    """Adds a kernel time's FLOP rate and its share of the bound to ``r``
    and prints them."""
    r["tflops_per_s"] = flops / (r["ms"] * 1e-3) / 1e12
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    log("kernels", kernel=kernel, case=case, ms=r["ms"],
        tflops_per_s=r["tflops_per_s"], bound_ms=r["bound_ms"],
        share_of_bound=r["share_of_bound"])


def causal_pairs(t: int, s: int) -> int:
    """(query, key) pairs the end-aligned causal mask keeps."""
    return sum(min(s, i + 1 + s - t) for i in range(t))


def rel_err(got, ref) -> float:
    """Max |err| over max |ref|: gradients have no natural unit."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1e-30)).item()


def flash_bwd_checks(torch, gen) -> dict:
    """Kernels 2 (dq) and 3 (dk, dv) against ``flash_attention_bwd_ref``,
    and kernel 1 against its plain version and timed at the training shape
    (its lse output on, as the training path calls it)."""
    fa = importlib.import_module("kubegpu_tpu_torch.ops.flash_attention")
    dev = "cuda"
    b, hq, hkv, t, d = 4, 32, 8, 2048, 128   # the 8B train step's shape
    q, do = (torch.randn(b, hq, t, d, generator=gen, device=dev).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, hkv, t, d, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    # kernel 1 at the training shape, held to the serving check's limits:
    # 2e-2 on |err| per unit of max(1, |ref|), since a bf16 rounding error
    # scales with the value and this shape's 16x more outputs reach larger
    # ones (a row over a few keys is near one value of v); 1e-3 on lse
    ref = fa.xla_attention(q, k, v, True)
    fwd = {"max_abs_err": max_err(out, ref),
           "scaled_err": ((out.float() - ref.float()).abs()
                          / ref.float().abs().clamp(min=1)).max().item(),
           "lse_err": max_err(lse, fa._xla_lse(q, k, True, d ** -0.5))}
    del ref
    check(fwd["scaled_err"] <= 2e-2, f"flash bf16 training shape max "
          f"|err| / max(1, |ref|) {fwd['scaled_err']} > 2e-2")
    check(fwd["lse_err"] <= 1e-3,
          f"flash bf16 training shape lse max |err| {fwd['lse_err']} > 1e-3")
    log("kernels", kernel="flash_fwd", case=f"bf16 [{b},{hq},{t},{d}] vs "
        f"[{b},{hkv},{t},{d}] causal, with lse", max_abs_err=fwd["max_abs_err"],
        scaled_err=fwd["scaled_err"], tol_scaled=2e-2, lse_err=fwd["lse_err"],
        lse_tol=1e-3)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True)
    dq = fa._flash_bwd_dq_cuda(*args)
    dk, dv = fa._flash_bwd_dkv_cuda(*args)
    rq, rk, rv = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    errs = {"dq": rel_err(dq, rq), "dk": rel_err(dk, rk),
            "dv": rel_err(dv, rv)}
    # bf16: both sides sum in f32 from the same bf16 inputs, in another
    # order, and round their outputs to bf16; two f32 sums on either side
    # of a rounding boundary land one bf16 ulp apart, at most 2^-7 of the
    # value
    check(max(errs.values()) <= 1e-2,
          f"flash bwd bf16 rel err {errs} > 1e-2")
    out_dq = {"max_abs_err": max_err(dq, rq)}
    out_dkv = {"max_abs_err": max(max_err(dk, rk), max_err(dv, rv))}
    # dq rows and the query group sum in registers, with no atomics: equal
    # bits
    dq2 = fa._flash_bwd_dq_cuda(*args)
    out_dq["bit_equal"] = bool(torch.equal(dq, dq2))
    check(out_dq["bit_equal"], "flash_bwd_dq: two launches differ")
    dk2, dv2 = fa._flash_bwd_dkv_cuda(*args)
    out_dkv["bit_equal"] = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
    check(out_dkv["bit_equal"], "flash_bwd_dkv: two launches differ")
    del dq2, dk2, dv2
    log("kernels", kernel="flash_bwd_dq+dkv",
        case=f"bf16 [{b},{hq},{t},{d}] vs [{b},{hkv},{t},{d}] causal",
        rel_err=errs, tol_rel=1e-2, dq_max_abs_err=out_dq["max_abs_err"],
        dkv_max_abs_err=out_dkv["max_abs_err"])
    del dq, dk, dv, rq, rk, rv
    # f32 edge cases: ragged T/S, end-aligned t < s, non-causal (t > s),
    # group 1 and group 4, head dims 16/80/128 (16 and 80 run the padded
    # instances)
    for causal, eq, ekv, et, es, ed in (
            (True, 8, 2, 37, 70, 128), (False, 8, 2, 64, 40, 128),
            (True, 4, 4, 33, 33, 16), (True, 8, 2, 29, 50, 80),
            (True, 4, 1, 48, 48, 64)):
        qf, dof = (torch.randn(2, eq, et, ed, generator=gen, device=dev)
                   for _ in range(2))
        kf, vf = (torch.randn(2, ekv, es, ed, generator=gen, device=dev)
                  for _ in range(2))
        of, lf = fa.flash_attention(qf, kf, vf, causal=causal,
                                    return_lse=True)
        fargs = (qf, kf, vf, dof, lf, (dof * of).sum(-1), causal)
        got = (fa._flash_bwd_dq_cuda(*fargs),
               *fa._flash_bwd_dkv_cuda(*fargs))
        ref = fa.flash_attention_bwd_ref(qf, kf, vf, of, lf, dof, causal)
        e = max(rel_err(a, r) for a, r in zip(got, ref))
        check(e <= 1e-4, f"flash bwd f32 hq={eq} hkv={ekv} t={et} s={es} "
              f"hd={ed} causal={causal}: rel err {e}")
        log("kernels", kernel="flash_bwd_dq+dkv",
            case=f"f32 [2,{eq},{et},{ed}] hkv={ekv} s={es} causal={causal}",
            rel_err=e, tol_rel=1e-4)
    out_dq["ms"] = cuda_ms(lambda: fa._flash_bwd_dq_cuda(*args))
    out_dkv["ms"] = cuda_ms(lambda: fa._flash_bwd_dkv_cuda(*args))
    # the plain version computes dq, dk and dv in one call: one time for
    # both rows
    plain = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse,
                                                       do, True), reps=5)
    out_dq["plain_ms"] = out_dkv["plain_ms"] = plain
    # the yardstick: autograd's backward of one SDPA call (one ATen
    # backward op for dq, dk and dv), its forward outside the window
    library = None
    try:
        import torch.nn.functional as F
        lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            enable_gqa=True)
        library = cuda_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True))
        del lo
    except (TypeError, RuntimeError) as exc:
        log("kernels", kernel="flash_bwd", library="unavailable",
            why=type(exc).__name__)
    out_dq["library_ms"] = out_dkv["library_ms"] = library
    pairs = b * hq * causal_pairs(t, t)
    io = (q.numel() + k.numel() + v.numel() + do.numel()) * 2 \
        + (lse.numel() + delta.numel()) * 4
    out_dq["bound_ms"], out_dq["bound_by"] = bound_ms(
        io + q.numel() * 2, 3 * 2 * d * pairs, q.dtype)
    out_dkv["bound_ms"], out_dkv["bound_by"] = bound_ms(
        io + 2 * k.numel() * 2, 4 * 2 * d * pairs, q.dtype)
    rate_line(out_dq, 3 * 2 * d * pairs, "flash_bwd_dq",
              f"training shape [{b},{hq},{t},{d}]")
    rate_line(out_dkv, 4 * 2 * d * pairs, "flash_bwd_dkv",
              f"training shape [{b},{hq},{t},{d}]")
    log("kernels", kernel="flash_bwd_dq+dkv", case="training shape, "
        "against one SDPA backward", ms=out_dq["ms"] + out_dkv["ms"],
        library_ms=library, perf_md_dq_ms_before=10.765)
    # the forward at the training shape (PERF.md's row 1 at this shape)
    fwd["ms"] = cuda_ms(lambda: fa.flash_attention(
        q, k, v, causal=True, return_lse=True))
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(
        (2 * q.numel() + k.numel() + v.numel()) * 2 + lse.numel() * 4,
        2 * 2 * d * pairs, q.dtype)
    fwd["plain_ms"] = cuda_ms(lambda: fa.xla_attention(q, k, v, True),
                              reps=5)
    fwd["library_ms"] = None
    try:
        import torch.nn.functional as F
        fwd["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    except (TypeError, RuntimeError) as exc:   # older torch: no GQA call
        log("kernels", kernel="flash_fwd", library="unavailable",
            why=type(exc).__name__)
    log("kernels", kernel="flash_fwd", case=f"training shape [{b},{hq},{t},"
        f"{d}] with lse", ms=fwd["ms"], plain_ms=fwd["plain_ms"],
        bound_ms=fwd["bound_ms"],
        bound_by=fwd["bound_by"], library_ms=fwd["library_ms"])
    rate_line(fwd, 2 * 2 * d * pairs, "flash_fwd",
              f"training shape [{b},{hq},{t},{d}]")
    return {"flash_bwd_dq": out_dq, "flash_bwd_dkv": out_dkv}, fwd


def paged_case(torch, gen, dtype, n_layers, n_pages, hkv, page, dim, hq,
               rows):
    """Build a pool and per-row state.  ``rows``: list of (pages, t,
    t_pad, d) with ``pages`` the row's table entries (0 = hole/unused)."""
    dev = "cuda"
    pk = torch.randn(n_layers, n_pages, hkv, page, dim, generator=gen,
                     device=dev).to(dtype)
    pv = torch.randn(n_layers, n_pages, hkv, page, dim, generator=gen,
                     device=dev).to(dtype)
    q = torch.randn(len(rows), hq, dim, generator=gen, device=dev).to(dtype)
    width = max(len(r[0]) for r in rows)
    pt = torch.tensor([r[0] + [0] * (width - len(r[0])) for r in rows],
                      dtype=torch.int32, device=dev)
    t, tpad, d = (torch.tensor([r[i] for r in rows], dtype=torch.int32,
                               device=dev) for i in (1, 2, 3))
    return q, pk, pv, pt, t, tpad, d


def paged_checks(torch, gen, slice_rows) -> dict:
    pa = importlib.import_module("kubegpu_tpu_torch.ops.paged_attention")
    out = {}
    # the serving shape: 8 rows, Llama-3-8B heads, the engine's pool
    args = paged_case(torch, gen, torch.bfloat16, 32, 41, 8, 128, 128, 32,
                      slice_rows)
    args = args[:4] + (31,) + args[4:]
    o, m, l = pa.paged_attention(*args)
    ro, rm, rl = pa.paged_attention_ref(*args)
    torch.cuda.synchronize()
    err = max_err(o, ro)
    m_err = max_err(m, rm)
    l_rel = ((l - rl).abs() / rl.clamp(min=1e-30)).max().item()
    check(err <= 1e-2, f"paged bf16 o max |err| {err} > 1e-2")
    check(m_err <= 1e-3 and l_rel <= 1e-3,
          f"paged bf16 m err {m_err} / l rel err {l_rel} > 1e-3")
    log("kernels", kernel="paged_decode", case="bf16 B=8 Hq=32 Hkv=8 P=128",
        max_abs_err=err, tol=1e-2, m_err=m_err, l_rel_err=l_rel)
    out["max_abs_err"] = err
    # f32 edge cases: GQA 4, a hole, an empty row, decode pages past
    # t_pad, folded queries Hq = 4 * Hkv * C with C = 2 and 4, and head
    # dims that run the padded instances
    rows = [([3, 7, 0, 0], 20, 32, 0),     # prompt over 2 pages
            ([5, 0, 9, 0], 40, 48, 0),     # hole at row-local page 1
            ([0, 0, 0, 0], 0, 0, 0),       # empty row
            ([2, 4, 6, 8], 10, 16, 40)]    # decode spans pages 1..3
    for hq, hd in ((8, 64), (16, 64), (32, 64), (8, 16), (4, 80)):
        fargs = paged_case(torch, gen, torch.float32, 2, 12, 2, 16, hd, hq,
                           rows)
        fargs = fargs[:4] + (1,) + fargs[4:]
        got, ref = pa.paged_attention(*fargs), pa.paged_attention_ref(*fargs)
        e = max(max_err(a, b) for a, b in zip(got, ref))
        check(e <= 1e-4, f"paged f32 hq={hq} hd={hd}: max |err| {e} > 1e-4")
        check(not got[0][2].any().item() and not got[2][2].any().item(),
              "paged: the empty row must give o = 0, l = 0")
        log("kernels", kernel="paged_decode",
            case=f"f32 hq={hq} hkv=2 hd={hd} P=16 holes/empty/decode",
            max_abs_err=e, tol=1e-4)
    out["ms"] = cuda_ms(lambda: pa.paged_attention(*args))
    out["plain_ms"] = cuda_ms(lambda: pa.paged_attention_ref(*args))
    out["library_ms"] = None   # no single PyTorch call reads a page table
    valid = sum(t + d for _, t, _, d in slice_rows)   # keys this data holds
    n_bytes = (valid * 8 * 128 * 2 * 2            # K and V of valid keys
               + 8 * 32 * 128 * 2                 # q
               + sum(len(r[0]) for r in slice_rows) * 4 + 3 * 8 * 4
               + 8 * 32 * (128 + 2) * 4)          # o, m, l
    out["bound_ms"], out["bound_by"] = bound_ms(
        n_bytes, 4 * 32 * 128 * valid, torch.bfloat16)
    return out


def quantize_pool(torch, kvquant, pk, pv, fmt: str):
    """(pool_k, pool_v, k_scale, v_scale) of a bf16/f32 pool in format
    ``q8`` (int8, per-token scales) or ``q4g<g>`` (packed int4, one scale
    per g keys), by the port's quantizers, as the engine writes them."""
    if fmt == "q8":
        (kq, ks), (vq, vs) = kvquant.quantize_rows(pk), \
            kvquant.quantize_rows(pv)
    else:
        g = int(fmt[3:])
        (kq, ks), (vq, vs) = (kvquant.quantize_groups_q4(x, g)
                              for x in (pk, pv))
    return kq, vq, ks, vs


def mass_checks(torch, got, ref, tol: float, empty_row=None) -> float:
    """The mass output against the plain version's: within ``tol``, every
    row summing to at most 1 + 1e-5 and the empty row at 0."""
    err = max_err(got, ref)
    check(err <= tol, f"mass max |err| {err} > {tol}")
    top = got.sum(dim=1).max().item()
    check(top <= 1 + 1e-5, f"a mass row sums to {top} > 1 + 1e-5")
    if empty_row is not None:
        check(not got[empty_row].any().item(), "the empty row's mass is not 0")
    return err


def paged_quant_checks(torch, gen, slice_rows) -> dict:
    """Kernels 5 (int8 pages) and 6 (packed int4 pages) and the mass output
    of kernels 4-6 against ``paged_attention_ref`` on the card: the serving
    shape (pools quantized from bf16 by the port's ``kvquant``, int4 groups
    of 16; two launches must give equal bits), then the f32 edge cases of
    ``paged_checks``, int4 groups of 1, 4 and P, and tables 40 pages wide
    (a split of the split walk holds two pages).  Times at the serving
    shape, with and without the mass, bounds from the bytes of this data's
    valid keys."""
    pa = importlib.import_module("kubegpu_tpu_torch.ops.paged_attention")
    kvq = importlib.import_module("kubegpu_tpu_torch.ops.kvquant")
    q, pk, pv, pt, t, tpad, d = paged_case(
        torch, gen, torch.bfloat16, 32, 41, 8, 128, 128, 32, slice_rows)
    pools = {"bf16": (pk, pv, None, None),
             "q8": quantize_pool(torch, kvq, pk, pv, "q8"),
             "q4g16": quantize_pool(torch, kvq, pk, pv, "q4g16")}
    del pk, pv
    out = {}
    for fmt, (kq, vq, ks, vs) in pools.items():
        args = (q, kq, vq, pt, 31, t, tpad, d, ks, vs)
        got = pa.paged_attention(*args, collect_mass=True)
        again = pa.paged_attention(*args, collect_mass=True)
        ref = pa.paged_attention_ref(*args, collect_mass=True)
        part = pa.paged_attention(*args)
        torch.cuda.synchronize()
        # the splits and the mass merge in a fixed order, with no float
        # atomics: equal bits
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"paged {fmt}: two launches differ")
        err = max_err(got[0], ref[0])
        m_err = max_err(got[1], ref[1])
        l_rel = ((got[2] - ref[2]).abs() / ref[2].clamp(min=1e-30)).max().item()
        check(err <= 1e-2, f"paged {fmt} bf16 o max |err| {err} > 1e-2")
        check(m_err <= 1e-3 and l_rel <= 1e-3,
              f"paged {fmt} bf16 m err {m_err} / l rel err {l_rel} > 1e-3")
        mass_err = mass_checks(torch, got[3], ref[3], 1e-3)
        log("kernels", kernel=f"paged {fmt}", case="bf16 B=8 Hq=32 Hkv=8 "
            "P=128, with mass", max_abs_err=err, tol=1e-2, m_err=m_err,
            l_rel_err=l_rel, mass_err=mass_err, mass_tol=1e-3,
            bit_equal=True, partials_equal_without_mass=all(
                torch.equal(a, b) for a, b in zip(part, got[:3])))
        out[fmt] = {"args": args, "max_abs_err": err, "mass_err": mass_err}
    # f32 edge cases: a hole, an empty row (2), decode pages past t_pad,
    # folded queries and padded head dims, on every format with the mass
    rows = [([3, 7, 0, 0], 20, 32, 0), ([5, 0, 9, 0], 40, 48, 0),
            ([0, 0, 0, 0], 0, 0, 0), ([2, 4, 6, 8], 10, 16, 40)]
    cases = [(fmt, hq, hd) for hq, hd in ((8, 64), (16, 64), (32, 64),
                                          (8, 16), (4, 80))
             for fmt in ("bf16", "q8", "q4g4")]
    cases += [("q4g1", 8, 64), ("q4g16", 8, 64), ("q4g1", 8, 16)]
    # tables 40 pages wide (32 splits of 2 pages): a long prompt with a
    # hole, a prompt and a decode region far past it, a decode region alone
    wide = [([1 + i if i != 7 else 0 for i in range(40)], 600, 608, 0),
            (list(range(41, 81)), 60, 128, 400), (list(range(81, 121)), 0, 0,
                                                  257), ([0] * 40, 0, 0, 0)]
    cases = [(fmt, hq, hd, rows) for fmt, hq, hd in cases] + [
        (fmt, 8, hd, wide) for fmt, hd in (("bf16", 128), ("q8", 128),
                                           ("q4g4", 128), ("bf16", 80))]
    for fmt, hq, hd, frows in cases:
        fq, fk, fv, fpt, ft, ftp, fd = paged_case(
            torch, gen, torch.float32, 2, 1 + max(max(r[0]) for r in frows),
            2, 16, hd, hq, frows)
        kq, vq, ks, vs = ((fk, fv, None, None) if fmt == "bf16"
                          else quantize_pool(torch, kvq, fk, fv, fmt))
        fargs = (fq, kq, vq, fpt, 1, ft, ftp, fd, ks, vs)
        got = pa.paged_attention(*fargs, collect_mass=True)
        ref = pa.paged_attention_ref(*fargs, collect_mass=True)
        # l of the wide rows sums ~600 weights: held relative to its size
        e = max(max_err(a, b) for a, b in zip(
            got[:3 if frows is rows else 2], ref))
        check(e <= 1e-4, f"paged {fmt} f32 hq={hq} hd={hd}: max |err| {e}")
        l_rel = ((got[2] - ref[2]).abs() / ref[2].clamp(min=1)).max().item()
        check(l_rel <= 1e-5, f"paged {fmt} f32 hq={hq} hd={hd}: l rel err "
              f"{l_rel}")
        empty = next(i for i, r in enumerate(frows) if r[1] == r[3] == 0)
        check(not got[0][empty].any().item()
              and not got[2][empty].any().item(),
              f"paged {fmt}: the empty row must give o = 0, l = 0")
        me = mass_checks(torch, got[3], ref[3], 1e-5, empty_row=empty)
        log("kernels", kernel=f"paged {'f32' if fmt == 'bf16' else fmt}",
            case=f"f32 hq={hq} hkv=2 hd={hd} P=16 holes/empty/decode, mass, "
            f"{fpt.shape[1]} pages", max_abs_err=e, tol=1e-4, mass_err=me,
            mass_tol=1e-5)
    # times at the serving shape: each kernel without and with the mass
    valid = sum(t_ + d_ for _, t_, _, d_ in slice_rows)
    groups = sum(-(-t_ // 16) + -(-d_ // 16) for _, t_, _, d_ in slice_rows)
    fixed = (8 * 32 * 128 * 2 + sum(len(r[0]) for r in slice_rows) * 4
             + 3 * 8 * 4 + 8 * 32 * (128 + 2) * 4)   # q, table, state, o/m/l
    kv_bytes = {"bf16": valid * 8 * 128 * 2 * 2,
                "q8": valid * 8 * (128 + 4) * 2,
                "q4g16": (valid * 64 + groups * 4) * 8 * 2}
    mass_bytes = 8 * pt.shape[1] * 4
    flops = 4 * 32 * 128 * valid
    for fmt in pools:
        args = out[fmt].pop("args")
        r = out[fmt]
        r["ms"] = cuda_ms(lambda: pa.paged_attention(*args))
        r["mass_ms"] = cuda_ms(lambda: pa.paged_attention(
            *args, collect_mass=True))
        # 5 reps: the int4 plain version enqueues ~70 kernels a call, and
        # 20 calls would fill the launch queue before the timed window
        r["plain_ms"] = cuda_ms(lambda: pa.paged_attention_ref(*args), reps=5)
        r["library_ms"] = None   # no single PyTorch call reads a page table
        r["bound_ms"], r["bound_by"] = bound_ms(fixed + kv_bytes[fmt], flops,
                                                torch.bfloat16)
        r["mass_bound_ms"], _ = bound_ms(fixed + kv_bytes[fmt] + mass_bytes,
                                         flops, torch.bfloat16)
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["mass_share_of_bound"] = r["mass_bound_ms"] / r["mass_ms"]
        log("kernels", kernel=f"paged {fmt}", ms=r["ms"],
            mass_ms=r["mass_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], mass_bound_ms=r["mass_bound_ms"],
            bound_by=r["bound_by"], share_of_bound=r["share_of_bound"],
            mass_share_of_bound=r["mass_share_of_bound"],
            perf_md_ms_before=PAGED_MS_BEFORE[fmt][0],
            perf_md_mass_ms_before=PAGED_MS_BEFORE[fmt][1])
    return out


# The times (ms, with the mass) of kernels 4-6 at the serving shape before
# kernel 5 moved onto the split walk: 4 and 6 on the split walk, 5 on the
# older chunk walk (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W)
PAGED_MS_BEFORE = {"bf16": (0.02005, 0.02290), "q8": (0.03992, 0.04834),
                   "q4g16": (0.01624, 0.01933)}


def paged_rounding_checks(torch) -> dict:
    """Kernels 4-6 round each P.V weight to q's type after the v-scale, as
    the TPU kernels do: bf16, V = 1, rows of 2-4 valid keys at the start of
    one page, integer q and K (so both sides compute the same scores and
    weights exactly).  The plain version's o is off 1 by the rounding
    (> 1e-4); each kernel must match it within 1e-5, the mass included."""
    pa = importlib.import_module("kubegpu_tpu_torch.ops.paged_attention")
    kvq = importlib.import_module("kubegpu_tpu_torch.ops.kvquant")
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    shape = (1, 8, 2, 16, 128)
    pk = torch.randint(-2, 3, shape, generator=g, device="cuda").bfloat16()
    pv = torch.ones(shape, device="cuda").bfloat16()
    q = torch.randint(-1, 2, (3, 8, 128), generator=g,
                      device="cuda").bfloat16()
    i32 = dict(dtype=torch.int32, device="cuda")
    pt = torch.tensor([[3, 0], [5, 0], [0, 7]], **i32)
    t, tpad, d = (torch.tensor(x, **i32) for x in ([3, 0, 0], [16, 0, 16],
                                                    [0, 4, 2]))
    out = {}
    for fmt in ("bf16", "q8", "q4g4"):
        kq, vq, ks, vs = ((pk, pv, None, None) if fmt == "bf16"
                          else quantize_pool(torch, kvq, pk, pv, fmt))
        args = (q, kq, vq, pt, 0, t, tpad, d, ks, vs)
        got = pa.paged_attention(*args, collect_mass=True)
        ref = pa.paged_attention_ref(*args, collect_mass=True)
        off = (ref[0] - 1).abs().max().item()
        err = max(max_err(a, r) for a, r in zip(got, ref))
        check(off > 1e-4, f"paged {fmt}: the rounding case is not sensitive "
              f"(plain o off 1 by {off})")
        check(err <= 1e-5, f"paged {fmt}: V = 1 rounding case max |err| "
              f"{err} > 1e-5")
        log("kernels", kernel=f"paged {fmt}", case="bf16 V=1, 2-4 keys a "
            "row, integer q and K: weights rounded as the reference",
            plain_o_off_1=off, max_abs_err=err, tol=1e-5)
        out[fmt] = err
    return out


# T5 v1.1-base's serving traffic (phase 8) and kernel 7's shape in it
T5_SERVE = {"batch": 8, "enc_len": 512, "steps": 384, "page": 128}
T5_TRAIN = {"batch": 8, "enc_len": 512, "dec_len": 128}


def paged_bias_checks(torch, gen) -> dict:
    """Kernel 7 against ``paged_attention_biased_ref`` on the card: at the
    T5 serving path's shape in its third block (bf16, B 8, H 12, P 128, D
    64, 32 buckets over 128, t = t_pad = 0, d = 256 flushed keys, q_pos =
    256 + j), then f32 edge cases at head dims 16, 64 and 80: an empty row,
    a 0 in a row's page table inside its prompt (attended: kernel 7 has no
    hole mask), a row with a prompt and a decode region, and three sets of
    query positions whose valid keys hit every bucket, the clamp included.
    Times at the serving shape; the bound counts the valid keys' K and V,
    q, the table, the page table and row state, and o/m/l."""
    pa = importlib.import_module("kubegpu_tpu_torch.ops.paged_attention")
    dev = "cuda"
    b, h, p, dd, nb, max_dist = 8, 12, T5_SERVE["page"], 64, 32, 128
    n_blocks = -(-T5_SERVE["steps"] // p)
    i32 = dict(dtype=torch.int32, device=dev)
    pk, pv = (torch.randn(12, 1 + b * n_blocks, h, p, dd, generator=gen,
                          device=dev).bfloat16() for _ in range(2))
    q = torch.randn(b, h, dd, generator=gen, device=dev).bfloat16()
    pt = (1 + torch.arange(b, **i32)[:, None] * n_blocks
          + torch.arange(n_blocks, **i32)[None, :])
    zeros = torch.zeros(b, **i32)
    d = torch.full((b,), 2 * p, **i32)
    qpos = 2 * p + torch.arange(b, **i32) * 16
    table = torch.randn(h, nb, generator=gen, device=dev)
    args = (q, pk, pv, pt, 11, zeros, zeros, d, qpos, table)
    o, m, l = pa.paged_attention_biased(*args, bias_max_dist=max_dist)
    again = pa.paged_attention_biased(*args, bias_max_dist=max_dist)
    ro, rm, rl = pa.paged_attention_biased_ref(*args, max_dist)
    torch.cuda.synchronize()
    # the splits merge in a fixed order, with no float atomics: equal bits
    check(all(torch.equal(x, y) for x, y in zip((o, m, l), again)),
          "paged_decode_bias: two launches differ")
    err, m_err = max_err(o, ro), max_err(m, rm)
    l_rel = ((l - rl).abs() / rl.clamp(min=1e-30)).max().item()
    check(err <= 1e-2, f"paged bias bf16 o max |err| {err} > 1e-2")
    check(m_err <= 1e-3 and l_rel <= 1e-3,
          f"paged bias bf16 m err {m_err} / l rel err {l_rel} > 1e-3")
    log("kernels", kernel="paged_decode_bias",
        case=f"bf16 B={b} H={h} P={p} D={dd} d=256 q_pos=256+j",
        max_abs_err=err, tol=1e-2, m_err=m_err, l_rel_err=l_rel,
        bit_equal=True)
    out = {"max_abs_err": err, "bit_equal": True}
    rows = [([3, 7, 0, 0], 20, 32, 0),     # prompt over 2 pages
            ([5, 0, 9, 0], 40, 48, 0),     # a 0 inside the prompt
            ([0, 0, 0, 0], 0, 0, 0),       # empty row
            ([2, 4, 6, 8], 10, 16, 40)]    # prompt and decode region
    hit = set()
    for hd in (16, 64, 80):
        fq, fk, fv, fpt, ft, ftp, fd = paged_case(
            torch, gen, torch.float32, 2, 12, 4, 16, hd, 4, rows)
        ftable = torch.randn(4, nb, generator=gen, device=dev)
        for qp in ([34, 60, 0, 30], [45, 130, 3, 90], [200, 400, 9, 175]):
            fqpos = torch.tensor(qp, **i32)
            fargs = (fq, fk, fv, fpt, 1, ft, ftp, fd, fqpos, ftable)
            got = pa.paged_attention_biased(*fargs, bias_max_dist=max_dist)
            ref = pa.paged_attention_biased_ref(*fargs, max_dist)
            e = max(max_err(a, r) for a, r in zip(got, ref))
            check(e <= 1e-4, f"paged bias f32 hd={hd} q_pos={qp}: max |err| "
                  f"{e} > 1e-4")
            check(not got[0][2].any().item() and not got[2][2].any().item()
                  and bool((got[1][2] == -1e30).all()),
                  "paged bias: the empty row must give o = 0, m = NEG_INF, "
                  "l = 0")
            log("kernels", kernel="paged_decode_bias",
                case=f"f32 H=4 hd={hd} P=16 hole/empty/decode q_pos={qp}",
                max_abs_err=e, tol=1e-4)
            phys = torch.arange(fpt.shape[1] * 16, device=dev)[None, :]
            valid = (phys < ft[:, None]) | ((phys >= ftp[:, None])
                                           & (phys < (ftp + fd)[:, None]))
            hit |= set(pa.rel_pos_bucket(phys - fqpos[:, None], False, nb,
                                         max_dist)[valid].tolist())
    check(hit == set(range(nb)), f"the f32 cases hit buckets {sorted(hit)}")
    out["ms"] = cuda_ms(lambda: pa.paged_attention_biased(
        *args, bias_max_dist=max_dist))
    # 5 reps: the plain version enqueues ~40 kernels a call
    out["plain_ms"] = cuda_ms(lambda: pa.paged_attention_biased_ref(
        *args, max_dist), reps=5)
    out["library_ms"] = None   # no single PyTorch call reads a page table
    valid = int(d.sum())
    n_bytes = (valid * h * dd * 2 * 2          # K and V of the valid keys
               + b * h * dd * 2 + h * nb * 4   # q, the table
               + pt.numel() * 4 + 4 * b * 4    # page table, t/t_pad/d/q_pos
               + b * h * (dd + 2) * 4)         # o, m, l
    out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, 4 * h * dd * valid,
                                                torch.bfloat16)
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    log("kernels", kernel="paged_decode_bias", ms=out["ms"],
        plain_ms=out["plain_ms"], bound_ms=out["bound_ms"],
        bound_by=out["bound_by"], share_of_bound=out["share_of_bound"],
        buckets_hit=len(hit), perf_md_ms_before=0.0263)
    return out


# -- phases 4-6 ------------------------------------------------------------

def forward_phase(torch, kernels, cfg, params, gen) -> dict:
    import dataclasses

    from kubegpu_tpu_torch.models import llama_forward
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen,
                           device="cuda")
    with torch.no_grad():
        before = kernels.launches["flash_fwd"]
        logits = llama_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        launched = kernels.launches["flash_fwd"] - before
        check(tuple(logits.shape) == (1, 512, cfg.vocab_size),
              f"forward logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "forward logits not finite")
        check(launched == cfg.n_layers,
              f"flash launches rose by {launched}, want {cfg.n_layers}")
        t0 = time.perf_counter()
        llama_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        plain = llama_forward(params, tokens, dataclasses.replace(
            cfg, attn_impl="plain"))
        # bf16 rounding differences in attention grow through 32 random
        # layers: hold the logits' relative L2 error, not the tokens
        rel = ((logits - plain).norm() / plain.norm()).item()
    check(rel <= 3e-2, f"forward vs plain-attention logits rel err {rel}")
    log("forward", shape="[1,512]", layers=cfg.n_layers,
        flash_launches=launched, ms=round(fwd_ms, 3), rel_err_vs_plain=rel,
        tol=3e-2)
    return {"ms": fwd_ms, "rel_err_vs_plain": rel}


PAGED_KERNELS = ("paged_decode", "paged_decode_q8", "paged_decode_q4")


def serving_window(torch, kernels, eng, cfg, gen, n_new, kernel="paged_decode",
                   prompts=None) -> dict:
    """One timed window: 12 requests with prompts of 200-512 tokens (new
    ones from ``gen``, or ``prompts``), 8 up front and 4 after two ticks
    (slots retire and are re-admitted), run to the end with ``drain``;
    checked and timed on the host clock.  ``kernel`` is the paged kernel
    of the engine's pool format: it must run ``stride × n_layers`` times a
    tick, and the other paged kernels not at all."""
    if prompts is None:
        lens = torch.randint(200, 513, (12,), generator=gen, device="cuda")
        prompts = [torch.randint(0, cfg.vocab_size, (int(n),), generator=gen,
                                 device="cuda").tolist() for n in lens]
    tick0, tok0 = eng._tick, eng.emitted_tokens
    before = dict(kernels.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, n_new) for p in prompts[:8]]
    done = []
    for _ in range(2):
        done += eng.step()
    rids += [eng.submit(p, n_new) for p in prompts[8:]]
    done += eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = kernels.launches[kernel] - before[kernel]
    check(sorted(r.rid for r in done) == sorted(rids),
          "not every request finished")
    others = {k: kernels.launches[k] - before[k] for k in PAGED_KERNELS
              if k != kernel}
    check(not any(others.values()),
          f"a {kernel} engine launched other paged kernels: {others}")
    for r in done:
        check(len(r.tokens) == n_new, f"rid {r.rid}: {len(r.tokens)} tokens")
        check(all(0 <= x < cfg.vocab_size for x in r.tokens),
              f"rid {r.rid}: token out of range")
    eng.check_page_invariants()
    check(len(eng._free_pages) == eng.total_pages, "pages leaked")
    ticks = eng._tick - tick0
    check(launched == ticks * eng.stride * cfg.n_layers,
          f"{kernel} launches {launched} != ticks {ticks} x {eng.stride} x "
          f"{cfg.n_layers}")
    tokens = eng.emitted_tokens - tok0
    by_rid = {r.rid: r.tokens for r in done}
    return {"tokens_per_s": tokens / wall, "wall_s": wall, "ticks": ticks,
            "tokens": tokens, "paged_launches": launched, "prompts": prompts,
            "outputs": [by_rid[r] for r in rids]}


def serving_phase(torch, kernels, cfg, params, gen, name,
                  windows: int = 5) -> dict:
    """The serving program's order: ``warmup()``, then ``windows`` timed
    windows of staggered requests; tokens/s is the windows' median."""
    import statistics

    from kubegpu_tpu_torch.models import ContinuousBatcher
    stride, n_new = 16, 32
    eng = ContinuousBatcher(params, cfg, n_slots=8, max_len=1024,
                            stride=stride, prompt_buckets=(512,),
                            paged=True, page_size=128, total_pages=40,
                            device="cuda")
    before = kernels.launches["paged_decode"]
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    warm_launches = kernels.launches["paged_decode"] - before
    check(warm_launches == stride * cfg.n_layers,
          f"warmup launched the paged kernel {warm_launches} times")
    check((eng._tick, eng.emitted_tokens) == (0, 0),
          "warmup changed the engine's state")
    runs = [serving_window(torch, kernels, eng, cfg, gen, n_new)
            for _ in range(windows)]
    rates = [r["tokens_per_s"] for r in runs]
    tok_s = statistics.median(rates)
    log("serving", warmup_s=round(warm_s, 3), windows=windows,
        requests=12 * windows, ticks=eng._tick, waves=list(eng.wave_sizes),
        paged_launches=warm_launches + sum(r["paged_launches"] for r in runs),
        tokens=eng.emitted_tokens, occupancy=round(eng.occupancy, 4),
        card=repr(name))
    log("serving", tokens_per_s_median=tok_s, tokens_per_s=rates,
        wall_s=[r["wall_s"] for r in runs])
    stats = {"tokens_per_s": tok_s, "tokens_per_s_windows": rates,
             "wall_s_windows": [r["wall_s"] for r in runs],
             "warmup_s": warm_s, "ticks": eng._tick,
             "tokens": eng.emitted_tokens, "occupancy": eng.occupancy,
             "pool_bytes": pool_bytes(eng)}
    return stats, eng, runs


def pool_bytes(eng) -> int:
    return sum(x.numel() * x.element_size() for x in eng.pool.values())


QUANT_ENGINES = (
    ("int8", dict(kv_bits=8), "paged_decode_q8"),
    ("int4", dict(kv_bits=4), "paged_decode_q4"),
    ("int4+mass", dict(kv_bits=4, evict_policy="mass", evict_param=0.3),
     "paged_decode_q4"))


def quant_serving_phase(torch, kernels, cfg, params, gen, name,
                        first_window, profile: bool = False) -> dict:
    """The quantized pools at phase 5's shape, each engine in turn:
    ``warmup()``, then two timed windows, the first on phase 5's first
    window's prompts (the share of greedy tokens that agree with the bf16
    engine's is printed, not held: random weights give near-tied logits).
    evict_param 0.3 evicts on the first decoding tick of a 4-page prompt,
    since the mass EMA starts at 0.  With ``profile``, one steady tick of
    the int8 engine is traced after its windows."""
    import statistics

    from kubegpu_tpu_torch.models import ContinuousBatcher
    out = {}
    for label, kw, kernel in QUANT_ENGINES:
        eng = ContinuousBatcher(params, cfg, n_slots=8, max_len=1024,
                                stride=16, prompt_buckets=(512,), paged=True,
                                page_size=128, total_pages=40, device="cuda",
                                **kw)
        before = kernels.launches[kernel]
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        check(kernels.launches[kernel] - before == 16 * cfg.n_layers,
              f"{label}: warmup did not run {kernel} once per step and layer")
        runs = [serving_window(torch, kernels, eng, cfg, gen, 32, kernel,
                               prompts=first_window["prompts"]),
                serving_window(torch, kernels, eng, cfg, gen, 32, kernel)]
        if eng.evict_policy is not None:
            check(eng.pages_evicted >= 1, f"{label}: no page was evicted")
        ref = [x for toks in first_window["outputs"] for x in toks]
        mine = [x for toks in runs[0]["outputs"] for x in toks]
        agree = sum(a == b for a, b in zip(ref, mine)) / len(ref)
        rates = [r["tokens_per_s"] for r in runs]
        stats = {"tokens_per_s": statistics.median(rates),
                 "tokens_per_s_windows": rates,
                 "wall_s_windows": [r["wall_s"] for r in runs],
                 "warmup_s": warm_s, "ticks": eng._tick,
                 "kernel_launches": sum(r["paged_launches"] for r in runs),
                 "pool_bytes": pool_bytes(eng),
                 "pages_evicted": eng.pages_evicted,
                 "agree_with_bf16": agree}
        log("serving", engine=label, kernel=kernel,
            tokens_per_s=stats["tokens_per_s"], tokens_per_s_windows=rates,
            warmup_s=round(warm_s, 3), ticks=eng._tick,
            launches=stats["kernel_launches"], pool_bytes=stats["pool_bytes"],
            pages_evicted=eng.pages_evicted, agree_with_bf16=agree,
            card=repr(name))
        if profile and label == "int8":
            stats["profile"] = profile_phase(torch, eng,
                                             first_window["prompts"], label)
        out[label] = stats
        del eng
        torch.cuda.empty_cache()
    return out


def device_trace(torch, fn, wall_ms: float) -> dict:
    """Run ``fn()`` (which ends in a synchronize) once under
    ``torch.profiler``: device time by kernel name, the summed time of
    every cuBLAS GEMM kernel and of each of the port's kernels
    (``PORT_KERNELS``), the traced wall time, and the device's idle share,
    one minus the kernels' summed time (one stream, so kernels never
    overlap) over ``wall_ms``, the same work's untraced wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        traced_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = by_name.setdefault(e.name, [0.0, 0])
            rec[0] += e.device_time_total / 1e3
            rec[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    gemms = [rec for n, rec in by_name.items() if GEMM_KERNEL.search(n)]
    port = {k: [sum(r[i] for n, r in by_name.items() if k in n)
                for i in (0, 1)] for k in PORT_KERNELS}
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_ms,
            "device_busy_ms": busy_ms,
            "gemm_ms": sum(ms for ms, _ in gemms),
            "gemm_launches": sum(c for _, c in gemms),
            "port_kernels": {k: {"ms": ms, "calls": c}
                             for k, (ms, c) in port.items()},
            "device_kernels": sum(c for _, c in by_name.values()),
            "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "kernels": [{"name": n[:120], "ms": ms, "calls": c}
                        for n, (ms, c) in top]}


def log_trace(what: str, out: dict) -> None:
    log("profile", what=what, wall_ms=round(out["wall_ms"], 3),
        traced_wall_ms=round(out["traced_wall_ms"], 3),
        device_busy_ms=round(out["device_busy_ms"], 3),
        gemm_ms=round(out["gemm_ms"], 3), gemm_launches=out["gemm_launches"],
        device_kernels=out["device_kernels"], idle_share=out["idle_share"],
        port_kernels={k: (round(v["ms"], 3), v["calls"])
                      for k, v in out["port_kernels"].items()},
        top=[(k["name"][:40], round(k["ms"], 3)) for k in out["kernels"][:8]])


def profile_phase(torch, eng, prompts, label: str = "bf16",
                  n_new: int = 80) -> dict:
    """Device time by kernel over one steady engine tick (``--profile``).
    The engine is refilled with requests long enough that the timed ticks
    decode every slot; after admission, one ``step()`` (collect + dispatch
    of a full stride block, ended by a synchronize) is timed untraced, and
    the next is traced."""
    for p in prompts[:eng.n_slots]:
        eng.submit(p, n_new)
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def tick():
        eng.step()
        torch.cuda.synchronize()
    out = device_trace(torch, tick, wall_ms)
    eng.drain()
    log_trace(f"one steady {label} engine tick", out)
    return out


def parity_narrow(torch) -> None:
    from kubegpu_tpu_torch.models import (
        ContinuousBatcher,
        LlamaConfig,
        greedy_generate,
        llama_init,
    )
    cfg = LlamaConfig.tiny(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                           d_ff=512, vocab_size=512, max_seq_len=128)
    params = llama_init(cfg, seed=SEED, device="cuda")
    eng = ContinuousBatcher(params, cfg, n_slots=3, stride=4,
                            prompt_buckets=(16, 32), paged=True,
                            page_size=16, debug_invariants=True,
                            device="cuda")
    g = torch.Generator().manual_seed(SEED)
    reqs = [(torch.randint(0, 512, (int(t),), generator=g).tolist(), n)
            for t, n in ((5, 12), (20, 7), (9, 1), (32, 10), (3, 9))]
    rids = {eng.submit(p, n): (p, n) for p, n in reqs[:3]}
    done = eng.step() + eng.step()
    rids.update({eng.submit(p, n): (p, n) for p, n in reqs[3:]})
    done += eng.drain()
    for r in done:
        p, n = rids[r.rid]
        solo = greedy_generate(params, [p], n, cfg,
                               device="cuda")[0].tolist()
        check(r.tokens == solo, f"narrow f32 rid {r.rid}: engine {r.tokens} "
              f"!= greedy {solo}")
    log("parity", case="narrow f32 engine vs greedy_generate",
        requests=len(done), equal=True)


def parity_full(torch, cfg, params, gen) -> dict:
    """First decode step of one request: the engine's paged path (paged
    kernel + write buffer + merge) against the plain dense cached path."""
    from kubegpu_tpu_torch.models import decode as dec
    from kubegpu_tpu_torch.models import serve as srv
    t = 300
    prompt = torch.randint(0, cfg.vocab_size, (1, t), generator=gen,
                           device="cuda")
    with torch.no_grad():
        logits_p, cache = dec.prefill(params, prompt, cfg, max_len=512)
        first = logits_p.argmax(-1)
        ref, _ = dec.decode_step(params, cache, first, t, cfg)
        del cache
        padded = torch.zeros(1, 512, dtype=torch.long, device="cuda")
        padded[0, :t] = prompt[0]
        lens = torch.tensor([t], device="cuda")
        firsts, cache_w = srv.prefill_wave(params, padded, lens, cfg)
        shape = (cfg.n_layers, 6, cfg.n_kv_heads, 128, cfg.head_dim)
        pool = {n: torch.zeros(shape, dtype=cfg.tdtype, device="cuda")
                for n in ("k", "v")}
        toks = torch.zeros(1, dtype=torch.long, device="cuda")
        pos = torch.zeros(1, dtype=torch.int32, device="cuda")
        srv.adopt_wave(pool, cache_w, torch.tensor([[1, 2, 3, 4]],
                                                   device="cuda"),
                       torch.tensor([0], device="cuda"), first, lens,
                       toks.clone(), toks, pos, 128)
        pt = torch.tensor([[1, 2, 3, 4, 5]], dtype=torch.int32,
                          device="cuda")
        i32 = dict(dtype=torch.int32, device="cuda")
        buf = {n: torch.zeros(cfg.n_layers, 1, cfg.n_kv_heads, 16,
                              cfg.head_dim, dtype=cfg.tdtype, device="cuda")
               for n in ("k", "v")}
        got = srv._paged_row_step(
            params, toks, pool, pt, torch.tensor([t], **i32),
            torch.tensor([512], **i32), torch.tensor([0], **i32), buf, pos,
            0, cfg)
    rel = ((got - ref).norm() / ref.norm()).item()
    mx = max_err(got, ref)
    same = bool((got.argmax(-1) == ref.argmax(-1)).all())
    check(rel <= 3e-2, f"full-width first-step logits rel err {rel} > 3e-2")
    log("parity", case="8B bf16 first decode step, paged vs dense",
        rel_l2_err=rel, max_abs_err=mx, tol_rel=3e-2, argmax_equal=same,
        prefill_first_equal=bool((firsts == first).all()))
    return {"rel_l2_err": rel, "max_abs_err": mx, "argmax_equal": same}


# -- phase 7: training -------------------------------------------------------

def train_flops_per_step(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step (fwd + bwd = 3x fwd), the MFU
    numerator: matmul fwd = 2 * params_in_matmuls * tokens, causal
    attention fwd = 2 * B * Hq * T^2 * hd per layer.  The reference
    benchmark's count (``train_flops_per_step``), kept here as a copy;
    remat's recomputed forward is not model work and is not counted."""
    hd = cfg.head_dim
    per_layer = (cfg.d_model * cfg.n_heads * hd
                 + 2 * cfg.d_model * cfg.n_kv_heads * hd
                 + cfg.n_heads * hd * cfg.d_model
                 + 3 * cfg.d_model * cfg.d_ff)
    matmul_params = cfg.n_layers * per_layer + cfg.d_model * cfg.vocab_size
    fwd = 2.0 * matmul_params * batch * seq \
        + cfg.n_layers * 2.0 * batch * cfg.n_heads * seq * seq * hd
    return 3.0 * fwd


def gemm_flops_per_step(cfg, batch: int, seq: int) -> float:
    """FLOPs of one remat train step's weight matmuls, the work cuBLAS
    does: a layer's forward, its two backward products and its recomputed
    forward (4x), except ``w_down`` (3x): torch's checkpoint stops the
    recompute once the backward's saved tensors are back, and nothing
    saves that last product's output.  lm_head is not recomputed (3x).
    That is 27 GEMMs a layer and 3 for lm_head."""
    hd, d = cfg.head_dim, cfg.d_model
    per_layer = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + 2 * d * cfg.d_ff)
    tokens = batch * seq
    return 2.0 * tokens * (cfg.n_layers * (4 * per_layer + 3 * d * cfg.d_ff)
                           + 3 * d * cfg.vocab_size)


def train_parity(torch, cfg, params, gen) -> dict:
    """One step's loss and the gradients of layer 0's wq/wk/wv and of
    lm_head at batch 1, through the kernels and through the plain
    attention (autograd over ``xla_attention``)."""
    import dataclasses

    from kubegpu_tpu_torch.models.llama import next_token_loss
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                           device="cuda")
    wanted = [params["layers"][n] for n in ("wq", "wk", "wv")] + [
        params["lm_head"]]
    runs = {}
    for impl in ("auto", "plain"):
        loss = next_token_loss(params, tokens,
                               dataclasses.replace(cfg, attn_impl=impl))
        grads = torch.autograd.grad(loss, wanted)
        runs[impl] = (loss.item(), [grads[0][0], grads[1][0], grads[2][0],
                                    grads[3]])
        del loss, grads
    (loss_k, got), (loss_p, ref) = runs["auto"], runs["plain"]
    rel = {name: ((g.float() - r.float()).norm() / r.float().norm()).item()
           for name, g, r in zip(("wq0", "wk0", "wv0", "lm_head"), got, ref)}
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    # bf16 through 8 random layers: the plain path rounds probabilities
    # and its autograd products to bf16 where the kernels keep f32
    check(math.isfinite(loss_k) and loss_rel <= 1e-2,
          f"train parity: loss {loss_k} vs plain {loss_p}")
    check(max(rel.values()) <= 5e-2, f"train parity: grad rel L2 {rel}")
    log("parity", case="8-layer 8B bf16 loss + grads, kernels vs plain",
        tokens="[1,2048]", loss=loss_k, loss_plain=loss_p,
        loss_rel_err=loss_rel, tol_loss_rel=1e-2, grad_rel_l2=rel,
        tol_rel_l2=5e-2)
    return {"loss": loss_k, "loss_plain": loss_p, "loss_rel_err": loss_rel,
            "grad_rel_l2": rel}


def train_phase(torch, kernels, gen, name, profile: bool) -> dict:
    """Llama-3-8B at full width cut to 8 layers (remat on, bf16): parity
    at batch 1, then ``make_train_step`` + ``adamw(1e-3)`` on one
    [4, 2048] batch: one warm step, three timed ones.  Launch counters are
    zeroed just before the steps and read just after."""
    import dataclasses
    import statistics

    from kubegpu_tpu_torch.models import LlamaConfig, llama_init
    from kubegpu_tpu_torch.models.llama import make_train_step
    from kubegpu_tpu_torch.optim import adamw
    from kubegpu_tpu_torch.tree import tree_leaves
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=8)
    check(cfg.remat, "the 8B config must keep remat on")
    batch, seq = 4, 2048
    t0 = time.perf_counter()
    params = llama_init(cfg, seed=SEED, device="cuda")
    for p in tree_leaves(params):
        p.requires_grad_()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    log("training", init_s=round(time.perf_counter() - t0, 2),
        layers=cfg.n_layers, params_b=round(n_params / 1e9, 3))
    parity = train_parity(torch, cfg, params, gen)
    opt = adamw(1e-3)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    kernels.reset_launches()          # the training path starts here
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        if i == 0:
            first = dict(kernels.launches)
    launches = dict(kernels.launches)   # ... and ends here
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    for kname, n in want.items():
        check(first[kname] == n and launches[kname] == 4 * n,
              f"{kname}: {first[kname]} launches in the first step, "
              f"{launches[kname]} in four; want {n} per step")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    timed = step_ms[1:]
    med_ms = statistics.median(timed)
    flops = train_flops_per_step(cfg, batch, seq)
    stats = {"layers": cfg.n_layers, "batch": batch, "seq": seq,
             "params": n_params, "losses": losses, "step_ms": step_ms,
             "step_ms_median": med_ms,
             "tokens_per_s": batch * seq / (med_ms / 1e3),
             "model_flops": flops,
             "mfu": flops / (med_ms / 1e3) / PEAK_FLOPS["bfloat16"],
             "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches_per_step": {k: first[k] for k in want},
             "launches": launches, "parity": parity, "card": name}
    log("training", steps=len(losses), losses=losses,
        step_ms=[round(x, 3) for x in step_ms], step_ms_median=med_ms,
        tokens_per_s=stats["tokens_per_s"], mfu=stats["mfu"],
        max_memory_gb=round(stats["max_memory_gb"], 3),
        launches_per_step=stats["launches_per_step"], card=repr(name))
    if profile:
        def one_step():
            nonlocal params, state
            params, state, _ = step(params, state, tokens)
            torch.cuda.synchronize()
        prof = stats["profile"] = device_trace(torch, one_step, med_ms)
        prof["gemm_flops"] = gemm_flops_per_step(cfg, batch, seq)
        prof["gemm_tflops_per_s"] = (prof["gemm_flops"] / prof["gemm_ms"]
                                     / 1e9 if prof["gemm_ms"] else None)
        log_trace("one train step", prof)
        log("profile", what="train step GEMMs", flops=prof["gemm_flops"],
            gemm_ms=prof["gemm_ms"], launches=prof["gemm_launches"],
            launches_counted=27 * cfg.n_layers + 3,
            tflops_per_s=prof["gemm_tflops_per_s"])
    return stats


# -- phase 8: T5 -------------------------------------------------------------

def t5_generate_timed(torch, fn, calls: int = 3) -> tuple[list, object]:
    """One warm ``fn()`` and ``calls`` timed ones, each bracketed by
    synchronizes; returns the timed walls (s) and the last tokens."""
    fn()
    walls = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, toks


def t5_serving(torch, kernels, t5, cfg, params, gen, name) -> dict:
    """8a: the dense and the paged greedy generate on ``T5_SERVE``'s
    traffic (encoding included); tokens/s is batch x steps over the median
    wall.  Launch counters are zeroed just before the paged calls and read
    just after: kernel 7 runs ``n_dec_layers x steps`` times a call."""
    import statistics
    b, steps, page = T5_SERVE["batch"], T5_SERVE["steps"], T5_SERVE["page"]
    enc = torch.randint(0, cfg.vocab_size, (b, T5_SERVE["enc_len"]),
                        generator=gen, device="cuda")
    dense_walls, dense = t5_generate_timed(
        torch, lambda: t5.t5_greedy_generate(params, enc, steps, cfg,
                                             device="cuda"))
    kernels.reset_launches()          # the T5 paged serving path starts here
    paged_walls, paged = t5_generate_timed(
        torch, lambda: t5.t5_greedy_generate_paged(
            params, enc, steps, cfg, page_size=page, device="cuda"))
    launches = dict(kernels.launches)   # ... and ends here
    per_call = cfg.n_dec_layers * steps
    check(launches["paged_decode_bias"] == 4 * per_call,
          f"paged_decode_bias ran {launches['paged_decode_bias']} times in "
          f"four paged calls, want {per_call} a call")
    check(not any(v for k, v in launches.items() if k != "paged_decode_bias"),
          f"the T5 path launched other kernels: {launches}")
    for toks in (dense, paged):
        check(tuple(toks.shape) == (b, steps)
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"T5 tokens {tuple(toks.shape)} out of shape or range")
    agree = (dense == paged).float().mean().item()
    out = {"dense_tokens_per_s": b * steps / statistics.median(dense_walls),
           "paged_tokens_per_s": b * steps / statistics.median(paged_walls),
           "dense_wall_s": dense_walls, "paged_wall_s": paged_walls,
           "paged_launches_per_call": per_call, "launches": launches,
           "agree_dense_paged": agree}
    log("t5", what="serving", batch=b, enc_len=T5_SERVE["enc_len"],
        steps=steps, page=page, dense_tokens_per_s=out["dense_tokens_per_s"],
        paged_tokens_per_s=out["paged_tokens_per_s"],
        dense_wall_s=[round(x, 3) for x in dense_walls],
        paged_wall_s=[round(x, 3) for x in paged_walls],
        kernel7_per_call=per_call, agree_dense_paged=agree, card=repr(name))
    return out


def t5_parity(torch, t5, cfg, params, gen) -> dict:
    """8b: on a narrow f32 config (the JAX package's TestT5OnPages setup:
    encoder 2 x 9, 11 steps over pages of 4) the paged tokens equal the
    dense ones; at full width in bf16 the paged step's logits agree with
    the dense step's at position 2 * page + 5, after two flushed pages,
    both decoders fed the same random tokens.  Tolerance: relative L2 3e-2,
    as the Llama paged-vs-dense check (bf16 rounding through 12 layers; the
    paged path rounds its buffer's weights to bf16 before P.V)."""
    tiny = t5.T5Config.tiny()
    tp = t5.t5_init(tiny, seed=5, device="cuda")
    enc = torch.arange(2 * 9, device="cuda").reshape(2, 9) % tiny.vocab_size
    dense = t5.t5_greedy_generate(tp, enc, 11, tiny, max_len=16,
                                  device="cuda")
    paged = t5.t5_greedy_generate_paged(tp, enc, 11, tiny, page_size=4,
                                        device="cuda")
    check(torch.equal(dense, paged), f"narrow f32 T5: paged {paged.tolist()}"
          f" != dense {dense.tolist()}")
    log("parity", case="narrow f32 T5 paged vs dense generate", steps=11,
        page=4, equal=True)
    page = T5_SERVE["page"]
    last = 2 * page + 5
    enc = torch.randint(0, cfg.vocab_size, (2, T5_SERVE["enc_len"]),
                        generator=gen, device="cuda")
    forced = torch.randint(0, cfg.vocab_size, (2, last + 1), generator=gen,
                           device="cuda")
    logits = {}

    def teacher(label):
        def pick(lg, i):
            if i == last:
                logits[label] = lg
            return forced[:, i]
        return pick
    with torch.no_grad():
        t5._t5_rollout(params, enc, last + 1, cfg, 0, last + 1,
                       teacher("dense"))
        t5._t5_paged_rollout(params, enc, last + 1, cfg, 0, page,
                             teacher("paged"))
    got, ref = logits["paged"], logits["dense"]
    rel = ((got - ref).norm() / ref.norm()).item()
    same = bool((got.argmax(-1) == ref.argmax(-1)).all())
    check(rel <= 3e-2, f"T5 full-width paged step logits rel err {rel}")
    log("parity", case=f"T5 bf16 step at position {last} (two flushed "
        "pages), paged vs dense", rel_l2_err=rel, max_abs_err=max_err(
            got, ref), tol_rel=3e-2, argmax_equal=same)
    return {"rel_l2_err": rel, "max_abs_err": max_err(got, ref),
            "argmax_equal": same}


def t5_training(torch, t5, cfg, params, gen, name) -> dict:
    """8c: ``make_t5_train_step`` + ``adamw(1e-3)`` on one fixed batch
    (``T5_TRAIN``): one warm step and three timed ones; losses finite and
    falling."""
    import statistics

    from kubegpu_tpu_torch.optim import adamw
    from kubegpu_tpu_torch.tree import tree_leaves
    for p in tree_leaves(params):
        p.requires_grad_()
    b = T5_TRAIN["batch"]
    enc = torch.randint(0, cfg.vocab_size, (b, T5_TRAIN["enc_len"]),
                        generator=gen, device="cuda")
    dec = torch.randint(0, cfg.vocab_size, (b, T5_TRAIN["dec_len"]),
                        generator=gen, device="cuda")
    opt = adamw(1e-3)
    state = opt.init(params)
    step = t5.make_t5_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, enc, dec)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    check(all(math.isfinite(x) for x in losses), f"T5 losses {losses}")
    check(losses[-1] < losses[0], f"T5 loss did not fall: {losses}")
    med = statistics.median(step_ms[1:])
    out = {"losses": losses, "step_ms": step_ms, "step_ms_median": med,
           "tokens_per_s": b * (T5_TRAIN["enc_len"] + T5_TRAIN["dec_len"])
           / (med / 1e3),
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("t5", what="training", enc=f"[{b},{T5_TRAIN['enc_len']}]",
        dec=f"[{b},{T5_TRAIN['dec_len']}]", losses=losses,
        step_ms=[round(x, 3) for x in step_ms], step_ms_median=med,
        tokens_per_s=out["tokens_per_s"],
        max_memory_gb=round(out["max_memory_gb"], 3), card=repr(name))
    return out


def t5_phase(torch, kernels, gen, name, cfg=None) -> dict:
    """Phase 8 at ``T5Config()`` (T5 v1.1-base widths, bf16) with random
    weights from ``SEED``: serving, parity, training."""
    from kubegpu_tpu_torch.tree import tree_leaves
    t5 = importlib.import_module("kubegpu_tpu_torch.models.t5")
    cfg = cfg or t5.T5Config()
    t0 = time.perf_counter()
    params = t5.t5_init(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    log("t5", init_s=round(time.perf_counter() - t0, 2),
        params_m=round(n_params / 1e6, 2), d_model=cfg.d_model,
        layers=f"{cfg.n_enc_layers}+{cfg.n_dec_layers}", heads=cfg.n_heads,
        d_ff=cfg.d_ff, vocab=cfg.vocab_size)
    serving = t5_serving(torch, kernels, t5, cfg, params, gen, name)
    parity = t5_parity(torch, t5, cfg, params, gen)
    torch.cuda.empty_cache()
    training = t5_training(torch, t5, cfg, params, gen, name)
    return {"params": n_params, "serving": serving, "parity": parity,
            "training": training}


def ptxas_instances(text: str) -> list:
    """Each kernel instance of an ``-Xptxas -v`` build log: its name
    (demangled by ``c++filt`` where the machine has it), registers a thread
    and bytes spilled (stores + loads)."""
    out, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append({"name": name, "registers": int(m.group(1)),
                        "spill_bytes": spill})
            name = None
    if out and shutil.which("c++filt"):
        names = subprocess.run(
            ["c++filt"], input="\n".join(i["name"] for i in out),
            capture_output=True, text=True, timeout=60).stdout.splitlines()
        for i, n in zip(out, names):
            i["name"] = n.replace("kubetpu::", "").replace(
                "__nv_bfloat16", "bf16")
    return out


def only_tc(launches: dict, names, path: str) -> None:
    """Kernels 1-3 ran on their tensor-core instances only."""
    for k in names:
        check(launches[f"{k}/tc"] == launches[k] > 0
              and launches[f"{k}/simt"] == 0,
              f"{path}: {k} ran off the tensor cores: {launches}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one steady engine tick and one train "
                    "step (torch.profiler)")
    ap.add_argument("--details", metavar="PATH",
                    help="write every phase's numbers to PATH as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        from kubegpu_tpu_torch import kernels
        from kubegpu_tpu_torch.models import LlamaConfig, llama_init
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    log("device", kind=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(card, flush=True)

    t0 = time.perf_counter()
    build_logs = kernels.build()
    build_s = time.perf_counter() - t0
    log("build", seconds=round(build_s, 2), kernels=list(build_logs))
    ptxas = {kname: ptxas_instances(text)
             for kname, text in build_logs.items()}
    for kname, inst in ptxas.items():
        spilling = [i["name"] for i in inst if i["spill_bytes"]]
        log("build", kernel=kname, instances=len(inst),
            max_registers=max((i["registers"] for i in inst), default=None),
            spilling=spilling)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cfg = LlamaConfig.llama3_8b()
    # the serving rows: prompts 200-512 in a 512 bucket, one decode block
    # flushed (d = 16) — the paged kernel's state mid-run
    slice_lens = [int(x) for x in torch.randint(
        200, 513, (8,), generator=gen, device="cuda")]
    slice_rows = [([1 + 5 * i + j for j in range(5)], n, 512, 16)
                  for i, n in enumerate(slice_lens)]
    results = {"flash_fwd": flash_checks(torch, gen),
               "paged_decode": paged_checks(torch, gen, slice_rows)}
    quant = paged_quant_checks(torch, gen, slice_rows)
    rounding = paged_rounding_checks(torch)
    results["paged_decode_q8"] = quant["q8"]
    results["paged_decode_q4"] = quant["q4g16"]
    results["paged_decode"]["mass"] = quant["bf16"]
    results["paged_decode_bias"] = paged_bias_checks(torch, gen)
    torch.cuda.empty_cache()
    bwd, fwd_train = flash_bwd_checks(torch, gen)
    results.update(bwd)
    for kname, r in results.items():
        log("kernels", kernel=kname, ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"])
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params = llama_init(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log("forward", init_s=round(time.perf_counter() - t0, 2),
        weights_gb=round(sum(p.numel() * p.element_size() for p in
                             [params["embed"], params["lm_head"],
                              *params["layers"].values()]) / 1e9, 2))
    kernels.reset_launches()          # the serving path starts here
    fwd = forward_phase(torch, kernels, cfg, params, gen)
    serve, engine, windows = serving_phase(torch, kernels, cfg, params, gen,
                                           name)
    serve_launches = dict(kernels.launches)   # ... and ends here
    check(all(serve_launches[k] > 0 for k in ("flash_fwd", "paged_decode")),
          f"a kernel of the serving path never ran: {serve_launches}")
    only_tc(serve_launches, ("flash_fwd",), "serving")
    prof = (profile_phase(torch, engine, windows[-1]["prompts"])
            if args.profile else None)
    del engine
    torch.cuda.empty_cache()
    kernels.reset_launches()          # the quantized serving path starts here
    quant_serve = quant_serving_phase(torch, kernels, cfg, params, gen, name,
                                      windows[0], args.profile)
    quant_launches = dict(kernels.launches)   # ... and ends here
    check(all(quant_launches[k] > 0 for k in ("paged_decode_q8",
                                              "paged_decode_q4")),
          f"a kernel of the quantized serving path never ran: "
          f"{quant_launches}")
    log("serving", pool_bytes={"bf16": serve["pool_bytes"], **{
        k: v["pool_bytes"] for k, v in quant_serve.items()}})

    parity = parity_full(torch, cfg, params, gen)
    del params
    torch.cuda.empty_cache()
    parity_narrow(torch)
    torch.cuda.empty_cache()

    train = train_phase(torch, kernels, gen, name, args.profile)
    train_launches = train["launches"]
    check(all(train_launches[k] > 0 for k in
              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
          f"a kernel of the training path never ran: {train_launches}")
    only_tc(train_launches, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
            "training")
    torch.cuda.empty_cache()

    t5_stats = t5_phase(torch, kernels, gen, name)
    t5_launches = t5_stats["serving"]["launches"]
    torch.cuda.empty_cache()

    routes = {"flash_fwd": ("kubegpu_tpu_torch/csrc/flash_fwd.cu",
                            "kubegpu_tpu/ops/flash_attention.py:200"),
              "paged_decode": ("kubegpu_tpu_torch/csrc/paged_decode.cu",
                               "kubegpu_tpu/ops/paged_attention.py:229"),
              "paged_decode_q8": ("kubegpu_tpu_torch/csrc/paged_decode_q8.cu",
                                  "kubegpu_tpu/ops/paged_attention.py:347"),
              "paged_decode_q4": ("kubegpu_tpu_torch/csrc/paged_decode_q4.cu",
                                  "kubegpu_tpu/ops/paged_attention.py:449"),
              "flash_bwd_dq": ("kubegpu_tpu_torch/csrc/flash_bwd_dq.cu",
                               "kubegpu_tpu/ops/flash_attention.py:383"),
              "flash_bwd_dkv": ("kubegpu_tpu_torch/csrc/flash_bwd_dkv.cu",
                                "kubegpu_tpu/ops/flash_attention.py:425"),
              "paged_decode_bias": (
                  "kubegpu_tpu_torch/csrc/paged_decode_bias.cu",
                  "kubegpu_tpu/ops/paged_attention.py:567")}
    paths = (serve_launches, quant_launches, train_launches, t5_launches)
    # launches: each kernel's count over the paths that run it (the
    # forward runs on serving and training)
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": routes[k][0],
         "replaces": routes[k][1],
         "launches": sum(path[k] for path in paths),
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for k, r in results.items()]}
    for r in line["kernels"]:
        check(all(isinstance(r[k], float) and math.isfinite(r[k])
                  for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")),
              f"{r['name']}: a number is missing")
        check(r["launches"] > 0, f"{r['name']} never ran on a path")
    check(len(line["kernels"]) == len(kernels.SIGNATURES),
          "the kernels line misses a kernel")
    details = {"card": card, "kind": name, "build_s": build_s,
               "ptxas": ptxas,
               "forward": fwd, "serving": serve, "parity": parity,
               "quantized_serving": quant_serve,
               "paged_mass": quant["bf16"], "paged_rounding": rounding,
               "profile": prof, "training": train,
               "flash_fwd_training_shape": fwd_train,
               "t5": t5_stats,
               "launches": {"serving": serve_launches,
                            "quantized_serving": quant_launches,
                            "training": train_launches,
                            "t5_paged_serving": t5_launches},
               "kernels": line["kernels"],
               "total_s": time.perf_counter() - t_start}
    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                    exist_ok=True)
        with open(args.details, "w") as f:
            json.dump(details, f, indent=1)
    log("done", total_s=round(details["total_s"], 1))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
