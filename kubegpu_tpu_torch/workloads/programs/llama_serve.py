"""Llama serving workload (counterpart of
``kubegpu_tpu/workloads/programs/llama_serve.py``): decode as a SCHEDULABLE
job, not just a library call.  The pod runs prefill and greedy decode on its
allocated card and prints the metric lines the node agent harvests into the
cluster registry, under the reference program's names.

    python -m kubegpu_tpu_torch.workloads.programs.llama_serve

runs on the card and fails where there is none; :func:`main` and
:func:`_serve_continuous` take ``device="cpu"`` for tests.

Model scale is ANNOTATION-DRIVEN: when the allocation advertises a whole
card's memory (``KUBETPU_HBM_GIB >= 16``, crishim-injected from the device
advertisement) and the program runs on CUDA, the pod serves the flagship
bench config (:func:`llama_bench_config`: 8 layers at d_model 2048, int8
weights and an int8 KV cache) instead of the tiny model.  (The reference's
docstring quotes a tokens/s target for that config: a TPU figure, not this
port's.)  SERVE_CONFIG overrides: auto | tiny | bench.

Env knobs:
  SERVE_CONFIG   auto (default) | tiny | bench
  SERVE_MODE     static (default) | continuous -- continuous runs the
                 arrival-driven ContinuousBatcher (models/serve.py):
                 SERVE_BATCH slots, SERVE_REQS sustained requests of
                 SERVE_STEPS tokens each, reporting steady-state engine
                 tok/s + occupancy
  SERVE_BATCH    sequences/slots (default 4 tiny / 32 bench)
  SERVE_PROMPT   prompt length (default 128 tiny / 1024 bench)
  SERVE_STEPS    decode steps per sequence (default 32 tiny / 128 bench)
  SERVE_REQS     continuous mode: total requests (default 3x slots)
  SERVE_INT8     "1" quantizes weights AND the static KV cache
                 (default: 0 tiny, 1 bench; continuous mode quantizes
                 weights, and its paged pool is int8 when slots x prompt
                 >= 16384, see SERVE_KV_INT8 / SERVE_KV_BITS)
  SERVE_SPEC_GAMMA  continuous+paged: engine-integrated speculative
                 decoding -- γ early-exit self-draft proposals per slot per
                 tick, one full-model verify (0 = off); SERVE_DRAFT_LAYERS
                 picks the draft slice (default n_layers/4).  The pod echoes
                 serve_engine_spec_accept_rate and
                 serve_engine_spec_tokens_per_tick
  SERVE_FUSED_K  continuous+paged: fused multi-tick decode -- K complete
                 engine ticks per host round-trip (default 1; the engine
                 drops any block back to K=1 while host work is pending).
                 Paged-only; under strict mode a fused ask on the dense
                 fallback aborts.  The pod echoes serve_engine_cfg_fused_k
                 and serve_fused_dispatches
  SERVE_KV_BITS  continuous+paged: KV-pool element width -- 16 (bf16), 8
                 (per-token int8, alias of SERVE_KV_INT8=1) or 4 (grouped
                 packed int4).  The pod echoes serve_kv_bits
  SERVE_EVICT_POLICY  continuous+paged: attention-aware page eviction --
                 "window" or "mass"; SERVE_EVICT_PARAM tunes the window
                 length / mass threshold.  Plain K=1 path only (no
                 spec/fused/tp); the pod echoes serve_pages_evicted_total
                 and serve_kv_quality_delta
  SERVE_PREFIX_CACHE, SERVE_CHUNKED_PREFILL  continuous+paged: "1" turns
                 on the prefix cache / chunked prefill
  SERVE_TP, SERVE_DP  continuous+paged: tensor / data parallel serving.
                 An ask the visible devices cannot satisfy degrades to the
                 one-device engine (loudly under strict mode).  A tp ask
                 they can satisfy (SERVE_DP=1) spawns SERVE_TP ranks, one
                 a card over NCCL (gloo ranks on the CPU), each serving
                 its shard of one tensor-parallel engine; rank 0 prints
                 the lines.  A dp ask serves through a
                 DataParallelServePool in this process: dp replicas, each
                 on SERVE_TP cards of its own (replica i on cards
                 i*tp..(i+1)*tp-1); at tp > 1 each replica is a gang of tp
                 rank processes over NCCL (gloo ranks on the CPU)
  SERVE_TRACE    "1" traces the engine (so does a KUBETPU_TRACE_CONTEXT
                 token); SERVE_TRACE_OUT writes the Chrome trace there

``KUBETPU_REQUIRE_PALLAS=1`` (:mod:`kubegpu_tpu_torch.ops.strict`) turns each
of the program's engine fallbacks into an error, as in the reference.

The decode throughput metric subtracts a separately-timed prefill of the
same configuration; the prefill-inclusive figure is emitted separately as
serve_e2e_tokens_per_s.
"""

from __future__ import annotations

import json
import os
import sys
import time


def llama_bench_config():
    """The reference's bench config (``kubegpu_tpu/benchmark.py``): Llama-3
    structure with head_dim 128 and GQA group 4, 8 layers at d_model 2048,
    bf16 (the reference's ``scan_unroll`` has no counterpart here)."""
    from kubegpu_tpu_torch.models import LlamaConfig
    return LlamaConfig(
        vocab_size=32000, d_model=2048, n_layers=8, n_heads=16,
        n_kv_heads=4, d_ff=8192, max_seq_len=2048, dtype="bfloat16",
        remat=False)


def _device_count(device) -> int:
    import torch
    return torch.cuda.device_count() if device.type == "cuda" else 1


def main(device="cuda") -> int:
    from kubegpu_tpu_torch.workloads.programs.distributed import (
        init_from_env,
        program_device,
    )

    env = init_from_env()
    import torch

    from kubegpu_tpu_torch.models import LlamaConfig, greedy_generate
    from kubegpu_tpu_torch.models.decode import prefill

    device = program_device(device, "llama_serve")
    mode = os.environ.get("SERVE_CONFIG", "auto")
    if mode == "auto":
        mode = ("bench" if device.type == "cuda"
                and (env.hbm_gib or 0.0) >= 16.0 else "tiny")

    if mode == "bench":
        batch = int(os.environ.get("SERVE_BATCH", "32"))
        prompt_t = int(os.environ.get("SERVE_PROMPT", "1024"))
        steps = int(os.environ.get("SERVE_STEPS", "128"))
        int8 = os.environ.get("SERVE_INT8", "1") == "1"
        cfg = llama_bench_config()
    else:
        batch = int(os.environ.get("SERVE_BATCH", "4"))
        prompt_t = int(os.environ.get("SERVE_PROMPT", "128"))
        steps = int(os.environ.get("SERVE_STEPS", "32"))
        int8 = os.environ.get("SERVE_INT8", "0") == "1"
        cfg = LlamaConfig.tiny(n_heads=4, n_kv_heads=4, dtype="float32",
                               max_seq_len=prompt_t + steps)
    if os.environ.get("SERVE_MODE", "static") == "continuous":
        # the engine's process (or each tp rank) makes the weights
        return _serve_continuous(env, cfg, None, batch, prompt_t, steps,
                                 int8, device=device)
    params = _model_params(cfg, int8, device)
    max_len = prompt_t + steps
    prompt = (torch.arange(batch * prompt_t, device=device).reshape(
        batch, prompt_t) % cfg.vocab_size)

    def fetch(x):
        # a one-element host read: it waits for the stream
        return x.reshape(-1)[0].item()

    def timeit(fn, n=2):
        out = fn()
        fetch(out)          # warm: first-call costs (graph capture)
        t0 = time.perf_counter()
        fetch(out)
        rtt = time.perf_counter() - t0   # the read's own round trip,
        # subtracted per burst as in the reference's protocol
        best = float("inf")
        for _ in range(2):  # best of 2: noise only ever adds
            t0 = time.perf_counter()
            for _ in range(n):
                out = fn()
            fetch(out)
            best = min(best, max(time.perf_counter() - t0 - rtt, 1e-9))
        return best / n, out

    with torch.no_grad():
        prefill_s, _ = timeit(
            lambda: prefill(params, prompt, cfg, max_len, kv_int8=int8)[0])
        gen_s, out = timeit(
            lambda: greedy_generate(params, prompt, steps, cfg,
                                    max_len=max_len, kv_int8=int8,
                                    device=device))
    decode_s = max(gen_s - prefill_s, 1e-9)
    first = int(out[0, 0].item())

    ok = 0 <= first < cfg.vocab_size
    if env.worker_id == 0:
        common = {
            "unit": "tokens/s", "config": mode, "batch": batch,
            "prompt": prompt_t, "steps": steps, "int8": int8,
            "devices": _device_count(device),
        }
        # the metric-line convention the node agent harvests; decode is
        # isolated against the same-config prefill
        print(json.dumps({
            "metric": "serve_decode_tokens_per_s",
            "value": round(batch * (steps - 1) / decode_s, 1),
            **common,
        }))
        print(json.dumps({
            "metric": "serve_e2e_tokens_per_s",
            "value": round(batch * steps / gen_s, 1),
            **common,
        }))
        # engine-config echo + per-phase timings, so the scheduled pod's
        # number can be attributed line by line
        for name, value in (
                ("serve_cfg_batch", batch),
                ("serve_cfg_prompt", prompt_t),
                ("serve_cfg_steps", steps),
                ("serve_cfg_int8", int(int8)),
                ("serve_phase_prefill_ms", round(prefill_s * 1e3, 2)),
                ("serve_phase_decode_ms", round(decode_s * 1e3, 2)),
                ("serve_phase_e2e_ms", round(gen_s * 1e3, 2))):
            print(json.dumps({"metric": name, "value": value}))
    if not ok:
        print("FAIL: generated token out of range", file=sys.stderr)
        return 3
    return 0


def _model_params(cfg, int8: bool, device):
    """The program's weights: ``llama_init`` from seed 0, int8 when
    asked (every process that serves makes the same tree)."""
    from kubegpu_tpu_torch.models import llama_init
    from kubegpu_tpu_torch.models.quant import quantize_llama
    params = llama_init(cfg, seed=0, device=device)
    return quantize_llama(params) if int8 else params


def _serve_continuous(env, cfg, params, n_slots, prompt_t, steps, int8,
                      device="cuda", record: dict | None = None) -> int:
    """Arrival-driven serving as a schedulable workload: saturate a
    ContinuousBatcher with SERVE_REQS requests and report steady-state
    engine throughput + occupancy as harvestable metric lines.
    ``params`` None makes the program's weights (:func:`_model_params`)
    where the engine runs: here, or in each tensor-parallel rank.  A
    ``record`` dict receives each request's tokens (submit order) and
    the metric lines."""
    import torch

    from kubegpu_tpu_torch.ops.strict import fallback

    device = torch.device(device)
    stride = max(4, min(16, steps))
    n_reqs = int(os.environ.get("SERVE_REQS", str(3 * n_slots)))
    max_len = prompt_t + steps + stride + 8
    # the paged pool serves by default; the dense engine serves instead
    # when the prompt bucket does not align to a page (tiny configs)
    page_size = 128
    paged = prompt_t % page_size == 0 and page_size % stride == 0
    if not paged:
        # strict mode forbids this silent paged -> dense degradation
        fallback("llama_serve.continuous",
                 f"prompt bucket {prompt_t} / stride {stride} does not "
                 f"align to page_size {page_size}; dense engine would "
                 "serve instead of the paged pool")
    # int8 KV pages only at the scale where the cache out-reads the
    # weights (the reference's rule)
    kv_int8 = paged and n_slots * prompt_t >= 16384
    if os.environ.get("SERVE_KV_INT8") is not None:
        kv_int8 = paged and os.environ["SERVE_KV_INT8"] == "1"
    # kv bit width: SERVE_KV_BITS=4 serves the grouped packed-int4 pool;
    # =8 is an alias of SERVE_KV_INT8=1.  Paged-only: under strict mode an
    # int4 ask on the dense fallback aborts.
    kv_bits = None
    kb_env = os.environ.get("SERVE_KV_BITS")
    if kb_env:
        kv_bits = int(kb_env)
        if kv_bits == 4 and not paged:
            fallback("llama_serve.kv_bits",
                     "SERVE_KV_BITS=4 needs the paged engine; the "
                     "dense fallback has no packed page pool")
            kv_bits = None
        elif kv_bits == 8:
            kv_int8, kv_bits = paged, None
        elif kv_bits == 16:
            kv_int8, kv_bits = False, None
        if kv_bits == 4:
            kv_int8 = False
    # serving fast-path knobs (ride the paged pool; off by default)
    prefix_cache = paged and os.environ.get(
        "SERVE_PREFIX_CACHE", "0") == "1"
    chunked = paged and os.environ.get(
        "SERVE_CHUNKED_PREFILL", "0") == "1"
    # engine-integrated speculative decoding; paged-only
    spec_gamma = int(os.environ.get("SERVE_SPEC_GAMMA", "0"))
    dl_env = os.environ.get("SERVE_DRAFT_LAYERS")
    draft_layers = int(dl_env) if dl_env else None
    if spec_gamma and not paged:
        fallback("llama_serve.spec",
                 f"SERVE_SPEC_GAMMA={spec_gamma} needs the paged "
                 "engine; the dense fallback would serve the plain "
                 "one-token-per-slot path")
        spec_gamma = 0
    # fused multi-tick decode: a ceiling, not a promise (the engine drops
    # a block to K=1 while host work is pending); paged-only
    fused_k = int(os.environ.get("SERVE_FUSED_K", "1"))
    if fused_k > 1 and not paged:
        fallback("llama_serve.fused",
                 f"SERVE_FUSED_K={fused_k} needs the paged engine; "
                 "the dense fallback syncs every tick")
        fused_k = 1
    # attention-aware page eviction rides the plain K=1 decode path only
    evict_policy = os.environ.get("SERVE_EVICT_POLICY") or None
    ep_env = os.environ.get("SERVE_EVICT_PARAM")
    evict_param = float(ep_env) if ep_env else None
    if evict_policy and (not paged or spec_gamma or fused_k > 1
                         or int(os.environ.get("SERVE_TP", "1")) > 1):
        fallback("llama_serve.evict",
                 f"SERVE_EVICT_POLICY={evict_policy} needs the paged "
                 "plain-decode engine (no spec/fused/tp); eviction "
                 "would silently stay off")
        evict_policy = evict_param = None
    # mesh serving (SERVE_TP / SERVE_DP): an ask the allocation or the
    # head geometry cannot satisfy degrades to the one-device engine
    # (loudly under strict mode); a tp ask it can satisfy runs tp ranks
    # of one sharded engine, a dp ask dp replicas behind one queue, each
    # a tp-rank gang of its own at tp > 1
    n_dev = _device_count(device)
    tp = int(os.environ.get("SERVE_TP", "1"))
    dp = int(os.environ.get("SERVE_DP", "1"))
    if paged and (tp > 1 or dp > 1):
        bad = []
        if tp * dp > n_dev:
            bad.append(f"dp*tp={dp * tp} > {n_dev} devices")
        if cfg.n_kv_heads % tp:
            bad.append(f"tp={tp} !| n_kv_heads={cfg.n_kv_heads}")
        if bad:
            fallback("llama_serve.tp",
                     "; ".join(bad) + " — single-chip engine would "
                     "serve instead of the mesh-sharded one")
            tp = dp = 1
    plan = dict(n_slots=n_slots, prompt_t=prompt_t, steps=steps,
                n_reqs=n_reqs, stride=stride, paged=paged, tp=tp, dp=dp,
                n_dev=n_dev, int8=int8, kv_int8=kv_int8,
                prefix_cache=prefix_cache, chunked=chunked,
                spec_gamma=spec_gamma, fused_k=fused_k,
                eng_kw=dict(n_slots=n_slots, max_len=max_len, stride=stride,
                            prompt_buckets=(prompt_t,), paged=paged,
                            page_size=page_size, kv_int8=kv_int8,
                            kv_bits=kv_bits, evict_policy=evict_policy,
                            evict_param=evict_param,
                            prefix_cache=prefix_cache,
                            chunked_prefill=chunked, spec_gamma=spec_gamma,
                            draft_layers=draft_layers, fused_ticks=fused_k))
    if paged and tp > 1 and device.type == "cuda":
        # the paged kernels once, here: the ranks then only load them
        from kubegpu_tpu_torch import kernels
        kernels.build(["paged_decode", "paged_decode_q8", "paged_decode_q4"])
    if paged and tp > 1 and dp == 1:
        # one rank a card over NCCL (gloo ranks on the CPU), each making
        # its weights and serving its shard; rank 0 reports
        from kubegpu_tpu_torch.parallel import launch
        from kubegpu_tpu_torch.models.serve import _params_on
        host = None if params is None else _params_on(params,
                                                      torch.device("cpu"))
        ok, lines, tokens = launch(
            _tp_rank, tp, cfg, host, plan,
            backend="nccl" if device.type == "cuda" else "gloo",
            device=device.type)
    else:
        if params is None:
            params = _model_params(cfg, int8, device)
        if not (paged and dp > 1):
            plan["tp"] = plan["dp"] = 1
        ok, lines, tokens = _serve(cfg, params, plan, device)
    if record is not None:
        record.update(tokens=tokens, lines=lines)
    if env.worker_id == 0:
        for line in lines:
            print(line)
    if not ok:
        print("FAIL: continuous engine dropped or corrupted requests",
              file=sys.stderr)
        return 3
    return 0


def _tp_rank(cfg, params, plan: dict):
    """One tensor-parallel rank of :func:`_serve_continuous`: the weights
    (the caller's, or made here on this rank's card), a ("tp",) mesh over
    the launch's group, and :func:`_serve` on it; rank 0's result is the
    run's."""
    import torch
    import torch.distributed as dist

    from kubegpu_tpu_torch.models.serve import _params_on, make_serve_mesh
    on_card = dist.get_backend() == "nccl"
    device = (torch.device("cuda", torch.cuda.current_device()) if on_card
              else torch.device("cpu"))
    params = (_model_params(cfg, plan["int8"], device) if params is None
              else _params_on(params, device))
    mesh = make_serve_mesh(plan["tp"], device.type)
    return _serve(cfg, params, plan, device, mesh=mesh,
                  rank0=dist.get_rank() == 0)


def _serve(cfg, params, plan: dict, device, mesh=None, rank0: bool = True):
    """Build the planned engine (a tensor-parallel rank's under ``mesh``,
    the dp pool, or one engine), warm it up, run SERVE_REQS requests
    through it and return (ok, the metric lines, each request's tokens).
    Only ``rank0`` writes the Chrome trace; a pool's replica gangs end
    before it returns."""
    from kubegpu_tpu_torch.models.serve import ContinuousBatcher

    tp, dp = plan["tp"], plan["dp"]
    # end-to-end request tracing: the crishim injects
    # KUBETPU_TRACE_CONTEXT into the pod's env; decoding it parents every
    # engine span under the scheduler's bind span.  No token (or
    # SERVE_TRACE=1 for a local root) leaves tracing off.
    from kubegpu_tpu_torch.obs.spans import TRACE_ENV, SpanContext, Tracer
    trace_ctx = SpanContext.decode(os.environ.get(TRACE_ENV))
    tracer = (Tracer() if trace_ctx is not None
              or os.environ.get("SERVE_TRACE") == "1" else None)
    eng_kw = dict(plan["eng_kw"], tracer=tracer, trace_ctx=trace_ctx)
    if mesh is not None:
        # a gloo group cannot be captured in a CUDA graph
        import torch.distributed as dist
        graphs = dist.get_backend(mesh.get_group("tp")) == "nccl"
        eng = ContinuousBatcher(params, cfg, device=device, mesh=mesh,
                                graphs=graphs, **eng_kw)
    elif plan["paged"] and dp > 1:
        from kubegpu_tpu_torch.models.serve import DataParallelServePool
        # the first dp·tp cards (at tp > 1 each replica's ranks cut their
        # shards from this process's tree), or the caller's CPU
        eng = DataParallelServePool(
            params, cfg, dp=dp, tp=tp,
            devices=None if device.type == "cuda" else [device] * (dp * tp),
            **eng_kw)
    else:
        eng = ContinuousBatcher(params, cfg, device=device, **eng_kw)
    try:
        return _drive(eng, cfg, plan, tracer, rank0)
    finally:
        if hasattr(eng, "close"):
            eng.close()      # a pool's replica gangs end here


def _drive(eng, cfg, plan: dict, tracer, rank0: bool):
    """:func:`_serve`'s run on the built engine or pool: warm it up, run
    SERVE_REQS requests and return (ok, the metric lines, the tokens)."""
    import numpy as np

    n_slots, prompt_t, steps = (plan["n_slots"], plan["prompt_t"],
                                plan["steps"])
    n_reqs, stride, tp, dp = (plan["n_reqs"], plan["stride"], plan["tp"],
                              plan["dp"])
    base = np.arange(prompt_t) % cfg.vocab_size
    # every wave size, the chunk step and the tick run (and, on the card,
    # are captured) OUTSIDE the timed window; warmup() leaves the engine's
    # state and counters as they were
    t_w0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t_w0
    t0 = time.perf_counter()
    rids = []
    for i in range(n_reqs):
        # arrays, not python lists: converting a long list costs ~ms per
        # submit and lands inside the measured window
        rids.append(eng.submit((base + i) % cfg.vocab_size, steps))
    done = eng.drain()
    elapsed = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in done)
    ok = len(done) == n_reqs and all(
        0 <= t < cfg.vocab_size for r in done for t in r.tokens)
    by_rid = {r.rid: r.tokens for r in done}
    tokens = [by_rid.get(rid) for rid in rids]
    common = {
        "unit": "tokens/s", "mode": "continuous",
        "slots": n_slots, "prompt": prompt_t, "steps": steps,
        "requests": n_reqs, "int8": plan["int8"],
        "devices": plan["n_dev"],
    }
    lines = [json.dumps({
        "metric": "serve_engine_tokens_per_s",
        "value": round(total / elapsed, 1), **common,
    }), json.dumps({
        "metric": "serve_engine_occupancy",
        "value": round(eng.occupancy, 4), "unit": "fraction",
    })]
    # config echo + phase timings: everything needed to rebuild this
    # engine, as harvestable numerics
    from kubegpu_tpu_torch.obs.metrics import percentiles
    stall = percentiles(eng.stall_ms)
    for name, value in (
            ("serve_engine_cfg_slots", n_slots),
            ("serve_engine_cfg_prompt", prompt_t),
            ("serve_engine_cfg_steps", steps),
            ("serve_engine_cfg_stride", stride),
            ("serve_engine_cfg_requests", n_reqs),
            ("serve_engine_cfg_paged", int(plan["paged"])),
            ("serve_engine_cfg_tp", tp),
            ("serve_engine_cfg_dp", dp),
            ("serve_engine_cfg_mesh_devices", tp * dp),
            ("serve_engine_cfg_kv_int8", int(plan["kv_int8"])),
            ("serve_engine_cfg_int8_weights", int(plan["int8"])),
            ("serve_engine_cfg_prefix_cache", int(plan["prefix_cache"])),
            ("serve_engine_cfg_chunked_prefill", int(plan["chunked"])),
            ("serve_engine_cfg_spec_gamma", plan["spec_gamma"]),
            ("serve_engine_cfg_fused_k", plan["fused_k"]),
            ("serve_fused_dispatches",
             eng.fused_dispatches if hasattr(eng, "fused_dispatches")
             else sum(e.fused_dispatches for e in eng.replicas)),
            ("serve_engine_cfg_draft_layers",
             getattr(eng, "draft_layers",
                     eng.replicas[0].draft_layers
                     if hasattr(eng, "replicas") else 0)),
            ("serve_engine_spec_accept_rate",
             round(eng.spec_acceptance_rate, 4)),
            ("serve_engine_spec_tokens_per_tick",
             round(eng.spec_tokens_per_tick, 3)),
            ("serve_engine_phase_warmup_ms",
             round(warmup_s * 1e3, 1)),
            ("serve_engine_phase_drain_ms",
             round(elapsed * 1e3, 1)),
            ("serve_engine_waves", eng.prefill_waves),
            ("serve_engine_ticks",
             eng.slot_steps // (stride * n_slots)),
            ("serve_engine_stall_p50_ms",
             round(stall["p50"], 3)),
            ("serve_engine_stall_p99_ms",
             round(stall["p99"], 3)),
            # fault-tolerance echo: zeros on a healthy run
            ("serve_failover_total",
             getattr(eng, "failovers", 0)),
            ("serve_requests_retried",
             getattr(eng, "requests_retried_total",
                     eng.requests_retried)),
            ("serve_slots_quarantined", eng.slots_quarantined),
            ("serve_requests_shed", eng.requests_shed),
            # live / peak state bytes at the dispatch boundaries (a tp
            # rank's: its KV-head shard of the pool)
            ("serve_hbm_pool_bytes", eng.hbm_pool_bytes),
            ("serve_hbm_peak_bytes", eng.hbm_peak_bytes),
            # overload echo: with no tiers every request is
            # best-effort, so goodput is the raw tokens/s above
            ("serve_goodput_tokens_per_s",
             round(total / elapsed, 1)),
            ("serve_requests_preempted",
             getattr(eng, "requests_preempted", 0)),
            ("serve_requests_resumed",
             getattr(eng, "requests_resumed", 0)),
            ("serve_deadline_miss",
             getattr(eng, "deadline_misses", 0)),
            # closed-loop echo: a bare engine is one replica with no
            # routing
            ("serve_routing_affinity_hits",
             getattr(eng, "routing_affinity_hits", 0)),
            ("serve_autoscale_events",
             getattr(eng, "autoscale_events", 0)),
            ("serve_replicas_active",
             len(eng._alive()) if hasattr(eng, "_alive") else 1),
            # kv compression & eviction echo
            ("serve_kv_bits",
             eng.kv_bits if hasattr(eng, "kv_bits")
             else eng.replicas[0].kv_bits),
            ("serve_pages_evicted_total",
             eng.pages_evicted if hasattr(eng, "pages_evicted")
             else sum(e.pages_evicted for e in eng.replicas)),
            ("serve_kv_quality_delta",
             getattr(eng, "kv_quality_delta", 0.0))):
        lines.append(json.dumps({"metric": name, "value": value}))
    if tracer is not None:
        # trace echo: the span count is harvestable; the Chrome trace
        # goes to SERVE_TRACE_OUT when asked
        lines.append(json.dumps({"metric": "serve_trace_spans",
                                 "value": len(tracer.spans())}))
        trace_out = os.environ.get("SERVE_TRACE_OUT")
        if trace_out and rank0:
            with open(trace_out, "w") as f:
                f.write(tracer.to_chrome_trace())
    return ok, lines, tokens


if __name__ == "__main__":
    raise SystemExit(main())
