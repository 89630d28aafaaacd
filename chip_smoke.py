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
   edge cases; and at ViT-B/16's attention ([128, 12, 197, 64] bf16,
   non-causal MHA, a ragged last tile: phase 14 (c)'s shape) on the
   tensor-core instances, each against its plain version, equal bits on
   two launches, timed beside ``scaled_dot_product_attention`` forward
   and backward.  Kernels 4-6 also run at the chunk step's shape (q [1,
   8192, 128] bf16: C = 256 prompt positions of 32 heads folded over 8 kv
   heads, a 384-token history), with the time, the bound and its share,
   and a first chunk's row (s = 0) that must give l = 0 and a finite o;
   and at the speculative verify's shape (q [8, 160, 128] and [8, 96,
   128] bf16: γ + 1 = 5 or 3 positions of 32 heads folded over 8 kv heads
   a row, groups of 20 and 12 cut into query chunks of 8 + 8 + 4 and 8 +
   4; histories of 200-576 keys), two launches with equal bits, with the
   time, the bound and its share.  Kernel 4 also runs at phase 5h's shapes:
   the beam's (q [4, 128, 128] bf16: 4 beams x 4 query heads folded over
   each kv head, 4 pages a row, t = t_pad = 512 and, unaligned, 500, d =
   0) and the prompt-lookup verify's (q [8, 288, 128] bf16: 9 positions x
   4 heads, 11-page tables, t = t_pad = 0, d = pos up to 1151 and one row
   at 37), two launches with equal bits, the time, the bound and its
   share.  Kernels 4-6 also hold the chaos path's
   NaN (at the serving rows, each pool format as the engine writes it): a
   NaN on one row's valid key (``k``, or the int8/int4 ``k_scale``) makes
   exactly that row non-finite, kernel and plain, and leaves every other
   row equal to the clean run bit for bit; NaN at every masked position (a
   recycled page's K and V or scales) reaches no output;
4. forward  — ``llama_forward`` at Llama-3-8B full width, bf16, [1, 512];
5. serving  — the paged ``ContinuousBatcher`` at the same width, its tick
   a CUDA graph captured by ``warmup()`` (eager run, capture and
   instantiation seconds and the graph's bytes printed), beside an eager
   engine (``graphs=False``): three windows of 12 staggered requests
   each, in turns, every window's prompts on both engines (tokens equal;
   each engine's median tokens/s); then the fused window: 8 requests of
   128 new tokens on the graph engine and on one with ``fused_ticks=4``
   (tokens equal, fused dispatches, tokens/s of each);
5f. prefix cache — the same engine with ``prefix_cache=True,
   chunked_prefill=True, prefill_chunk=256``, a graph engine and an eager
   one: 12 requests of 64 new tokens, four groups of three sharing a
   384-token prefix, the four leaders first and their eight followers
   after two steps; equal tokens, exact counters (8 hits, 24 aliased
   pages, 3072 prompt tokens saved, 16 chunks), no page leaked, kernel 4
   ``(ticks × stride + chunks) × n_layers`` times (the path's launches
   are those of the two engines' warmups and windows); the first-token
   logits through the chunk step against the plain prefill's
   (relative L2 within 3e-2); prefill tokens, time to first token
   (leaders, followers) and tokens/s beside phase 5's engine on the same
   window, and the chunk step's wall ms as a graph and eagerly;
5g. speculative — the same engine with ``spec_gamma=4`` (a draft of the
   first 8 layers), a graph engine and an eager one, on the first 8
   prompts of phase 5's first window with 64 new tokens (the reference's
   ``cb_spec`` traffic): equal
   tokens, no page leaked, kernel 4 ``spec_ticks × (γ × draft_layers +
   n_layers)`` times; tokens/s beside phase 5's engine on the same
   window, the acceptance and tokens a tick, the spec tick's wall ms
   (graph and eager) and device ms (graph), the capture's seconds and
   bytes; then the same window with a draft of all 32 layers (its
   acceptance above the default draft's, more than one token a tick),
   ``fused_ticks=4`` (tokens equal to K = 1) and ``kv_bits=8`` and ``4``;
5b. quantized serving — the same graph engine with int8 pages, int4
   pages, and int4 pages with mass eviction, in turn: ``warmup()`` and
   two windows each (the first on phase 5's first prompts: the share of
   greedy tokens equal to the bf16 engine's is printed), every request
   finished, no page leaked, pages evicted, the pool's bytes per format;
   an eager engine of each format on the first window's prompts must give
   the same tokens and evictions;
5c. int8 weights — ``quantize_llama`` of the 8B weights on the card (both
   trees' bytes printed), ``llama_forward [1, 512]`` on them against the
   same forward on their dequantized bf16 weights (relative L2 error of the
   logits within 3e-2), and the paged engine on int8 weights with
   ``kv_bits=8``, graph and eager, one window each on phase 5's first
   prompts (tokens equal; tokens/s beside 5b's bf16-weight int8 engine);
5h. search — beam search, speculative and prompt-lookup decoding at
   Llama-3-8B width cut to 16 of 32 layers (a view of 5c's int8 weights:
   the script's time limit) (``search_phase``), each
   through its CUDA graphs and eagerly at 32 tokens (equal tokens and
   stats), then timed through its graphs at full length: (a) ``beam_generate`` (int8 cache) and ``beam_generate_paged``
   (bf16 pages of 128; kernel 4 ``n_layers x (steps - 1)`` times a call),
   batch 4, prompt 512, 32 steps, 4 beams (``paged_vs_dense``, the share of
   equal tokens and the score gap printed); (b) ``spec_generate`` and
   ``spec_generate_fused``, batch 8, prompt 1024, 128 steps, γ 4, a draft
   of 8 layers, the int8 cache, beside ``greedy_generate`` (acceptance,
   iterations, the fused call's host reads), then a draft of all 16 layers
   (its acceptance above the 8-layer draft's, more than one token an
   iteration); (c) ``pld_generate_fused`` (int8 cache) and
   ``pld_generate_paged`` (pages of 128; kernel 4 ``n_layers x
   iterations`` times a call) on prompts tiled from a 128-token pattern, γ
   8, n-gram 3; (d) phase 6's narrow f32 config: every decoder equals
   ``greedy_generate`` (the paged beam the dense one), the paged PLD's
   tokens and stats the fused one's, a perfect draft accepts 1.0;
5d. static — ``llama_serve.py``'s bench traffic (batch 32, prompt 1024,
   128 steps): ``prefill`` and ``greedy_generate`` on int8 weights with
   the int8 cache, then on bf16 weights with the bf16 cache, its decode
   step a CUDA graph and eagerly (tokens equal):
   ``serve_decode_tokens_per_s`` (decode less the same-config prefill) and
   ``serve_e2e_tokens_per_s``, peak memory and the graph's pool;
5e. dense — ``ContinuousBatcher(paged=False)`` at phase 5's shape, bf16:
   ``warmup()`` captures the tick; two windows on it and on an eager
   engine in turns (tokens equal, no slot held after a window);
6. parity   — a narrow f32 engine (through its graph) token for token
   against the port's own ``greedy_generate``, plain, with both
   fast-path knobs (shared prefixes, chunks) and speculative with both
   knobs (γ = 2, a one-layer draft), and the full-width first
   decode step's logits against the plain dense path;
7. training — Llama-3-8B at full width cut to 8 layers (remat on), bf16:
   first one step's loss and gradients at batch 1 through the kernels
   against ``attn_impl="plain"``, then ``make_train_step`` with the port's
   ``adamw(1e-3)`` on one [4, 2048] batch: one warm step and three timed
   steps (median step ms, tokens/s, model-FLOP utilisation, peak memory,
   falling losses);
8. t5       — T5 v1.1-base at full width (``T5Config()``), bf16: the dense
   and the paged greedy generate on 8 encoder inputs of 512 tokens, 384
   decode steps over pages of 128, through their CUDA graphs and eagerly
   (one warm graph call, then graph, eager, graph, eager, graph: equal
   tokens, each mode's median tokens/s; the paged one runs kernel 7 once
   per decoder layer and step); parity of the paged tokens with the dense
   ones on a narrow f32 config and of the full-width paged step's logits
   with the dense step's after two flushed pages; one paged generate on
   ``quantize_t5`` weights (tokens in range, tokens/s beside bf16's);
   ``make_t5_train_step``
   with ``adamw(1e-3)`` on one fixed batch (encoder [8, 512], decoder [8,
   128]): one warm and three timed steps;
9. llama_serve — the workload program the cluster schedules: first kernels
   4-6 at its bench shape (q [32, 16, 128] bf16 over 4 kv heads, pages of
   128, 1024-1176 keys a row; two launches with equal bits, the time, the
   bound and its share), then ``python -m
   kubegpu_tpu_torch.workloads.programs.llama_serve`` with a whole-card
   grant's env (``KUBETPU_HBM_GIB=80``, ``TPU_WORKER_ID=0``,
   ``KUBETPU_REQUIRE_PALLAS=1``; auto picks the bench config: int8 weights,
   32 x 1024 x 128) in its static and its continuous mode (96 requests on
   32 slots, int8 pages): rc 0 and the reference program's metric names in
   order, occupancy in (0, 1], peak state bytes >= state bytes > 0; then
   ``_serve_continuous`` in process on the bench config with 32 requests,
   once per pool format (kernel 4, 5 or 6, and no other of them, launched
   stride x n_layers times a tick and for warmup's tick) and once traced
   (a valid Chrome trace with one ``request`` span a request, tokens/s
   beside the untraced run), and on Llama-3-8B's bf16 weights (int8 pages
   by the program's rule);
10. lifecycle — sampling and the request lifecycle at phase 5's engine
   shape (``lifecycle_phase``): ``sampling=True, top_k=50, seed=7`` with
   half the requests at temperature 0.8, on a graph, an eager and a
   ``fused_ticks=4`` engine (equal tokens), ``seed=8`` (only the sampled
   requests change) and a greedy engine (its tokens on the greedy ones);
   the replayed tick's device ms, greedy against top_k 50 and 0; an int8
   engine with ``nan_logits`` and ``fail_dispatch`` (one quarantine, one
   replay, one retried dispatch); tier-1 requests preempted by a tier-0
   one and resumed.  A replayed or resumed request's tokens before the
   fault and every other request's equal the fault-free run's, and its
   continuation equals a fresh run of its replay prompt; the share of that
   continuation equal to the fault-free run's is printed, not held (the
   replay's prefill computes the accepted tokens' K/V in another GEMM shape
   than the decode did, and random weights' logits are near-tied).  At
   phase 6's narrow f32 config the same chaos and tier scenarios give
   every request the fault-free tokens;
11. pools    -- the serving pools at phase 5's engine shape
   (``pool_phase``), two engines sharing the weights on the one card:
   ``DataParallelServePool(dp=2, routing="affinity")`` with the prefix
   cache on 16 requests in three shared-prefix groups (exactly once, the
   same routes and tokens from a second identical pool, the affinity hit
   rate, tokens/s beside one 16-slot engine's, the memory a retired
   replica still holds), a chaos kill of replica 1 (one failover, every
   request finished on replica 0), ``DisaggServePool(prefill=1,
   decode=1)`` on bf16 and int8 pages (migrations equal the requests
   with more than one new token, every import's digest met, the decode
   replica's kernel launches, each chain's export and import ms, the
   pages migrated); then the same at phase 6's narrow f32 config, every
   token equal to ``greedy_generate``'s (the int8 pools' to one int8
   engine's), the disaggregated pool's to the symmetric pool's and the
   replays to the fault-free run;
12. load     -- the open-loop load harness at phase 5f's engine shape,
   Llama-3-8B's width cut to 16 of 32 layers (a view of the bf16 weights:
   the script's time limit) (``load_phase``): one seeded bursty trace (48 requests, prompts around
   300 tokens, half on 3 shared 128-token prefixes, the reference's three
   goodput tiers) through ``run_load`` on one engine FIFO and tiered
   (goodput a tick and a second, attainment by tier, TTFT p99 in ticks
   and ms, nothing lost or duplicated), on ``DataParallelServePool(dp=2)``
   with affinity and least-loaded routing (the hit rate, the gold tier's
   goodput ratio), with ``collect_overlap=True`` on bf16 and int8 pages
   (``overlap_ms``, overlapped ticks > 0, tokens/s both ways, the share of
   equal tokens and the logit gap where one parts; ``--profile``: the idle
   share of three steady steps both ways), ``donate=False`` (a held pool
   handle keeps its values, the peak grows by one pool), the narrow f32
   config's equal-token gates for both knobs, then ``run_fleet`` of 64
   simulated replicas calibrated from the card's tick and chunk (a rack
   killed, watch weather, an upgrade wave and a control-plane crash:
   nothing lost or duplicated, outcomes identical to the twin, the kill
   paged within 16 ticks; the host seconds).
13. moe      -- the MoE family (``moe_phase``, after phase 9) at
   Mixtral-8x7B's width cut to 8 layers in bf16: ``moe_forward`` [1, 512]
   (kernel 1) against ``moe_prefill``'s last logits (bf16 printed; within
   relative L2 1e-4 in f32 at 2 layers); the paged engine on the
   reference's moe_paged_engine traffic (8 requests in a 512 bucket, 32
   new tokens, stride 16, pages of 128) as a graph and eagerly (equal
   tokens, tokens/s, the replayed tick's ms beside its byte bound), with
   ``fused_ticks=4`` (equal tokens), ``kv_bits=8`` (kernel 5), the dense
   engine (no kernel of the port); int8 experts at the full 32 layers with
   int8 pages (tokens/s, peak memory, the tick against its bound); and a
   narrow f32 config whose paged and dense engines' tokens equal
   ``moe_greedy_generate``'s.
14. train    -- the training families (``train_families_phase``),
   bf16, random weights from seed 0, each on one fixed batch (a warm step
   and three timed ones, finite losses, launches a step): (a)
   ``make_moe_train_step`` at Mixtral-8x7B's width cut to 4 layers, [2,
   2048], remat (kernels 1-3; the gradient through routing held to plain
   attention in f32 at one layer, the bf16 gap printed with the tokens
   each layer reroutes), model and executed one-hot TFLOP/s; (b) LoRA
   rank 8 on wq/wv over Llama-3-8B at 32 layers, [4, 2048] (adapter
   gradients against plain attention, the base's bytes unchanged); (c)
   ViT-B/16 at [128, 224, 224, 3] (kernels 1-3 at [128, 12, 197, 64],
   non-causal; loss and every gradient against plain attention; MFU); (d)
   ResNet-50 at [64, 224, 224, 3] (cuDNN: no kernel of the port; the
   running statistics moved); (e) the four training programs as pods
   (``python -m``, the reference's line) with ``VIT_PRESET=b16`` and
   ``RESNET_PRESET=50``, all at once, then ``LLAMA_PRESET=8b`` alone
   where its reckoned peak fits the card's free memory.
15. tp       -- tensor-parallel serving (``tp_phase``, last), ranks spawned
   by ``kubegpu_tpu_torch.parallel.launch``: (a) phase 6's narrow f32
   config, every knob (waves, int8 and int4 pages, prefix cache + chunked
   prefill, the speculative tick fused 2 at a time) at tp = 1 and on two
   gloo ranks sharing the card (eager: gloo cannot be captured, and a
   gloo engine with ``graphs=True`` must raise): equal tokens on the
   model-dtype pools, every rank's host digest equal; (b) Llama-3-8B's
   width cut to 4 of 32 layers (gloo is a check, not a path), in bf16:
   the tp = 1 engine's bf16 window (graph and eager), its int8 and
   int4 windows (eager) and its first-step logits, then the engine
   freed and two gloo ranks, each making the weights from the seed and
   serving its shard (kernels 4-6 over 4 kv heads of 16 query heads):
   the first-step logits within 3e-2 relative L2, the token agreement,
   tokens/s beside tp = 1, a tick's wall with and without its
   collectives, each rank's peak memory; (c) the NCCL path with graphs
   over ``min(4, device_count)`` cards at all 32 layers, against a tp = 1
   graph engine of its own, or a line saying it was not run
   for want of cards.  Kernels 4-6 also run in phase 3 at the local
   shapes of tp = 2 and 4.
16. pool_tp  -- the serving pools at tp > 1 (``pool_tp_phase``): each
   replica a gang of tp rank processes (``DataParallelServePool(tp=2)``,
   ``DisaggServePool(1, 1, tp=2)``), cutting its shards from this
   process's weights on the card.  (a) The narrow f32 config over gloo
   ranks sharing the card: the 1 + 1 disaggregated pool's tokens, routes,
   migrations and replica host digests equal the tp = 1 pool's.  (b)
   Llama-3-8B's width cut to 4 of 32 layers (gloo is a check, not a
   path), four gloo ranks on the card, eager: the dp pool over bf16 pages
   (kernel 4) and the disaggregated pool over int8 pages (kernel 5; three
   pools of ranks in all since phase 19 was added, for the script's time
   limit), every rank's launches equal ``stride × n_layers`` a
   tick at 4 local kv heads; pool tokens/s beside one gang's on the same
   window (the pool after ``retire_replica(1)``; 8 prompts of 16 new
   tokens: a wave and a tick a replica, a check and not a throughput),
   the round trip a replica step costs, migration ms and bytes a chain,
   each rank's peak memory (below the whole tree's bytes), first-step
   logits within 3e-2 relative L2 of tp = 1's, the token agreement with
   the tp = 1 pool (not gated).  (c) NCCL with graphs at 32 layers over
   four cards (gang 0 on cards 0-1, gang 1 on 2-3), as (b) over bf16
   pages, and the throughput: the dp pool and one gang on a window of 32
   prompts of 128 new tokens (two waves and 16 ticks a replica); or a
   line saying it was not run for want of cards.
17. cluster  -- the cluster layer (``cluster_phase``): (a)
   ``NvmlBackend().discover()`` against ``torch.cuda`` and nvidia-smi
   (count, names, UUIDs, memory, NVLink pairs, the slice type picked);
   (b) the cluster ``apply --real --set backend.type=nvml`` builds
   (``SimCluster.from_config``: one node agent over ``NvmlBackend``) with
   real pods: ``kubegpu_tpu_torch/examples/config2-resnet-1gpu.json`` and
   ``serve-llama.json`` (a static and a continuous serving pod) applied at
   once, each pod exiting 0 on the card its grant names (the UUID it
   reports equals its ``CUDA_VISIBLE_DEVICES``, one card visible), its
   metric lines harvested as ``workload_*``, its kernel launches among
   them (``KUBETPU_REPORT_LAUNCHES=1``; the continuous pod must have run
   kernel 5, which decodes its int8 pages); two cards run pods at once, one card each after the
   one before; then ``python -m kubegpu_tpu_torch apply -f
   config2-resnet-1gpu.json --real --set backend.type=nvml`` as
   ``cli.main``, which must exit 0 with its pod Succeeded; (c) host
   only, 32 mock ``h100-sxm-8`` nodes filled by a seeded mix of 1- to
   16-card gangs in one scheduling pass each: decision ms p50/p99, mean
   locality, every gang on one node unless it is a multislice 16.
18. gang     -- the gang bootstrap and fault recovery (``gang_phase``),
   through the cluster ``apply --real --set backend.type=nvml``
   builds: (a) ``NvmlBackend().discover()`` with its health reads
   (remapped rows, XID events, NVLink pairs): which the card answers,
   what they read, every card healthy; (b) with two or more cards
   ``allreduce-bench.json`` and ``dp-gang.json`` at ``min(4, cards)``
   workers over NCCL, each worker on the card its grant names, worker
   0's bandwidth line, the NCCL transport of each pair (``NCCL_DEBUG=
   INFO``), the dp gang's workers each launching kernels 1-3 (their
   CUDA-core instances: the preset is f32) and its losses within 1e-4
   relative of one worker's at the same global batch; on one card two
   ``allreduce_bench`` workers with a 2-pod gang's env of 500 millicards
   sharing it over gloo (started as the node agent starts pods: the
   allocator places no fractional gang), and a line saying the NCCL
   gangs were not run; (c) with two or more
   cards the all-reduce bus bandwidth over NCCL ranks, one a card, at
   bf16 buffers of 4 MiB to 1 GiB, beside the 450 GB/s a direction
   registered for ``h100-sxm-*``; (d) a running ``llama_pjit`` gang (one
   pod on one card, two workers on more) loses a card it holds: the next
   tick kills every member and requeues the gang, which is re-placed on
   other cards where enough are healthy, else pends until the card heals,
   then runs to Succeeded (ms and ticks from the fault to the eviction
   and from the heal or re-placement to Succeeded).
19. daemons  -- the cluster layer as its operators run it
   (``daemons_phase``): (a) three processes on this host, ``python -m
   kubegpu_tpu_torch.kubemeta.apiserver_serve`` on a free port, ``python
   -m kubegpu_tpu_torch.scheduler.daemon`` and ``python -m
   kubegpu_tpu_torch.crishim.serve --backend nvml --real-processes --env
   KUBETPU_REPORT_LAUNCHES=1 --http-port ...``, talking only over HTTP and
   the CRI socket; the Node read back over HTTP advertises this host's
   cards (nvidia-smi's UUIDs, NVML's slice type).  (b) ``serve-llama.json``'s
   ``llama-serve-cb`` created over ``HttpApiClient`` and followed on the
   watch to Succeeded; over HTTP, the card its log says it saw is the one
   its ``AllocateFrom`` names (through the node's advertisement), and the
   node's ``/metrics`` holds every metric line it printed, kernel 5's
   launches above 0; then one-card ``python -c`` probe pods, one at a
   time: ms from the create to the SCHEDULED event at the client, p50 and
   p99.  (c) In this process the cluster ``SimCluster.from_config`` builds
   with ``backend.type=nvml`` (its own apiserver) behind
   ``ExtenderHTTPServer``: a one-card pod through ``/filter``,
   ``/prioritize`` and ``/bind``, whose ``AllocateFrom`` names a card of
   this host.  (d) With two or more cards ``allreduce-bench.json``'s gang
   at ``min(4, cards)`` workers through the daemons, each worker on its
   grant's card.  At the end the daemons are stopped, and no process the
   phase started is alive or listed by nvidia-smi's or NVML's compute
   processes.
20. workloads -- the allocator core and the workload surface
   (``workloads_phase``, last): (a) the C++ allocator core compiled
   afresh with this host's compiler (seconds); each of its seven entries
   against the Python paths (``KUBETPU_NO_NATIVE=1``) on seeded
   occupancies of ``h100-sxm-8`` and ``v5e-256``, all equal; phase 17
   (c)'s seeded gang mix over 32 mock ``h100-sxm-8`` nodes with the core
   and on the Python paths: equal bindings and localities, decision ms
   p50/p99 of each.  (b) On ``--set backend.type=nvml``: ``configs``
   (the nine names), ``demo config1 --real`` (its 0-card pod sees no
   card), ``demo config2 --real`` (the ResNet pod on the card its grant
   names), ``metrics --format prometheus`` of
   ``config2-resnet-1gpu.json`` scheduled, and a ``mnist_mlp`` pod whose
   loss falls on its granted card, its first and last losses against
   ``mnist_mlp.train`` on the CPU from the same initial parameters;
   ``prefetch_to_device``'s card branch against its numpy source,
   exactly, over six epochs; every pod's kernel launches as it reported
   them (``KUBETPU_REPORT_LAUNCHES=1``).

Twenty paths are driven: serving (phases 4-5), the prefix cache (5f),
speculative serving (5g),
quantized serving (5b),
int8-weight serving (5c), the search decoders (5h, after 5c), the
static path and the dense engine (5d-5e, which run no kernel of the port,
as the reference runs no Pallas kernel there), training (phase 7's steps), T5 paged serving (phase 8's bf16
paged calls), the program's in-process engine runs (phase 9),
sampling with the request lifecycle (phase 10, run after 5e), the
serving pools (phase 11, after 10), the load harness (phase 12, after
11), MoE serving (phase 13), the training families (phase 14) and
tensor-parallel serving (phase 15) and the pools at tp > 1 (phase 16;
the counts of both are the ranks'); the cluster layer (phase 17), the
gangs (phase 18), the daemons (phase 19) and the workload surface (phase
20, last) launch no kernel in this process: their pods are processes of
their own, and report their counts as metric lines (phase 20's pods run
no kernel of the port).  Launch
counters are zeroed just before each and read just after; a graph replay
counts the launches captured in it.  The serving and training paths must
run kernels 1-3 on their tensor-core instances only.  The line
before the last is one JSON object per kernel; the last line is
``{"ok": true, "device": {...}}``.  ``--details PATH`` writes every
phase's numbers to PATH as JSON.  With ``--profile`` it also traces one
steady tick of the bf16, the int8, the int8-weight and the dense engine,
and one spec tick (the draft's kernel-4 time against the verify's),
each as a graph replay and eagerly (the profiler must see the paged
kernel inside the graph), one replayed static decode step per format
(with its weight products, weight copies and attention timed alone), a
block of T5's paged decode like the ticks, one train step after phase
7 (device time by kernel, idle share), and three steady steps of phase
12's bf16 engine with ``collect_overlap`` off and on.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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


# ViT-B/16's attention (phase 14 (c)): bidirectional, 197 tokens (196
# patches and the class token, a ragged last tile), 12 heads of 64, MHA
VIT_ATTN = {"b": 128, "h": 12, "t": 197, "d": 64}


def vit_shape_checks(torch, gen) -> dict:
    """Kernels 1-3 at ViT-B/16's attention shape, bf16, non-causal, on
    their tensor-core instances: the forward and lse against
    ``xla_attention`` / ``_xla_lse``, dq and dk/dv against
    ``flash_attention_bwd_ref``, equal bits on two launches of each, and
    each one's time, bound and share beside ``scaled_dot_product_attention``
    (forward, and autograd's backward of one call).  Returns {kernel:
    numbers}."""
    fa = importlib.import_module("kubegpu_tpu_torch.ops.flash_attention")
    from kubegpu_tpu_torch import kernels
    b, h, t, d = (VIT_ATTN[k] for k in "bhtd")
    check(fa._flash_route(torch.bfloat16, d) == "tc",
          "ViT's shape does not route to the tensor cores")
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    tc0 = {n: kernels.launches[f"{n}/tc"] for n in
           ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    out, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    out2, lse2 = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    ref = fa.xla_attention(q, k, v, causal=False)
    ref_lse = fa._xla_lse(q, k, False, d ** -0.5)
    torch.cuda.synchronize()
    fwd = {"max_abs_err": max_err(out, ref),
           "scaled_err": ((out.float() - ref.float()).abs()
                          / ref.float().abs().clamp(min=1)).max().item(),
           "lse_err": max_err(lse, ref_lse),
           "bit_equal": bool(torch.equal(out, out2)
                             and torch.equal(lse, lse2))}
    del out2, lse2, ref, ref_lse
    # the training shape's limits (flash_bwd_checks): 2e-2 per unit of
    # max(1, |ref|), 1e-3 on lse, 1e-2 relative on the gradients
    check(fwd["scaled_err"] <= 2e-2 and fwd["lse_err"] <= 1e-3,
          f"flash bf16 ViT shape: {fwd}")
    check(fwd["bit_equal"], "flash_fwd ViT shape: two launches differ")
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, False)
    dq, dq2 = (fa._flash_bwd_dq_cuda(*args) for _ in range(2))
    (dk, dv), (dk2, dv2) = (fa._flash_bwd_dkv_cuda(*args) for _ in range(2))
    rq, rk, rv = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, False)
    torch.cuda.synchronize()
    errs = {"dq": rel_err(dq, rq), "dk": rel_err(dk, rk),
            "dv": rel_err(dv, rv)}
    check(max(errs.values()) <= 1e-2, f"flash bwd bf16 ViT shape rel err "
          f"{errs} > 1e-2")
    out_dq = {"max_abs_err": max_err(dq, rq), "rel_err": errs["dq"],
              "bit_equal": bool(torch.equal(dq, dq2))}
    out_dkv = {"max_abs_err": max(max_err(dk, rk), max_err(dv, rv)),
               "rel_err": max(errs["dk"], errs["dv"]),
               "bit_equal": bool(torch.equal(dk, dk2)
                                 and torch.equal(dv, dv2))}
    check(out_dq["bit_equal"] and out_dkv["bit_equal"],
          "flash backward ViT shape: two launches differ")
    tc = {n: kernels.launches[f"{n}/tc"] - tc0[n] for n in tc0}
    check(tc == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2},
          f"the ViT shape ran off the tensor cores: {tc}")
    del dq2, dk2, dv2, rq, rk, rv
    log("kernels", kernel="flash_fwd+bwd", case=f"bf16 [{b},{h},{t},{d}] "
        "non-causal MHA (ViT-B/16)", fwd_scaled_err=fwd["scaled_err"],
        lse_err=fwd["lse_err"], rel_err=errs, bit_equal=True)
    pairs = b * h * t * t
    io = (q.numel() + k.numel() + v.numel() + do.numel()) * 2 \
        + (lse.numel() + delta.numel()) * 4
    fwd["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=False,
                                                   return_lse=True))
    fwd["plain_ms"] = cuda_ms(lambda: fa.xla_attention(q, k, v, False),
                              reps=5)
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(
        (2 * q.numel() + k.numel() + v.numel()) * 2 + lse.numel() * 4,
        2 * 2 * d * pairs, q.dtype)
    out_dq["ms"] = cuda_ms(lambda: fa._flash_bwd_dq_cuda(*args))
    out_dkv["ms"] = cuda_ms(lambda: fa._flash_bwd_dkv_cuda(*args))
    out_dq["plain_ms"] = out_dkv["plain_ms"] = cuda_ms(
        lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse, do, False),
        reps=5)
    out_dq["bound_ms"], out_dq["bound_by"] = bound_ms(
        io + q.numel() * 2, 3 * 2 * d * pairs, q.dtype)
    out_dkv["bound_ms"], out_dkv["bound_by"] = bound_ms(
        io + 2 * k.numel() * 2, 4 * 2 * d * pairs, q.dtype)
    import torch.nn.functional as F
    fwd["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=False))
    lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=False)
    out_dq["library_ms"] = out_dkv["library_ms"] = cuda_ms(
        lambda: torch.autograd.grad(lo, (lq, lk, lv), do, retain_graph=True))
    del lo
    for name, r, flops in (("flash_fwd", fwd, 2 * 2 * d * pairs),
                           ("flash_bwd_dq", out_dq, 3 * 2 * d * pairs),
                           ("flash_bwd_dkv", out_dkv, 4 * 2 * d * pairs)):
        rate_line(r, flops, name, f"ViT shape [{b},{h},{t},{d}] non-causal")
        log("kernels", kernel=name, case="ViT shape", ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"])
    return {"flash_fwd": fwd, "flash_bwd_dq": out_dq,
            "flash_bwd_dkv": out_dkv}


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


# the chunk step's call shape: C = 256 prompt positions of Llama-3-8B's 32
# query heads folded over 8 kv heads (a group of 1024), a history of 3
# pages of 128 (s = 384), in the engine's table of 12 pages
CHUNK = {"c": 256, "s": 384, "width": 12}


def chunk_shape_checks(torch, gen) -> dict:
    """Kernels 4-6 at the chunk step's folded shape (q [1, 8192, 128] bf16,
    ``t = t_pad = s = 384``, ``d = 0``) against ``paged_attention_ref`` on
    one pool (bf16, and quantized to int8 and int4 groups of 16): o within
    1e-2, m within 1e-3, l within 1e-3 relative; then a first chunk's row,
    s = 0, which holds no valid key and must give l = 0 and a finite o (it
    drops out of the merge).  Times at the folded shape, the bound from
    this data's bytes (K and V of the 384 valid keys, q, the table, o, m,
    l) and operations, and the share of the bound."""
    pa = importlib.import_module("kubegpu_tpu_torch.ops.paged_attention")
    kvq = importlib.import_module("kubegpu_tpu_torch.ops.kvquant")
    c, s, width = CHUNK["c"], CHUNK["s"], CHUNK["width"]
    hq = 32 * c
    table = [[3, 17, 29, 5, 11] + [0] * (width - 5)]
    q, pk, pv, pt, _, _, _ = paged_case(torch, gen, torch.bfloat16, 4, 41, 8,
                                        128, 128, hq, [(table[0], s, s, 0)])
    i32 = dict(dtype=torch.int32, device="cuda")
    sv, zero = torch.full((1,), s, **i32), torch.zeros((1,), **i32)
    pools = {"bf16": (pk, pv, None, None),
             "q8": quantize_pool(torch, kvq, pk, pv, "q8"),
             "q4g16": quantize_pool(torch, kvq, pk, pv, "q4g16")}
    kv_bytes = {"bf16": s * 8 * 128 * 2 * 2, "q8": s * 8 * (128 + 4) * 2,
                "q4g16": (s * 64 + (s // 16) * 4) * 8 * 2}
    fixed = hq * 128 * 2 + width * 4 + 3 * 4 + hq * (128 + 2) * 4
    flops = 4 * hq * 128 * s
    out = {}
    for fmt, (kq, vq, ks, vs) in pools.items():
        args = (q, kq, vq, pt, 3, sv, sv, zero, ks, vs)
        o, m, l = pa.paged_attention(*args)
        ro, rm, rl = pa.paged_attention_ref(*args)
        first = pa.paged_attention(q, kq, vq, pt, 3, zero, zero, zero, ks, vs)
        torch.cuda.synchronize()
        err = max_err(o, ro)
        m_err = max_err(m, rm)
        l_rel = ((l - rl).abs() / rl.clamp(min=1e-30)).max().item()
        check(err <= 1e-2, f"chunk-shape paged {fmt}: o max |err| {err}")
        check(m_err <= 1e-3 and l_rel <= 1e-3,
              f"chunk-shape paged {fmt}: m err {m_err} / l rel err {l_rel}")
        check(not first[2].any().item()
              and bool(torch.isfinite(first[0]).all()),
              f"chunk-shape paged {fmt}: the s = 0 row must give l = 0 and "
              "a finite o")
        r = {"max_abs_err": err, "m_err": m_err, "l_rel_err": l_rel}
        r["ms"] = cuda_ms(lambda: pa.paged_attention(*args))
        r["plain_ms"] = cuda_ms(lambda: pa.paged_attention_ref(*args),
                                reps=5)
        r["library_ms"] = None   # no single PyTorch call reads a page table
        r["bound_ms"], r["bound_by"] = bound_ms(fixed + kv_bytes[fmt], flops,
                                                torch.bfloat16)
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        log("kernels", kernel=f"paged {fmt}", case=f"chunk shape q [1, {hq}, "
            f"128] bf16 (C={c} folded), s={s}, table {width} wide; s=0 row "
            "l=0, o finite", max_abs_err=err, tol=1e-2, m_err=m_err,
            l_rel_err=l_rel, ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            share_of_bound=r["share_of_bound"])
        out[fmt] = r
    return out


# the speculative verify's call shape (phase 5g): γ + 1 positions of
# Llama-3-8B's 32 query heads folded over 8 kv heads for each of 8 rows,
# over the engine's table of 12 pages of 128
VERIFY_GAMMAS = (4, 2)


def verify_shape_checks(torch, gen, slice_lens) -> dict:
    """Kernels 4-6 at the verify's batched folded shape (q [8, 32(γ+1),
    128] bf16 for γ = 4 and 2: groups of 20 and 12, cut into query chunks
    of 8 + 8 + 4 and 8 + 4 within one launch) against
    ``paged_attention_ref``: prompts of ``slice_lens`` (200-512) keys in a
    512 bucket and 0-64 flushed decode keys a row (histories of 200-576),
    one pool (bf16, and quantized to int8 and int4 groups of 16); o within
    1e-2, m within 1e-3, l within 1e-3 relative, and equal bits on two
    launches.  Times, the bound from this data's bytes (K and V of each
    row's valid keys, q, the table, o, m, l) and operations, and the share
    of the bound."""
    pa = importlib.import_module("kubegpu_tpu_torch.ops.paged_attention")
    kvq = importlib.import_module("kubegpu_tpu_torch.ops.kvquant")
    ds = [int(x) for x in torch.randint(0, 65, (8,), generator=gen,
                                        device="cuda")]
    rows = [([1 + 5 * i + j for j in range(5)] + [0] * 7, n, 512, d)
            for i, (n, d) in enumerate(zip(slice_lens, ds))]
    out = {}
    for gamma in VERIFY_GAMMAS:
        hq = 32 * (gamma + 1)
        q, pk, pv, pt, t, tpad, d = paged_case(
            torch, gen, torch.bfloat16, 4, 41, 8, 128, 128, hq, rows)
        pools = {"bf16": (pk, pv, None, None),
                 "q8": quantize_pool(torch, kvq, pk, pv, "q8"),
                 "q4g16": quantize_pool(torch, kvq, pk, pv, "q4g16")}
        valid = sum(r[1] + r[3] for r in rows)
        groups = sum(-(-r[1] // 16) + -(-r[3] // 16) for r in rows)
        kv_bytes = {"bf16": valid * 8 * 128 * 2 * 2,
                    "q8": valid * 8 * (128 + 4) * 2,
                    "q4g16": (valid * 64 + groups * 4) * 8 * 2}
        fixed = (8 * hq * 128 * 2 + 8 * 12 * 4 + 3 * 8 * 4
                 + 8 * hq * (128 + 2) * 4)
        flops = 4 * hq * 128 * valid
        for fmt, (kq, vq, ks, vs) in pools.items():
            args = (q, kq, vq, pt, 3, t, tpad, d, ks, vs)
            got = pa.paged_attention(*args)
            again = pa.paged_attention(*args)
            ref = pa.paged_attention_ref(*args)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"verify-shape paged {fmt} γ={gamma}: two launches differ")
            err = max_err(got[0], ref[0])
            m_err = max_err(got[1], ref[1])
            l_rel = ((got[2] - ref[2]).abs()
                     / ref[2].clamp(min=1e-30)).max().item()
            check(err <= 1e-2, f"verify-shape paged {fmt} γ={gamma}: o max "
                  f"|err| {err}")
            check(m_err <= 1e-3 and l_rel <= 1e-3,
                  f"verify-shape paged {fmt} γ={gamma}: m err {m_err} / l "
                  f"rel err {l_rel}")
            r = {"max_abs_err": err, "m_err": m_err, "l_rel_err": l_rel}
            r["ms"] = cuda_ms(lambda: pa.paged_attention(*args))
            r["plain_ms"] = cuda_ms(lambda: pa.paged_attention_ref(*args),
                                    reps=5)
            r["library_ms"] = None   # no PyTorch call reads a page table
            r["bound_ms"], r["bound_by"] = bound_ms(
                fixed + kv_bytes[fmt], flops, torch.bfloat16)
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
            log("kernels", kernel=f"paged {fmt}", case=f"verify shape q [8, "
                f"{hq}, 128] bf16 (γ={gamma}: group {4 * (gamma + 1)} a kv "
                f"head), {valid} valid keys, two launches equal",
                max_abs_err=err, tol=1e-2, m_err=m_err, l_rel_err=l_rel,
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], share_of_bound=r["share_of_bound"])
            out.setdefault(fmt, {})[f"gamma{gamma}"] = r
        del pools, pk, pv
    return out


# kernel 4 at the search decoders' call shapes (phase 5h): a sequence's W
# beams folded into the query group over its prompt pages (t = t_pad, d = 0;
# t_pad unaligned at t = 500), and the prompt-lookup verify's γ + 1 = 9
# positions folded over a history wholly in the decode region (t = t_pad =
# 0, d = pos), in tables of ceil((1152 + γ) / 128) + 1 = 11 pages
SEARCH_SHAPES = {"beam": {"rows": 4, "beams": 4, "pages": 4, "t": (512, 500)},
                 "pld": {"rows": 8, "gamma": 8, "pages": 11,
                         "pos": (1024, 1152), "short_pos": 37}}


def search_shape_checks(torch, gen) -> dict:
    """Kernel 4 at the beam shape (q [4, 32·4, 128] bf16: 4 beams × 4 query
    heads a kv head, 2 query chunks of 8, over 4 pages a row, t = t_pad =
    512 and, unaligned, 500; d = 0) and the PLD verify shape (q [8, 32·9,
    128] bf16: a group of 36, 5 query chunks of <= 8, over 11-page tables,
    t = t_pad = 0, d = pos in [1024, 1152) and one row at pos = 37 < P)
    against ``paged_attention_ref``: o within 1e-2, m within 1e-3, l within
    1e-3 relative, equal bits on two launches.  Times, the bound from this
    data's bytes (K and V of each row's valid keys, q, the table, t/t_pad/d,
    o, m, l) and operations, and the share of the bound."""
    pa = importlib.import_module("kubegpu_tpu_torch.ops.paged_attention")
    beam, pld = SEARCH_SHAPES["beam"], SEARCH_SHAPES["pld"]
    cases = {}
    for t in beam["t"]:
        n = beam["pages"]
        rows = [([1 + n * i + j for j in range(n)], t, t, 0)
                for i in range(beam["rows"])]
        cases[f"beam_t{t}"] = (rows, 32 * beam["beams"])
    pos = [int(x) for x in torch.randint(*pld["pos"], (pld["rows"],),
                                         generator=gen, device="cuda")]
    pos[-1] = pld["short_pos"]
    n = pld["pages"]
    cases["pld_verify"] = ([([1 + n * i + j for j in range(n)], 0, 0, p)
                            for i, p in enumerate(pos)],
                           32 * (pld["gamma"] + 1))
    out = {}
    for label, (rows, hq) in cases.items():
        b = len(rows)
        n_pages = 1 + sum(len(r[0]) for r in rows)
        q, pk, pv, pt, t, tpad, d = paged_case(
            torch, gen, torch.bfloat16, 4, n_pages, 8, 128, 128, hq, rows)
        args = (q, pk, pv, pt, 3, t, tpad, d)
        got = pa.paged_attention(*args)
        again = pa.paged_attention(*args)
        ref = pa.paged_attention_ref(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, c) for a, c in zip(got, again)),
              f"{label} paged bf16: two launches differ")
        err = max_err(got[0], ref[0])
        m_err = max_err(got[1], ref[1])
        l_rel = ((got[2] - ref[2]).abs()
                 / ref[2].clamp(min=1e-30)).max().item()
        check(err <= 1e-2, f"{label} paged bf16: o max |err| {err}")
        check(m_err <= 1e-3 and l_rel <= 1e-3,
              f"{label} paged bf16: m err {m_err} / l rel err {l_rel}")
        valid = sum(r[1] + r[3] for r in rows)
        n_bytes = (valid * 8 * 128 * 2 * 2 + b * hq * 128 * 2
                   + pt.numel() * 4 + 3 * b * 4 + b * hq * (128 + 2) * 4)
        r = {"max_abs_err": err, "m_err": m_err, "l_rel_err": l_rel,
             "q_shape": [b, hq, 128], "valid_keys": valid}
        r["ms"] = cuda_ms(lambda: pa.paged_attention(*args))
        r["plain_ms"] = cuda_ms(lambda: pa.paged_attention_ref(*args),
                                reps=5)
        r["library_ms"] = None   # no PyTorch call reads a page table
        r["bound_ms"], r["bound_by"] = bound_ms(
            n_bytes, 4 * hq * 128 * valid, torch.bfloat16)
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        log("kernels", kernel="paged bf16", case=f"{label} q [{b}, {hq}, "
            f"128] bf16 (group {hq // 8} a kv head), {valid} valid keys, "
            "two launches equal", max_abs_err=err, tol=1e-2, m_err=m_err,
            l_rel_err=l_rel, ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            share_of_bound=r["share_of_bound"])
        out[label] = r
    return out


# kernels 4-6 at the tensor-parallel engine's local shapes (phase 15): each
# rank's decode query holds Llama-3-8B's 32 / tp query heads over its 8 / tp
# kv heads (the group stays 4), over the serving rows of phase 3
TP_DEGREES = (2, 4)


def tp_shape_checks(torch, gen, slice_rows) -> dict:
    """Kernels 4 (bf16 pages), 5 (int8) and 6 (packed int4, groups of 16)
    at the local shapes of tp = 2 (q [8, 16, 128], 4 kv heads) and tp = 4
    (q [8, 8, 128], 2 kv heads), bf16, over the serving rows: against
    ``paged_attention_ref`` (o within 1e-2, m within 1e-3, l within 1e-3
    relative), equal bits on two launches; times, the bound from this
    data's bytes and operations, and the share of the bound."""
    pa = importlib.import_module("kubegpu_tpu_torch.ops.paged_attention")
    kvq = importlib.import_module("kubegpu_tpu_torch.ops.kvquant")
    kernel = {"bf16": "paged_decode", "q8": "paged_decode_q8",
              "q4g16": "paged_decode_q4"}
    out = {k: {} for k in kernel.values()}
    valid = sum(t + d for _, t, _, d in slice_rows)
    groups = sum(-(-t // 16) + -(-d // 16) for _, t, _, d in slice_rows)
    for tp in TP_DEGREES:
        hq, hkv = 32 // tp, 8 // tp
        q, pk, pv, pt, t, tpad, d = paged_case(
            torch, gen, torch.bfloat16, 4, 41, hkv, 128, 128, hq, slice_rows)
        pools = {"bf16": (pk, pv, None, None),
                 "q8": quantize_pool(torch, kvq, pk, pv, "q8"),
                 "q4g16": quantize_pool(torch, kvq, pk, pv, "q4g16")}
        fixed = (8 * hq * 128 * 2 + pt.numel() * 4 + 3 * 8 * 4
                 + 8 * hq * (128 + 2) * 4)        # q, table, state, o/m/l
        kv_bytes = {"bf16": valid * hkv * 128 * 2 * 2,
                    "q8": valid * hkv * (128 + 4) * 2,
                    "q4g16": (valid * 64 + groups * 4) * hkv * 2}
        for fmt, (kq, vq, ks, vs) in pools.items():
            args = (q, kq, vq, pt, 3, t, tpad, d, ks, vs)
            got = pa.paged_attention(*args)
            again = pa.paged_attention(*args)
            ref = pa.paged_attention_ref(*args)
            torch.cuda.synchronize()
            label = f"tp{tp} {fmt}"
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"{label}: two launches differ")
            err = max_err(got[0], ref[0])
            m_err = max_err(got[1], ref[1])
            l_rel = ((got[2] - ref[2]).abs()
                     / ref[2].clamp(min=1e-30)).max().item()
            check(err <= 1e-2, f"{label}: o max |err| {err} > 1e-2")
            check(m_err <= 1e-3 and l_rel <= 1e-3,
                  f"{label}: m err {m_err} / l rel err {l_rel} > 1e-3")
            r = {"max_abs_err": err, "m_err": m_err, "l_rel_err": l_rel,
                 "q_shape": [8, hq, 128], "kv_heads": hkv,
                 "valid_keys": valid}
            r["ms"] = cuda_ms(lambda: pa.paged_attention(*args))
            r["plain_ms"] = cuda_ms(lambda: pa.paged_attention_ref(*args),
                                    reps=5)
            r["library_ms"] = None   # no PyTorch call reads a page table
            r["bound_ms"], r["bound_by"] = bound_ms(
                fixed + kv_bytes[fmt], 4 * hq * 128 * valid, torch.bfloat16)
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
            log("kernels", kernel=kernel[fmt], case=f"tp={tp} local shape q "
                f"[8, {hq}, 128] over {hkv} kv heads, {fmt} pages, two "
                "launches equal", max_abs_err=err, tol=1e-2, m_err=m_err,
                l_rel_err=l_rel, ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                share_of_bound=r["share_of_bound"])
            out[kernel[fmt]][f"tp{tp}"] = r
        del q, pk, pv, pools
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


def window_prompts(torch, cfg, gen, n: int = 12) -> list:
    """``n`` prompts of 200-512 tokens from ``gen``."""
    lens = torch.randint(200, 513, (n,), generator=gen, device="cuda")
    return [torch.randint(0, cfg.vocab_size, (int(k),), generator=gen,
                          device="cuda").tolist() for k in lens]


def serving_window(torch, kernels, eng, cfg, gen, n_new, kernel="paged_decode",
                   prompts=None, up_front: int = 8) -> dict:
    """One timed window: requests with prompts of 200-512 tokens (``prompts``,
    or 12 new ones from ``gen``), ``up_front`` up front and the rest after
    two ticks (slots retire and are re-admitted), run to the end with
    ``drain``; checked and timed on the host clock.  ``kernel`` is the paged
    kernel of the engine's pool format: it must run ``tick_launches`` times
    a tick (``stride × n_layers``, or ``γ × draft_layers + n_layers`` a
    speculative tick), graph replays included, and the other paged kernels
    not at all; the dense engine (``kernel=None``) runs none of them."""
    if prompts is None:
        prompts = window_prompts(torch, cfg, gen)
    tick0, tok0, ev0 = eng._tick, eng.emitted_tokens, eng.pages_evicted
    spec0 = eng.spec_ticks
    before = dict(kernels.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, n_new) for p in prompts[:up_front]]
    done = []
    for _ in range(2):
        done += eng.step()
    rids += [eng.submit(p, n_new) for p in prompts[up_front:]]
    done += eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = (kernels.launches[kernel] - before[kernel]) if kernel else 0
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
    spec_ticks = eng.spec_ticks - spec0
    check(not (eng.slot_req or eng.active.any() or eng.queue),
          "a slot is still held after the window")
    want = (spec_ticks * tick_launches(eng, "spec")
            + (ticks - spec_ticks) * tick_launches(eng, "plain"))
    check(kernel is None or launched == want,
          f"{kernel} launches {launched} != {want} for {ticks} ticks, "
          f"{spec_ticks} of them speculative")
    tokens = eng.emitted_tokens - tok0
    by_rid = {r.rid: r.tokens for r in done}
    return {"tokens_per_s": tokens / wall, "wall_s": wall, "ticks": ticks,
            "spec_ticks": spec_ticks,
            "tokens": tokens, "paged_launches": launched, "prompts": prompts,
            "pages_evicted": eng.pages_evicted - ev0,
            "outputs": [by_rid[r] for r in rids]}


def tick_launches(eng, kind: str) -> int:
    """Paged-kernel launches of one tick of ``kind``: a plain tick's
    ``stride × n_layers``, a speculative one's draft steps (``γ ×
    draft_layers``) and verify (``n_layers``)."""
    n_layers = eng.cfg.n_layers
    if kind == "spec":
        return eng.spec_gamma * eng.draft_layers + n_layers
    return eng.stride * n_layers


def graph_log(label: str, eng) -> dict:
    """The engine's warmup costs: the eager tick before the capture, the
    capture, the instantiation, and the device memory the graph
    reserved."""
    st = eng.graph_stats
    check(st is not None, f"{label}: no CUDA graph was captured")
    log("graph", engine=label, eager_s=round(st["eager_s"], 3),
        capture_s=round(st["capture_s"], 3),
        instantiate_s=round(st["instantiate_s"], 3),
        pool_bytes=st["pool_bytes"], tally=st["tally"])
    return dict(st)


def same_tokens(label: str, graph_run: dict, eager_run: dict) -> None:
    check(graph_run["outputs"] == eager_run["outputs"],
          f"{label}: the graph engine's tokens differ from the eager "
          "engine's on the same prompts")
    check(graph_run["pages_evicted"] == eager_run["pages_evicted"],
          f"{label}: evictions {graph_run['pages_evicted']} (graph) != "
          f"{eager_run['pages_evicted']} (eager)")


ENGINE = dict(n_slots=8, max_len=1024, stride=16, prompt_buckets=(512,),
              paged=True, page_size=128, total_pages=40, device="cuda")


def warmed(torch, kernels, ContinuousBatcher, cfg, params, label, kernel,
           **kw):
    """A ``warmup()``-ed engine: its eager tick on scratch ran ``kernel``
    once per step and layer (a speculative tick: per draft step and draft
    layer, then per layer), the state is untouched, and (a graph engine)
    the graph captured the same launches."""
    eng = ContinuousBatcher(params, cfg, **ENGINE, **kw)
    before = kernels.launches[kernel]
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    want = tick_launches(eng, "spec" if eng.spec_gamma else "plain")
    check(kernels.launches[kernel] - before == want,
          f"{label}: warmup did not run {kernel} once per step and layer")
    check((eng._tick, eng.emitted_tokens) == (0, 0),
          f"{label}: warmup changed the engine's state")
    if eng.graphs:
        check(eng.graph_stats["tally"] == {kernel: want},
              f"{label}: the graph captured {eng.graph_stats['tally']}")
    return eng, warm_s


def serving_phase(torch, kernels, cfg, params, gen, name,
                  windows: int = 3) -> dict:
    """The serving program's order: ``warmup()``, then timed windows of
    staggered requests, on the graph engine and an eager one
    (``graphs=False``) in turns (G E, E G, ...), each window's prompts fed
    to both: tokens equal; tokens/s is each engine's median."""
    import statistics

    from kubegpu_tpu_torch.models import ContinuousBatcher
    n_new = 32
    eng, warm_s = warmed(torch, kernels, ContinuousBatcher, cfg, params,
                         "bf16", "paged_decode")
    eager, eager_warm_s = warmed(torch, kernels, ContinuousBatcher, cfg,
                                 params, "bf16 eager", "paged_decode",
                                 graphs=False)
    graph = graph_log("bf16", eng)
    runs, eager_runs = [], []
    for i in range(windows):
        prompts = window_prompts(torch, cfg, gen)
        order = (eng, eager) if i % 2 == 0 else (eager, eng)
        out = {id(e): serving_window(torch, kernels, e, cfg, gen, n_new,
                                     prompts=prompts) for e in order}
        runs.append(out[id(eng)])
        eager_runs.append(out[id(eager)])
        same_tokens(f"bf16 window {i}", runs[-1], eager_runs[-1])
    rates = [r["tokens_per_s"] for r in runs]
    eager_rates = [r["tokens_per_s"] for r in eager_runs]
    tok_s, eager_tok_s = (statistics.median(rates),
                          statistics.median(eager_rates))
    log("serving", warmup_s=round(warm_s, 3),
        eager_warmup_s=round(eager_warm_s, 3), windows=windows,
        requests=12 * windows, ticks=eng._tick, waves=list(eng.wave_sizes),
        tokens=eng.emitted_tokens, occupancy=round(eng.occupancy, 4),
        graph_equals_eager=True, card=repr(name))
    log("serving", tokens_per_s_median=tok_s, tokens_per_s=rates,
        eager_tokens_per_s_median=eager_tok_s,
        eager_tokens_per_s=eager_rates, wall_s=[r["wall_s"] for r in runs],
        eager_wall_s=[r["wall_s"] for r in eager_runs])
    stats = {"tokens_per_s": tok_s, "tokens_per_s_windows": rates,
             "eager_tokens_per_s": eager_tok_s,
             "eager_tokens_per_s_windows": eager_rates,
             "wall_s_windows": [r["wall_s"] for r in runs],
             "eager_wall_s_windows": [r["wall_s"] for r in eager_runs],
             "warmup_s": warm_s, "eager_warmup_s": eager_warm_s,
             "graph": graph, "ticks": eng._tick,
             "tokens": eng.emitted_tokens, "occupancy": eng.occupancy,
             "pool_bytes": pool_bytes(eng)}
    return stats, eng, eager, runs


def fused_phase(torch, kernels, cfg, params, gen, eng, name) -> dict:
    """The fused window: 8 requests up front (prompts of 200-512 from
    ``gen``), 128 new tokens each, on the graph engine (K = 1) and on one
    with ``fused_ticks=4``, in turns K1, K4, K4, K1: equal tokens, fused
    dispatches on the K = 4 engine, tokens/s of each (median of two)."""
    import statistics

    from kubegpu_tpu_torch.models import ContinuousBatcher
    fused, warm_s = warmed(torch, kernels, ContinuousBatcher, cfg, params,
                           "fused K=4", "paged_decode", fused_ticks=4)
    graph_log("fused K=4", fused)
    prompts = window_prompts(torch, cfg, gen, 8)
    d0 = fused.fused_dispatches
    out = {1: [], 4: []}
    for k, e in ((1, eng), (4, fused), (4, fused), (1, eng)):
        out[k].append(serving_window(torch, kernels, e, cfg, gen, 128,
                                     prompts=prompts))
    for a, b in zip(out[1], out[4]):
        check(a["outputs"] == b["outputs"],
              "fused K=4 tokens differ from K=1 tokens")
    dispatches = fused.fused_dispatches - d0
    check(dispatches > 0, "the K=4 engine never fused")
    stats = {f"k{k}_tokens_per_s": statistics.median(
        r["tokens_per_s"] for r in runs) for k, runs in out.items()}
    stats.update({f"k{k}_tokens_per_s_windows": [r["tokens_per_s"]
                                                for r in runs]
                  for k, runs in out.items()})
    stats.update(fused_dispatches=dispatches,
                 fused_ticks_run=fused.fused_ticks_run,
                 fused_stalls=fused.fused_stalls,
                 ticks=[r["ticks"] for r in out[4]], warmup_s=warm_s)
    log("fused", requests=8, n_new=128, equal=True, **stats, card=repr(name))
    del fused
    return stats


# phase 5f: the serving fast path on phase 5's engine; traffic of four
# groups of three requests sharing a 384-token prefix (3 pages)
PREFIX = dict(prefix_cache=True, chunked_prefill=True, prefill_chunk=256)
PREFIX_NEW = 64


def prefix_prompts(torch, cfg, gen) -> tuple:
    """(leaders, followers): four groups, each a 384-token prefix and three
    distinct tails to 400-500 tokens; the groups' first prompts lead."""
    groups = []
    for _ in range(4):
        shared = torch.randint(0, cfg.vocab_size, (384,), generator=gen,
                               device="cuda").tolist()
        lens = torch.randint(400, 501, (3,), generator=gen, device="cuda")
        groups.append([shared + torch.randint(
            0, cfg.vocab_size, (int(n) - 384,), generator=gen,
            device="cuda").tolist() for n in lens])
    return [g[0] for g in groups], [p for g in groups for p in g[1:]]


def prefix_window(torch, kernels, eng, cfg, leaders, followers) -> dict:
    """The four leaders, two ``step()`` calls (their two chunks each: the
    final one registers their pages), then the eight followers, run to the
    end; time to first token of each request (host clock from its submit
    to the step that fetched its first token), tokens/s over the window,
    and the paged kernel's launches."""
    reqs, t_sub, ttft = {}, {}, {}

    def submit(prompts):
        for p in prompts:
            rid = eng.submit(p, PREFIX_NEW)
            reqs[rid] = eng.queue[-1][0]
            t_sub[rid] = time.perf_counter()

    def step():
        out = eng.step()
        now = time.perf_counter()
        for rid, r in reqs.items():
            if rid not in ttft and r.tokens:
                ttft[rid] = now - t_sub[rid]
        return out

    tick0, tok0 = eng._tick, eng.emitted_tokens
    before = dict(kernels.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    submit(leaders)
    done = step() + step()
    submit(followers)
    while eng.queue or eng.slot_req:
        done += step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: kernels.launches[k] - before.get(k, 0)
                for k in kernels.launches}
    check(sorted(r.rid for r in done) == sorted(reqs),
          "not every request finished")
    for r in done:
        check(len(r.tokens) == PREFIX_NEW and all(
            0 <= x < cfg.vocab_size for x in r.tokens),
            f"rid {r.rid}: {len(r.tokens)} tokens or one out of range")
    eng.check_page_invariants()
    check(not (eng.slot_req or eng.active.any() or eng._prefilling),
          "a slot is still held after the window")
    check(len(eng._free_pages) + len(eng._page_refs) == eng.total_pages
          and not any(eng._page_refs.values()),
          "a page leaked, or a registered page kept a reference")
    rids = sorted(reqs)
    lead = [ttft[r] for r in rids[:len(leaders)]]
    foll = [ttft[r] for r in rids[len(leaders):]]
    by_rid = {r.rid: r.tokens for r in done}
    return {"tokens_per_s": (eng.emitted_tokens - tok0) / wall,
            "wall_s": wall, "ticks": eng._tick - tick0,
            "ttft_leaders_s": lead, "ttft_followers_s": foll,
            "ttft_leaders_mean_s": sum(lead) / len(lead),
            "ttft_followers_mean_s": sum(foll) / len(foll),
            "launches": launched, "outputs": [by_rid[r] for r in rids]}


def first_logits(torch, cfg, params, leaders, followers) -> list:
    """Relative L2 error of each request's first-token logits through the
    chunk step (``prefill_chunk_logits``: a leader's two chunks from page
    0 on fresh pages, a follower's one chunk from page 3 over its leader's
    three pages) against the plain engine's prefill (``prefill_wave``'s
    dense forward at bucket 512, the head at ``t - 1``)."""
    from kubegpu_tpu_torch.models import decode as dec
    from kubegpu_tpu_torch.models import serve as srv
    c, width = PREFIX["prefill_chunk"], CHUNK["width"]
    shape = (cfg.n_layers, 10, cfg.n_kv_heads, 128, cfg.head_dim)
    i32 = dict(dtype=torch.int32, device="cuda")
    errs = []
    with torch.no_grad():
        for g, lead in enumerate(leaders):
            pool = {n: torch.zeros(shape, dtype=cfg.tdtype, device="cuda")
                    for n in ("k", "v")}
            # the leader on pages 1-5, each follower on 1-3 and two own
            rows = [([1, 2, 3, 4, 5], lead, (0, c))] + [
                ([1, 2, 3, 6 + 2 * j, 7 + 2 * j], p, (384,))
                for j, p in enumerate(followers[2 * g:2 * g + 2])]
            for pages, prompt, starts in rows:
                t = len(prompt)
                toks = torch.zeros(512 + c, dtype=torch.long, device="cuda")
                toks[:t] = torch.tensor(prompt, device="cuda")
                pt = torch.tensor([pages + [0] * (width - len(pages))],
                                  **i32)
                for s in starts:
                    got = srv.prefill_chunk_logits(
                        params, pool, toks[None, s:s + c], pt, s,
                        torch.full((1,), t, **i32), cfg, 128)
                cache = dec.init_kv_cache(cfg, 1, 512, device="cuda")
                want, _ = dec._forward_with_cache(
                    params, toks[None, :512], cache, 0, cfg,
                    head_rows=torch.full((1,), t - 1, device="cuda"))
                want = want[:, 0]
                errs.append(((got - want).norm() / want.norm()).item())
            del pool, cache
    return errs


def prefix_phase(torch, kernels, cfg, params, gen, name, plain,
                 profile: bool = False) -> dict:
    """Phase 5f: ``ContinuousBatcher(prefix_cache=True, chunked_prefill=
    True, prefill_chunk=256)`` at phase 5's shape (bf16), a graph engine
    and an eager one (``graphs=False``), each ``warmup()``-ed (the chunk
    step's graph captured: ``n_layers`` launches of kernel 4), then the
    window of ``prefix_window`` on each: equal tokens, exact counters (8
    hits, 24 aliased pages, 3072 tokens saved, 16 chunks), no page leaked;
    every prompt admits through the chunk step, and kernel 4 runs
    ``(ticks × stride + chunks) × n_layers`` times.  The path's launches
    are read after those two windows.  The same window on phase 5's plain
    engine (``plain``) for its prefill tokens,
    time to first token and tokens/s (the share of equal tokens printed:
    near ties at full width); the first-token logits through the chunk
    step against the plain prefill's (relative L2 <= 3e-2); and the chunk
    step alone at its input of phase 3's chunk shape (a 384-token history
    on pages 1-3, writes to trash page 0), wall ms as a graph replay and
    eagerly, and the replay's device ms; with ``profile``, both traced
    (device time by kernel)."""
    from kubegpu_tpu_torch.models import ContinuousBatcher
    leaders, followers = prefix_prompts(torch, cfg, gen)
    stride, n_l = ENGINE["stride"], cfg.n_layers
    engines = {}
    for label, kw in (("graph", {}), ("eager", {"graphs": False})):
        eng = ContinuousBatcher(params, cfg, **ENGINE, **PREFIX, **kw)
        before = kernels.launches["paged_decode"]
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        check(kernels.launches["paged_decode"] - before == (stride + 1) * n_l,
              f"prefix {label}: warmup did not run the tick and the chunk "
              "step")
        if eng.graphs:
            check(eng.graph_stats["tally"] == {"paged_decode": stride * n_l}
                  and eng.chunk_graph_stats["tally"] == {
                      "paged_decode": n_l},
                  f"prefix: the graphs captured {eng.graph_stats['tally']} "
                  f"and {eng.chunk_graph_stats['tally']}")
            log("graph", engine="prefix chunk step",
                **{k: v for k, v in eng.chunk_graph_stats.items()})
        engines[label] = (eng, warm_s)
    runs = {}
    for label, (eng, _) in engines.items():
        r = prefix_window(torch, kernels, eng, cfg, leaders, followers)
        counters = {k: getattr(eng, k) for k in (
            "prefix_hits", "pages_aliased", "prefill_tokens_saved",
            "chunks_run")}
        check(counters == {"prefix_hits": 8, "pages_aliased": 24,
                           "prefill_tokens_saved": 3072, "chunks_run": 16},
              f"prefix {label}: counters {counters}")
        k4 = r["launches"].get("paged_decode", 0)
        check(k4 == (r["ticks"] * stride + eng.chunks_run) * n_l,
              f"prefix {label}: launches {r['launches']} for {r['ticks']} "
              f"ticks and {eng.chunks_run} chunks")
        r.update(counters, prefill_tokens=eng.prefill_tokens)
        runs[label] = r
    # the path ends here: the plain engine's window, the logit comparison
    # and the timing do not count
    path_launches = dict(kernels.launches)
    check(runs["graph"]["outputs"] == runs["eager"]["outputs"],
          "prefix: the graph engine's tokens differ from the eager one's")
    base_tokens = plain.prefill_tokens
    base = prefix_window(torch, kernels, plain, cfg, leaders, followers)
    base_tokens = plain.prefill_tokens - base_tokens
    ref = [x for toks in base["outputs"] for x in toks]
    mine = [x for toks in runs["graph"]["outputs"] for x in toks]
    agree = sum(a == b for a, b in zip(ref, mine)) / len(ref)
    errs = first_logits(torch, cfg, params, leaders, followers)
    check(max(errs) <= 3e-2, f"prefix: first-token logits rel L2 {errs}")
    # the chunk step alone: replay and eager body at phase 3's chunk input
    c = PREFIX["prefill_chunk"]
    step_in = torch.zeros_like(engines["graph"][0]._chunk_in)
    step_in[:c] = torch.randint(0, cfg.vocab_size, (c,), generator=gen,
                                device="cuda").int()
    step_in[c], step_in[c + 1] = CHUNK["s"], 500
    step_in[c + 2:c + 5] = torch.tensor([1, 2, 3], device="cuda")
    step = {}
    for label, (eng, _) in engines.items():
        eng._chunk_in.copy_(step_in)
        fn = (eng._chunk_graph.replay if eng.graphs
              else lambda e=eng: e._chunk_on(e.pool))
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        step[f"{label}_wall_ms"] = (time.perf_counter() - t0) * 200
        if profile:
            trace = device_trace(torch, lambda f=fn: (
                f(), torch.cuda.synchronize()), step[f"{label}_wall_ms"])
            log_trace(f"prefix chunk step ({label})", trace)
            step[f"{label}_trace"] = trace
    step["graph_device_ms"] = cuda_ms(engines["graph"][0]._chunk_graph.replay,
                                      reps=10)
    stats = {label: {k: v for k, v in r.items() if k != "outputs"}
             for label, r in runs.items()}
    stats.update(plain={k: v for k, v in base.items() if k != "outputs"},
                 plain_prefill_tokens=base_tokens, token_agreement=agree,
                 first_logits_rel_l2=errs, chunk_step=step,
                 warmup_s={k: v[1] for k, v in engines.items()},
                 path_launches=path_launches)
    stats["plain"]["prefill_tokens"] = base_tokens
    for label in ("graph", "eager", "plain"):
        r = stats[label]
        log("prefix", engine=label, prefill_tokens=r["prefill_tokens"],
            ttft_leaders_mean_s=r["ttft_leaders_mean_s"],
            ttft_followers_mean_s=r["ttft_followers_mean_s"],
            ttft_leaders_s=r["ttft_leaders_s"],
            ttft_followers_s=r["ttft_followers_s"],
            tokens_per_s=r["tokens_per_s"], wall_s=r["wall_s"],
            ticks=r["ticks"], launches={k: v for k, v in r["launches"].items()
                                        if v and "/" not in k})
    log("prefix", prefix_hits=8, pages_aliased=24,
        prefill_tokens_saved=3072, chunks_run=16, graph_equals_eager=True,
        first_logits_rel_l2_max=max(errs), tol=3e-2,
        token_agreement_with_plain=agree, card=repr(name), **{
            k: v for k, v in step.items() if not k.endswith("_trace")})
    return stats


# phase 5g: speculative serving on phase 5's engine (the reference's cb_spec
# row: 8 slots, prompts in a 512 bucket, pages of 128, 64 new tokens, γ = 4;
# the draft is the first max(1, L / 4) = 8 layers)
SPEC = dict(spec_gamma=4)
SPEC_NEW = 64


def spec_trace(torch, fn, n_draft: int) -> dict:
    """One ``fn()`` (a spec tick, ended by a synchronize) under
    ``torch.profiler``: the device's busy time, its time by kernel name
    (the eight largest), and the paged kernel's time split between the
    draft's launches (the first ``n_draft`` in time order) and the
    verify's (the rest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    paged = [e.device_time_total / 1e3 for e in evs
             if "paged_split" in e.name]
    by_name: dict[str, float] = {}
    for e in evs:
        by_name[e.name[:60]] = (by_name.get(e.name[:60], 0.0)
                                + e.device_time_total / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_busy_ms": sum(e.device_time_total for e in evs) / 1e3,
            "top": [(n, round(ms, 3)) for n, ms in top],
            "device_kernels": len(evs), "paged_calls": len(paged),
            "draft_paged_ms": sum(paged[:n_draft]),
            "verify_paged_ms": sum(paged[n_draft:]),
            "draft_paged_calls": len(paged[:n_draft]),
            "verify_paged_calls": len(paged[n_draft:])}


def spec_tick_timing(torch, eng, prompts, profile: bool) -> dict:
    """The spec tick alone, mid-run: 8 requests of 40 new tokens (16 on
    an eager engine, which runs the tick 7 times here and drains slowly)
    admitted and two ticks run, then the tick body run again on that
    state (its
    tick index reset each time): wall ms over 5 runs, and for a graph
    engine the replay's device ms (``cuda_ms``; an eager tick's thousands
    of launches would fill the launch queue there); with ``profile`` one
    tick traced.  The slots' tokens and positions are restored after, and
    the requests drained unchecked."""
    for p in prompts[:eng.n_slots]:
        eng.submit(p, 40 if eng.graphs else 16)
    eng.step()
    eng.step()
    pos, tokens = eng.pos.clone(), eng.tokens.clone()

    def tick():
        eng._tv["tk"].zero_()
        eng._run_tick("spec")

    tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        tick()
    torch.cuda.synchronize()
    out = {"wall_ms": (time.perf_counter() - t0) * 200,
           "device_ms": cuda_ms(tick, reps=5) if eng.graphs else None}
    if profile:
        out["trace"] = spec_trace(
            torch, lambda: (tick(), torch.cuda.synchronize()),
            eng.spec_gamma * eng.draft_layers)
        check(out["trace"]["paged_calls"] == tick_launches(eng, "spec"),
              f"spec tick trace: {out['trace']['paged_calls']} paged calls")
    eng.pos.copy_(pos)
    eng.tokens.copy_(tokens)
    eng.drain()
    return out


def spec_phase(torch, kernels, cfg, params, gen, name, plain, prompts,
               profile: bool = False) -> dict:
    """Phase 5g: ``ContinuousBatcher(spec_gamma=4)`` (draft of 8 layers) at
    phase 5's shape (bf16), a graph engine and an eager one, each
    ``warmup()``-ed (one spec tick: kernel 4 ``γ × draft_layers + n_layers``
    = 64 times), then the first 8 prompts of phase 5's first window
    (``prompts``: one wave, cut from 12 to keep the run's time) with 64
    new tokens on each: equal tokens, every request finished, no
    page leaked, kernel 4 ``spec_ticks × 64`` times; the same window on
    phase 5's plain engine (``plain``) for its tokens/s.  The path's
    launches are read at the end, less the plain window's.  Then the spec
    tick's wall
    and device ms (graph; wall only eagerly), and windows of the same
    prompts on four more engines: a draft of all 32 layers (its acceptance
    must pass the default draft's, its tokens per tick 1), ``fused_ticks=4``
    (tokens equal to the K = 1 graph engine's) and ``kv_bits=8`` and ``4``
    (kernels 5 and 6 through the verify's window writes)."""
    from kubegpu_tpu_torch.models import ContinuousBatcher
    prompts = prompts[:8]
    engines = {}
    for label, kw in (("graph", {}), ("eager", {"graphs": False})):
        engines[label] = warmed(torch, kernels, ContinuousBatcher, cfg,
                                params, f"spec {label}", "paged_decode",
                                **SPEC, **kw)
    eng, eager = engines["graph"][0], engines["eager"][0]
    graph = graph_log("spec", eng)
    runs = {}
    for label, (e, _) in engines.items():
        runs[label] = serving_window(torch, kernels, e, cfg, gen, SPEC_NEW,
                                     prompts=prompts)
        check(runs[label]["spec_ticks"] == runs[label]["ticks"] > 0,
              f"spec {label}: {runs[label]['spec_ticks']} of "
              f"{runs[label]['ticks']} ticks speculative")
        runs[label].update(acceptance=e.spec_acceptance_rate,
                           tokens_per_tick=e.spec_tokens_per_tick,
                           spec_ticks_total=e.spec_ticks)
    same_tokens("spec", runs["graph"], runs["eager"])
    # the plain engine's window is no part of the path
    base = serving_window(torch, kernels, plain, cfg, gen, SPEC_NEW,
                          prompts=prompts)
    timing = {label: spec_tick_timing(torch, e, prompts, profile)
              for label, (e, _) in engines.items()}
    warm = {label: v[1] for label, v in engines.items()}
    del eng, eager, engines
    torch.cuda.empty_cache()
    extra = {}
    for label, kw, kernel in (
            ("draft32", dict(draft_layers=32), "paged_decode"),
            ("fused4", dict(fused_ticks=4), "paged_decode"),
            ("int8", dict(kv_bits=8), "paged_decode_q8"),
            ("int4", dict(kv_bits=4), "paged_decode_q4")):
        e, warm_s = warmed(torch, kernels, ContinuousBatcher, cfg, params,
                           f"spec {label}", kernel, **SPEC, **kw)
        r = serving_window(torch, kernels, e, cfg, gen, SPEC_NEW,
                           kernel=kernel, prompts=prompts)
        r.update(acceptance=e.spec_acceptance_rate,
                 tokens_per_tick=e.spec_tokens_per_tick, warmup_s=warm_s,
                 fused_dispatches=e.fused_dispatches)
        extra[label] = r
        del e
        torch.cuda.empty_cache()
    path_launches = dict(kernels.launches)   # the path ends here
    path_launches["paged_decode"] -= base["paged_launches"]
    check(extra["draft32"]["acceptance"] > runs["graph"]["acceptance"]
          and extra["draft32"]["tokens_per_tick"] > 1.0,
          f"spec: the 32-layer draft accepts {extra['draft32']['acceptance']}"
          f" (default draft {runs['graph']['acceptance']}), "
          f"{extra['draft32']['tokens_per_tick']} tokens a tick")
    check(extra["fused4"]["outputs"] == runs["graph"]["outputs"]
          and extra["fused4"]["fused_dispatches"] > 0,
          "spec: fused_ticks=4 tokens differ from K = 1, or it never fused")
    stats = {label: {k: v for k, v in r.items()
                     if k not in ("outputs", "prompts")}
             for label, r in {**runs, **extra}.items()}
    stats.update(plain={k: v for k, v in base.items()
                        if k not in ("outputs", "prompts")},
                 tick=timing, capture=graph, warmup_s=warm,
                 path_launches=path_launches)
    for label in ("graph", "eager"):
        r = runs[label]
        log("spec", engine=label, tokens_per_s=r["tokens_per_s"],
            wall_s=r["wall_s"], ticks=r["ticks"],
            acceptance=r["acceptance"], tokens_per_tick=r["tokens_per_tick"],
            paged_launches=r["paged_launches"],
            tick_wall_ms=timing[label]["wall_ms"],
            tick_device_ms=timing[label]["device_ms"])
    log("spec", engine="plain (phase 5's graph engine, same window)",
        tokens_per_s=base["tokens_per_s"], wall_s=base["wall_s"],
        ticks=base["ticks"])
    for label, r in extra.items():
        log("spec", run=label, tokens_per_s=r["tokens_per_s"],
            ticks=r["ticks"], acceptance=r["acceptance"],
            tokens_per_tick=r["tokens_per_tick"],
            paged_launches=r["paged_launches"],
            fused_dispatches=r["fused_dispatches"])
    log("spec", graph_equals_eager=True, fused4_equals_k1=True,
        capture_s=graph["capture_s"], instantiate_s=graph["instantiate_s"],
        graph_pool_bytes=graph["pool_bytes"], card=repr(name))
    if profile:
        for label in ("graph", "eager"):
            log("profile", what=f"one spec tick ({label})",
                **timing[label]["trace"])
    return stats


def pool_bytes(eng) -> int:
    kv = eng.pool if eng.paged else eng.cache
    return sum(x.numel() * x.element_size() for x in kv.values())


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
    engine's is printed, not held: random weights give near-tied logits),
    and an eager engine (``graphs=False``) on those prompts too, whose
    tokens and evictions the graph engine's must equal.  evict_param 0.3
    evicts on the first decoding tick of a 4-page prompt, since the mass
    EMA starts at 0.  With ``profile``, one steady tick of the int8
    engine, graph and eager, is traced after its windows."""
    import statistics

    from kubegpu_tpu_torch.models import ContinuousBatcher
    out = {}
    for label, kw, kernel in QUANT_ENGINES:
        eng, warm_s = warmed(torch, kernels, ContinuousBatcher, cfg, params,
                             label, kernel, **kw)
        graph = graph_log(label, eng)
        runs = [serving_window(torch, kernels, eng, cfg, gen, 32, kernel,
                               prompts=first_window["prompts"]),
                serving_window(torch, kernels, eng, cfg, gen, 32, kernel)]
        eager, _ = warmed(torch, kernels, ContinuousBatcher, cfg, params,
                          f"{label} eager", kernel, graphs=False, **kw)
        eager_run = serving_window(torch, kernels, eager, cfg, gen, 32,
                                   kernel, prompts=first_window["prompts"])
        same_tokens(label, runs[0], eager_run)
        if eng.evict_policy is not None:
            check(eng.pages_evicted >= 1, f"{label}: no page was evicted")
        ref = [x for toks in first_window["outputs"] for x in toks]
        mine = [x for toks in runs[0]["outputs"] for x in toks]
        agree = sum(a == b for a, b in zip(ref, mine)) / len(ref)
        rates = [r["tokens_per_s"] for r in runs]
        stats = {"tokens_per_s": statistics.median(rates),
                 "tokens_per_s_windows": rates,
                 "eager_tokens_per_s": eager_run["tokens_per_s"],
                 "wall_s_windows": [r["wall_s"] for r in runs],
                 "warmup_s": warm_s, "graph": graph, "ticks": eng._tick,
                 "kernel_launches": sum(r["paged_launches"] for r in runs),
                 "pool_bytes": pool_bytes(eng),
                 "pages_evicted": eng.pages_evicted,
                 "pages_evicted_first_window": runs[0]["pages_evicted"],
                 "agree_with_bf16": agree}
        log("serving", engine=label, kernel=kernel,
            tokens_per_s=stats["tokens_per_s"], tokens_per_s_windows=rates,
            eager_tokens_per_s=stats["eager_tokens_per_s"],
            warmup_s=round(warm_s, 3), ticks=eng._tick,
            launches=stats["kernel_launches"], pool_bytes=stats["pool_bytes"],
            pages_evicted=eng.pages_evicted, graph_equals_eager=True,
            agree_with_bf16=agree, card=repr(name))
        if profile and label == "int8":
            stats["profile"] = profile_pair(torch, eng, eager,
                                            first_window["prompts"], label)
        out[label] = stats
        del eng, eager
        torch.cuda.empty_cache()
    return out


# -- phases 5c-5e: int8 weights, the static path, the dense slot engine ---

# llama_serve.py's bench mode (SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS)
STATIC = {"batch": 32, "prompt": 1024, "steps": 128}
DENSE_ENGINE = dict(n_slots=8, max_len=1024, stride=16, prompt_buckets=(512,),
                    paged=False, device="cuda")


def dequantized(tree, dtype):
    """``tree`` with every QTensor leaf dequantized to ``dtype``."""
    from kubegpu_tpu_torch.models.quant import QTensor
    return {k: (dequantized(v, dtype) if isinstance(v, dict) else
                v.dequantize(dtype) if isinstance(v, QTensor) else v)
            for k, v in tree.items()}


def quant_weights_phase(torch, kernels, cfg, params, gen, name,
                        first_window, profile: bool = False):
    """5c: ``quantize_llama`` of the 8B weights on the card (the trees'
    bytes), ``llama_forward [1, 512]`` on them (kernel 1 once a layer)
    against the same forward on their dequantized bf16 weights, and the
    paged engine on int8 weights with ``kv_bits=8`` (kernel 5): a warmed
    graph engine and an eager one, one window each on phase 5's first
    prompts, equal tokens.  Returns (stats, the quantized tree)."""
    from kubegpu_tpu_torch.models import ContinuousBatcher, llama_forward
    from kubegpu_tpu_torch.models.quant import quantize_llama, tree_nbytes
    t0 = time.perf_counter()
    qparams = quantize_llama(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    nbytes = {"bf16": tree_nbytes(params), "int8": tree_nbytes(qparams)}
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen,
                           device="cuda")
    tol = 3e-2
    with torch.no_grad():
        before = kernels.launches["flash_fwd"]
        logits = llama_forward(qparams, tokens, cfg)
        launched = kernels.launches["flash_fwd"] - before
        ref = llama_forward(dequantized(qparams, cfg.tdtype), tokens, cfg)
        rel = ((logits - ref).norm() / ref.norm()).item()
        same = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    check(launched == cfg.n_layers,
          f"int8 forward: flash launches {launched}, want {cfg.n_layers}")
    check(bool(torch.isfinite(logits).all()), "int8 forward not finite")
    check(rel <= tol, f"int8 forward vs dequantized bf16 rel err {rel}")
    del logits, ref
    torch.cuda.empty_cache()
    log("quant", what="weights", quantize_s=round(quant_s, 2),
        tree_bytes=nbytes, forward_rel_l2_err=rel, tol_rel=tol,
        argmax_agree=same, flash_launches=launched)
    eng, warm_s = warmed(torch, kernels, ContinuousBatcher, cfg, qparams,
                         "int8w", "paged_decode_q8", kv_bits=8)
    graph = graph_log("int8 weights + int8 pages", eng)
    eager, _ = warmed(torch, kernels, ContinuousBatcher, cfg, qparams,
                      "int8w eager", "paged_decode_q8", graphs=False,
                      kv_bits=8)
    run = serving_window(torch, kernels, eng, cfg, gen, 32, "paged_decode_q8",
                         prompts=first_window["prompts"])
    eager_run = serving_window(torch, kernels, eager, cfg, gen, 32,
                               "paged_decode_q8",
                               prompts=first_window["prompts"])
    same_tokens("int8 weights", run, eager_run)
    stats = {"quantize_s": quant_s, "tree_bytes": nbytes,
             "forward_rel_l2_err": rel, "forward_tol": tol,
             "forward_argmax_agree": same,
             "tokens_per_s": run["tokens_per_s"],
             "eager_tokens_per_s": eager_run["tokens_per_s"],
             "wall_s": run["wall_s"], "eager_wall_s": eager_run["wall_s"],
             "warmup_s": warm_s, "graph": graph, "ticks": run["ticks"]}
    log("serving", engine="int8 weights + int8 pages",
        tokens_per_s=run["tokens_per_s"],
        eager_tokens_per_s=eager_run["tokens_per_s"],
        warmup_s=round(warm_s, 3), graph_equals_eager=True, card=repr(name))
    if profile:
        stats["profile"] = profile_pair(torch, eng, eager,
                                        first_window["prompts"], "int8w")
    del eng, eager
    torch.cuda.empty_cache()
    return stats, qparams


def step_shares(torch, cfg, params, st, kv_int8: bool) -> dict:
    """``--profile``: one static decode step's parts timed alone at its
    shape (batch 32 at the step's middle position): the weight products
    of one layer and the head (with int8 weights, their ``to(bf16)``
    copies alone too), and one layer's cached attention; the layer parts
    times ``n_layers``."""
    from kubegpu_tpu_torch.models import decode as dec
    from kubegpu_tpu_torch.models.llama import unbind_layers
    from kubegpu_tpu_torch.models.quant import QTensor
    b = st["token"].shape[0]
    lp = unbind_layers(params["layers"])[0]
    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = {n: torch.randn(b, 1, lp[n].shape[0], generator=g, device="cuda",
                        dtype=cfg.tdtype) for n in names}
    xh = torch.randn(b, 1, cfg.d_model, generator=g, device="cuda",
                     dtype=cfg.tdtype)
    q = torch.randn(b, cfg.n_heads, 1, cfg.head_dim, generator=g,
                    device="cuda", dtype=cfg.tdtype)
    qpos = st["pos"].clone()
    cache = st["cache"]
    layer = {n: v[0] for n, v in cache.items()}
    with torch.no_grad():
        gemm = cuda_ms(lambda: [x[n] @ lp[n] for n in names], reps=5)
        head = cuda_ms(lambda: xh @ params["lm_head"], reps=5)
        if kv_int8:
            attend = cuda_ms(lambda: dec._cached_attend_q8(
                q, layer["k"], layer["v"], layer["k_scale"],
                layer["v_scale"], qpos), reps=5)
        else:
            attend = cuda_ms(lambda: dec._cached_attend(
                q, layer["k"], layer["v"], qpos), reps=5)
        copies = head_copy = 0.0
        if isinstance(params["lm_head"], QTensor):
            copies = cuda_ms(lambda: [lp[n].values.to(cfg.tdtype)
                                      for n in names], reps=5)
            head_copy = cuda_ms(
                lambda: params["lm_head"].values.to(cfg.tdtype), reps=5)
    n = cfg.n_layers
    return {"weights_ms": gemm * n + head,
            "weight_copies_ms": copies * n + head_copy,
            "attention_ms": attend * n}


def static_phase(torch, cfg, formats, name, profile: bool = False) -> dict:
    """5d: ``llama_serve.py``'s bench traffic (``STATIC``: batch 32,
    prompt 1024, 128 steps, max_len 1152) through ``prefill`` and
    ``greedy_generate`` for each of ``formats`` ((label, params, kv_int8)),
    by llama_serve's method: one warm call (it captures the step's
    graph), then ``prefill`` alone, a graph call and an eager call
    (``graphs=False``), each bracketed by synchronizes; decode is the call
    less the same-config prefill.  Tokens equal across the calls; peak
    memory (``max_memory_allocated``, both weight trees resident) and the
    graph's pool per format; the graph's state is dropped before the
    eager call.  With ``profile``, one replayed step is traced and its
    parts timed alone (:func:`step_shares`)."""
    from kubegpu_tpu_torch.models import decode as dec
    b, t, steps = STATIC["batch"], STATIC["prompt"], STATIC["steps"]
    max_len = t + steps
    prompt = torch.arange(b * t, device="cuda").reshape(b, t) % cfg.vocab_size
    out = {}
    for label, p, kv_int8 in formats:
        dec.clear_graphs()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0, r

        def generate(graphs: bool):
            return dec.greedy_generate(p, prompt, steps, cfg,
                                       max_len=max_len, kv_int8=kv_int8,
                                       device="cuda", graphs=graphs)

        with torch.no_grad():
            first_s, first = timed(lambda: generate(True))
            prefill_s, _ = timed(lambda: dec.prefill(
                p, prompt, cfg, max_len, kv_int8)[0])
            graph_s, toks = timed(lambda: generate(True))
        graph_peak = torch.cuda.max_memory_allocated()
        (_, st, graphs), = dec._graph_cache.values()
        stats = {}
        if profile:
            step_ms = 1e3 * (graph_s - prefill_s) / (steps - 1)

            def one_step():
                st["pos"].fill_(t + steps // 2)
                graphs["step"].replay()
                torch.cuda.synchronize()
            stats["profile"] = device_trace(torch, one_step, step_ms)
            log_trace(f"one static {label} decode step (graph)",
                      stats["profile"])
            stats["parts"] = step_shares(torch, cfg, p, st, kv_int8)
            log("profile", what=f"static {label} step parts, alone",
                step_ms=round(step_ms, 3),
                **{k: round(v, 3) for k, v in stats["parts"].items()})
        pool = (graphs["step"].pool_bytes, graphs["step"].capture_s,
                graphs["step"].instantiate_s)
        del st, graphs
        # the eager call makes its own state: drop the graph's first
        dec.clear_graphs()
        torch.cuda.empty_cache()
        with torch.no_grad():
            eager_s, eager_toks = timed(lambda: generate(False))
        check(tuple(toks.shape) == (b, steps)
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"static {label}: tokens {tuple(toks.shape)} out of range")
        check(torch.equal(toks, first) and torch.equal(toks, eager_toks),
              f"static {label}: graph tokens differ from eager tokens")
        peak = torch.cuda.max_memory_allocated()
        stats.update({
            "first_call_s": first_s, "prefill_s": prefill_s,
            "graph_s": graph_s, "eager_s": eager_s,
            "decode_s": graph_s - prefill_s,
            "eager_decode_s": eager_s - prefill_s,
            "serve_decode_tokens_per_s":
                b * (steps - 1) / max(graph_s - prefill_s, 1e-9),
            "serve_e2e_tokens_per_s": b * steps / graph_s,
            "eager_serve_decode_tokens_per_s":
                b * (steps - 1) / max(eager_s - prefill_s, 1e-9),
            "eager_serve_e2e_tokens_per_s": b * steps / eager_s,
            "peak_bytes": peak, "graph_run_peak_bytes": graph_peak,
            "weights_and_rest_bytes": base, "graph_pool_bytes": pool[0],
            "capture_s": pool[1], "instantiate_s": pool[2]})
        log("static", weights=label, kv_int8=kv_int8, batch=b, prompt=t,
            steps=steps,
            serve_decode_tokens_per_s=stats["serve_decode_tokens_per_s"],
            serve_e2e_tokens_per_s=stats["serve_e2e_tokens_per_s"],
            eager_serve_decode_tokens_per_s=stats[
                "eager_serve_decode_tokens_per_s"],
            eager_serve_e2e_tokens_per_s=stats["eager_serve_e2e_tokens_per_s"],
            prefill_s=round(prefill_s, 4), graph_s=round(graph_s, 4),
            eager_s=round(eager_s, 4), first_call_s=round(first_s, 3),
            peak_gb=round(peak / 1e9, 2),
            graph_run_peak_gb=round(graph_peak / 1e9, 2),
            resident_gb=round(base / 1e9, 2), graph_pool_bytes=pool[0],
            graph_equals_eager=True, card=repr(name))
        out[label] = stats
    dec.clear_graphs()
    torch.cuda.empty_cache()
    return out


def dense_engine_phase(torch, kernels, cfg, params, gen, name, first_window,
                       profile: bool = False) -> dict:
    """5e: the dense slot engine (``ContinuousBatcher(paged=False)``, the
    reference's default) at phase 5's shape, bf16: ``warmup()`` (it
    captures the tick), then two windows on the graph engine and on an
    eager one in turns (G E, E G; phase 5's first prompts, then new ones):
    tokens equal, no slot held after a window; with ``profile``, one steady
    tick of each traced."""
    import statistics

    from kubegpu_tpu_torch.models import ContinuousBatcher
    engines = {}
    for graphs in (True, False):
        eng = ContinuousBatcher(params, cfg, graphs=graphs, **DENSE_ENGINE)
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        engines[graphs] = (eng, time.perf_counter() - t0)
        check((eng._tick, eng.emitted_tokens) == (0, 0)
              and not eng.cache["k"].any(),
              "dense warmup changed the engine's state")
    (eng, warm_s), (eager, eager_warm_s) = engines[True], engines[False]
    graph = graph_log("dense", eng)
    check(graph["tally"] == {}, f"the dense tick captured {graph['tally']}")
    runs, eager_runs = [], []
    for i, prompts in enumerate((first_window["prompts"],
                                 window_prompts(torch, cfg, gen))):
        order = (eng, eager) if i % 2 == 0 else (eager, eng)
        got = {id(e): serving_window(torch, kernels, e, cfg, gen, 32, None,
                                     prompts=prompts) for e in order}
        runs.append(got[id(eng)])
        eager_runs.append(got[id(eager)])
        same_tokens(f"dense window {i}", runs[-1], eager_runs[-1])
    ref = [x for toks in first_window["outputs"] for x in toks]
    mine = [x for toks in runs[0]["outputs"] for x in toks]
    agree = sum(a == b for a, b in zip(ref, mine)) / len(ref)
    rates = [r["tokens_per_s"] for r in runs]
    eager_rates = [r["tokens_per_s"] for r in eager_runs]
    stats = {"tokens_per_s": statistics.median(rates),
             "tokens_per_s_windows": rates,
             "eager_tokens_per_s": statistics.median(eager_rates),
             "eager_tokens_per_s_windows": eager_rates,
             "warmup_s": warm_s, "eager_warmup_s": eager_warm_s,
             "graph": graph, "ticks": eng._tick,
             "cache_bytes": pool_bytes(eng), "agree_with_paged": agree}
    log("serving", engine="dense", tokens_per_s=stats["tokens_per_s"],
        tokens_per_s_windows=rates,
        eager_tokens_per_s=stats["eager_tokens_per_s"],
        eager_tokens_per_s_windows=eager_rates, warmup_s=round(warm_s, 3),
        ticks=eng._tick, cache_bytes=stats["cache_bytes"],
        graph_equals_eager=True, agree_with_paged=agree, card=repr(name))
    if profile:
        stats["profile"] = profile_pair(torch, eng, eager,
                                        first_window["prompts"], "dense")
    del eng, eager, engines
    torch.cuda.empty_cache()
    return stats


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
    copies = [rec for n, rec in by_name.items() if "copy" in n.lower()]
    port = {k: [sum(r[i] for n, r in by_name.items() if k in n)
                for i in (0, 1)] for k in PORT_KERNELS}
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_ms,
            "device_busy_ms": busy_ms,
            "gemm_ms": sum(ms for ms, _ in gemms),
            "gemm_launches": sum(c for _, c in gemms),
            "copy_ms": sum(ms for ms, _ in copies),
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
        copy_ms=round(out["copy_ms"], 3),
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
    the next is traced.  On a graph engine the tick is a replay: the
    profiler must see the paged kernel inside it once per step and
    layer."""
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
    kind = "graph" if eng.graphs else "eager"
    log_trace(f"one steady {label} engine tick ({kind})", out)
    want = eng.stride * eng.cfg.n_layers if eng.paged else 0
    check(out["port_kernels"]["paged_split"]["calls"] == want,
          f"{label} {kind} tick: the profiler saw "
          f"{out['port_kernels']['paged_split']['calls']} paged kernels, "
          f"want {want}")
    return out


def profile_pair(torch, eng, eager, prompts, label: str) -> dict:
    """One steady tick of the graph engine and of the eager one."""
    out = {"graph": profile_phase(torch, eng, prompts, label),
           "eager": profile_phase(torch, eager, prompts, label)}
    g, e = out["graph"], out["eager"]
    log("profile", what=f"{label} tick, graph vs eager",
        wall_ms=(round(g["wall_ms"], 3), round(e["wall_ms"], 3)),
        device_busy_ms=(round(g["device_busy_ms"], 3),
                        round(e["device_busy_ms"], 3)),
        idle_share=(g["idle_share"], e["idle_share"]),
        device_kernels=(g["device_kernels"], e["device_kernels"]))
    return out


def parity_narrow(torch) -> None:
    from kubegpu_tpu_torch.models import (
        ContinuousBatcher,
        LlamaConfig,
        decode,
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
    # both fast-path knobs: three requests sharing a 16-token page, each
    # prompt past the 16-token chunk (kernel 4 over folded f32 queries)
    eng = ContinuousBatcher(params, cfg, n_slots=3, stride=4,
                            prompt_buckets=(16, 32), paged=True,
                            page_size=16, prefix_cache=True,
                            chunked_prefill=True, prefill_chunk=16,
                            debug_invariants=True, device="cuda")
    eng.warmup()
    shared = torch.randint(0, 512, (16,), generator=g).tolist()
    reqs = [(shared + torch.randint(0, 512, (int(t),), generator=g).tolist(),
             n) for t, n in ((9, 10), (14, 6), (5, 12), (11, 1))]
    rids = {eng.submit(*reqs[0]): reqs[0]}
    done = eng.step() + eng.step() + eng.step()
    rids.update({eng.submit(p, n): (p, n) for p, n in reqs[1:]})
    done += eng.drain()
    check(eng.prefix_hits == 3 and eng.chunks_run == 5,
          f"narrow prefix engine: {eng.prefix_hits} hits, {eng.chunks_run} "
          "chunks")
    for r in done:
        p, n = rids[r.rid]
        solo = greedy_generate(params, [p], n, cfg,
                               device="cuda")[0].tolist()
        check(r.tokens == solo, f"narrow f32 prefix rid {r.rid}: engine "
              f"{r.tokens} != greedy {solo}")
    log("parity", case="narrow f32 prefix cache + chunked prefill engine vs "
        "greedy_generate", requests=len(done), prefix_hits=eng.prefix_hits,
        chunks_run=eng.chunks_run, equal=True)
    # the same traffic on a speculative engine through its graph
    eng = ContinuousBatcher(params, cfg, n_slots=3, stride=4,
                            prompt_buckets=(16, 32), paged=True,
                            page_size=16, prefix_cache=True,
                            chunked_prefill=True, prefill_chunk=16,
                            spec_gamma=2, draft_layers=1,
                            debug_invariants=True, device="cuda")
    eng.warmup()
    check(eng.graph_stats is not None, "narrow spec engine: no graph")
    rids = {eng.submit(*reqs[0]): reqs[0]}
    done = eng.step() + eng.step() + eng.step()
    rids.update({eng.submit(p, n): (p, n) for p, n in reqs[1:]})
    done += eng.drain()
    check(eng.spec_ticks > 0 and eng.prefix_hits == 3,
          f"narrow spec engine: {eng.spec_ticks} spec ticks, "
          f"{eng.prefix_hits} hits")
    for r in done:
        p, n = rids[r.rid]
        solo = greedy_generate(params, [p], n, cfg,
                               device="cuda")[0].tolist()
        check(r.tokens == solo, f"narrow f32 spec rid {r.rid}: engine "
              f"{r.tokens} != greedy {solo}")
    log("parity", case="narrow f32 speculative engine (γ=2, draft 1 layer, "
        "prefix cache + chunked prefill, graph) vs greedy_generate",
        requests=len(done), spec_ticks=eng.spec_ticks,
        acceptance=eng.spec_acceptance_rate, equal=True)
    decode.clear_graphs()


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

def t5_serving(torch, kernels, t5, cfg, params, gen, name) -> dict:
    """8a: the dense and the paged greedy generate on ``T5_SERVE``'s
    traffic (encoding included), through their CUDA graphs (the default)
    and eagerly (``graphs=False``): one warm graph call (it captures),
    then timed calls graph, eager, graph, eager, graph, each bracketed by
    synchronizes.  Every call's tokens equal the first's; tokens/s is
    batch x steps over each mode's median wall.  Launch counters are
    zeroed just before the paged calls and read just after: kernel 7 runs
    ``n_dec_layers x steps`` times a call, replays included."""
    import statistics
    b, steps, page = T5_SERVE["batch"], T5_SERVE["steps"], T5_SERVE["page"]
    enc = torch.randint(0, cfg.vocab_size, (b, T5_SERVE["enc_len"]),
                        generator=gen, device="cuda")
    t5.clear_graphs()
    calls = {"dense": lambda g: t5.t5_greedy_generate(
                 params, enc, steps, cfg, device="cuda", graphs=g),
             "paged": lambda g: t5.t5_greedy_generate_paged(
                 params, enc, steps, cfg, page_size=page, device="cuda",
                 graphs=g)}
    out, toks = {}, {}
    for kind, call in calls.items():
        if kind == "paged":
            kernels.reset_launches()  # the T5 paged serving path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = call(True)
        torch.cuda.synchronize()
        out[f"{kind}_first_call_s"] = time.perf_counter() - t0
        walls = {True: [], False: []}
        for graphs in (True, False, True, False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = call(graphs)
            torch.cuda.synchronize()
            walls[graphs].append(time.perf_counter() - t0)
            check(torch.equal(got, first), f"T5 {kind}: the "
                  f"{'graph' if graphs else 'eager'} call's tokens differ "
                  "from the first graph call's")
        if kind == "paged":
            launches = dict(kernels.launches)   # ... and ends here
        toks[kind] = first
        out[f"{kind}_tokens_per_s"] = b * steps / statistics.median(
            walls[True])
        out[f"{kind}_eager_tokens_per_s"] = b * steps / statistics.median(
            walls[False])
        out[f"{kind}_wall_s"] = walls[True]
        out[f"{kind}_eager_wall_s"] = walls[False]
    graphs = {k[0]: {n: {"capture_s": g.capture_s,
                         "instantiate_s": g.instantiate_s,
                         "pool_bytes": g.pool_bytes, "tally": g.tally}
                     for n, g in v[2].items()}
              for k, v in t5._graph_cache.items()}
    per_call = cfg.n_dec_layers * steps
    check(launches["paged_decode_bias"] == 6 * per_call,
          f"paged_decode_bias ran {launches['paged_decode_bias']} times in "
          f"six paged calls, want {per_call} a call")
    check(not any(v for k, v in launches.items() if k != "paged_decode_bias"),
          f"the T5 path launched other kernels: {launches}")
    check(graphs["paged"]["block"]["tally"] == {
        "paged_decode_bias": cfg.n_dec_layers * page},
          f"the T5 block graph captured {graphs['paged']['block']['tally']}")
    for t in toks.values():
        check(tuple(t.shape) == (b, steps)
              and bool(((t >= 0) & (t < cfg.vocab_size)).all()),
              f"T5 tokens {tuple(t.shape)} out of shape or range")
    agree = (toks["dense"] == toks["paged"]).float().mean().item()
    out.update(paged_launches_per_call=per_call, launches=launches,
               agree_dense_paged=agree, graphs=graphs)
    log("t5", what="serving", batch=b, enc_len=T5_SERVE["enc_len"],
        steps=steps, page=page, dense_tokens_per_s=out["dense_tokens_per_s"],
        dense_eager_tokens_per_s=out["dense_eager_tokens_per_s"],
        paged_tokens_per_s=out["paged_tokens_per_s"],
        paged_eager_tokens_per_s=out["paged_eager_tokens_per_s"],
        dense_wall_s=[round(x, 3) for x in out["dense_wall_s"]],
        paged_wall_s=[round(x, 3) for x in out["paged_wall_s"]],
        first_call_s=(round(out["dense_first_call_s"], 3),
                      round(out["paged_first_call_s"], 3)),
        kernel7_per_call=per_call, graph_equals_eager=True,
        agree_dense_paged=agree, card=repr(name))
    for kind, gs in graphs.items():
        for n, g in gs.items():
            log("graph", t5=f"{kind}/{n}", capture_s=round(g["capture_s"], 3),
                instantiate_s=round(g["instantiate_s"], 3),
                pool_bytes=g["pool_bytes"], tally=g["tally"])
    return out


def t5_quant_serving(torch, kernels, t5, cfg, params, gen, name,
                     serving: dict) -> dict:
    """8b: the paged generate on ``quantize_t5`` weights at ``T5_SERVE``'s
    shape, through its graph: one warm call (it captures), one timed.
    Tokens in shape and range and equal on both calls; kernel 7 runs
    ``n_dec_layers x steps`` times a call; tokens/s beside the bf16
    call's."""
    from kubegpu_tpu_torch.models.quant import quantize_t5, tree_nbytes
    b, steps, page = T5_SERVE["batch"], T5_SERVE["steps"], T5_SERVE["page"]
    q = quantize_t5(params)
    enc = torch.randint(0, cfg.vocab_size, (b, T5_SERVE["enc_len"]),
                        generator=gen, device="cuda")
    t5.clear_graphs()
    before = kernels.launches["paged_decode_bias"]

    def call():
        return t5.t5_greedy_generate_paged(q, enc, steps, cfg, page_size=page,
                                           device="cuda")
    first = call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = kernels.launches["paged_decode_bias"] - before
    check(launched == 2 * cfg.n_dec_layers * steps,
          f"T5 int8: kernel 7 ran {launched} times in two calls")
    check(tuple(toks.shape) == (b, steps)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"T5 int8 tokens {tuple(toks.shape)} out of shape or range")
    check(torch.equal(toks, first), "T5 int8: two calls' tokens differ")
    out = {"paged_tokens_per_s": b * steps / wall, "wall_s": wall,
           "bf16_paged_tokens_per_s": serving["paged_tokens_per_s"],
           "tree_bytes": {"bf16": tree_nbytes(params),
                          "int8": tree_nbytes(q)}}
    log("t5", what="paged serving on int8 weights",
        paged_tokens_per_s=out["paged_tokens_per_s"],
        bf16_paged_tokens_per_s=out["bf16_paged_tokens_per_s"],
        tree_bytes=out["tree_bytes"], card=repr(name))
    t5.clear_graphs()
    return out


def t5_profile(torch, t5, cfg, params) -> dict:
    """``--profile``: one block of T5's paged decode (``page`` steps, its
    third block: two flushed pages a row) as a replay of the cached block
    graph and as the same body run eagerly, each timed untraced and then
    traced; per-step numbers are the block's over ``page``.  The profiler
    must see kernel 7 once per decoder layer and step in both."""
    page = T5_SERVE["page"]
    entry = next(v for v in t5._graph_cache.values() if "block" in v[2])
    st, graph = entry[1], entry[2]["block"]
    runs = {"graph": graph.replay,
            "eager": lambda: t5._t5_paged_block(params, st, page, cfg)}
    out = {}
    for kind, run in runs.items():
        def block():
            st["d0"].fill_(2 * page)
            run()
            torch.cuda.synchronize()
        block()
        t0 = time.perf_counter()
        block()
        wall_ms = (time.perf_counter() - t0) * 1e3
        out[kind] = tr = device_trace(torch, block, wall_ms)
        log_trace(f"one T5 paged block of {page} steps ({kind})", tr)
        log("profile", what=f"T5 paged step ({kind})",
            wall_ms=tr["wall_ms"] / page,
            device_busy_ms=tr["device_busy_ms"] / page,
            device_kernels=tr["device_kernels"] / page)
        want = cfg.n_dec_layers * page
        check(tr["port_kernels"]["paged_split"]["calls"] == want,
              f"T5 {kind} block: the profiler saw "
              f"{tr['port_kernels']['paged_split']['calls']} kernel-7 "
              f"launches, want {want}")
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


def t5_phase(torch, kernels, gen, name, cfg=None, profile=False) -> dict:
    """Phase 8 at ``T5Config()`` (T5 v1.1-base widths, bf16) with random
    weights from ``SEED``: serving (with ``profile``, a traced block),
    parity, training."""
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
    if profile:
        with torch.no_grad():
            serving["profile"] = t5_profile(torch, t5, cfg, params)
    serving["int8"] = t5_quant_serving(torch, kernels, t5, cfg, params, gen,
                                       name, serving)
    parity = t5_parity(torch, t5, cfg, params, gen)
    torch.cuda.empty_cache()
    training = t5_training(torch, t5, cfg, params, gen, name)
    return {"params": n_params, "serving": serving, "parity": parity,
            "training": training}


# -- phase 9: the workload program -----------------------------------------

PROGRAM = "kubegpu_tpu_torch.workloads.programs.llama_serve"
# the env a whole-card grant gets from the crishim; strict mode makes any
# engine fallback of the program an error
POD_ENV = {"KUBETPU_HBM_GIB": "80", "TPU_WORKER_ID": "0",
           "KUBETPU_REQUIRE_PALLAS": "1"}
# the reference program's metric names, in the order it prints them (the
# CPU tests hold these lists to its output)
STATIC_METRICS = (
    "serve_decode_tokens_per_s", "serve_e2e_tokens_per_s", "serve_cfg_batch",
    "serve_cfg_prompt", "serve_cfg_steps", "serve_cfg_int8",
    "serve_phase_prefill_ms", "serve_phase_decode_ms", "serve_phase_e2e_ms")
CONTINUOUS_METRICS = (
    "serve_engine_tokens_per_s", "serve_engine_occupancy",
    "serve_engine_cfg_slots", "serve_engine_cfg_prompt",
    "serve_engine_cfg_steps", "serve_engine_cfg_stride",
    "serve_engine_cfg_requests", "serve_engine_cfg_paged",
    "serve_engine_cfg_tp", "serve_engine_cfg_dp",
    "serve_engine_cfg_mesh_devices", "serve_engine_cfg_kv_int8",
    "serve_engine_cfg_int8_weights", "serve_engine_cfg_prefix_cache",
    "serve_engine_cfg_chunked_prefill", "serve_engine_cfg_spec_gamma",
    "serve_engine_cfg_fused_k", "serve_fused_dispatches",
    "serve_engine_cfg_draft_layers", "serve_engine_spec_accept_rate",
    "serve_engine_spec_tokens_per_tick", "serve_engine_phase_warmup_ms",
    "serve_engine_phase_drain_ms", "serve_engine_waves", "serve_engine_ticks",
    "serve_engine_stall_p50_ms", "serve_engine_stall_p99_ms",
    "serve_failover_total", "serve_requests_retried",
    "serve_slots_quarantined", "serve_requests_shed", "serve_hbm_pool_bytes",
    "serve_hbm_peak_bytes", "serve_goodput_tokens_per_s",
    "serve_requests_preempted", "serve_requests_resumed",
    "serve_deadline_miss", "serve_routing_affinity_hits",
    "serve_autoscale_events", "serve_replicas_active", "serve_kv_bits",
    "serve_pages_evicted_total", "serve_kv_quality_delta")
# the program's bench traffic: 32 slots, prompts of 1024, 128 steps, its
# engine's stride and pages; 32 requests for the in-process runs
BENCH = {"slots": 32, "prompt": 1024, "steps": 128, "stride": 16,
         "page": 128, "reqs": 32}
# (label, env, the paged kernel the run's pool format runs)
PROGRAM_RUNS = (("kv16", {"SERVE_KV_BITS": "16"}, "paged_decode"),
                ("kv8", {}, "paged_decode_q8"),
                ("kv4", {"SERVE_KV_BITS": "4"}, "paged_decode_q4"),
                ("kv8-traced", {"SERVE_TRACE": "1"}, "paged_decode_q8"))


def metric_lines(text: str) -> dict:
    """{metric: value} of the program's JSON metric lines, in order."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith("{") and '"metric"' in ln:
            m = json.loads(ln)
            out[m["metric"]] = m["value"]
    return out


def program_env(extra: dict) -> dict:
    """This process's env without any serving or allocation knob, plus the
    pod's and ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SERVE_", "KUBETPU_", "TPU_"))}
    return {**env, **POD_ENV, **extra}


def program_run(label: str, names: tuple, extra: dict,
                timeout: int = 600) -> dict:
    """``python -m`` the port's program as the pod runs it (``POD_ENV``
    plus ``extra``); rc must be 0 and its metric names ``names``, in
    order.  Returns the metrics and the command's wall seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = program_env(extra)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", PROGRAM], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"llama_serve {label}: rc {r.returncode}\n"
          f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    got = metric_lines(r.stdout)
    check(tuple(got) == names, f"llama_serve {label}: metric names "
          f"{list(got)} differ from the reference program's")
    return {"metrics": got, "wall_s": wall}


def program_shape_checks(torch, gen) -> dict:
    """Kernels 4-6 at ``llama_serve.py``'s bench shape (q [32, 16, 128]
    bf16 over 4 kv heads, pages of 128, prompts of 1024 and 0-152 flushed
    decode keys a row, in the engine's table of 18 pages) against
    ``paged_attention_ref``: o within 1e-2, m within 1e-3, l within 1e-3
    relative, equal bits on two launches; times, the bound from this data's
    bytes and operations, and the share of the bound."""
    pa = importlib.import_module("kubegpu_tpu_torch.ops.paged_attention")
    kvq = importlib.import_module("kubegpu_tpu_torch.ops.kvquant")
    b, hq, hkv, page, t = BENCH["slots"], 16, 4, BENCH["page"], 1024
    ds = [int(x) for x in torch.randint(0, 153, (b,), generator=gen,
                                        device="cuda")]
    # 8 prompt pages and 2 decode pages a row, the rest of 18 empty
    rows = [(list(range(1 + 10 * i, 11 + 10 * i)) + [0] * 8, t, t, d)
            for i, d in enumerate(ds)]
    q, pk, pv, pt, tv, tpad, dv = paged_case(
        torch, gen, torch.bfloat16, 8, 1 + 10 * b, hkv, page, 128, hq, rows)
    pools = {"bf16": (pk, pv, None, None),
             "q8": quantize_pool(torch, kvq, pk, pv, "q8"),
             "q4g16": quantize_pool(torch, kvq, pk, pv, "q4g16")}
    valid = sum(r[1] + r[3] for r in rows)
    groups = sum(-(-r[1] // 16) + -(-r[3] // 16) for r in rows)
    kv_bytes = {"bf16": valid * hkv * 128 * 2 * 2,
                "q8": valid * hkv * (128 + 4) * 2,
                "q4g16": (valid * 64 + groups * 4) * hkv * 2}
    fixed = (b * hq * 128 * 2 + b * 18 * 4 + 3 * b * 4
             + b * hq * (128 + 2) * 4)          # q, table, state, o/m/l
    flops = 4 * hq * 128 * valid
    out = {}
    for fmt, (kq, vq, ks, vs) in pools.items():
        args = (q, kq, vq, pt, 7, tv, tpad, dv, ks, vs)
        got = pa.paged_attention(*args)
        again = pa.paged_attention(*args)
        ref = pa.paged_attention_ref(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"program-shape paged {fmt}: two launches differ")
        err = max_err(got[0], ref[0])
        m_err = max_err(got[1], ref[1])
        l_rel = ((got[2] - ref[2]).abs() / ref[2].clamp(min=1e-30)).max().item()
        check(err <= 1e-2, f"program-shape paged {fmt}: o max |err| {err}")
        check(m_err <= 1e-3 and l_rel <= 1e-3,
              f"program-shape paged {fmt}: m err {m_err} / l rel err {l_rel}")
        r = {"max_abs_err": err, "m_err": m_err, "l_rel_err": l_rel,
             "ms": cuda_ms(lambda: pa.paged_attention(*args)),
             "plain_ms": cuda_ms(lambda: pa.paged_attention_ref(*args),
                                 reps=5),
             "library_ms": None}   # no PyTorch call reads a page table
        r["bound_ms"], r["bound_by"] = bound_ms(fixed + kv_bytes[fmt], flops,
                                                torch.bfloat16)
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        log("program", kernel=f"paged {fmt}", case=f"llama_serve bench shape "
            f"q [{b}, {hq}, 128] bf16 over {hkv} kv heads, {valid} valid "
            "keys, two launches equal", max_abs_err=err, tol=1e-2,
            m_err=m_err, l_rel_err=l_rel, ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            share_of_bound=r["share_of_bound"])
        out[fmt] = r
    return out


def continuous_run(torch, kernels, label, cfg, params, int8, extra,
                   kernel) -> dict:
    """One in-process ``_serve_continuous`` at the bench traffic with
    ``SERVE_REQS=32`` and the pod's env plus ``extra``: rc 0, the reference's
    metric names, and ``kernel`` (and no other of kernels 4-6) launched
    ``n_layers`` times a decode step: ``stride × n_layers`` for warmup's
    eager tick and for each tick dispatched."""
    import contextlib
    import io
    from kubegpu_tpu_torch.workloads.programs import distributed, llama_serve
    saved = dict(os.environ)
    os.environ.clear()
    os.environ.update(program_env({"SERVE_REQS": str(BENCH["reqs"]),
                                   **extra}))
    try:
        buf = io.StringIO()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = llama_serve._serve_continuous(
                distributed.read_env(), cfg, params, BENCH["slots"],
                BENCH["prompt"], BENCH["steps"], int8, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    check(rc == 0, f"{label}: _serve_continuous returned {rc}")
    got = metric_lines(buf.getvalue())
    names = CONTINUOUS_METRICS + (("serve_trace_spans",)
                                  if "SERVE_TRACE" in extra else ())
    check(tuple(got) == names, f"{label}: metric names {list(got)}")
    ticks = got["serve_engine_ticks"]
    want = BENCH["stride"] * cfg.n_layers * (ticks + 1)
    check(launches[kernel] == want,
          f"{label}: {kernel} ran {launches[kernel]} times, not stride × "
          f"n_layers × (ticks + warmup's tick) = {want}")
    others = [k for k in PAGED_KERNELS if k != kernel and launches[k]]
    check(not others, f"{label}: {others} also ran")
    check(0 < got["serve_engine_occupancy"] <= 1
          and got["serve_hbm_peak_bytes"] >= got["serve_hbm_pool_bytes"] > 0,
          f"{label}: occupancy or state bytes out of range: {got}")
    log("program", run=label, wall_s=round(wall, 2), launches={
        k: launches[k] for k in ("flash_fwd", *PAGED_KERNELS)},
        **{k.replace("serve_", ""): got[k] for k in (
            "serve_engine_tokens_per_s", "serve_engine_occupancy",
            "serve_engine_waves", "serve_engine_ticks",
            "serve_engine_stall_p50_ms", "serve_engine_stall_p99_ms",
            "serve_kv_bits", "serve_hbm_pool_bytes",
            "serve_engine_phase_warmup_ms", "serve_engine_phase_drain_ms")})
    return {"metrics": got, "launches": launches, "wall_s": wall}


def program_phase(torch, kernels, gen, name, bench_cfg=None,
                  full_cfg=None) -> dict:
    """Phase 9: ``llama_serve.py`` as the pod runs it.  (e) kernels 4-6 at
    the program's shape first; (a) the static and (b) the continuous mode
    as ``python -m`` subprocesses with a whole-card grant's env (auto picks
    the bench config); (c) ``_serve_continuous`` in process on the bench
    config with int8 weights, one run per pool format and a traced one;
    (d) ``_serve_continuous`` on Llama-3-8B's bf16 weights."""
    from kubegpu_tpu_torch.models import LlamaConfig, llama_init
    from kubegpu_tpu_torch.models.quant import quantize_llama
    from kubegpu_tpu_torch.obs.spans import validate_chrome_trace
    from kubegpu_tpu_torch.workloads.programs.llama_serve import (
        llama_bench_config)
    out = {"program_shape": program_shape_checks(torch, gen)}
    torch.cuda.empty_cache()
    static = program_run("static", STATIC_METRICS, {})
    log("program", mode="static", wall_s=round(static["wall_s"], 1),
        **static["metrics"])
    cont = program_run("continuous", CONTINUOUS_METRICS,
                       {"SERVE_MODE": "continuous"})
    m = cont["metrics"]
    check(0 < m["serve_engine_occupancy"] <= 1,
          f"continuous: occupancy {m['serve_engine_occupancy']}")
    check(m["serve_hbm_peak_bytes"] >= m["serve_hbm_pool_bytes"] > 0,
          f"continuous: state bytes {m['serve_hbm_pool_bytes']} / peak "
          f"{m['serve_hbm_peak_bytes']}")
    check((m["serve_engine_cfg_slots"], m["serve_engine_cfg_requests"],
           m["serve_kv_bits"]) == (BENCH["slots"], 3 * BENCH["slots"], 8),
          "continuous: the pod did not serve the bench traffic on int8 "
          "pages")
    log("program", mode="continuous", wall_s=round(cont["wall_s"], 1),
        **{k.replace("serve_", ""): m[k] for k in (
            "serve_engine_tokens_per_s", "serve_engine_waves",
            "serve_engine_ticks", "serve_engine_stall_p50_ms",
            "serve_engine_stall_p99_ms", "serve_hbm_pool_bytes",
            "serve_hbm_peak_bytes", "serve_engine_occupancy")})
    out.update(static=static, continuous=cont)
    # (c) the bench config in process, int8 weights as the program has them
    cfg = bench_cfg or llama_bench_config()
    params = quantize_llama(llama_init(cfg, seed=0, device="cuda"))
    trace_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "llama_serve_trace.json")
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    runs = {}
    for label, extra, kernel in PROGRAM_RUNS:
        if "SERVE_TRACE" in extra:
            extra = {**extra, "SERVE_TRACE_OUT": trace_path}
        runs[label] = continuous_run(torch, kernels, label, cfg, params, True,
                                     extra, kernel)
    with open(trace_path) as f:
        events = validate_chrome_trace(f.read())
    n_req = sum(e["ph"] == "X" and e["name"] == "request" for e in events)
    check(n_req == BENCH["reqs"], f"traced run: {n_req} request spans, not "
          f"{BENCH['reqs']}")
    traced = runs["kv8-traced"]["metrics"]["serve_engine_tokens_per_s"]
    untraced = runs["kv8"]["metrics"]["serve_engine_tokens_per_s"]
    log("program", trace_events=len(events), request_spans=n_req,
        spans=runs["kv8-traced"]["metrics"]["serve_trace_spans"],
        traced_tokens_per_s=traced, untraced_tokens_per_s=untraced)
    out["runs"] = runs
    del params
    torch.cuda.empty_cache()
    # (d) full width: Llama-3-8B's bf16 weights, kernel 5 by the kv_int8 rule
    full = full_cfg or LlamaConfig.llama3_8b()
    params = llama_init(full, seed=SEED, device="cuda")
    out["llama3_8b"] = continuous_run(torch, kernels, "llama3-8b", full,
                                      params, False, {}, "paged_decode_q8")
    del params
    torch.cuda.empty_cache()
    out["launches"] = {k: sum(r["launches"][k] for r in (
        *runs.values(), out["llama3_8b"])) for k in kernels.launches}
    return out


# -- phase 3 (d): NaN propagation in kernels 4-6 ---------------------------

def masked_positions(torch, slice_rows, n_pages: int, page: int,
                     group: int = 1):
    """[n_pages, page] mask of the pool positions that slice_rows' rows hold
    but never attend: a prompt page's rows past t and the decode page's
    rows past d (the bytes a recycled page keeps), whole groups of
    ``group`` keys only (an int4 scale covers a group)."""
    mask = torch.zeros(n_pages, page, dtype=torch.bool, device="cuda")
    for pages, t, tpad, d in slice_rows:
        for rl, pid in enumerate(pages):
            phys = rl * page + torch.arange(page, device="cuda")
            valid = (phys < t) | ((phys >= tpad) & (phys < tpad + d))
            # a group is masked only if none of its keys is valid
            gvalid = valid.view(-1, group).any(dim=1).repeat_interleave(group)
            mask[pid] = ~gvalid
    return mask


def paged_nan_checks(torch, gen, slice_rows) -> dict:
    """The chaos path's NaN on the card, kernels 4-6 against their plain
    versions at the serving rows (bf16 queries, 32 heads over 8 kv heads,
    pages of 128; a pool of 2 layers, layer 1), each format as the engine
    writes it (int4 groups of 16):

    - a NaN on a VALID key (the engine's ``poison_slot``: row 3's first
      page, its ``k`` or, int8 and int4, its ``k_scale``): exactly row 3's
      o is non-finite, kernel and plain, and every other row's (o, m, l)
      equals the clean run's bit for bit;
    - NaN at every MASKED position of every row (a recycled page's bytes:
      prompt rows past t, decode rows past d; ``k`` and ``v``, or the
      int8 and int4 scales, whole int4 groups only): every output stays
      finite, the kernel's equal to its clean run's bit for bit and the
      plain version's within the tolerance of the clean comparison."""
    pa = importlib.import_module("kubegpu_tpu_torch.ops.paged_attention")
    kvq = importlib.import_module("kubegpu_tpu_torch.ops.kvquant")
    q, pk, pv, pt, t, tpad, d = paged_case(
        torch, gen, torch.bfloat16, 2, 41, 8, 128, 128, 32, slice_rows)
    nan = float("nan")
    out = {}
    for kname, fmt, tol in (("paged_decode", "bf16", 1e-2),
                            ("paged_decode_q8", "q8", 1e-2),
                            ("paged_decode_q4", "q4g16", 1e-2)):
        pool = ((pk, pv, None, None) if fmt == "bf16"
                else quantize_pool(torch, kvq, pk, pv, fmt))

        def run(fn, pool):
            res = fn(q, pool[0], pool[1], pt, 1, t, tpad, d, pool[2],
                     pool[3])
            torch.cuda.synchronize()
            return res

        clean = run(pa.paged_attention, pool)
        # a NaN on a valid key of row 3
        bad = [x.clone() if x is not None else None for x in pool]
        leaf = 0 if fmt == "bf16" else 2
        bad[leaf][:, slice_rows[3][0][0]] = nan
        got, ref = run(pa.paged_attention, bad), run(pa.paged_attention_ref,
                                                     bad)
        for label, res in (("kernel", got), ("plain", ref)):
            rows = (~torch.isfinite(res[0]).all(dim=(1, 2))).tolist()
            check(rows == [i == 3 for i in range(len(slice_rows))],
                  f"{kname} ({label}): a NaN on row 3's valid key made rows "
                  f"{[i for i, r in enumerate(rows) if r]} non-finite")
        others = [i for i in range(len(slice_rows)) if i != 3]
        check(all(torch.equal(a[others], b[others])
                  for a, b in zip(got, clean)),
              f"{kname}: a row that never reads the NaN page changed")
        # NaN at every masked position (a recycled page)
        group = 1 if fmt != "q4g16" else 16
        mask = masked_positions(torch, slice_rows, pk.shape[1], 128, group)
        rec = [x.clone() if x is not None else None for x in pool]
        # [L, n_pages, Hkv, P, ...] through its [L, n_pages, P, Hkv, ...]
        # view: the (page, position) mask picks every layer's and head's
        if fmt == "bf16":
            for x in rec[:2]:
                x.transpose(2, 3)[:, mask] = nan
        else:
            smask = mask.view(mask.shape[0], -1, group)[..., 0]
            for x in rec[2:]:
                x.transpose(2, 3)[:, smask] = nan
        got, ref = run(pa.paged_attention, rec), run(pa.paged_attention_ref,
                                                     rec)
        check(all(torch.isfinite(x).all().item() for x in got + ref),
              f"{kname}: NaN at masked positions reached an output")
        check(all(torch.equal(a, b) for a, b in zip(got, clean)),
              f"{kname}: NaN at masked positions changed the kernel's output")
        err = max_err(got[0], ref[0])
        check(err <= tol, f"{kname}: masked-NaN o max |err| {err} > {tol}")
        log("kernels", kernel=kname, case=f"NaN {fmt}: a valid key's NaN "
            "reaches its row only (others bit-equal); masked NaN "
            f"({int(mask.sum())} positions) reaches no output",
            max_abs_err=err, tol=tol)
        out[fmt] = {"masked_positions": int(mask.sum()),
                    "max_abs_err_masked": err}
    return out


# -- phase 5h: beam search, speculative and prompt-lookup decoding ----------

# the reference's bench rows on int8 weights (kubegpu_tpu/benchmark.py:
# ``beam``, ``spec_decode``, ``spec_decode_pld``; random weights here): the
# eager runs are cut to EAGER_STEPS tokens (compared with a graph run of as
# many), never in width
# phase 5h runs the first 16 of the 32 layers (a view of 5c's int8 tree):
# the script's time limit, since phase 18 was added
SEARCH_LAYERS = 16
SEARCH = {"beam": {"b": 4, "t": 512, "steps": 32, "beams": 4, "page": 128},
          "spec": {"b": 8, "t": 1024, "steps": 128, "gamma": 4, "draft": 8},
          "pld": {"b": 8, "t": 1024, "steps": 128, "gamma": 8, "ngram": 3,
                  "pattern": 128, "page": 128}}
EAGER_STEPS = 32


def timed_call(torch, kernels, fn):
    """(fn()'s result, its wall ms between synchronizes, kernel 4's
    launches in it)."""
    before = kernels.launches["paged_decode"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (res, (time.perf_counter() - t0) * 1e3,
            kernels.launches["paged_decode"] - before)


def graph_and_eager(torch, kernels, label, fn, launches_of, reads,
                    keyed_by_steps: bool = True) -> dict:
    """``fn(n_steps, graphs)`` through its graphs and eagerly at
    ``EAGER_STEPS`` (equal tokens and stats), and through its graphs at the
    full step count, timed.  Graphs whose state is ``keyed_by_steps`` are
    captured again at the full count, so a first full call captures them
    and a second is timed; otherwise the cut call's graphs serve.  Kernel 4
    must launch ``launches_of(result, n_steps)`` times a call.  Returns the
    timed graph call's result, the ms of each call and the timed call's
    host reads (``reads["n"]``, counted by :func:`search_phase`)."""
    runs = {}
    order = (("graph_cut", EAGER_STEPS, True),
             ("eager_cut", EAGER_STEPS, False))
    order += ((("first", None, True),) if keyed_by_steps else ()) + (
        ("graph", None, True),)
    for key, n, graphs in order:
        reads["n"] = 0
        res, ms, k4 = timed_call(torch, kernels, lambda: fn(n, graphs))
        want = launches_of(res, n)
        check(k4 == want, f"phase 5h {label} ({key}): kernel 4 launched "
              f"{k4} times, want {want}")
        runs[key] = (res, ms, reads["n"])
    (g_toks, g_extra), (e_toks, e_extra) = (runs["graph_cut"][0],
                                            runs["eager_cut"][0])
    same_extra = (torch.equal(g_extra, e_extra)
                  if isinstance(g_extra, torch.Tensor) else g_extra == e_extra)
    check(torch.equal(g_toks, e_toks) and same_extra,
          f"phase 5h {label}: graph and eager runs differ")
    if keyed_by_steps:
        check(torch.equal(runs["first"][0][0], runs["graph"][0][0]),
              f"phase 5h {label}: two graph calls differ")
    return {"result": runs["graph"][0], "ms": runs["graph"][1],
            "first_ms": runs.get("first", (None, None))[1],
            "graph_cut_ms": runs["graph_cut"][1],
            "eager_cut_ms": runs["eager_cut"][1],
            "host_reads": runs["graph"][2]}


def share_equal(a, b) -> float:
    return (a == b).float().mean().item()


def beam_search_runs(torch, kernels, cfg, qparams, gen, reads) -> dict:
    """5h (a): ``beam_generate`` (int8 cache) and ``beam_generate_paged``
    (bf16 pages of 128) on the int8 weights, the reference's ``beam`` row;
    kernel 4 ``n_layers × (steps - 1)`` times a paged call, none a dense
    one."""
    from kubegpu_tpu_torch.models import decode as dec
    c = SEARCH["beam"]
    prompt = torch.randint(0, cfg.vocab_size, (c["b"], c["t"]), generator=gen,
                           device="cuda")
    out = {}
    for label, fn, kw in (("dense", dec.beam_generate, {"kv_int8": True}),
                          ("paged", dec.beam_generate_paged,
                           {"page_size": c["page"]})):
        def call(n, graphs, fn=fn, kw=kw):
            return fn(qparams, prompt, n or c["steps"], cfg, beams=c["beams"],
                      max_len=c["t"] + c["steps"], graphs=graphs, **kw)

        def launches(res, n, label=label):
            return (cfg.n_layers * ((n or c["steps"]) - 1)
                    if label == "paged" else 0)

        r = graph_and_eager(torch, kernels, f"beam {label}", call, launches,
                            reads)
        toks, score = r.pop("result")
        check(toks.shape == (c["b"], c["steps"])
              and bool(torch.isfinite(score).all())
              and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
              f"phase 5h beam {label}: tokens or scores out of range")
        out[label] = {**r, "tokens": toks, "score": score,
                      "kernel4_launches": launches(None, None)}
    dense, paged = out["dense"], out["paged"]
    stats = {k: {x: v[x] for x in ("ms", "first_ms", "graph_cut_ms",
                                   "eager_cut_ms", "kernel4_launches")}
             for k, v in out.items()}
    stats["paged_vs_dense"] = dense["ms"] / paged["ms"]
    stats["tokens_equal_share"] = share_equal(dense["tokens"],
                                              paged["tokens"])
    stats["score_gap"] = (dense["score"] - paged["score"]).abs().max().item()
    log("search", part="(a) beam, B {b}, prompt {t}, {steps} steps, W "
        "{beams}".format(**c),
        dense_int8_cache_ms=dense["ms"], paged_bf16_pages_ms=paged["ms"],
        paged_vs_dense=stats["paged_vs_dense"],
        eager_cut_ms={k: v["eager_cut_ms"] for k, v in out.items()},
        tokens_equal_share=stats["tokens_equal_share"],
        score_gap=stats["score_gap"],
        kernel4_per_paged_call=paged["kernel4_launches"])
    return stats


def spec_runs(torch, kernels, cfg, qparams, gen, reads) -> dict:
    """5h (b): ``spec_generate`` (the host loop) and ``spec_generate_fused``
    with a draft of the first 8 layers and the int8 cache, beside
    ``greedy_generate`` on the same inputs (the reference's
    ``spec_decode`` row); then the fused loop with a draft of all 32
    layers, whose acceptance must beat the 8-layer draft's with more than
    one token an iteration."""
    from kubegpu_tpu_torch.models import decode as dec
    c = SEARCH["spec"]
    b, t, steps = c["b"], c["t"], c["steps"]
    max_len = t + steps
    prompt = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                           device="cuda")

    def greedy_call():
        return dec.greedy_generate(qparams, prompt, steps, cfg,
                                   max_len=max_len, kv_int8=True)

    # captures the step (its graph is keyed by batch and cache length)
    dec.greedy_generate(qparams, prompt, 2, cfg, max_len=max_len,
                        kv_int8=True)
    greedy, greedy_ms, _ = timed_call(torch, kernels, greedy_call)
    dview = dec.draft_view(qparams, c["draft"])
    out = {"greedy_ms": greedy_ms}
    for label, fn in (("host", dec.spec_generate),
                      ("fused", dec.spec_generate_fused)):
        def call(n, graphs, fn=fn):
            return fn(qparams, prompt, n or steps, cfg, c["draft"],
                      gamma=c["gamma"], max_len=max_len, kv_int8=True,
                      dparams=dview, graphs=graphs)

        # the host loop's graphs are keyed by the cache length alone
        r = graph_and_eager(torch, kernels, f"spec {label}", call,
                            lambda res, n: 0, reads, label == "fused")
        toks, st = r.pop("result")
        # the host loop reads its acceptance once an iteration
        out[label] = {**r, "stats": st, "greedy_equal_share": share_equal(
            toks, greedy), "tokens": toks}
    out["host"]["host_reads"] = "one an iteration"
    full = dec.draft_view(qparams, cfg.n_layers)
    reads["n"] = 0
    (ptoks, pst), pms, _ = timed_call(
        torch, kernels, lambda: dec.spec_generate_fused(
            qparams, prompt, steps, cfg, cfg.n_layers, gamma=c["gamma"],
            max_len=max_len, kv_int8=True, dparams=full))
    fst = out["fused"]["stats"]
    check(pst["acceptance_rate"] > fst["acceptance_rate"]
          and (steps - 1) / pst["iterations"] > 1,
          f"phase 5h: the 32-layer draft {pst} does not beat the 8-layer "
          f"one {fst} with more than one token an iteration")
    out["draft32"] = {"ms": pms, "stats": pst, "host_reads": reads["n"],
                      "greedy_equal_share": share_equal(ptoks, greedy)}
    out["host_fused_equal_share"] = share_equal(out["host"].pop("tokens"),
                                                out["fused"].pop("tokens"))
    log("search", part="(b) spec, B {b}, prompt {t}, {steps} steps, γ "
        "{gamma}, draft {draft} layers, int8 cache".format(**c), host=out["host"]["stats"],
        host_ms=out["host"]["ms"], fused=fst, fused_ms=out["fused"]["ms"],
        fused_host_reads=out["fused"]["host_reads"], greedy_ms=greedy_ms,
        eager_cut_ms={k: out[k]["eager_cut_ms"] for k in ("host", "fused")},
        greedy_equal_share={k: out[k]["greedy_equal_share"]
                            for k in ("host", "fused", "draft32")},
        host_fused_equal_share=out["host_fused_equal_share"])
    log("search", part=f"(b) draft of all {cfg.n_layers} layers (fused)",
        stats=pst,
        ms=pms, host_reads=reads["n"],
        tokens_per_iteration=(steps - 1) / pst["iterations"])
    return out


def pld_runs(torch, kernels, cfg, qparams, gen, reads) -> dict:
    """5h (c): ``pld_generate_fused`` (int8 cache) and
    ``pld_generate_paged`` (bf16 pages of 128) on prompts tiled from one
    128-token pattern (each row from another offset), the reference's
    ``spec_decode_pld`` traffic; kernel 4 ``n_layers × iterations`` times
    a paged call, none a fused one."""
    from kubegpu_tpu_torch.models import decode as dec
    c = SEARCH["pld"]
    b, t, steps = c["b"], c["t"], c["steps"]
    max_len = t + steps
    pattern = torch.randint(0, cfg.vocab_size, (c["pattern"],), generator=gen,
                            device="cuda")
    prompt = torch.stack([pattern.roll(-16 * i).repeat(t // c["pattern"])
                          for i in range(b)])
    # the step's graph is (b)'s: one batch, cache length and format
    greedy, greedy_ms, _ = timed_call(
        torch, kernels, lambda: dec.greedy_generate(
            qparams, prompt, steps, cfg, max_len=max_len, kv_int8=True))
    out = {"greedy_ms": greedy_ms}
    for label, fn, kw in (("fused", dec.pld_generate_fused,
                           {"kv_int8": True}),
                          ("paged", dec.pld_generate_paged,
                           {"page_size": c["page"]})):
        def call(n, graphs, fn=fn, kw=kw):
            return fn(qparams, prompt, n or steps, cfg, gamma=c["gamma"],
                      ngram=c["ngram"], max_len=max_len, graphs=graphs, **kw)

        def launches(res, n, label=label):
            return (cfg.n_layers * res[1]["iterations"] if label == "paged"
                    else 0)

        r = graph_and_eager(torch, kernels, f"pld {label}", call, launches,
                            reads)
        toks, st = r.pop("result")
        out[label] = {**r, "stats": st,
                      "greedy_equal_share": share_equal(toks, greedy),
                      "tokens": toks,
                      "kernel4_launches": cfg.n_layers * st["iterations"]}
    out["paged_fused_equal_share"] = share_equal(out["fused"].pop("tokens"),
                                                 out["paged"].pop("tokens"))
    log("search", part="(c) PLD, B {b}, prompt {t} (a {pattern}-token "
        "pattern tiled), {steps} steps, γ {gamma}, n-gram {ngram}"
        .format(**c),
        fused=out["fused"]["stats"], fused_ms=out["fused"]["ms"],
        paged=out["paged"]["stats"], paged_ms=out["paged"]["ms"],
        greedy_ms=greedy_ms,
        host_reads={k: out[k]["host_reads"] for k in ("fused", "paged")},
        eager_cut_ms={k: out[k]["eager_cut_ms"]
                        for k in ("fused", "paged")},
        greedy_equal_share={k: out[k]["greedy_equal_share"]
                            for k in ("fused", "paged")},
        paged_fused_equal_share=out["paged_fused_equal_share"],
        kernel4_per_paged_call=out["paged"]["kernel4_launches"])
    return out


def search_narrow(torch) -> dict:
    """5h (d): phase 6's narrow f32 config on the card, through the graphs:
    every decoder's tokens equal ``greedy_generate``'s (the paged beam's
    equal the dense beam's, scores within 1e-4); the paged PLD's tokens and
    stats equal the fused PLD's; a perfect draft accepts exactly 1.0."""
    from kubegpu_tpu_torch.models import LlamaConfig, llama_init
    from kubegpu_tpu_torch.models import decode as dec
    cfg = LlamaConfig.tiny(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                           d_ff=512, vocab_size=512, max_seq_len=128)
    params = llama_init(cfg, seed=SEED, device="cuda")
    g = torch.Generator().manual_seed(SEED + 11)
    prompt = torch.randint(0, 512, (2, 11), generator=g).cuda()
    greedy = dec.greedy_generate(params, prompt, 12, cfg)
    toks, _ = dec.beam_generate(params, prompt, 12, cfg, beams=1)
    check(torch.equal(toks, greedy), "narrow f32: beam W=1 != greedy")
    dense = dec.beam_generate(params, prompt, 9, cfg, beams=3)
    paged = dec.beam_generate_paged(params, prompt, 9, cfg, beams=3,
                                    page_size=8)
    gap = (dense[1] - paged[1]).abs().max().item()
    check(torch.equal(dense[0], paged[0]) and gap <= 1e-4,
          f"narrow f32: the paged beam differs from the dense one ({gap})")
    for fn in (dec.spec_generate, dec.spec_generate_fused):
        toks, _ = fn(params, prompt, 9, cfg, 1, gamma=4)
        check(torch.equal(toks, greedy[:, :9]),
              f"narrow f32: {fn.__name__} != greedy")
    toks, perfect = dec.spec_generate_fused(params, prompt, 12, cfg, 2,
                                            gamma=4)
    check(torch.equal(toks, greedy) and perfect["acceptance_rate"] == 1.0,
          f"narrow f32: the perfect draft gave {perfect}")
    pat = torch.tensor([5, 9, 2, 7, 11]).repeat(4)[None].repeat(2, 1).cuda()
    want = dec.greedy_generate(params, pat, 14, cfg, max_len=48)
    fused = dec.pld_generate_fused(params, pat, 14, cfg, gamma=4, ngram=2,
                                   max_len=48)
    paged = dec.pld_generate_paged(params, pat, 14, cfg, gamma=4, ngram=2,
                                   max_len=48, page_size=8)
    check(torch.equal(fused[0], want) and torch.equal(paged[0], want)
          and fused[1] == paged[1],
          f"narrow f32: PLD fused {fused[1]} / paged {paged[1]} != greedy")
    out = {"beam_score_gap": gap, "perfect_draft": perfect,
           "pld": fused[1]}
    log("search", part="(d) narrow f32: every decoder equals greedy, paged "
        "beam = dense, paged PLD = fused", **out)
    return out


def search_phase(torch, kernels, cfg, qparams, gen, name) -> dict:
    """Phase 5h at Llama-3-8B width (``cfg``'s depth) on phase 5c's int8
    weights:
    (a) beam, (b) spec, (c) PLD, each through its graphs and eagerly, then
    (d) the narrow f32 gates.  The fused loops' host reads a call are
    counted at ``decode._read_loop_state``.  Returns the phase's numbers,
    its peak memory and seconds."""
    from kubegpu_tpu_torch.models import decode as dec
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reads = {"n": 0}
    read = dec._read_loop_state

    def counted(st):
        reads["n"] += 1
        return read(st)

    dec._read_loop_state = counted
    try:
        out = {"beam": beam_search_runs(torch, kernels, cfg, qparams, gen,
                                        reads),
               "spec": spec_runs(torch, kernels, cfg, qparams, gen, reads),
               "pld": pld_runs(torch, kernels, cfg, qparams, gen, reads)}
    finally:
        dec._read_loop_state = read
    dec.clear_graphs()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["narrow"] = search_narrow(torch)
    dec.clear_graphs()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log("search", peak_gb=round(out["peak_gb"], 2),
        seconds=round(out["seconds"], 1), card=repr(name))
    return out


# -- phase 10: sampling and the request lifecycle ---------------------------

# the sampled engine's knobs: top-k 50, a common serving setting
SAMPLED = dict(sampling=True, top_k=50)
LIFECYCLE_NEW = 48


def lifecycle_prompts(torch, cfg, gen, n: int = 8) -> list:
    """``n`` prompts of 200-440 tokens: a replay's prompt (prompt plus the
    tokens accepted before a quarantine or a park) still fits the 512
    bucket."""
    lens = torch.randint(200, 441, (n,), generator=gen, device="cuda")
    return [torch.randint(0, cfg.vocab_size, (int(k),), generator=gen,
                          device="cuda").tolist() for k in lens]


def lifecycle_run(eng, prompts, n_new, temps=None, tiers=None,
                  late=None) -> dict:
    """Submit ``prompts`` (with ``temps`` and ``tiers``), then after two
    steps the ``late`` (prompt, tier) requests, and drain; every request
    must come back.  Returns tokens by rid (rids in submit order) and the
    errors."""
    n = len(prompts)
    temps = temps or [0.0] * n
    tiers = tiers or [0] * n
    rids = [eng.submit(p, n_new, temperature=tp, tier=tr)
            for p, tp, tr in zip(prompts, temps, tiers)]
    done = eng.step() + eng.step()
    rids += [eng.submit(p, n_new, tier=tr) for p, tr in late or ()]
    done += eng.drain()
    check(sorted(r.rid for r in done) == sorted(rids),
          "phase 10: a request was lost or returned twice")
    by_rid = {r.rid: r for r in done}
    eng.check_page_invariants()
    check(len(eng._free_pages) == eng.total_pages, "phase 10: pages leaked")
    return {"tokens": [by_rid[r].tokens for r in rids],
            "errors": [by_rid[r].error for r in rids]}


def tick_ms(torch, eng, prompts) -> float:
    """The device ms of one replayed plain tick with every slot decoding (8
    requests of 112 new tokens, which fill the 40 pages, admitted and one
    tick run): ``cuda_ms`` over 5 replays, the tick index reset before
    each.  The engine is left mid-run: call it last on an engine."""
    for p in prompts[:eng.n_slots]:
        eng.submit(p, 112)
    eng.step()
    eng.step()
    check(eng.active.all(), "tick_ms: not every slot is decoding")

    def tick():
        eng._tv["tk"].zero_()
        eng._run_tick("plain")

    return cuda_ms(tick, reps=5)


def replay_checks(label, clean, got, rid, accepted, fresh) -> float:
    """A quarantined or parked request against the clean run: every other
    request's tokens equal, the replayed one's first ``accepted`` tokens
    equal, and its continuation equal to ``fresh``, a clean engine's
    tokens for the replay's own prompt (prompt + accepted tokens): the
    replay is that request, bit for bit.  Returns the share of the
    continuation equal to the clean run's (not held: the replay's prefill
    computes the accepted tokens' K/V in another GEMM shape than the
    decode steps did, and random weights' near-tied logits flip)."""
    for i, (a, b) in enumerate(zip(clean, got)):
        if i != rid:
            check(a == b, f"{label}: rid {i}'s tokens differ from the "
                  "clean run's")
    check(got[rid][:accepted] == clean[rid][:accepted],
          f"{label}: the replayed request's accepted tokens changed")
    check(got[rid][accepted:] == fresh,
          f"{label}: the replay differs from a fresh run of its prompt")
    tail = list(zip(got[rid][accepted:], clean[rid][accepted:]))
    return sum(a == b for a, b in tail) / max(len(tail), 1)


def narrow_replays(torch) -> dict:
    """Phase 10's chaos and tier scenarios at phase 6's narrow f32 config
    (model-dtype pages of 16, 3 slots, stride 4): there f32 logits have no
    near ties, so a quarantined request's replay and a parked request's
    resume give the fault-free tokens, every request equal to the clean
    run's and to ``greedy_generate``'s."""
    from kubegpu_tpu_torch.models import (
        ContinuousBatcher,
        LlamaConfig,
        greedy_generate,
        llama_init,
    )
    from kubegpu_tpu_torch.obs.chaos import ChaosEvent, ChaosInjector
    cfg = LlamaConfig.tiny(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                           d_ff=512, vocab_size=512, max_seq_len=128)
    params = llama_init(cfg, seed=SEED, device="cuda")
    kw = dict(n_slots=3, stride=4, prompt_buckets=(16, 32), paged=True,
              page_size=16, debug_invariants=True, device="cuda")
    g = torch.Generator().manual_seed(SEED)
    prompts = [torch.randint(0, 512, (t,), generator=g).tolist()
               for t in (5, 9, 12, 7)]
    n_new = 16
    solo = [greedy_generate(params, [p], n_new, cfg,
                            device="cuda")[0].tolist() for p in prompts]
    clean = lifecycle_run(ContinuousBatcher(params, cfg, **kw), prompts[:3],
                          n_new)
    eng = ContinuousBatcher(params, cfg, chaos=ChaosInjector(
        [ChaosEvent(2, "nan_logits"), ChaosEvent(3, "fail_dispatch")]), **kw)
    chaos = lifecycle_run(eng, prompts[:3], n_new)
    counts = (eng.slots_quarantined, eng.requests_retried,
              eng.dispatch_failures)
    check(counts == (1, 1, 1), f"narrow chaos: counters {counts}")
    check(chaos["tokens"] == clean["tokens"] == solo[:3],
          "narrow chaos: a replayed request differs from the fault-free run")
    eng = ContinuousBatcher(params, cfg, **kw)
    tiers = lifecycle_run(eng, prompts[:3], n_new, tiers=[1] * 3,
                          late=[(prompts[3], 0)])
    check(eng.requests_preempted >= 1
          and eng.requests_resumed == eng.requests_preempted,
          f"narrow tiers: preempted {eng.requests_preempted}, resumed "
          f"{eng.requests_resumed}")
    check(tiers["tokens"] == solo,
          "narrow tiers: a resumed request differs from the unpreempted run")
    log("lifecycle", part="narrow f32 (phase 6's config)",
        quarantined_replay_equals_clean=True, preempted=eng.requests_preempted,
        resumed_equals_unpreempted=True, equal_greedy_generate=True)
    return {"chaos_counters": counts,
            "requests_preempted": eng.requests_preempted}


def lifecycle_phase(torch, kernels, cfg, params, gen, name) -> dict:
    """Phase 10: sampling and the request lifecycle at phase 5's engine
    shape (Llama-3-8B, bf16, 8 slots, pages of 128, 512 bucket):

    (a) sampling -- ``sampling=True, top_k=50, seed=7``, 8 requests of 48
        new tokens, half at temperature 0.8 and half greedy, on a graph
        engine, an eager one and a ``fused_ticks=4`` one (equal tokens);
        ``seed=8`` changes the sampled requests and only them; the greedy
        requests equal a greedy engine's; then the replayed tick's device
        ms, greedy against sampled with top_k 50 and 0 (one tick each,
        every slot decoding);
    (b) chaos -- ``kv_bits=8`` with ``nan_logits`` at tick 2 and
        ``fail_dispatch`` at tick 3: one slot quarantined and replayed,
        one dispatch retried, against the clean run (:func:`replay_checks`);
    (c) tiers -- 8 tier-1 requests decode; a tier-0 request arrives after
        two steps and preempts the newest; the parked request resumes
        (:func:`replay_checks` against an unpreempted run, the tier-0
        request against a fresh run of its prompt);
    then (b) and (c) at the narrow f32 config, every token equal to the
    fault-free run's (:func:`narrow_replays`).

    Returns the phase's numbers."""
    from kubegpu_tpu_torch.models import ContinuousBatcher
    from kubegpu_tpu_torch.obs.chaos import ChaosEvent, ChaosInjector

    def engine(kernel="paged_decode", **kw):
        return warmed(torch, kernels, ContinuousBatcher, cfg, params,
                      "phase 10", kernel, **kw)[0]

    t_phase = time.perf_counter()
    prompts = lifecycle_prompts(torch, cfg, gen)
    temps = [0.8, 0.0] * 4
    out = {}
    # (a) sampling
    engines, runs = {}, {}
    for label, kw in (("graph", dict(SAMPLED, seed=7)),
                      ("eager", dict(SAMPLED, seed=7, graphs=False)),
                      ("fused4", dict(SAMPLED, seed=7, fused_ticks=4)),
                      ("seed8", dict(SAMPLED, seed=8)), ("greedy", {})):
        engines[label] = engine(**kw)
        runs[label] = lifecycle_run(engines[label], prompts, LIFECYCLE_NEW,
                                    temps if kw else None)["tokens"]
    check(engines["fused4"].fused_dispatches > 0, "phase 10: K=4 never fused")
    check(runs["graph"] == runs["eager"] == runs["fused4"],
          "phase 10 (a): seed 7's graph, eager and fused K=4 engines differ")
    sampled = [i for i, tp in enumerate(temps) if tp > 0]
    greedy_rows = [i for i, tp in enumerate(temps) if tp == 0]
    check(all(runs["seed8"][i] == runs["graph"][i] == runs["greedy"][i]
              for i in greedy_rows),
          "phase 10 (a): a greedy request of a sampling engine differs from "
          "the greedy engine's")
    check(any(runs["seed8"][i] != runs["graph"][i] for i in sampled),
          "phase 10 (a): seed 8 drew seed 7's tokens")
    check(any(runs["graph"][i] != runs["greedy"][i] for i in sampled),
          "phase 10 (a): the sampled requests drew the argmax")
    for label in ("eager", "fused4", "seed8"):
        del engines[label]
    ms = {"greedy": tick_ms(torch, engines.pop("greedy"), prompts),
          "top_k50": tick_ms(torch, engines.pop("graph"), prompts),
          "top_k0": tick_ms(torch, engine(sampling=True, top_k=0, seed=7),
                            prompts)}
    torch.cuda.empty_cache()
    out["sampling"] = {
        "tick_ms": ms, "ratio_top_k50": ms["top_k50"] / ms["greedy"],
        "ratio_top_k0": ms["top_k0"] / ms["greedy"],
        "sampled_rows_differing_from_greedy": sum(
            runs["graph"][i] != runs["greedy"][i] for i in sampled)}
    log("lifecycle", part="(a) sampling", seed7_graph_eager_fused4_equal=True,
        seed8_changes_sampled=True, greedy_rows_equal_greedy_engine=True,
        tick_ms=ms, ratio_top_k50=out["sampling"]["ratio_top_k50"],
        ratio_top_k0=out["sampling"]["ratio_top_k0"], card=repr(name))

    # (b) chaos on int8 pages
    clean_eng = engine("paged_decode_q8", kv_bits=8)
    clean = lifecycle_run(clean_eng, prompts, LIFECYCLE_NEW)
    chaos = ChaosInjector([ChaosEvent(2, "nan_logits"),
                           ChaosEvent(3, "fail_dispatch")])
    eng = engine("paged_decode_q8", kv_bits=8, chaos=chaos)
    quarantined = []
    quarantine = eng._quarantine

    def note(slot, req):
        quarantined.append((req.rid, len(req.tokens)))
        quarantine(slot, req)

    eng._quarantine = note
    got = lifecycle_run(eng, prompts, LIFECYCLE_NEW)
    counts = (eng.slots_quarantined, eng.requests_retried,
              eng.dispatch_failures)
    check(counts == (1, 1, 1), f"phase 10 (b): quarantined, retried, "
          f"dispatch failures = {counts}, not (1, 1, 1)")
    check(not any(got["errors"]), f"phase 10 (b): errors {got['errors']}")
    (rid, accepted), = quarantined
    replay = prompts[rid] + got["tokens"][rid][:accepted]
    fresh = lifecycle_run(clean_eng, [replay], LIFECYCLE_NEW - accepted)
    share = replay_checks("phase 10 (b)", clean["tokens"], got["tokens"],
                          rid, accepted, fresh["tokens"][0])
    out["chaos"] = {"quarantined_rid": rid, "accepted": accepted,
                    "replay_equals_clean_share": share}
    log("lifecycle", part="(b) int8 chaos", slots_quarantined=counts[0],
        requests_retried=counts[1], dispatch_failures=counts[2],
        quarantined_rid=rid, accepted=accepted,
        others_equal_clean=True, replay_equals_fresh=True,
        replay_equals_clean_share=share)
    del eng, clean_eng
    torch.cuda.empty_cache()

    # (c) tier preemption; the unpreempted run is (a)'s greedy engine's
    hi = lifecycle_prompts(torch, cfg, gen, 1)[0]
    eng = engine()
    parked = []
    preempt = eng._preempt_slot

    def note_park(slot, req):
        parked.append((req.rid, len(req.tokens)))
        preempt(slot, req)

    eng._preempt_slot = note_park
    got = lifecycle_run(eng, prompts, LIFECYCLE_NEW, tiers=[1] * 8,
                        late=[(hi, 0)])
    check(eng.requests_preempted >= 1 and
          eng.requests_resumed == eng.requests_preempted,
          f"phase 10 (c): preempted {eng.requests_preempted}, resumed "
          f"{eng.requests_resumed}")
    check(not any(got["errors"]), f"phase 10 (c): errors {got['errors']}")
    (rid, accepted), = parked
    replay = prompts[rid] + got["tokens"][rid][:accepted]
    fresh = lifecycle_run(eng, [replay], LIFECYCLE_NEW - accepted)
    share = replay_checks("phase 10 (c)", runs["greedy"], got["tokens"][:8],
                          rid, accepted, fresh["tokens"][0])
    solo_hi = lifecycle_run(eng, [hi], LIFECYCLE_NEW)["tokens"][0]
    check(got["tokens"][8] == solo_hi,
          "phase 10 (c): the tier-0 request differs from a fresh run")
    out["tiers"] = {"parked_rid": rid, "accepted": accepted,
                    "requests_preempted": eng.requests_preempted,
                    "resume_equals_unpreempted_share": share}
    log("lifecycle", part="(c) tier preemption",
        requests_preempted=eng.requests_preempted,
        requests_resumed=eng.requests_resumed, parked_rid=rid,
        accepted=accepted, others_equal_unpreempted=True,
        resume_equals_fresh=True, resume_equals_unpreempted_share=share)
    del eng
    torch.cuda.empty_cache()
    out["narrow"] = narrow_replays(torch)
    out["wall_s"] = time.perf_counter() - t_phase
    log("lifecycle", wall_s=round(out["wall_s"], 1))
    return out


# -- phase 11: the serving pools --------------------------------------------

# phase 5's engine without its device: the pools place their replicas
POOL_ENGINE = {k: v for k, v in ENGINE.items() if k != "device"}
POOL_NEW = 32
# phase 6's narrow f32 config and a small paged engine over it
NARROW_CFG = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                  vocab_size=512, max_seq_len=128)
# (the 48 bucket holds a replay's prompt: prompt + accepted tokens)
NARROW_ENGINE = dict(n_slots=3, stride=4, prompt_buckets=(16, 32, 48),
                     paged=True, page_size=16, debug_invariants=True)


def pool_prompts(torch, vocab, gen, prefix: int, tail: tuple, n: int = 16,
                 groups: int = 3) -> list:
    """``n`` prompts in ``groups`` shared-prefix groups (request i in group
    i % groups): a group's ``prefix`` tokens (whole pages) and a tail of
    ``tail`` = (lo, hi) random tokens."""
    heads = [torch.randint(0, vocab, (prefix,), generator=gen,
                           device="cuda").tolist() for _ in range(groups)]
    lens = torch.randint(tail[0], tail[1] + 1, (n,), generator=gen,
                         device="cuda")
    return [heads[i % groups] + torch.randint(
        0, vocab, (int(k),), generator=gen, device="cuda").tolist()
        for i, k in enumerate(lens)]


def pool_window(torch, pool, prompts, n_new, label: str = "phase 11"
                ) -> dict:
    """Submit every prompt (``n_new[i]`` new tokens) and drain, timed to a
    synchronize: tokens by submit order, each request returned exactly
    once and without error, tokens/s, the routes and which replica
    finished each request."""
    finished = {}
    if hasattr(pool, "_finish"):
        base = pool._finish

        def note(replica, r, done):
            rid = pool._local.get((replica, r.rid))
            base(replica, r, done)
            if rid is not None:
                finished[rid] = replica

        pool._finish = note
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [pool.submit(p, n) for p, n in zip(prompts, n_new)]
    done = pool.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(sorted(r.rid for r in done) == sorted(rids),
          f"{label}: a request was lost or returned twice")
    check(all(r.error is None for r in done),
          f"{label}: errors {[r.error for r in done if r.error]}")
    by_rid = {r.rid: r.tokens for r in done}
    tokens = [by_rid[r] for r in rids]
    check(all(len(t) == n for t, n in zip(tokens, n_new)),
          f"{label}: a request came back short")
    return {"tokens": tokens, "wall_s": wall,
            "tokens_per_s": sum(map(len, tokens)) / wall,
            "routes": [tuple(x) for x in getattr(pool, "route_log", ())],
            "finished_on": [finished.get(r) for r in rids]}


def equal_share(a: list, b: list) -> float:
    """The share of token positions two runs agree on."""
    pairs = [(x, y) for ta, tb in zip(a, b) for x, y in zip(ta, tb)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def counted_imports(serve, pool) -> list:
    """Wrap the decode replica's ``import_chain`` to note, for each offered
    chain (a deferred one is offered again), whether the import computed
    its digest once (the engine's own check, ``serve._chain_digest``; a
    mismatch raises and fails the request); returns the list it fills.
    The caller restores ``serve._chain_digest``."""
    eng, seen, calls = pool.replicas[1], [], [0]
    real_import, real_digest = eng.import_chain, serve._chain_digest

    def digest(chain, t):
        calls[0] += 1
        return real_digest(chain, t)

    def checked(exp, *a, **k):
        before = calls[0]
        local = real_import(exp, *a, **k)
        seen.append(calls[0] - before == 1)
        return local

    serve._chain_digest = digest
    eng.import_chain = checked
    return seen


def timed_exports(torch, pool) -> list:
    """Wrap the prefill replica's chain export to time each (gather, copy
    to the host, digest); returns the ms list it fills."""
    eng, ms = pool.replicas[0], []
    real = eng._export_chain_slot

    def timed(slot, req):
        t0 = time.perf_counter()
        real(slot, req)
        ms.append((time.perf_counter() - t0) * 1e3)

    eng._export_chain_slot = timed
    return ms


def replica_launches(kernels, eng, kernel: str) -> list:
    """Wrap ``eng.step`` to add up the ``kernel`` launches each of its steps
    makes (a graph replay adds its captured tally); returns a one-item
    list holding the sum."""
    total = [0]
    real = eng.step

    def step():
        before = kernels.launches[kernel]
        try:
            return real()
        finally:
            total[0] += kernels.launches[kernel] - before

    eng.step = step
    return total


def disagg_run(torch, kernels, DisaggServePool, params, cfg, prompts, n_new,
               kernel, **kw) -> dict:
    """A warmed ``DisaggServePool(prefill=1, decode=1)`` on one card over
    ``prompts``: migrations equal the requests with ``n_new > 1``, every
    import met its digest, the decode replica launched ``kernel``."""
    from kubegpu_tpu_torch.models import serve
    pool = DisaggServePool(params, cfg, prefill=1, decode=1,
                           devices=["cuda:0"] * 2, **kw)
    pool.warmup()
    real_digest = serve._chain_digest
    imports = counted_imports(serve, pool)
    export_ms = timed_exports(torch, pool)
    dec = replica_launches(kernels, pool.replicas[1], kernel)
    try:
        run = pool_window(torch, pool, prompts, n_new)
    finally:
        serve._chain_digest = real_digest
    want = sum(n > 1 for n in n_new)
    check(pool.migrations == want == pool.replicas[1].chains_imported,
          f"phase 11 (c): migrations {pool.migrations}, imports "
          f"{pool.replicas[1].chains_imported}, want {want}")
    check(len(imports) >= want and all(imports),
          "phase 11 (c): an import did not check its chain's digest")
    check(dec[0] > 0, f"phase 11 (c): the decode replica never ran {kernel}")
    check(len(export_ms) == pool.replicas[0].chains_exported == want,
          "phase 11 (c): exports != migrations")
    run.update(migrations=pool.migrations,
               migrated_pages=pool.migrated_pages, export_ms=export_ms,
               import_ms=list(pool.migration_ms),
               decode_replica_launches=dec[0],
               import_attempts=len(imports))
    del pool
    torch.cuda.empty_cache()
    return run


def narrow_pools(torch, kernels) -> dict:
    """(a)-(c) at phase 6's narrow f32 config: every token equals
    ``greedy_generate``'s for its prompt (model-dtype pages, the prefix
    cache on) or, on int8 pages (waves of one, no prefix cache), one int8
    engine's; the disaggregated pool's equal the symmetric pool's, and
    the chaos run's replays equal the fault-free run."""
    from kubegpu_tpu_torch.models import (
        ContinuousBatcher,
        DataParallelServePool,
        DisaggServePool,
        LlamaConfig,
        greedy_generate,
        llama_init,
    )
    from kubegpu_tpu_torch.obs.chaos import ChaosEvent, ChaosInjector
    cfg = LlamaConfig.tiny(**NARROW_CFG)
    params = llama_init(cfg, seed=SEED, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    prompts = pool_prompts(torch, cfg.vocab_size, g, 16, (4, 14), n=9)
    n_new = [16] * 8 + [1]
    solo = [greedy_generate(params, [p], n, cfg, device="cuda")[0].tolist()
            for p, n in zip(prompts, n_new)]
    kw = dict(NARROW_ENGINE, prefix_cache=True)
    devs = ["cuda:0"] * 2
    out = {}
    runs = []
    for _ in range(2):
        pool = DataParallelServePool(params, cfg, dp=2, devices=devs, **kw)
        runs.append(pool_window(torch, pool, prompts, n_new))
    check(runs[0]["tokens"] == runs[1]["tokens"] == solo,
          "narrow (a): a pool's tokens differ from greedy_generate's")
    check(runs[0]["routes"] == runs[1]["routes"],
          "narrow (a): the routes differ between two identical runs")
    out["affinity_hit_rate"] = pool.routing_affinity_hit_rate
    pool = DataParallelServePool(params, cfg, dp=2, devices=devs, chaos={
        1: ChaosInjector([ChaosEvent(1, "kill_replica")])}, **kw)
    chaos = pool_window(torch, pool, prompts, [16] * len(prompts))
    check(pool.failovers == 1 and 1 in pool.dead_replicas,
          f"narrow (b): failovers {pool.failovers}")
    check(chaos["tokens"][:8] == solo[:8],
          "narrow (b): a replayed request differs from the fault-free run")
    check(set(chaos["finished_on"]) == {0},
          "narrow (b): a request finished off replica 0")
    before = kernels.launches["paged_decode"]
    dis = disagg_run(torch, kernels, DisaggServePool, params, cfg, prompts,
                     n_new, "paged_decode", **kw)
    check(dis["tokens"] == runs[0]["tokens"],
          "narrow (c): the disaggregated pool's tokens differ from the "
          "symmetric pool's")
    check(kernels.launches["paged_decode"] > before, "narrow: no kernel 4")
    # int8 codes round the K/V: a request must see the same GEMM shapes on
    # every engine for its codes to be equal, so every prefill is a wave of
    # one and nothing is aliased (a follower's tail through the chunk step,
    # or a wave of another size, may move a code by one)
    q8 = dict(NARROW_ENGINE, kv_bits=8, max_wave=1)
    single = ContinuousBatcher(params, cfg, device="cuda", **q8)
    for p, n in zip(prompts, n_new):
        single.submit(p, n)
    by_rid = {r.rid: r.tokens for r in single.drain()}
    q8_single = [by_rid[i] for i in range(len(prompts))]
    sym8 = pool_window(torch, DataParallelServePool(
        params, cfg, dp=2, devices=devs, **q8), prompts, n_new)
    dis8 = disagg_run(torch, kernels, DisaggServePool, params, cfg, prompts,
                      n_new, "paged_decode_q8", **q8)
    check(sym8["tokens"] == q8_single,
          "narrow (c): the int8 symmetric pool differs from one int8 engine")
    check(dis8["tokens"] == sym8["tokens"],
          "narrow (c): the int8 disaggregated pool differs from the "
          "symmetric one")
    out.update(pool_equals_greedy=True, routes_repeat=True,
               replays_equal_fault_free=True, disagg_equals_symmetric=True,
               int8_disagg_equals_single=True,
               migrations=dis["migrations"], migrated_pages=dis["migrated_pages"])
    log("pools", part="narrow f32 (phase 6's config)",
        pool_equals_greedy=True, routes_repeat=True,
        affinity_hit_rate=round(out["affinity_hit_rate"], 3),
        replays_equal_fault_free=True, disagg_equals_symmetric=True,
        int8_disagg_equals_single_engine=True,
        migrations=dis["migrations"], migrated_pages=dis["migrated_pages"])
    return out


def pool_phase(torch, kernels, cfg, params, gen, name) -> dict:
    """Phase 11: the serving pools at phase 5's engine shape (Llama-3-8B,
    bf16 weights shared by two engines on the one card, 8 slots each,
    pages of 128, a 512 bucket), every pool ``warmup()``-ed (the replicas
    capture their graphs one after the other):

    (a) ``DataParallelServePool(dp=2, routing="affinity",
        prefix_cache=True)``: 16 greedy requests in three groups sharing a
        256-token prefix (two pages), 32 new tokens (two of them 1);
        every request returns once; a second identical pool gives the
        same routes and tokens; the affinity hit rate, and tokens/s
        beside one 16-slot engine's (80 pages) on the same prompts; then
        ``retire_replica(1)`` and the memory still held (a retired
        replica keeps its engine, and so its pool and graphs);
    (b) the second pool again, its replica 1 killed at its second tick
        (``ChaosInjector``): one failover, every request returned once
        and finished on replica 0;
    (c) ``DisaggServePool(prefill=1, decode=1)`` on bf16 pages and on
        ``kv_bits=8`` pages (kernel 5): migrations equal the requests with
        more than one new token, every import met its digest, the decode
        replica's launches; each chain's export and import ms and the
        pages migrated;
    (d) (a)-(c) at phase 6's narrow f32 config with every token held
        (:func:`narrow_pools`).

    At full width in bf16 only exactly-once completion and the counters
    are held: near-tied argmaxes flip across batch shapes and replays
    (ROADMAP.md queue 3), so the shares of equal tokens are printed."""
    from kubegpu_tpu_torch.models import (
        ContinuousBatcher,
        DataParallelServePool,
        DisaggServePool,
    )
    from kubegpu_tpu_torch.obs.chaos import ChaosEvent, ChaosInjector
    t_phase = time.perf_counter()
    prompts = pool_prompts(torch, cfg.vocab_size, gen, 256, (40, 200))
    n_new = [POOL_NEW] * 14 + [1, 1]
    devs = ["cuda:0"] * 2
    aff_kw = dict(POOL_ENGINE, prefix_cache=True)
    out = {}
    torch.cuda.reset_peak_memory_stats()

    def warmed_pool(cls, **kw):
        pool = cls(params, cfg, devices=devs, **kw)
        t0 = time.perf_counter()
        pool.warmup()
        torch.cuda.synchronize()
        return pool, time.perf_counter() - t0

    # (a) affinity routing on two identical pools, and one 16-slot engine
    pools, runs, warm_s = [], [], []
    for _ in range(2):
        pool, w = warmed_pool(DataParallelServePool, dp=2, routing="affinity",
                              **aff_kw)
        pools.append(pool)
        warm_s.append(w)
        runs.append(pool_window(torch, pool, prompts, n_new))
    check(runs[0]["routes"] == runs[1]["routes"],
          "phase 11 (a): the routes differ between two identical runs")
    check(runs[0]["tokens"] == runs[1]["tokens"],
          "phase 11 (a): two identical pools gave different tokens")
    hit_rate = pool.routing_affinity_hit_rate
    check(hit_rate > 0, "phase 11 (a): no request hit its chain's replica")
    peak = torch.cuda.max_memory_allocated()
    held0 = torch.cuda.memory_allocated()
    pool = pools.pop(0)
    pool.retire_replica(1)
    pool.step()
    check(1 in pool.dead_replicas and pool.drains == 1,
          "phase 11 (a): the retire did not land")
    held1 = torch.cuda.memory_allocated()
    del pool
    torch.cuda.empty_cache()
    single = ContinuousBatcher(params, cfg, device="cuda",
                               **dict(aff_kw, n_slots=16, total_pages=80))
    single.warmup()
    one = pool_window(torch, single, prompts, n_new)
    del single
    torch.cuda.empty_cache()
    out["affinity"] = {
        "hit_rate": hit_rate, "routes": runs[0]["routes"],
        "tokens_per_s": [r["tokens_per_s"] for r in runs],
        "single_engine_tokens_per_s": one["tokens_per_s"],
        "equal_single_engine_share": equal_share(runs[0]["tokens"],
                                                 one["tokens"]),
        "warmup_s": warm_s, "peak_bytes": peak,
        "allocated_before_retire": held0, "allocated_after_retire": held1}
    log("pools", part="(a) dp=2 affinity", card=repr(name),
        hit_rate=round(hit_rate, 3), routes_repeat=True, tokens_repeat=True,
        tokens_per_s=[round(r["tokens_per_s"], 1) for r in runs],
        single_16slot_tokens_per_s=round(one["tokens_per_s"], 1),
        equal_single_engine_share=round(
            out["affinity"]["equal_single_engine_share"], 4),
        warmup_s=[round(w, 2) for w in warm_s],
        peak_gb=round(peak / 1e9, 2),
        allocated_gb_before_retire=round(held0 / 1e9, 3),
        allocated_gb_after_retire=round(held1 / 1e9, 3))

    # (b) the second pool's replica 1 killed at its next tick but one
    pool = pools.pop()
    pool.replicas[1].chaos = ChaosInjector([ChaosEvent(
        pool.replicas[1]._tick + 1, "kill_replica")])
    chaos = pool_window(torch, pool, prompts, [POOL_NEW] * len(prompts))
    check(pool.failovers == 1 and 1 in pool.dead_replicas,
          f"phase 11 (b): failovers {pool.failovers}, dead "
          f"{pool.dead_replicas}")
    check(set(chaos["finished_on"]) == {0},
          "phase 11 (b): a request finished off replica 0")
    out["chaos"] = {"failovers": pool.failovers,
                    "requests_retried": pool.requests_retried,
                    "replay_ms": list(pool.replay_ms),
                    "equal_fault_free_share": equal_share(
                        runs[0]["tokens"][:14], chaos["tokens"][:14])}
    log("pools", part="(b) replica 1 killed", failovers=pool.failovers,
        requests_retried=pool.requests_retried,
        replay_ms=[round(x, 3) for x in pool.replay_ms],
        all_finished_on_replica_0=True,
        equal_fault_free_share=round(out["chaos"]["equal_fault_free_share"],
                                     4))
    del pool
    torch.cuda.empty_cache()

    # (c) disaggregated prefill/decode, bf16 and int8 pages
    out["disagg"] = {}
    for label, kernel, kw in (("bf16", "paged_decode", {}),
                              ("int8", "paged_decode_q8", {"kv_bits": 8})):
        run = disagg_run(torch, kernels, DisaggServePool, params, cfg,
                         prompts, n_new, kernel, **aff_kw, **kw)
        if label == "bf16":
            run["equal_symmetric_share"] = equal_share(runs[0]["tokens"],
                                                       run["tokens"])
        out["disagg"][label] = {k: v for k, v in run.items()
                                if k not in ("tokens", "routes")}
        log("pools", part=f"(c) disagg {label}",
            migrations=run["migrations"],
            migrated_pages=run["migrated_pages"],
            digests_checked=run["import_attempts"],
            decode_replica_launches=run["decode_replica_launches"],
            export_ms=[round(x, 3) for x in run["export_ms"]],
            import_ms=[round(x, 3) for x in run["import_ms"]],
            tokens_per_s=round(run["tokens_per_s"], 1),
            **({"equal_symmetric_share": round(
                run["equal_symmetric_share"], 4)} if label == "bf16" else {}))

    # (d) the narrow f32 config, every token held
    out["narrow"] = narrow_pools(torch, kernels)
    out["wall_s"] = time.perf_counter() - t_phase
    log("pools", wall_s=round(out["wall_s"], 1))
    return out


# -- phase 12: the load harness and the fleet ------------------------------

# the reference's cb_slo_goodput tiers: (name, TTFT ticks, ticks a token,
# share of the traffic)
# phase 12 runs the first 16 of the 32 layers (a view of the bf16 tree),
# for the script's time limit since phase 18 was added
LOAD_LAYERS = 16
LOAD_TIERS = (("gold", 8, 4.0, 0.3), ("std", 30, 8.0, 0.4),
              ("batch", 10 ** 6, 10 ** 6, 0.3))
LOAD_ENGINE = dict(ENGINE, **PREFIX)
LOAD_POOL_ENGINE = {k: v for k, v in LOAD_ENGINE.items() if k != "device"}
# the fleet's failure domains, replicas and trace
FLEET = {"replicas": 64, "domains": 4, "requests": 4096,
         "mean_iat_ticks": 0.1}


def load_spec(loadgen, vocab: int, **kw):
    """Phase 12's open-loop traffic (``LoadSpec``, seed 7): 48 requests,
    0.9 ticks between arrivals on average, Markov-modulated bursts,
    prompts log-normal around 300 tokens (sigma 0.4, at most 512), 8-64
    new tokens (log-normal around 24), half of them on one of 3 shared
    128-token prefixes (one page), under the three tiers; ``kw``
    overrides a field (the narrow config's lengths and vocabulary)."""
    tiers = tuple(loadgen.TierSpec(*t) for t in LOAD_TIERS)
    spec = dict(seed=7, n_requests=48, mean_iat_ticks=0.9, burst=True,
                prompt_len_mean=math.log(300), prompt_len_sigma=0.4,
                prompt_len_max=512, out_len_mean=math.log(24),
                out_len_min=8, out_len_max=64, prefix_share=0.5,
                n_shared_prefixes=3, prefix_len=128, vocab=vocab,
                tiers=tiers)
    spec.update(kw)
    return loadgen.LoadSpec(**spec), tiers


def load_leg(torch, kernels, loadgen, label, target, trace, tiers, vocab,
             tiered: bool = True) -> dict:
    """``run_load`` of ``trace`` through ``target`` (an engine or a pool
    built with a metrics registry, so every first token is stamped): no
    request lost or returned twice, every completed one with its tokens,
    in range; the ticks and wall, goodput a tick and a second, attainment
    by tier, TTFT p99 in ticks (from the records) and in ms (the
    registry's ``serve_ttft_ms``), the engine's tokens/s and the paged
    kernels' launches."""
    from kubegpu_tpu_torch.obs.metrics import percentiles
    before = dict(kernels.launches)
    torch.cuda.synchronize()
    rep = loadgen.run_load(target, trace, tiers, tiered=tiered)
    torch.cuda.synchronize()
    check(rep.lost == 0 and rep.duplicated == 0,
          f"phase 12 {label}: lost {rep.lost}, duplicated {rep.duplicated}")
    check(rep.completed + rep.failed == rep.submitted == len(trace),
          f"phase 12 {label}: {rep.completed} + {rep.failed} of "
          f"{rep.submitted}")
    for rec in rep.records:
        if rec["completed"]:
            check(len(rec["tokens"]) == rec["max_new"],
                  f"phase 12 {label}: rid {rec['rid']} came back short")
    check(all(0 <= t < vocab for rec in rep.records for t in rec["tokens"]),
          f"phase 12 {label}: a token out of range")
    ttft = [rec["ttft_ticks"] for rec in rep.records if "ttft_ticks" in rec]
    reg = getattr(target, "_metrics", None)
    hists = reg.snapshot()["histograms"] if reg is not None else {}
    out = {"ticks": rep.ticks, "wall_s": rep.wall_s,
           "submitted": rep.submitted, "completed": rep.completed,
           "failed": rep.failed, "lost": rep.lost,
           "duplicated": rep.duplicated,
           "goodput_tokens": rep.goodput_tokens,
           "goodput_tokens_per_tick": rep.goodput_tokens_per_tick,
           "goodput_tokens_per_s": rep.goodput_tokens_per_s,
           "tokens_per_s": rep.total_tokens / rep.wall_s,
           "attainment": {a["name"]: a["attainment"]
                          for a in rep.per_tier.values()},
           "goodput_by_tier": {a["name"]: a["goodput_tokens"]
                               for a in rep.per_tier.values()},
           "ttft_p99_ticks": percentiles(ttft)["p99"] if ttft else None,
           "ttft_p99_ms": (hists["serve_ttft_ms"]["p99"]
                           if "serve_ttft_ms" in hists else None),
           "busy_chip_ticks": rep.busy_chip_ticks,
           "launches": {k: kernels.launches[k] - before[k]
                        for k in PAGED_KERNELS},
           "records": rep.records}
    log("load", leg=label, ticks=rep.ticks, wall_s=round(rep.wall_s, 3),
        goodput_tokens_per_tick=round(rep.goodput_tokens_per_tick, 4),
        goodput_tokens_per_s=round(rep.goodput_tokens_per_s, 1),
        tokens_per_s=round(out["tokens_per_s"], 1),
        attainment=out["attainment"],
        ttft_p99_ticks=out["ttft_p99_ticks"],
        ttft_p99_ms=(round(out["ttft_p99_ms"], 3)
                     if out["ttft_p99_ms"] is not None else None),
        completed=rep.completed, failed=rep.failed, lost=rep.lost,
        duplicated=rep.duplicated,
        launches={k: v for k, v in out["launches"].items() if v})
    return out


def load_engine(torch, ContinuousBatcher, cfg, params, **kw):
    """A ``warmup()``-ed engine of phase 5f's shape with a metrics
    registry, and its warmup seconds."""
    from kubegpu_tpu_torch.obs.metrics import MetricsRegistry
    eng = ContinuousBatcher(params, cfg, metrics=MetricsRegistry(),
                            **dict(LOAD_ENGINE, **kw))
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def token_split(torch, cfg, params, a: list, b: list) -> dict:
    """Records of two legs of one trace: the share of completed requests
    with equal tokens, and for each that differs, the gap between the two
    legs' tokens' logits at the first position they part (the plain
    prefill's logits, ``llama_forward`` of prompt + the agreed tokens),
    beside that row's logit range.  A near tie (gap within 5% of the
    range) is bf16 rounding that one extra batch row or prefill shape
    can flip; a wider gap is a fault."""
    from kubegpu_tpu_torch.models import llama_forward
    pairs = [(x, y) for x, y in zip(a, b)
             if x["completed"] and y["completed"]]
    same = sum(x["tokens"] == y["tokens"] for x, y in pairs)
    gaps = []
    for x, y in pairs:
        j = next((i for i, (u, v) in enumerate(zip(x["tokens"],
                                                   y["tokens"]))
                  if u != v), None)
        if j is None:
            continue
        seq = [int(t) for t in x["prompt"]] + x["tokens"][:j]
        with torch.no_grad():
            row = llama_forward(params, torch.tensor([seq], device="cuda"),
                                cfg)[0, -1].float()
        gap = abs(row[x["tokens"][j]] - row[y["tokens"][j]]).item()
        span = (row.max() - row.min()).item()
        gaps.append({"rid": x["rid"], "pos": j, "gap": gap, "range": span})
        check(gap <= 0.05 * span,
              f"phase 12: rid {x['rid']} parts at token {j} with a logit "
              f"gap {gap} of a {span} range: not a near tie")
    return {"equal_share": same / max(len(pairs), 1), "compared": len(pairs),
            "splits": gaps}


def steady_prompts(torch, cfg, gen, n: int = 8) -> list:
    """``n`` prompts of 128 tokens (one page, one chunk)."""
    return [torch.randint(0, cfg.vocab_size, (128,), generator=gen,
                          device="cuda").tolist() for _ in range(n)]


def steady_state(eng, prompts, n_new: int = 128) -> int:
    """Fill every slot with a 128-new-token request (8 ticks) and step
    until every slot decodes, none prefills and nothing queues; returns
    the steps taken."""
    for p in prompts[:eng.n_slots]:
        eng.submit(p, n_new)
    for steps in range(1, 6):
        eng.step()
        if eng.active.all() and not eng._prefilling and not eng.queue:
            return steps
    raise SmokeFailure("phase 12: the engine never reached its steady "
                       "state")


def event_ms(torch, fn, reps: int = 5) -> float:
    """Median device ms of ``fn()`` between two CUDA events, one call at a
    time (a replayed tick is ~10^4 kernels: ``cuda_ms``'s queue of calls
    behind a sleeping card does not fit it, and the host's enqueue is
    small beside the ~0.2 s it times)."""
    import statistics
    times = []
    for _ in range(reps + 1):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def steady_idle(torch, eng, prompts, label: str, block_ms: float,
                steps: int = 3) -> dict:
    """``--profile``: the device's idle share over ``steps`` consecutive
    steady steps (no synchronize between them, one at the end): their
    untraced wall against ``steps`` replayed ticks' device ms
    (``block_ms``, :func:`calibrate`), then the same count traced
    (``device_trace``; its busy ms over its own traced wall); with
    ``collect_overlap`` each of them dispatches the next tick before it
    reads the last.  Every slot must still be resident after."""
    steady_state(eng, prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def run():
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    out = device_trace(torch, run, wall_ms)
    check(len(eng.slot_req) == eng.n_slots,
          f"{label}: a request finished inside the traced steps")
    eng.drain()
    out["idle_share_events"] = 1 - steps * block_ms / wall_ms
    out["idle_share_traced"] = 1 - out["device_busy_ms"] / out[
        "traced_wall_ms"]
    log_trace(f"{steps} steady {label} steps", out)
    return out


def calibrate(torch, eng, prompts) -> dict:
    """The fleet's cost model from the card: the device ms of one replayed
    chunk step (``prefill_chunk`` prompt tokens) a token, and of one
    replayed plain tick (a stride block) with every slot decoding
    (:func:`event_ms`).  The chunk replays rewrite the last chunk's
    (freed) pages; the tick's run past the slots' host state, so the
    engine is drained after (its requests' tokens are not looked at)."""
    chunk_ms = event_ms(torch, eng._chunk_graph.replay)
    steady_state(eng, prompts, n_new=112)

    def tick():
        eng._tv["tk"].zero_()
        eng._run_tick("plain")

    block_ms = event_ms(torch, tick)
    eng.drain()
    check(len(eng._free_pages) == eng.total_pages,
          "calibrate: the drained engine leaked pages")
    return {"block_ms": block_ms, "chunk_ms": chunk_ms,
            "prefill_ms_per_token": chunk_ms / eng.prefill_chunk}


def narrow_load(torch) -> dict:
    """(c) and (d) at phase 6's narrow f32 config: one trace of its own
    (prompts of at most 48 tokens, 4-24 new ones, a 16-token shared
    prefix) through an engine with ``collect_overlap`` off and on, on
    model-dtype and on int8 pages: equal tokens; and an engine with
    ``donate=False`` against ``donate=True`` on the same trace: equal
    tokens."""
    from kubegpu_tpu_torch import loadgen
    from kubegpu_tpu_torch.models import (
        ContinuousBatcher,
        LlamaConfig,
        llama_init,
    )
    from kubegpu_tpu_torch.obs.metrics import MetricsRegistry
    cfg = LlamaConfig.tiny(**NARROW_CFG)
    params = llama_init(cfg, seed=SEED, device="cuda")
    spec, tiers = load_spec(loadgen, cfg.vocab_size, n_requests=24,
                            prompt_len_mean=math.log(20), prompt_len_max=48,
                            out_len_mean=math.log(10), out_len_min=4,
                            out_len_max=24, prefix_len=16)
    trace = loadgen.synth_trace(spec)
    out = {}

    def tokens(**kw):
        eng = ContinuousBatcher(params, cfg, device="cuda",
                                metrics=MetricsRegistry(),
                                **dict(NARROW_ENGINE, prefix_cache=True,
                                       **kw))
        rep = loadgen.run_load(eng, trace, tiers)
        check(rep.lost == 0 and rep.duplicated == 0,
              "phase 12 narrow: lost or duplicated")
        return eng, [r["tokens"] for r in rep.records]

    for label, kw in (("f32", {}), ("int8", {"kv_bits": 8})):
        _, off = tokens(**kw)
        eng, on = tokens(collect_overlap=True, **kw)
        check(on == off, f"phase 12 narrow {label}: collect_overlap tokens "
              "differ from the serial engine's")
        check(len(eng.overlap_ms) > 0,
              f"phase 12 narrow {label}: no tick overlapped")
        out[f"overlap_{label}"] = {"equal": True,
                                   "overlapped": len(eng.overlap_ms)}
    _, kept = tokens(donate=False)
    _, donated = tokens()
    check(kept == donated, "phase 12 narrow: donate=False tokens differ")
    out["donate_equal"] = True
    log("load", part="narrow f32 (phase 6's config)",
        overlap_tokens_equal=True,
        overlapped={k: v["overlapped"] for k, v in out.items()
                    if k.startswith("overlap")},
        donate_false_tokens_equal=True)
    return out


def donate_phase(torch, ContinuousBatcher, cfg, params, gen) -> dict:
    """(d) at full width: phase 5's engine with ``donate=False`` and with
    ``donate=True``, each on 8 requests of 64 new tokens: a handle to the
    public pool's ``k`` taken after two steps equals its snapshot after a
    third (``donate=False``: the public leaves were rebound, the live pool
    moved on), ``hbm_peak_bytes`` grows by exactly one pool, and the
    card's peak allocation over each engine's life is printed."""
    prompts = window_prompts(torch, cfg, gen, n=8)
    out = {}
    for donate in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = ContinuousBatcher(params, cfg, donate=donate, **ENGINE)
        eng.warmup()
        rids = [eng.submit(p, 64) for p in prompts]
        eng.step()
        eng.step()
        handle = eng.pool["k"]
        snap = handle.clone()
        eng.step()
        torch.cuda.synchronize()
        held = torch.equal(handle, snap)
        moved = not torch.equal(eng.pool["k"], snap)
        if donate:
            check(handle is eng.pool["k"] and moved,
                  "phase 12 (d): donate=True's pool is not the live one")
        else:
            check(held and moved and handle is not eng.pool["k"],
                  "phase 12 (d): donate=False lost a held handle's values")
        del handle, snap
        done = {r.rid: r.tokens for r in eng.drain()}
        check(sorted(done) == sorted(rids), "phase 12 (d): a request lost")
        torch.cuda.synchronize()
        out[donate] = {"peak_bytes": torch.cuda.max_memory_allocated() - base,
                       "hbm_peak_bytes": eng.hbm_peak_bytes,
                       "pool_bytes": pool_bytes(eng),
                       "tokens": [done[r] for r in rids]}
        del eng
    grow = out[False]["hbm_peak_bytes"] - out[True]["hbm_peak_bytes"]
    check(grow == out[True]["pool_bytes"],
          f"phase 12 (d): hbm_peak_bytes grew by {grow}, one pool is "
          f"{out[True]['pool_bytes']}")
    res = {"donate": {k: out[True][k] for k in ("peak_bytes",
                                                "hbm_peak_bytes")},
           "no_donate": {k: out[False][k] for k in ("peak_bytes",
                                                    "hbm_peak_bytes")},
           "pool_bytes": out[True]["pool_bytes"],
           "equal_share": equal_share(out[True]["tokens"],
                                      out[False]["tokens"])}
    log("load", part="(d) donate=False", handle_kept=True,
        pool_gb=round(res["pool_bytes"] / 1e9, 3),
        peak_gb={"donate": round(out[True]["peak_bytes"] / 1e9, 3),
                 "no_donate": round(out[False]["peak_bytes"] / 1e9, 3)},
        hbm_peak_gb={"donate": round(out[True]["hbm_peak_bytes"] / 1e9, 3),
                     "no_donate": round(out[False]["hbm_peak_bytes"] / 1e9,
                                        3)},
        equal_share=round(res["equal_share"], 4))
    return res


def fleet_phase(cfg, costs: dict, page_bytes: int) -> dict:
    """(e) ``run_fleet`` on the host: 64 simulated replicas of phase 5f's
    engine shape in 4 racks, their cost model from (a)'s card numbers,
    under a 4096-request diurnal trace with a flash crowd and phase 12's
    tiers, a ``FlightRecorder`` on each run.  An uninterrupted twin
    (no failover alert may fire), then watch weather (duplicated, delayed and
    reordered deliveries), a rack killed at tick 24, a watch partition
    and a rack evicted behind it, and an upgrade wave over the racks; then
    the rack kill and a control-plane crash at tick 60 (journal
    recovery).  Each run: nothing lost or duplicated, outcomes identical
    to the twin, the kill paged within 16 ticks."""
    from kubegpu_tpu_torch import fleet, loadgen
    from kubegpu_tpu_torch.obs import chaos as ch
    from kubegpu_tpu_torch.obs.alerts import FlightRecorder
    from kubegpu_tpu_torch.obs.metrics import MetricsRegistry
    spec, tiers = load_spec(
        loadgen, cfg.vocab_size, n_requests=FLEET["requests"],
        mean_iat_ticks=FLEET["mean_iat_ticks"], diurnal=True,
        diurnal_period_ticks=128.0, flash_at=(40.0,), flash_rate_x=4.0,
        flash_len_ticks=16.0, tenants=("acme", "blue", "coral"))
    trace = loadgen.synth_trace(spec)
    fcfg = fleet.FleetConfig(
        vocab=cfg.vocab_size, n_slots=ENGINE["n_slots"],
        page_size=ENGINE["page_size"], total_pages=ENGINE["total_pages"],
        max_len=ENGINE["max_len"], prefill_tokens_per_tick=PREFIX[
            "prefill_chunk"], page_bytes=page_bytes,
        costs=fleet.ReplicaCosts(
            block_ms=costs["block_ms"],
            prefill_ms_per_token=costs["prefill_ms_per_token"]))
    E = ch.DomainChaosEvent
    kill_at = 24

    def run(label, **kw):
        rec = FlightRecorder(MetricsRegistry())
        t0 = time.perf_counter()
        rep = fleet.run_fleet(trace, tiers, cfg=fcfg,
                              replicas=FLEET["replicas"],
                              domains=FLEET["domains"], metrics=rec.metrics,
                              controller=rec, **kw)
        host_s = time.perf_counter() - t0
        check(rep.load.lost == 0 and rep.load.duplicated == 0,
              f"phase 12 (e) {label}: lost {rep.load.lost}, duplicated "
              f"{rep.load.duplicated}")
        check(rep.tier_inversions == 0,
              f"phase 12 (e) {label}: a tier inversion")
        check(sum(rep.cost_by_key.values()) == rep.busy_chip_ticks,
              f"phase 12 (e) {label}: the chip-tick ledger does not "
              "conserve")
        return rep, rec, host_s

    twin, twin_rec, twin_s = run("twin")
    check(all(rule != "alert_failover_burn"
              for _, rule in twin_rec.alert_log()),
          f"phase 12 (e): the fault-free twin paged a failover burn "
          f"{twin_rec.alert_log()}")
    out = {"twin": {"host_s": twin_s, "ticks": twin.load.ticks,
                    "completed": twin.load.completed,
                    "alerts": twin_rec.alert_log(),
                    "attainment": twin.load.slo_attainment,
                    "sim_ms": twin.sim_ms}}
    scenarios = (
        ("chaos+upgrade", dict(
            chaos=ch.DomainChaosInjector(events=[
                E(tick=20, kind=ch.WATCH_DUP, dup=3, duration_ticks=16),
                E(tick=20, kind=ch.WATCH_DELAY, delay_ticks=3,
                  duration_ticks=16),
                E(tick=20, kind=ch.WATCH_REORDER, duration_ticks=16),
                E(tick=kill_at, kind=ch.DOMAIN_KILL, domain="rack1"),
                E(tick=30, kind=ch.WATCH_PARTITION, duration_ticks=6),
                E(tick=31, kind=ch.DOMAIN_EVICT, domain="rack2")]),
            upgrade=True, upgrade_floor=24, upgrade_surge=4,
            upgrade_start=40)),
        ("kill+crash", dict(
            chaos=ch.DomainChaosInjector(events=[
                E(tick=kill_at, kind=ch.DOMAIN_KILL, domain="rack1")]),
            journal=fleet.ControlPlaneJournal(), crash_at=60)))
    for label, kw in scenarios:
        rep, rec, host_s = run(label, **kw)
        cmp_ = fleet.compare_outcomes(twin.load, rep.load)
        check(cmp_["identical"] and cmp_["checked"] == len(trace),
              f"phase 12 (e) {label}: outcomes differ from the twin {cmp_}")
        pages = [t for t, rule in rec.alert_log()
                 if rule == "alert_failover_burn"]
        check(pages and kill_at <= pages[0] <= kill_at + 16,
              f"phase 12 (e) {label}: the rack kill paged at {pages}")
        out[label] = {
            "host_s": host_s, "ticks": rep.load.ticks,
            "killed_replicas": rep.killed_replicas,
            "failovers": rep.failovers, "domain_kills": rep.domain_kills,
            "domain_evictions": rep.domain_evictions,
            "watch_delivered": rep.watch_delivered,
            "upgrade_waves": rep.upgrade_waves,
            "upgraded_replicas": rep.upgraded_replicas,
            "min_alive": rep.min_alive, "recoveries": rep.recoveries,
            "redriven": rep.redriven, "alerts": rec.alert_log(),
            "page_after_ticks": pages[0] - kill_at,
            "recorder_ms_per_tick": rec.overhead_per_tick_s * 1e3,
            "sim_ms": rep.sim_ms, "outcomes_identical": True}
        log("fleet", run=label, host_s=round(host_s, 3),
            ticks=rep.load.ticks, killed=rep.killed_replicas,
            failovers=rep.failovers, watch_delivered=rep.watch_delivered,
            upgrade_waves=rep.upgrade_waves,
            upgraded=rep.upgraded_replicas, min_alive=rep.min_alive,
            recoveries=rep.recoveries, redriven=rep.redriven,
            lost=0, duplicated=0, outcomes_identical=True,
            paged_after_ticks=pages[0] - kill_at,
            recorder_ms_per_tick=round(rec.overhead_per_tick_s * 1e3, 4))
    log("fleet", run="twin", host_s=round(twin_s, 3),
        ticks=twin.load.ticks, completed=twin.load.completed,
        alerts=twin_rec.alert_log(),
        replicas=FLEET["replicas"], domains=FLEET["domains"],
        requests=len(trace), block_ms=round(costs["block_ms"], 4),
        prefill_ms_per_token=round(costs["prefill_ms_per_token"], 6))
    return out


def load_phase(torch, kernels, cfg, params, gen, name,
               profile: bool = False) -> dict:
    """Phase 12: the load harness at phase 5f's engine shape (Llama-3-8B,
    bf16, 8 slots, pages of 128, the prefix cache and 256-token chunks),
    every engine ``warmup()``-ed, one seeded open-loop trace
    (:func:`load_spec`) through:

    (a) one engine, FIFO against tiered (``run_load(tiered=False|True)``,
        each on a fresh engine): ticks, wall, goodput a tick and a second,
        attainment by tier, TTFT p99 in ticks and ms, nothing lost or
        duplicated; then, on the tiered engine, the device ms of a
        replayed chunk step and tick (the fleet's cost model);
    (b) ``DataParallelServePool(dp=2)`` on the one card, weights shared,
        ``routing="affinity"`` against ``"least_loaded"``: the hit rate,
        the gold tier's goodput ratio, kernel 4's launches;
    (c) ``collect_overlap=True`` against (a)'s tiered leg, and on int8
        pages (kernel 5) both ways: ``overlap_ms`` median and p99, the
        overlapped ticks (> 0), tokens/s both ways, the share of equal
        tokens (a request that differs must part at a near tie:
        :func:`token_split`); with ``profile``, the idle share of three
        steady steps both ways on bf16 pages;
    (d) ``donate=False`` (:func:`donate_phase`), and (c)'s and (d)'s
        token gates at the narrow f32 config (:func:`narrow_load`);
    (e) ``run_fleet`` of 64 simulated replicas calibrated from (a)
        (:func:`fleet_phase`)."""
    import statistics

    from kubegpu_tpu_torch import loadgen
    from kubegpu_tpu_torch.models import (
        ContinuousBatcher,
        DataParallelServePool,
    )
    from kubegpu_tpu_torch.obs.metrics import MetricsRegistry, percentiles
    t_phase = time.perf_counter()
    spec, tiers = load_spec(loadgen, cfg.vocab_size)
    trace = loadgen.synth_trace(spec)
    prompts = steady_prompts(torch, cfg, gen)
    out = {"trace": {"requests": len(trace),
                     "last_arrival_tick": trace[-1]["arrival_tick"],
                     "prompt_tokens": sum(len(e["prompt"]) for e in trace),
                     "new_tokens": sum(e["max_new"] for e in trace)}}
    log("load", trace=out["trace"], card=repr(name))
    legs, warm = {}, {}

    # (a) FIFO against tiered, a fresh engine each
    for label, tiered in (("fifo", False), ("tiered", True)):
        eng, warm[label] = load_engine(torch, ContinuousBatcher, cfg, params)
        legs[label] = load_leg(torch, kernels, loadgen, f"(a) {label}", eng,
                               trace, tiers, cfg.vocab_size, tiered=tiered)
        if label == "fifo":
            del eng
            torch.cuda.empty_cache()
    gold = LOAD_TIERS[0][0]
    costs = calibrate(torch, eng, prompts)
    prof = {}
    if profile:
        prof["bf16"] = steady_idle(torch, eng, prompts, "bf16 (overlap off)",
                                   costs["block_ms"])
    del eng
    torch.cuda.empty_cache()
    log("load", part="(a) FIFO vs tiered",
        gold_goodput={k: legs[k]["goodput_by_tier"][gold]
                      for k in ("fifo", "tiered")},
        gold_goodput_ratio=(legs["tiered"]["goodput_by_tier"][gold]
                            / max(legs["fifo"]["goodput_by_tier"][gold], 1)),
        warmup_s={k: round(v, 2) for k, v in warm.items()},
        block_ms=round(costs["block_ms"], 4),
        chunk_ms=round(costs["chunk_ms"], 4),
        prefill_ms_per_token=round(costs["prefill_ms_per_token"], 6))

    # (b) two replicas on the one card, affinity against least-loaded
    pools = {}
    for routing in ("affinity", "least_loaded"):
        pool = DataParallelServePool(params, cfg, dp=2,
                                     devices=["cuda:0"] * 2,
                                     routing=routing,
                                     metrics=MetricsRegistry(),
                                     **LOAD_POOL_ENGINE)
        pool.warmup()
        leg = load_leg(torch, kernels, loadgen, f"(b) dp=2 {routing}", pool,
                       trace, tiers, cfg.vocab_size)
        leg["hit_rate"] = pool.routing_affinity_hit_rate
        leg["affinity_hits"] = pool.routing_affinity_hits
        pools[routing] = leg
        del pool
        torch.cuda.empty_cache()
    check(pools["affinity"]["affinity_hits"] > 0,
          "phase 12 (b): affinity routing never hit a chain's replica")
    check(pools["least_loaded"]["affinity_hits"] == 0,
          "phase 12 (b): least-loaded routing counted affinity hits")
    check(all(p["launches"]["paged_decode"] > 0 for p in pools.values()),
          "phase 12 (b): a pool leg never ran kernel 4")
    log("load", part="(b) dp=2 routing",
        hit_rate={k: round(v["hit_rate"], 4) for k, v in pools.items()},
        gold_goodput={k: v["goodput_by_tier"][gold]
                      for k, v in pools.items()},
        gold_goodput_ratio=(pools["affinity"]["goodput_by_tier"][gold]
                            / max(pools["least_loaded"]["goodput_by_tier"][
                                gold], 1)),
        kernel4_launches={k: v["launches"]["paged_decode"]
                          for k, v in pools.items()})

    # (c) collect_overlap on bf16 pages (against (a)'s tiered leg) and on
    # int8 pages both ways
    overlap = {}
    for label, kw in (("bf16", {}), ("int8", {"kv_bits": 8})):
        if label == "bf16":
            off = legs["tiered"]
        else:
            eng, _ = load_engine(torch, ContinuousBatcher, cfg, params, **kw)
            off = load_leg(torch, kernels, loadgen, f"(c) {label} serial",
                           eng, trace, tiers, cfg.vocab_size)
            del eng
            torch.cuda.empty_cache()
        eng, _ = load_engine(torch, ContinuousBatcher, cfg, params,
                             collect_overlap=True, **kw)
        on = load_leg(torch, kernels, loadgen, f"(c) {label} overlap", eng,
                      trace, tiers, cfg.vocab_size)
        check(len(eng.overlap_ms) > 0,
              f"phase 12 (c) {label}: no tick overlapped")
        kernel = "paged_decode_q8" if kw else "paged_decode"
        check(on["launches"][kernel] > 0,
              f"phase 12 (c) {label}: {kernel} never ran")
        ov = percentiles(eng.overlap_ms)
        split = token_split(torch, cfg, params, off["records"],
                            on["records"])
        overlap[label] = {
            "overlapped_ticks": len(eng.overlap_ms),
            "overlap_ms_p50": statistics.median(eng.overlap_ms),
            "overlap_ms_p99": ov["p99"],
            "tokens_per_s": {"serial": off["tokens_per_s"],
                             "overlap": on["tokens_per_s"]},
            "goodput_tokens_per_s": {"serial": off["goodput_tokens_per_s"],
                                     "overlap": on["goodput_tokens_per_s"]},
            "ticks": {"serial": off["ticks"], "overlap": on["ticks"]},
            "serial": {k: v for k, v in off.items() if k != "records"},
            "overlap": {k: v for k, v in on.items() if k != "records"},
            **split}
        if profile and label == "bf16":
            prof["bf16_overlap"] = steady_idle(torch, eng, prompts,
                                               "bf16 (overlap on)",
                                               costs["block_ms"])
        del eng
        torch.cuda.empty_cache()
        log("load", part=f"(c) collect_overlap {label}",
            overlapped_ticks=overlap[label]["overlapped_ticks"],
            overlap_ms_p50=round(overlap[label]["overlap_ms_p50"], 4),
            overlap_ms_p99=round(ov["p99"], 4),
            tokens_per_s={k: round(v, 1) for k, v in
                          overlap[label]["tokens_per_s"].items()},
            equal_share=round(split["equal_share"], 4),
            splits=[(g["rid"], g["pos"], round(g["gap"], 4),
                     round(g["range"], 3)) for g in split["splits"]])
    if profile:
        log("profile", what="bf16 steady steps, overlap off vs on",
            idle_share_events=(prof["bf16"]["idle_share_events"],
                               prof["bf16_overlap"]["idle_share_events"]),
            idle_share_traced=(prof["bf16"]["idle_share_traced"],
                               prof["bf16_overlap"]["idle_share_traced"]),
            wall_ms=(round(prof["bf16"]["wall_ms"], 3),
                     round(prof["bf16_overlap"]["wall_ms"], 3)),
            device_busy_ms=(round(prof["bf16"]["device_busy_ms"], 3),
                            round(prof["bf16_overlap"]["device_busy_ms"],
                                  3)))

    # (d) donate=False at full width, then (c) and (d) at the narrow config
    donate = donate_phase(torch, ContinuousBatcher, cfg, params, gen)
    narrow = narrow_load(torch)
    torch.cuda.empty_cache()

    # (e) the fleet, calibrated from (a)
    page_bytes = donate["pool_bytes"] // (ENGINE["total_pages"] + 1)
    fleet = fleet_phase(cfg, costs, page_bytes)
    for leg in list(legs.values()) + list(pools.values()):
        leg.pop("records", None)
    out.update(legs=legs, pools=pools, overlap=overlap, donate=donate,
               narrow=narrow, fleet=fleet, costs=costs, warmup_s=warm,
               profile=prof or None,
               wall_s=time.perf_counter() - t_phase)
    log("load", wall_s=round(out["wall_s"], 1))
    return out


# -- phase 13: the MoE family's serving path ---------------------------------

# Mixtral-8x7B's width cut to 8 of its 32 layers in bf16 (32 would be 93.4 GB);
# the reference's moe_paged_engine row: 8 slots, a 512 bucket, 32 new tokens,
# stride 16, pages of 128 (ENGINE)
MOE_LAYERS = 8
MOE_NEW = 32
# (g): phase 6's narrow f32 backbone with 8 experts, top 2, no drops
MOE_NARROW = dict(n_experts=8, top_k=2, capacity_factor=4.0)


def moe_config(n_layers: int):
    import dataclasses

    from kubegpu_tpu_torch.models import MoEConfig
    cfg = MoEConfig.mixtral_8x7b_shaped()
    return dataclasses.replace(cfg, base=dataclasses.replace(
        cfg.base, n_layers=n_layers))


def moe_int8_params(torch, cfg, seed: int) -> dict:
    """``quantize_moe``'s tree at ``cfg``'s full depth, built a layer at a
    time: each layer drawn in bf16 by ``moe_init`` at depth 1, quantized,
    and copied into int8 stacks allocated once, so no bf16 copy of the
    whole tree ever exists (the embedding, final norm and head are the
    first draw's)."""
    import dataclasses

    from kubegpu_tpu_torch.models import moe_init
    from kubegpu_tpu_torch.models.quant import QTensor, quantize_moe
    one = dataclasses.replace(cfg, base=dataclasses.replace(cfg.base,
                                                            n_layers=1))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = cfg.base.n_layers
    out = None
    for i in range(n):
        q = quantize_moe(moe_init(one, device="cuda", generator=gen))
        if out is None:
            out = {k: v for k, v in q.items() if k != "layers"}
            out["layers"] = {
                k: (QTensor(v.values.new_empty((n,) + v.values.shape[1:]),
                            v.scale.new_empty((n,) + v.scale.shape[1:]))
                    if isinstance(v, QTensor)
                    else v.new_empty((n,) + v.shape[1:]))
                for k, v in q["layers"].items()}
        for k, v in q["layers"].items():
            dst = out["layers"][k]
            for a, b in ((dst.values, v.values), (dst.scale, v.scale)) \
                    if isinstance(v, QTensor) else ((dst, v),):
                a[i].copy_(b[0])
        del q
    return out


def moe_tick_bound(eng, moe, params) -> tuple[float, str, float]:
    """(bound ms, what bounds it, bytes) of one stride tick with every slot
    decoding from its current position: each step reads every weight but
    the embedding table (all experts: the dense one-hot form multiplies
    every expert's capacity buffer; int8 experts at their int8 bytes) and
    each slot's K/V history in the pool's format, and does
    the weight products at the tick's row counts (the experts at ``E ×
    B·C`` rows)."""
    from kubegpu_tpu_torch.models.quant import tree_nbytes
    cfg = eng.cfg
    b, stride = eng.n_slots, eng.stride
    elem = params["embed"].element_size()
    weights = tree_nbytes(params) - params["embed"].numel() * elem
    # the pool's bytes a token position (every layer, K and V, scales too)
    pool = eng.pool
    kv_row = (sum(x.numel() * x.element_size() for x in pool.values())
              // (pool["k"].shape[1] * eng.page_size))
    pos = [int(p) for p in eng.pos.tolist()]
    kv = sum(p + j for p in pos for j in range(stride)) * kv_row
    n_bytes = stride * (weights + b * cfg.d_model * elem) + kv
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    attn_w = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    rows = moe.n_experts * b * moe.capacity(1)
    keys = sum(p + j for p in pos for j in range(stride))
    flops = (stride * (2 * b * (cfg.n_layers * attn_w + d * cfg.vocab_size)
                       + cfg.n_layers * 2 * rows * 3 * d * f)
             + 4 * cfg.n_layers * cfg.n_heads * hd * keys)
    ms, by = bound_ms(n_bytes, flops, cfg.tdtype)
    return ms, by, n_bytes


def moe_tick_ms(torch, eng, prompts) -> float:
    """Device ms of one replayed plain tick with every slot decoding (8
    requests of 112 new tokens fill the 40 pages; two steps admit them and
    run one tick): ``event_ms`` over 3 replays, the tick index reset before
    each.  The engine is left mid-run: call it last on an engine."""
    for p in prompts[:eng.n_slots]:
        eng.submit(p, 112)
    eng.step()
    eng.step()
    check(eng.active.all(), "phase 13: not every slot is decoding")

    def tick():
        eng._tv["tk"].zero_()
        eng._run_tick("plain")

    return event_ms(torch, tick, reps=3)


def moe_narrow(torch) -> dict:
    """(g) phase 6's narrow f32 backbone with 8 experts on the card: the
    paged engine (graph) and the dense one, staggered requests, every token
    equal to ``moe_greedy_generate``'s."""
    from kubegpu_tpu_torch.models import (
        ContinuousBatcher,
        LlamaConfig,
        MoEConfig,
        decode,
        moe_greedy_generate,
        moe_init,
    )
    cfg = MoEConfig(base=LlamaConfig.tiny(**NARROW_CFG), **MOE_NARROW)
    params = moe_init(cfg, seed=SEED, device="cuda")
    g = torch.Generator().manual_seed(SEED)
    reqs = [(torch.randint(0, cfg.base.vocab_size, (int(t),),
                           generator=g).tolist(), n)
            for t, n in ((5, 12), (20, 7), (9, 1), (32, 10), (3, 9))]
    out = {}
    for paged in (True, False):
        eng = ContinuousBatcher(params, cfg, device="cuda",
                                **{**NARROW_ENGINE, "paged": paged})
        eng.warmup()
        rids = {eng.submit(p, n): (p, n) for p, n in reqs[:3]}
        done = eng.step() + eng.step()
        rids.update({eng.submit(p, n): (p, n) for p, n in reqs[3:]})
        done += eng.drain()
        check(len(done) == len(reqs), "phase 13 (g): a request was lost")
        for r in done:
            p, n = rids[r.rid]
            solo = moe_greedy_generate(params, [p], n, cfg,
                                       device="cuda")[0].tolist()
            check(r.tokens == solo, f"phase 13 (g) paged={paged} rid "
                  f"{r.rid}: engine {r.tokens} != moe_greedy_generate "
                  f"{solo}")
        out["paged" if paged else "dense"] = len(done)
    decode.clear_graphs()
    log("moe", part="(g) narrow f32 engines vs moe_greedy_generate",
        requests=out, equal=True)
    return out


def moe_phase(torch, kernels, gen, name) -> dict:
    """Phase 13: the MoE family's serving path at Mixtral-8x7B's width, cut
    to 8 layers in bf16 (random weights from ``SEED``), on ENGINE's shape
    (the reference's moe_paged_engine row).  (a) ``moe_forward`` on [1,
    512] (kernel 1 once a layer), its last logits against
    ``moe_prefill``'s (the plain cached path): printed in bf16, within
    relative L2 1e-4 in f32 at 2 layers;
    (b) the paged engine as a graph and eagerly, one window of 8 staggered
    requests (6 up front, 2 after two steps) of 32 new tokens each: equal
    tokens, tokens/s, the replayed tick's ms beside its byte bound; (c)
    ``fused_ticks=4`` on the same prompts: equal tokens, fused dispatches;
    (d) ``kv_bits=8`` (kernel 5); (e) the dense engine (no kernel of the
    port); (f) int8 experts (``quantize_moe``) at the full 32 layers, built
    a layer at a time, on the paged engine with ``kv_bits=8``: tokens/s,
    the card's peak memory over the window, the replayed tick's ms beside
    its byte bound (the int8 bytes); (g) :func:`moe_narrow`.  Launches are
    counted per leg; the phase's are returned under ``launches``."""
    import dataclasses

    from kubegpu_tpu_torch.models import (
        ContinuousBatcher,
        moe_forward,
        moe_init,
        moe_prefill,
    )
    from kubegpu_tpu_torch.models.quant import tree_nbytes
    t_phase = time.perf_counter()
    cfg = moe_config(MOE_LAYERS)
    t0 = time.perf_counter()
    params = moe_init(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "weights_bytes": tree_nbytes(params), "layers": MOE_LAYERS,
           "reduced": "n_layers 32 -> 8 (bf16 tree 93.4 GB at 32)"}
    log("moe", config="Mixtral-8x7B width", layers=MOE_LAYERS,
        weights_gb=round(out["weights_bytes"] / 1e9, 2),
        init_s=round(out["init_s"], 2))
    legs = {}

    def leg(label: str, before: dict) -> dict:
        legs[label] = {k: kernels.launches[k] - before[k] for k in before}
        return legs[label]

    # (a) the forward (kernel 1 once a layer) at the width, and its parity
    # with the plain cached prefill in f32 at 2 layers: in bf16 a routing
    # choice is a step function of the router's logits, so bf16 noise
    # reroutes tokens, more of them each layer
    # (experiments/torch_moe_route_gap.py), and the bf16 gap (printed)
    # measures that, not the kernel
    before = dict(kernels.launches)
    tokens = torch.randint(0, cfg.base.vocab_size, (1, 512), generator=gen,
                           device="cuda")
    with torch.no_grad():
        logits, aux = moe_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moe_forward(params, tokens, cfg)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        ref, _ = moe_prefill(params, tokens, cfg, max_len=512)
    rel = ((logits[:, -1] - ref).norm() / ref.norm()).item()
    fl = leg("forward", before)
    check(tuple(logits.shape) == (1, 512, cfg.base.vocab_size)
          and bool(torch.isfinite(logits).all())
          and math.isfinite(float(aux)), "phase 13 (a): forward output")
    check(fl["flash_fwd"] == 2 * cfg.base.n_layers,
          f"phase 13 (a): flash_fwd ran {fl['flash_fwd']} times, want "
          f"{2 * cfg.base.n_layers} (two forwards)")
    del logits, ref
    f32 = dataclasses.replace(cfg, base=dataclasses.replace(
        cfg.base, n_layers=2, dtype="float32"))
    p32 = moe_init(f32, seed=SEED + 8, device="cuda")
    with torch.no_grad():
        l32, _ = moe_forward(p32, tokens, f32)
        r32, _ = moe_prefill(p32, tokens, f32, max_len=512)
    rel32 = ((l32[:, -1] - r32).norm() / r32.norm()).item()
    check(rel32 <= 1e-4, f"phase 13 (a): f32 forward vs prefill rel err "
          f"{rel32}")
    del p32, l32, r32
    torch.cuda.empty_cache()
    out["forward"] = {"ms": fwd_ms, "bf16_rel_err_vs_prefill": rel,
                      "f32_rel_err_vs_prefill": rel32, "aux": float(aux)}
    log("moe", part="(a) moe_forward [1,512] vs moe_prefill",
        flash_launches=fl["flash_fwd"], ms=round(fwd_ms, 3),
        bf16_rel_err=rel, f32_2_layers_rel_err=rel32, tol_f32=1e-4,
        aux=float(aux))

    # (b) the paged engine, graph and eager, and (c) fused K = 4
    prompts = window_prompts(torch, cfg.base, gen, 8)
    before = dict(kernels.launches)
    eng, warm_s = warmed(torch, kernels, ContinuousBatcher, cfg, params,
                         "moe bf16", "paged_decode")
    eager, eager_warm_s = warmed(torch, kernels, ContinuousBatcher, cfg,
                                 params, "moe bf16 eager", "paged_decode",
                                 graphs=False)
    check(eng.cfg == cfg.base, "phase 13: the engine does not run the "
          "config's backbone")
    graph = graph_log("moe bf16", eng)
    runs = {id(e): serving_window(torch, kernels, e, cfg.base, gen, MOE_NEW,
                                  prompts=prompts, up_front=6)
            for e in (eng, eager)}
    g_run, e_run = runs[id(eng)], runs[id(eager)]
    same_tokens("phase 13 (b)", g_run, e_run)
    del eager
    fused, fused_warm_s = warmed(torch, kernels, ContinuousBatcher, cfg,
                                 params, "moe fused K=4", "paged_decode",
                                 fused_ticks=4)
    f_run = serving_window(torch, kernels, fused, cfg.base, gen, MOE_NEW,
                           prompts=prompts, up_front=6)
    check(f_run["outputs"] == g_run["outputs"],
          "phase 13 (c): fused K=4 tokens differ from K=1 tokens")
    check(fused.fused_dispatches > 0, "phase 13 (c): the K=4 engine never "
          "fused")
    out["fused"] = {"tokens_per_s": f_run["tokens_per_s"],
                    "fused_dispatches": fused.fused_dispatches,
                    "warmup_s": fused_warm_s}
    del fused
    tick_ms = moe_tick_ms(torch, eng, prompts)
    tick_bound, tick_by, tick_bytes = moe_tick_bound(eng, cfg, params)
    pl = leg("paged", before)
    check(pl["paged_decode"] > 0 and pl["flash_fwd"] == 0,
          f"phase 13 (b): launches {pl}")
    out["paged"] = {"tokens_per_s": g_run["tokens_per_s"],
                    "eager_tokens_per_s": e_run["tokens_per_s"],
                    "ticks": g_run["ticks"], "warmup_s": warm_s,
                    "eager_warmup_s": eager_warm_s, "graph": graph,
                    "tick_ms": tick_ms, "tick_bound_ms": tick_bound,
                    "tick_bound_by": tick_by, "tick_bytes": tick_bytes}
    log("moe", part="(b) paged engine graph vs eager, (c) fused K=4",
        requests=len(prompts), n_new=MOE_NEW, equal=True,
        tokens_per_s=g_run["tokens_per_s"],
        eager_tokens_per_s=e_run["tokens_per_s"],
        fused_tokens_per_s=f_run["tokens_per_s"],
        fused_dispatches=out["fused"]["fused_dispatches"],
        tick_ms=tick_ms, tick_bound_ms=tick_bound, tick_bound_by=tick_by,
        tick_gb=round(tick_bytes / 1e9, 3),
        share_of_bound=tick_bound / tick_ms, card=repr(name))
    del eng
    torch.cuda.empty_cache()

    # (d) int8 pages
    before = dict(kernels.launches)
    q8, q8_warm_s = warmed(torch, kernels, ContinuousBatcher, cfg, params,
                           "moe int8 pages", "paged_decode_q8", kv_bits=8)
    q_run = serving_window(torch, kernels, q8, cfg.base, gen, MOE_NEW,
                           "paged_decode_q8", prompts=prompts, up_front=6)
    ql = leg("kv8", before)
    check(ql["paged_decode_q8"] > 0, f"phase 13 (d): launches {ql}")
    agree = equal_share(g_run["outputs"], q_run["outputs"])
    out["kv8"] = {"tokens_per_s": q_run["tokens_per_s"],
                  "warmup_s": q8_warm_s, "agree_with_bf16": agree}
    log("moe", part="(d) paged engine, int8 pages",
        tokens_per_s=q_run["tokens_per_s"], agree_with_bf16=agree,
        q8_launches=ql["paged_decode_q8"])
    del q8

    # (e) the dense engine: no kernel of the port
    before = dict(kernels.launches)
    dense = ContinuousBatcher(params, cfg, graphs=True, **DENSE_ENGINE)
    t0 = time.perf_counter()
    dense.warmup()
    torch.cuda.synchronize()
    dense_warm_s = time.perf_counter() - t0
    check(dense.graph_stats["tally"] == {},
          f"phase 13 (e): the dense tick captured "
          f"{dense.graph_stats['tally']}")
    d_run = serving_window(torch, kernels, dense, cfg.base, gen, MOE_NEW,
                           None, prompts=prompts, up_front=6)
    dl = leg("dense", before)
    check(not any(dl.values()), f"phase 13 (e): the dense engine launched "
          f"{dl}")
    agree = equal_share(g_run["outputs"], d_run["outputs"])
    out["dense"] = {"tokens_per_s": d_run["tokens_per_s"],
                    "warmup_s": dense_warm_s, "agree_with_paged": agree}
    log("moe", part="(e) dense engine", tokens_per_s=d_run["tokens_per_s"],
        agree_with_paged=agree)
    del dense, params
    torch.cuda.empty_cache()

    # (f) int8 experts at the full depth, int8 pages
    full = moe_config(32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = moe_int8_params(torch, full, SEED + 6)
    torch.cuda.synchronize()
    q_init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    before = dict(kernels.launches)
    qw, qw_warm_s = warmed(torch, kernels, ContinuousBatcher, full, qparams,
                           "moe int8 experts", "paged_decode_q8", kv_bits=8)
    w_run = serving_window(torch, kernels, qw, full.base, gen, MOE_NEW,
                           "paged_decode_q8", prompts=prompts, up_front=6)
    peak = torch.cuda.max_memory_allocated()
    q_tick_ms = moe_tick_ms(torch, qw, prompts)
    q_bound, q_by, q_bytes = moe_tick_bound(qw, full, qparams)
    wl = leg("int8_experts", before)
    check(wl["paged_decode_q8"] > 0, f"phase 13 (f): launches {wl}")
    out["int8_experts"] = {"layers": 32,
                           "weights_bytes": tree_nbytes(qparams),
                           "init_s": q_init_s, "init_peak_bytes": init_peak,
                           "peak_bytes": peak,
                           "tokens_per_s": w_run["tokens_per_s"],
                           "warmup_s": qw_warm_s, "tick_ms": q_tick_ms,
                           "tick_bound_ms": q_bound, "tick_bound_by": q_by,
                           "tick_bytes": q_bytes}
    log("moe", part="(f) int8 experts, 32 layers, int8 pages",
        weights_gb=round(tree_nbytes(qparams) / 1e9, 2),
        init_s=round(q_init_s, 2), init_peak_gb=round(init_peak / 1e9, 2),
        peak_gb=round(peak / 1e9, 2), tokens_per_s=w_run["tokens_per_s"],
        tick_ms=q_tick_ms, tick_bound_ms=q_bound, tick_bound_by=q_by,
        share_of_bound=q_bound / q_tick_ms, card=repr(name))
    del qw, qparams
    torch.cuda.empty_cache()

    out["narrow"] = moe_narrow(torch)
    out["launches"] = {k: sum(x[k] for x in legs.values())
                       for k in kernels.launches}
    out["legs"] = legs
    out["wall_s"] = time.perf_counter() - t_phase
    log("moe", wall_s=round(out["wall_s"], 1))
    return out


# -- phase 14: the training families ---------------------------------------

# (a) Mixtral-8x7B's width cut to 4 of 32 layers: a layer is 1.451 G
# parameters and AdamW holds 8 bytes a parameter (bf16 params, grads, mu,
# nu), so 4 layers and the embedding and head hold 48.5 GB, plus AdamW's
# temporaries (twice the largest leaf, w_gate's 3.76 GB); 5 layers would be
# ~68 GB before activations
MOE_TRAIN = {"layers": 4, "batch": 2, "seq": 2048}
# AdamW's rate for (a): at the 1e-3 of phases 7 and (b)-(c) the fixed
# batch's loss at this width rose again by the fourth step (10.87, 9.90,
# 8.27, 10.95 on an NVIDIA H100 80GB HBM3 at 700.00 W): each step moves
# every weight by ~lr, 6% of a 4096-wide weight's scale, and the router's
# choices shift with it
MOE_TRAIN_LR = 3e-4
# (b) Llama-3-8B at full width and depth, rank 8 on wq/wv
LORA_TRAIN = {"batch": 4, "seq": 2048, "rank": 8}
# (c) ViT-B/16 at full width and depth, (d) ResNet-50, bf16 convolutions
VIT_TRAIN_BATCH = 128
RESNET_TRAIN_BATCH = 64
# (e) the pods: each program's module and the keys of the reference's line
TRAIN_PROGRAM_KEYS = {
    "llama_pjit": ("preset", "mesh", "workers", "devices", "start_step",
                   "resumed_opt", "losses"),
    "vit_train": ("preset", "devices", "losses"),
    "t5_train": ("devices", "tp", "losses"),
    "resnet_single": ("first_loss", "last_loss", "chips"),
}
TRAIN_PROGRAM_HEADS = {"llama_pjit": "llama_pjit:", "vit_train": "vit:",
                       "t5_train": "t5:", "resnet_single": "resnet:"}
TRAIN_POD_ENV = {"TPU_WORKER_ID": "0", "TPU_VISIBLE_CHIPS": "0",
                 "KUBETPU_EXPECT_CHIPS": "1"}
TRAIN_PROGRAM_RUNS = (("llama_pjit", {}), ("vit_train", {}),
                      ("vit_train", {"VIT_PRESET": "b16"}), ("t5_train", {}),
                      ("resnet_single", {}),
                      ("resnet_single", {"RESNET_PRESET": "50"}))


def timed_steps(torch, kernels, step, n: int = 4, falls: bool = True
                ) -> dict:
    """``step()`` (returns the loss) ``n`` times on a fixed batch, each
    ended by a synchronize: the first warm, the rest timed; the losses
    finite and, with ``falls``, the last below the first.  The launch
    counters are zeroed just before and read just after (the path's
    launches), and the first step's launches kept.  Peak memory is over
    the steps."""
    import statistics
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    kernels.reset_launches()          # the path starts here
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if i == 0:
            first = dict(kernels.launches)
    launches = dict(kernels.launches)   # ... and ends here
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(not falls or losses[-1] < losses[0],
          f"the loss did not fall: {losses}")
    return {"losses": losses, "step_ms": step_ms,
            "step_ms_median": statistics.median(step_ms[1:]),
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "first_step_launches": first}


def leaf_names(tree, prefix: str = "") -> list:
    """The paths of a nested dict's leaves, in ``tree_leaves``' order."""
    return [n for k, v in tree.items() for n in (
        leaf_names(v, f"{prefix}{k}/") if isinstance(v, dict)
        else [prefix + k])]


def rel_l2(got, ref) -> float:
    return ((got.float() - ref.float()).norm()
            / ref.float().norm().clamp(min=1e-30)).item()


def moe_train_flops(cfg, batch: int, seq: int) -> tuple[float, float]:
    """(model, executed) FLOPs of one MoE train step (3x the forward, as
    ``train_flops_per_step``; remat's recompute not counted).  Model: each
    token through its top-k experts.  Executed: the one-hot form's work,
    every expert over its whole capacity buffer of every routing group
    (a row), plus the dispatch and combine products ``[G, T, E, C] x [G, T,
    d]``."""
    b = cfg.base
    hd, d, f = b.head_dim, b.d_model, b.d_ff
    tokens = batch * seq
    attn_w = d * (b.n_heads + 2 * b.n_kv_heads) * hd + b.n_heads * hd * d
    attn = 2.0 * batch * b.n_heads * seq * seq * hd   # as the Llama count
    common = b.n_layers * (2.0 * tokens * (attn_w + d * cfg.n_experts)
                           + attn) + 2.0 * tokens * d * b.vocab_size
    model = common + b.n_layers * 2.0 * tokens * cfg.top_k * 3 * d * f
    cap = cfg.capacity(seq)
    rows = batch * cfg.n_experts * cap
    executed = common + b.n_layers * (
        2.0 * rows * 3 * d * f + 2 * 2.0 * tokens * cfg.n_experts * cap * d)
    return 3 * model, 3 * executed


def moe_reroutes(torch, moe, run) -> tuple:
    """``run()`` with ``moe.route_tokens`` wrapped to keep each call's
    kept (token, expert) choices; returns (run()'s result, the choices of
    the first ``n`` calls: the forward's layers, before any recompute)."""
    seen = []
    real = moe.route_tokens

    def recording(logits, top_k, capacity):
        out = real(logits, top_k, capacity)
        seen.append(out[0].detach().sum(-1) > 0)
        return out

    moe.route_tokens = recording
    try:
        return run(), seen
    finally:
        moe.route_tokens = real


def moe_train_parity(torch, cfg, params, gen, wanted) -> dict:
    """Kernels against plain attention (autograd over ``xla_attention``):
    the loss and the gradients of ``wanted`` ({name: (leaf, index)}) at
    [1, seq], and each layer's tokens whose kept experts differ between
    the two runs."""
    import dataclasses

    moe = importlib.import_module("kubegpu_tpu_torch.models.moe")
    tokens = torch.randint(0, cfg.base.vocab_size, (1, MOE_TRAIN["seq"]),
                           generator=gen, device="cuda")
    runs = {}
    for impl in ("auto", "plain"):
        c = dataclasses.replace(cfg, base=dataclasses.replace(
            cfg.base, attn_impl=impl))

        def run():
            loss = moe.moe_next_token_loss(params, tokens, c)
            grads = torch.autograd.grad(loss, [w for w, _ in
                                               wanted.values()])
            return loss.item(), [g if i is None else g[i] for g, (_, i) in
                                 zip(grads, wanted.values())]
        (loss, grads), seen = moe_reroutes(torch, moe, run)
        runs[impl] = (loss, grads, seen[:cfg.base.n_layers])
    (lk, gk, sk), (lp, gp, sp) = runs["auto"], runs["plain"]
    return {"loss": lk, "loss_plain": lp, "loss_rel_err": abs(lk - lp)
            / abs(lp), "grad_rel_l2": {n: rel_l2(g, r) for n, g, r in
                                       zip(wanted, gk, gp)},
            "rerouted_tokens": [int((a != b).any(-1).sum()) for a, b in
                                zip(sk, sp)]}


def moe_train(torch, kernels, gen, name) -> dict:
    """(a) ``make_moe_train_step`` + ``adamw(MOE_TRAIN_LR)`` at Mixtral's
    width cut to ``MOE_TRAIN["layers"]`` layers (remat on, bf16), tokens
    [2, 2048], after the parity of kernels against plain attention: in
    bf16 at this depth (printed: a routing choice is a step in the
    router's logits, so rounding reroutes tokens and moves the router's
    and experts' gradients, as phase 13 found for the forward) with its
    loss within 1e-2, and in f32 at one layer (gated: within 1e-3 on the
    loss and every compared gradient, no token rerouted; f32 runs the
    CUDA-core instances)."""
    from kubegpu_tpu_torch.models import make_moe_train_step, moe_init
    from kubegpu_tpu_torch.optim import adamw
    from kubegpu_tpu_torch.tree import tree_leaves
    import dataclasses
    out = {}
    # f32, one layer: the gradient through routing, kernels vs plain
    cfg32 = moe_config(1)
    cfg32 = dataclasses.replace(cfg32, base=dataclasses.replace(
        cfg32.base, dtype="float32"))
    p32 = moe_init(cfg32, seed=SEED + 1, device="cuda")
    for p in tree_leaves(p32):
        p.requires_grad_()
    lay = p32["layers"]
    f32 = moe_train_parity(torch, cfg32, p32, gen, {
        "wq0": (lay["wq"], 0), "w_router0": (lay["w_router"], 0),
        "w_gate0": (lay["w_gate"], 0), "lm_head": (p32["lm_head"], None)})
    del p32, lay
    torch.cuda.empty_cache()
    check(f32["loss_rel_err"] <= 1e-3 and max(f32["grad_rel_l2"].values())
          <= 1e-3 and not any(f32["rerouted_tokens"]),
          f"phase 14 (a): f32 parity {f32}")
    log("train14", part="(a) MoE f32 parity, 1 layer at Mixtral width, "
        "kernels vs plain", tokens=f"[1,{MOE_TRAIN['seq']}]",
        loss_rel_err=f32["loss_rel_err"], grad_rel_l2=f32["grad_rel_l2"],
        rerouted_tokens=f32["rerouted_tokens"], tol=1e-3)
    out["parity_f32"] = f32

    cfg = moe_config(MOE_TRAIN["layers"])
    check(cfg.base.remat, "the MoE train config must keep remat on")
    t0 = time.perf_counter()
    params = moe_init(cfg, seed=SEED, device="cuda")
    for p in tree_leaves(params):
        p.requires_grad_()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    lay = params["layers"]
    bf16 = moe_train_parity(torch, cfg, params, gen, {
        "wq0": (lay["wq"], 0), "w_router0": (lay["w_router"], 0),
        "w_gate0": (lay["w_gate"], 0), "lm_head": (params["lm_head"], None)})
    check(math.isfinite(bf16["loss"]) and bf16["loss_rel_err"] <= 1e-2
          and all(math.isfinite(x) for x in bf16["grad_rel_l2"].values()),
          f"phase 14 (a): bf16 parity {bf16}")
    log("train14", part=f"(a) MoE bf16 parity, {cfg.base.n_layers} layers",
        loss=bf16["loss"], loss_plain=bf16["loss_plain"],
        loss_rel_err=bf16["loss_rel_err"], tol_loss_rel=1e-2,
        grad_rel_l2=bf16["grad_rel_l2"],
        rerouted_tokens=bf16["rerouted_tokens"])
    out["parity_bf16"] = bf16
    opt = adamw(MOE_TRAIN_LR)
    state = opt.init(params)
    step = make_moe_train_step(cfg, opt)
    tokens = torch.randint(0, cfg.base.vocab_size,
                           (MOE_TRAIN["batch"], MOE_TRAIN["seq"]),
                           generator=gen, device="cuda")

    def one():
        nonlocal params, state
        params, state, loss = step(params, state, tokens)
        return loss

    st = timed_steps(torch, kernels, one)
    want = {"flash_fwd": 2 * cfg.base.n_layers,
            "flash_bwd_dq": cfg.base.n_layers,
            "flash_bwd_dkv": cfg.base.n_layers}
    got = {k: st["first_step_launches"][k] for k in want}
    check(got == want, f"phase 14 (a): launches a step {got}, want {want}")
    only_tc(st["launches"], want, "MoE training")
    model, executed = moe_train_flops(cfg, MOE_TRAIN["batch"],
                                      MOE_TRAIN["seq"])
    sec = st["step_ms_median"] / 1e3
    out.update(st, layers=cfg.base.n_layers, params=n_params,
               init_s=time.perf_counter() - t0, model_flops=model,
               executed_flops=executed,
               model_tflops_per_s=model / sec / 1e12,
               executed_tflops_per_s=executed / sec / 1e12,
               mfu=model / sec / PEAK_FLOPS["bfloat16"],
               tokens_per_s=MOE_TRAIN["batch"] * MOE_TRAIN["seq"] / sec,
               reduced="n_layers 32 -> 4 (AdamW state 8 B a parameter)")
    log("train14", part="(a) MoE training", layers=cfg.base.n_layers,
        params_b=round(n_params / 1e9, 3),
        tokens=f"[{MOE_TRAIN['batch']},{MOE_TRAIN['seq']}]",
        losses=st["losses"], step_ms=[round(x, 3) for x in st["step_ms"]],
        step_ms_median=st["step_ms_median"],
        tokens_per_s=out["tokens_per_s"],
        model_tflops_per_s=out["model_tflops_per_s"],
        executed_tflops_per_s=out["executed_tflops_per_s"], mfu=out["mfu"],
        max_memory_gb=round(st["max_memory_gb"], 3),
        launches_per_step=got, card=repr(name))
    return out


def tree_fingerprint(torch, tree) -> list:
    """Per leaf: the sum and the sum of squares of its raw 16-bit words
    (int64, in chunks): any change of a leaf's bytes that keeps both is
    vanishingly unlikely, and no copy of the tree is made."""
    from kubegpu_tpu_torch.tree import tree_leaves
    out = []
    for leaf in tree_leaves(tree):
        words = leaf.detach().reshape(-1).view(torch.int16)
        s1 = s2 = 0
        for chunk in words.split(1 << 26):
            c = chunk.long()
            s1 += int(c.sum())
            s2 += int((c * c).sum())
        out.append((s1, s2))
    return out


def lora_train(torch, kernels, gen, name) -> dict:
    """(b) ``make_lora_train_step`` + ``adamw(1e-3)`` over Llama-3-8B at
    full width and depth (32 layers, remat), rank 8 on wq/wv, tokens [4,
    2048]: the steps, then the adapter gradients through the kernels
    against plain attention at [1, 2048] (the adapters then moved: at init
    ``b`` is zero and ``a`` has no gradient), and the base tree's bytes
    unchanged, no ``.grad`` on it."""
    import dataclasses

    from kubegpu_tpu_torch.models import (
        LlamaConfig,
        LoRAConfig,
        llama_init,
        lora_init,
        lora_merge,
        lora_n_params,
        make_lora_train_step,
    )
    from kubegpu_tpu_torch.models.llama import next_token_loss
    from kubegpu_tpu_torch.optim import adamw
    from kubegpu_tpu_torch.tree import tree_leaves
    cfg = LlamaConfig.llama3_8b()
    lcfg = LoRAConfig(rank=LORA_TRAIN["rank"])
    t0 = time.perf_counter()
    base = llama_init(cfg, seed=SEED, device="cuda")
    adapters = lora_init(base, lcfg, seed=SEED, device="cuda")
    for p in tree_leaves(adapters):
        p.requires_grad_()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = tree_fingerprint(torch, base)
    opt = adamw(1e-3)
    state = opt.init(adapters)
    step = make_lora_train_step(cfg, lcfg, opt)
    tokens = torch.randint(0, cfg.vocab_size,
                           (LORA_TRAIN["batch"], LORA_TRAIN["seq"]),
                           generator=gen, device="cuda")

    def one():
        nonlocal adapters, state
        adapters, state, loss = step(adapters, state, base, tokens)
        return loss

    st = timed_steps(torch, kernels, one)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    got = {k: st["first_step_launches"][k] for k in want}
    check(got == want, f"phase 14 (b): launches a step {got}, want {want}")
    only_tc(st["launches"], want, "LoRA training")
    check(tree_fingerprint(torch, base) == before
          and all(not p.requires_grad and p.grad is None
                  for p in tree_leaves(base)),
          "phase 14 (b): the base tree changed or holds a gradient")
    # parity: the adapter gradients, kernels vs plain attention
    ptok = tokens[:1]
    runs = {}
    for impl in ("auto", "plain"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        loss = next_token_loss(lora_merge(base, adapters, lcfg), ptok, c)
        runs[impl] = (loss.item(), torch.autograd.grad(
            loss, tree_leaves(adapters)))
        del loss
    (lk, gk), (lp, gp) = runs["auto"], runs["plain"]
    rel = {n: rel_l2(g, r) for n, g, r in zip(leaf_names(adapters), gk,
                                                  gp)}
    loss_rel = abs(lk - lp) / abs(lp)
    # bf16 through 32 layers: the plain path rounds its probabilities and
    # autograd products to bf16 where the kernels keep f32 (phase 7's
    # limits)
    check(math.isfinite(lk) and loss_rel <= 1e-2 and max(rel.values())
          <= 5e-2, f"phase 14 (b): parity loss {lk} vs {lp}, grads {rel}")
    sec = st["step_ms_median"] / 1e3
    out = dict(st, layers=cfg.n_layers, init_s=init_s,
               adapter_params=lora_n_params(adapters),
               base_params=sum(p.numel() for p in tree_leaves(base)),
               tokens_per_s=LORA_TRAIN["batch"] * LORA_TRAIN["seq"] / sec,
               parity={"loss": lk, "loss_plain": lp, "loss_rel_err": loss_rel,
                       "grad_rel_l2": rel}, base_unchanged=True)
    log("train14", part="(b) Llama-3-8B LoRA (rank 8, wq/wv), 32 layers",
        tokens=f"[{LORA_TRAIN['batch']},{LORA_TRAIN['seq']}]",
        adapter_params=out["adapter_params"], losses=st["losses"],
        step_ms=[round(x, 3) for x in st["step_ms"]],
        step_ms_median=st["step_ms_median"], tokens_per_s=out["tokens_per_s"],
        max_memory_gb=round(st["max_memory_gb"], 3),
        parity_loss_rel_err=loss_rel, parity_grad_rel_l2=rel,
        tol_loss_rel=1e-2, tol_rel_l2=5e-2, base_unchanged=True,
        card=repr(name))
    return out


def vit_train_flops(cfg, batch: int) -> float:
    """Model FLOPs of one ViT train step (3x the forward): the patch
    embedding, every block's matmuls and its bidirectional attention (2 x
    2 x T² x d a layer), the head."""
    t, d, f = cfg.n_patches + 1, cfg.d_model, cfg.d_ff
    patch = cfg.patch_size * cfg.patch_size * 3
    fwd = batch * (2.0 * cfg.n_patches * patch * d
                   + cfg.n_layers * (2.0 * t * (4 * d * d + 2 * d * f)
                                     + 4.0 * t * t * d)
                   + 2.0 * d * cfg.n_classes)
    return 3 * fwd


def vit_train(torch, kernels, gen, name) -> dict:
    """(c) ``make_vit_train_step`` + ``adamw(1e-3)`` for ViT-B/16 at full
    width and depth (bf16) on one fixed batch of ``VIT_TRAIN_BATCH`` images
    224 px: kernels 1-3 at [128, 12, 197, 64], non-causal; the loss and
    every gradient through the kernels against plain attention first."""
    import dataclasses

    from kubegpu_tpu_torch.models import (
        ViTConfig,
        make_vit_train_step,
        vit_init,
        vit_loss,
    )
    from kubegpu_tpu_torch.optim import adamw
    from kubegpu_tpu_torch.tree import tree_leaves
    cfg = ViTConfig.base_16()
    b = VIT_TRAIN_BATCH
    params = vit_init(cfg, seed=SEED, device="cuda")
    for p in tree_leaves(params):
        p.requires_grad_()
    images = torch.rand((b, cfg.image_size, cfg.image_size, 3),
                        generator=gen, device="cuda")
    labels = torch.randint(0, cfg.n_classes, (b,), generator=gen,
                           device="cuda")
    runs = {}
    for impl in ("auto", "plain"):
        loss = vit_loss(params, images, labels,
                        dataclasses.replace(cfg, attn_impl=impl))
        runs[impl] = (loss.item(), torch.autograd.grad(
            loss, tree_leaves(params)))
        del loss
    (lk, gk), (lp, gp) = runs["auto"], runs["plain"]
    rel = {n: rel_l2(g, r) for n, g, r in zip(leaf_names(params), gk, gp)}
    loss_rel = abs(lk - lp) / abs(lp)
    del runs, gk, gp
    check(math.isfinite(lk) and loss_rel <= 1e-2 and max(rel.values())
          <= 5e-2, f"phase 14 (c): parity loss {lk} vs {lp}, grads {rel}")
    opt = adamw(1e-3)
    state = opt.init(params)
    step = make_vit_train_step(cfg, opt)

    def one():
        nonlocal params, state
        params, state, loss = step(params, state, images, labels)
        return loss

    st = timed_steps(torch, kernels, one)
    want = {k: cfg.n_layers for k in
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    got = {k: st["first_step_launches"][k] for k in want}
    check(got == want, f"phase 14 (c): launches a step {got}, want {want}")
    only_tc(st["launches"], want, "ViT training")
    flops = vit_train_flops(cfg, b)
    sec = st["step_ms_median"] / 1e3
    out = dict(st, batch=b, images_per_s=b / sec, model_flops=flops,
               mfu=flops / sec / PEAK_FLOPS["bfloat16"],
               parity={"loss": lk, "loss_plain": lp, "loss_rel_err": loss_rel,
                       "grad_rel_l2_max": max(rel.values()),
                       "grad_rel_l2": rel})
    log("train14", part="(c) ViT-B/16", batch=b, losses=st["losses"],
        step_ms=[round(x, 3) for x in st["step_ms"]],
        step_ms_median=st["step_ms_median"],
        images_per_s=out["images_per_s"], mfu=out["mfu"],
        max_memory_gb=round(st["max_memory_gb"], 3),
        parity_loss_rel_err=loss_rel,
        parity_grad_rel_l2_max=max(rel.values()), tol_loss_rel=1e-2,
        tol_rel_l2=5e-2, launches_per_step=got, card=repr(name))
    return out


def conv_flops(torch, model, size: int) -> float:
    """Forward FLOPs of one image through the model's convolutions and
    head (2 x MACs), from their output shapes in one batch-1 forward."""
    from kubegpu_tpu_torch.models.resnet import Conv, Dense
    total = [0.0]

    def hook(mod, args, out):
        if isinstance(mod, Conv):
            w = mod.weight
            total[0] += 2.0 * w[0].numel() * out.numel()
        else:
            total[0] += 2.0 * mod.kernel.numel()

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv, Dense))]
    try:
        with torch.no_grad():
            model(torch.zeros((1, size, size, 3), device="cuda"), train=False)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def resnet_train(torch, kernels, gen, name) -> dict:
    """(d) ``make_resnet_train_step`` + ``adam(1e-2)`` (the program's
    optimizer) for ResNet-50 at ``RESNET_TRAIN_BATCH`` images of 224 px,
    bf16 convolutions (cuDNN, channels_last; no kernel of the port, as the
    reference runs no Pallas kernel there): step ms, images/s, and the
    running statistics moved and finite."""
    from kubegpu_tpu_torch.models import make_resnet_train_step, resnet50
    from kubegpu_tpu_torch.models.resnet import resnet_variables
    from kubegpu_tpu_torch.optim import adam
    model = resnet50(device="cuda", seed=SEED)
    params, stats = resnet_variables(model)
    before = {k: v.clone() for k, v in stats.items()}
    b = RESNET_TRAIN_BATCH
    images = torch.randn((b, 224, 224, 3), generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    opt = adam(1e-2)
    state = opt.init(params)
    step = make_resnet_train_step(model, opt)

    def one():
        nonlocal params, stats, state
        params, stats, state, loss = step(params, stats, state, images,
                                          labels)
        return loss

    # the loss is printed, not gated: Adam at 1e-2 on a fresh ResNet-50
    # need not fall within three steps
    st = timed_steps(torch, kernels, one, falls=False)
    check(not any(st["launches"].values()),
          f"phase 14 (d): ResNet launched a kernel of the port "
          f"{st['launches']}")
    moved = sum(int(not torch.equal(stats[k], v)) for k, v in before.items())
    check(moved == len(before) and all(bool(torch.isfinite(v).all())
                                       for v in stats.values()),
          f"phase 14 (d): {moved} of {len(before)} running statistics "
          "moved, or one is not finite")
    flops = 3 * b * conv_flops(torch, model, 224)
    sec = st["step_ms_median"] / 1e3
    out = dict(st, batch=b, images_per_s=b / sec, model_flops=flops,
               mfu=flops / sec / PEAK_FLOPS["bfloat16"],
               stats_moved=moved)
    log("train14", part="(d) ResNet-50", batch=b, losses=st["losses"],
        step_ms=[round(x, 3) for x in st["step_ms"]],
        step_ms_median=st["step_ms_median"],
        images_per_s=out["images_per_s"], mfu=out["mfu"],
        gflops_per_image_fwd=round(flops / 3 / b / 1e9, 3),
        max_memory_gb=round(st["max_memory_gb"], 3), stats_moved=moved,
        card=repr(name))
    return out


def train_program_line(text: str, program: str) -> dict:
    """The program's result line as {key: value string}, in order."""
    head = TRAIN_PROGRAM_HEADS[program]
    lines = [ln for ln in text.splitlines() if ln.startswith(head)]
    check(len(lines) == 1, f"{program}: {len(lines)} result lines\n{text}")
    return dict(re.findall(r"(\w+)=(\[[^\]]*\]|\{[^}]*\}|\S+)",
                           lines[0][len(head):]))


def llama_8b_reckoning(torch) -> dict:
    """``LLAMA_PRESET=8b``'s reckoned peak: AdamW's state (8 bytes a
    parameter: bf16 params, grads, mu, nu) plus the update's temporaries
    (two slices of ``optim.CHUNK`` bf16 elements), against the card's
    memory and what is free of it now (this process keeps its earlier
    phases' graphs and caches)."""
    from kubegpu_tpu_torch import optim
    from kubegpu_tpu_torch.models import LlamaConfig
    cfg = LlamaConfig.llama3_8b()
    hd, d, f, L = cfg.head_dim, cfg.d_model, cfg.d_ff, cfg.n_layers
    n = (2 * cfg.vocab_size * d + L * (d * (cfg.n_heads + 2 * cfg.n_kv_heads)
                                       * hd + cfg.n_heads * hd * d
                                       + 3 * d * f + 2 * d) + d)
    peak = 8 * n + 2 * 2 * optim.CHUNK
    free, total = torch.cuda.mem_get_info()
    return {"params": n, "reckoned_peak_gb": peak / 1e9,
            "card_gb": total / 1e9, "free_gb": free / 1e9,
            "this_process_reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "run": peak < free}


def pod_env(knobs: dict) -> dict:
    """This process's env without any program or allocation knob, plus a
    one-card grant's (``TRAIN_POD_ENV``) and ``knobs``."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("LLAMA_", "VIT_", "T5_", "RESNET_",
                                "KUBETPU_", "TPU_", "JAX_"))}
    env.update(TRAIN_POD_ENV, **knobs)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_pods(runs) -> list:
    """``python -m`` each (program, knobs) of ``runs`` at once, as pods
    sharing the card; each must exit 0 and print the reference's line
    (its keys in order).  Returns the lines; the wall seconds are the
    group's."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         f"kubegpu_tpu_torch.workloads.programs.{program}"], cwd=root,
        env=pod_env(knobs), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for program, knobs in runs]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    got = []
    for (program, knobs), proc, (out, err) in zip(runs, procs, outs):
        check(proc.returncode == 0, f"{program} {knobs}: rc "
              f"{proc.returncode}\n{out[-2000:]}\n{err[-4000:]}")
        line = train_program_line(out, program)
        check(tuple(line) == TRAIN_PROGRAM_KEYS[program],
              f"{program}: keys {list(line)} differ from the reference's")
        got.append({"program": program, "knobs": knobs, "line": line,
                    "group_wall_s": wall})
        log("train14", part="(e) pod", program=program, knobs=knobs,
            line=line)
    log("train14", part="(e) pods", n=len(runs), wall_s=round(wall, 2))
    return got


def train_programs(torch) -> dict:
    """(e) each training program as its pod runs it: ``python -m
    kubegpu_tpu_torch.workloads.programs.<name>`` with a one-card grant's
    env at its defaults, plus ``VIT_PRESET=b16`` and ``RESNET_PRESET=50``,
    all at once (each process takes ~8 s to reach the card, and these
    pods are small); then, alone, ``LLAMA_PRESET=8b`` where its reckoned
    peak fits the memory free on the card.  Each exits 0 with the
    reference's line.  The kernels are already built: a child only loads
    them."""
    import gc
    out = {"runs": run_pods(TRAIN_PROGRAM_RUNS)}
    gc.collect()
    torch.cuda.empty_cache()
    reck = out["llama_8b"] = llama_8b_reckoning(torch)
    log("train14", part="(e) LLAMA_PRESET=8b reckoning",
        params_b=round(reck["params"] / 1e9, 3),
        reckoned_peak_gb=round(reck["reckoned_peak_gb"], 2),
        free_gb=round(reck["free_gb"], 2), card_gb=round(reck["card_gb"], 2),
        this_process_reserved_gb=round(reck["this_process_reserved_gb"], 2),
        run=reck["run"])
    if reck["run"]:
        out["runs"] += run_pods((("llama_pjit", {"LLAMA_PRESET": "8b"}),))
    return out


def train_families_phase(torch, kernels, gen, name) -> dict:
    """Phase 14: the training families on the card, random weights from
    ``SEED``, bf16: (a) :func:`moe_train`, (b) :func:`lora_train`, (c)
    :func:`vit_train`, (d) :func:`resnet_train`, (e) :func:`train_programs`.
    Each leg's launches are counted over its steps (zeroed just before,
    read just after); the phase's sum is returned under ``launches``."""
    t_phase = time.perf_counter()
    out = {}
    for key, fn in (("moe", moe_train), ("lora", lora_train),
                    ("vit", vit_train), ("resnet", resnet_train)):
        t0 = time.perf_counter()
        out[key] = fn(torch, kernels, gen, name)
        out[key]["wall_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["programs"] = train_programs(torch)
    out["launches"] = {k: sum(out[leg]["launches"][k] for leg in
                              ("moe", "lora", "vit", "resnet"))
                       for k in kernels.launches}
    out["wall_s"] = time.perf_counter() - t_phase
    log("train14", wall_s=round(out["wall_s"], 1),
        launches={k: v for k, v in out["launches"].items() if v})
    return out


# -- phase 15: tensor-parallel serving ----------------------------------------

# (a): phase 6's narrow f32 config (head_dim 64; tp = 2 leaves one kv head a
# rank) on its engine shape, each case's knobs over the plain engine's
TP_NARROW = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                 vocab_size=512, max_seq_len=128)
TP_NARROW_ENGINE = dict(n_slots=3, stride=4, prompt_buckets=(16, 32),
                        paged=True, page_size=16, device="cuda")
TP_NARROW_CASES = {
    "plain": {}, "q8": dict(kv_bits=8), "q4": dict(kv_bits=4),
    "prefix_chunked": dict(prefix_cache=True, chunked_prefill=True,
                           prefill_chunk=16),
    "spec_fused": dict(prefix_cache=True, chunked_prefill=True,
                       prefill_chunk=16, spec_gamma=2, draft_layers=1,
                       fused_ticks=2)}
# (b), (c): pool format -> (kv_bits, its kernel, prompts, new tokens): a
# window of 8 prompts of 200-512 tokens, all up front, 16 new tokens (one
# tick), on phase 5's engine shape
TP_FULL = {"bf16": (16, "paged_decode", 8, 16),
           "q8": (8, "paged_decode_q8", 8, 16),
           "q4": (4, "paged_decode_q4", 8, 16)}
# the first-step logits of tp > 1 against tp = 1 at full width in bf16:
# relative L2 (a row-split product's partials are rounded to bf16 before
# their sum, and over 32 layers the residual stream moves by a few bf16 ulp)
TP_LOGIT_REL_L2 = 3e-2
# (b): Llama-3-8B's width at 4 of its 32 layers (two gloo ranks sharing one
# card are a check, not a path, as phase 16's (b); 4 since phase 18 was
# added, for the script's time limit); (c) over NCCL keeps 32
TP_GLOO_LAYERS = 4


def llama3_8b_at(n_layers: int | None):
    """``LlamaConfig.llama3_8b()``, at ``n_layers`` layers where given."""
    import dataclasses

    from kubegpu_tpu_torch.models import LlamaConfig
    cfg = LlamaConfig.llama3_8b()
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


def tp_narrow_traffic(case: str) -> list:
    """(prompt, max_new, submit-after-steps) of a narrow case, from a CPU
    generator of its own: the plain engine's five staggered requests, or
    (the prefix-cache cases) four sharing a 16-token page."""
    import torch
    g = torch.Generator().manual_seed(SEED + 15)
    if "prefix_cache" not in TP_NARROW_CASES[case]:
        return [(torch.randint(0, 512, (t,), generator=g).tolist(), n, s)
                for t, n, s in ((5, 12, 0), (20, 7, 0), (9, 1, 0),
                                (32, 10, 2), (3, 9, 2))]
    shared = torch.randint(0, 512, (16,), generator=g).tolist()
    return [(shared + torch.randint(0, 512, (t,), generator=g).tolist(), n, s)
            for t, n, s in ((9, 10, 0), (14, 6, 3), (5, 12, 3), (11, 1, 3))]


def tp_narrow_run(torch, kernels, mesh=None, graphs=True) -> dict:
    """Every narrow case on one engine each (``mesh``: a tensor-parallel
    rank's), ``warmup()`` first: tokens by request, counters, the host
    digest and the paged kernels' launches."""
    from kubegpu_tpu_torch.models import ContinuousBatcher, LlamaConfig
    from kubegpu_tpu_torch.models import llama_init
    cfg = LlamaConfig.tiny(**TP_NARROW)
    params = llama_init(cfg, seed=SEED, device="cuda")
    out = {}
    for case, kw in TP_NARROW_CASES.items():
        eng = ContinuousBatcher(params, cfg, mesh=mesh, graphs=graphs,
                                **TP_NARROW_ENGINE, **kw)
        eng.warmup()
        before = dict(kernels.launches)
        reqs = tp_narrow_traffic(case)
        rids, done, steps = [], [], 0
        for p, n, after in reqs:
            while steps < after:
                done += eng.step()
                steps += 1
            rids.append(eng.submit(p, n))
        done += eng.drain()
        eng.check_page_invariants()
        by_rid = {r.rid: r.tokens for r in done}
        out[case] = {"tokens": [by_rid[r] for r in rids],
                     "digest": eng.host_digest(),
                     "launches": {k: kernels.launches[k] - before[k]
                                  for k in PAGED_KERNELS},
                     "prefix_hits": eng.prefix_hits,
                     "spec_ticks": eng.spec_ticks,
                     "fused_dispatches": eng.fused_dispatches}
        del eng
    return out


def tp_first_logits(torch, eng, prompts) -> "torch.Tensor":
    """The first-step logits [8, V] f32 of the first 8 prompts (a dense
    prefill at bucket 512, the head at ``t - 1``) through the engine's
    weights, local config and group: the full vocabulary on every rank."""
    from kubegpu_tpu_torch.models import decode as dec
    lens = [len(p) for p in prompts[:8]]
    toks = torch.zeros((8, 512), dtype=torch.long, device="cuda")
    for i, p in enumerate(prompts[:8]):
        toks[i, :len(p)] = torch.tensor(p, device="cuda")
    cache = dec.init_kv_cache(eng._lcfg, 8, 512, device="cuda")
    with torch.no_grad():
        logits, _ = dec._forward_with_cache(
            eng.params, toks, cache, 0, eng._lcfg,
            head_rows=torch.tensor(lens, device="cuda") - 1,
            tp_group=eng._tp_group)
    return logits[:, 0].float().cpu()


def tp_tick_ms(torch, eng, group, reps: int = 2) -> float:
    """Wall ms of one eager plain tick body on scratch state, its
    collectives over ``group`` (None: each rank's partial sums and its
    vocabulary shard kept local, the same kernels and GEMMs without a
    collective), median of ``reps``."""
    import statistics

    from kubegpu_tpu_torch.models import serve as srv
    st = eng._scratch_state()
    walls = []
    for _ in range(reps + 1):
        st["freeze"]["tk"].zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.tick_body(eng.params, eng._tv, st, eng._lcfg, eng.stride,
                      eng.eos_id, eng._sampler, eng._ffn, group)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls[1:])


def tp_rank(job: dict) -> dict:
    """One rank of phase 15 (a spawned process over the launch's group):
    ``job["kind"]`` "narrow" runs :func:`tp_narrow_run` on a ("tp",) mesh;
    "full" makes Llama-3-8B's bf16 weights from the seed (at
    ``job["n_layers"]`` layers where it is given), and for each
    pool format of ``job["formats"]`` warms an engine on its shard
    (graphs over NCCL only), runs the window on ``job["prompts"]`` and
    frees it; the bf16 engine also gives the first-step logits and the
    tick's wall with and without its collectives.  Returns rank 0's
    results with every rank's host digests and peak memory."""
    import gc

    import torch
    import torch.distributed as dist

    from kubegpu_tpu_torch import kernels
    from kubegpu_tpu_torch.models import (
        ContinuousBatcher,
        LlamaConfig,
        llama_init,
        make_serve_mesh,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    tp, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_serve_mesh(tp, "cuda")
    group = mesh.get_group("tp")
    backend = str(dist.get_backend(group))
    graphs = backend == "nccl"
    if graphs is False:
        try:
            ContinuousBatcher(llama_init(LlamaConfig.tiny(**TP_NARROW),
                                         device="cuda"),
                              LlamaConfig.tiny(**TP_NARROW), mesh=mesh,
                              graphs=True, **TP_NARROW_ENGINE)
            raise SmokeFailure("a gloo tp engine took graphs=True")
        except ValueError as exc:
            check("graphs=False" in str(exc), f"gloo graphs: {exc}")
    kernels.reset_launches()
    out = {"backend": backend, "tp": tp, "device": str(torch.cuda.current_device())}
    torch.cuda.reset_peak_memory_stats()
    if job["kind"] == "narrow":
        out["cases"] = tp_narrow_run(torch, kernels, mesh, graphs)
    else:
        cfg = llama3_8b_at(job.get("n_layers"))
        t0 = time.perf_counter()
        params = llama_init(cfg, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        for fmt in job["formats"]:
            bits, kernel, n_prompts, n_new = TP_FULL[fmt]
            eng, warm_s = warmed(torch, kernels, ContinuousBatcher, cfg,
                                 params, f"tp={tp} {fmt}", kernel, mesh=mesh,
                                 graphs=graphs, kv_bits=bits)
            r = {"warmup_s": warm_s, "pool_bytes": pool_bytes(eng)}
            if fmt == "bf16":
                r["first_logits"] = tp_first_logits(torch, eng,
                                                    job["prompts"])
                r["tick_ms"] = tp_tick_ms(torch, eng, group)
                r["tick_ms_no_collectives"] = tp_tick_ms(torch, eng, None)
            run = serving_window(torch, kernels, eng, cfg, None, n_new,
                                 kernel=kernel,
                                 prompts=job["prompts"][:n_prompts])
            r.update({k: run[k] for k in ("tokens_per_s", "wall_s", "ticks",
                                          "paged_launches", "outputs")})
            r["digest"] = eng.host_digest()
            out[fmt] = r
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        del params
    out["launches"] = dict(kernels.launches)
    facts = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "digests": {k: v["digest"] for k, v in
                         (out["cases"] if job["kind"] == "narrow"
                          else {f: out[f] for f in job["formats"]}).items()},
             "launches": out["launches"]}
    every = [None] * tp
    dist.all_gather_object(every, facts)
    out["ranks"] = every
    return out


def tp_launch(job: dict, tp: int, backend: str) -> dict:
    from kubegpu_tpu_torch.parallel import launch
    t0 = time.perf_counter()
    out = launch(tp_rank, tp, job, backend=backend, device="cuda",
                 timeout_s=600)
    out["launch_s"] = time.perf_counter() - t0
    for i, r in enumerate(out["ranks"]):
        check(r["digests"] == out["ranks"][0]["digests"],
              f"tp={tp} {backend}: rank {i}'s host state parts from rank 0's")
    return out


def token_agreement(a: list, b: list) -> float:
    pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def tp_single(torch, kernels, gen, runs, n_layers: int | None = None
              ) -> tuple:
    """The tp = 1 side at full width: Llama-3-8B's bf16 weights from the
    seed (at ``n_layers`` layers where it is given, else all 32), the
    window's prompts from ``gen``, and for each (pool format,
    graphs) of ``runs`` a warmed engine's window on them; the eager bf16
    engine's first-step logits.  The weights and engines are freed before
    it returns (the ranks need the card)."""
    import gc

    from kubegpu_tpu_torch.models import ContinuousBatcher, llama_init
    cfg = llama3_8b_at(n_layers)
    params = llama_init(cfg, seed=SEED, device="cuda")
    prompts = window_prompts(torch, cfg, gen, n=8)
    single, logits = {}, None
    for fmt, graphs in runs:
        bits, kernel, n_prompts, n_new = TP_FULL[fmt]
        eng, _ = warmed(torch, kernels, ContinuousBatcher, cfg, params,
                        f"tp=1 {fmt}", kernel, graphs=graphs, kv_bits=bits)
        run = serving_window(torch, kernels, eng, cfg, None, n_new,
                             kernel=kernel, prompts=prompts[:n_prompts])
        single[fmt + ("" if graphs else " eager")] = run
        if fmt == "bf16" and logits is None:
            logits = tp_first_logits(torch, eng, prompts)
        del eng
        gc.collect()
    del params
    torch.cuda.empty_cache()
    return prompts, single, logits


def logits_gap(got, ref) -> tuple[float, float]:
    """(the largest per-row relative L2 of ``got`` against ``ref``, the
    share of rows whose argmax agrees)."""
    rel = ((got - ref).norm(dim=1) / ref.norm(dim=1)).max().item()
    return rel, (got.argmax(1) == ref.argmax(1)).float().mean().item()


def tp_nccl(torch, name, prompts, single, ref_logits,
            n: int | None = None) -> dict | None:
    """(c): Llama-3-8B's bf16 engine over ``min(4, device_count)`` NCCL
    ranks, one a card, its tick captured as a graph: the first-step
    logits within ``TP_LOGIT_REL_L2`` of tp = 1's, the window's token
    agreement and tokens/s beside the tp = 1 graph engine's, the tick's
    wall with and without its collectives.  None (and a line saying so)
    where there is one card.  ``n`` overrides the rank count."""
    n = n or min(4, torch.cuda.device_count())
    if n < 2:
        log("tp", part="c NCCL", run=False,
            reason=f"{torch.cuda.device_count()} card visible; the NCCL "
            "path needs two or more (one rank a card)")
        return None
    out = tp_launch({"kind": "full", "prompts": prompts,
                     "formats": ["bf16"]}, n, "nccl")
    r = out["bf16"]
    rel, argmax_equal = logits_gap(r.pop("first_logits"), ref_logits)
    check(rel <= TP_LOGIT_REL_L2, f"tp={n} NCCL first-step logits rel L2 "
          f"{rel} > {TP_LOGIT_REL_L2}")
    row = {"tp": n, "tokens_per_s": r["tokens_per_s"],
           "tp1_graph_tokens_per_s": single["bf16"]["tokens_per_s"],
           "agreement": token_agreement(r["outputs"],
                                        single["bf16"]["outputs"]),
           "tick_ms": r["tick_ms"],
           "tick_ms_no_collectives": r["tick_ms_no_collectives"],
           "collective_ms": r["tick_ms"] - r["tick_ms_no_collectives"],
           "first_logits_rel_l2": rel, "first_argmax_equal": argmax_equal,
           "rank_peak_gb": [x["peak_gb"] for x in out["ranks"]],
           "launch_s": out["launch_s"], "warmup_s": r["warmup_s"],
           "paged_launches": r["paged_launches"], "ticks": r["ticks"],
           "launches": {k: out["launches"][k] for k in PAGED_KERNELS}}
    log("tp", part="c NCCL bf16", graphs=True, card=repr(name), **row)
    return row


def tp_phase(torch, kernels, gen, name) -> dict:
    """Tensor-parallel serving on the card.  (a) The narrow f32 engines of
    every knob at tp = 1 (graphs) and tp = 2 (two gloo ranks on the card,
    eager): equal tokens on the model-dtype pools, equal host digests on
    every rank, kernels 4-6 launched on the local heads.  (b) Llama-3-8B
    at ``TP_GLOO_LAYERS`` layers in bf16: the tp = 1 engines' windows
    (bf16 graph and eager, int8 and int4 eager) and first-step logits,
    freed; then two gloo ranks, each on its shard: logits within
    ``TP_LOGIT_REL_L2``, the token agreement, tokens/s, the tick's
    collectives, each rank's peak memory.  (c) NCCL over ``min(4,
    device_count)`` cards with graphs at all 32 layers (:func:`tp_nccl`,
    against a tp = 1 graph engine of its own)."""
    t_phase = time.perf_counter()
    out = {}
    # (a) narrow f32
    one = tp_narrow_run(torch, kernels)
    two = tp_launch({"kind": "narrow"}, 2, "gloo")
    for case, ref in one.items():
        got = two["cases"][case]
        equal = got["tokens"] == ref["tokens"]
        agree = token_agreement(got["tokens"], ref["tokens"])
        # the model-dtype pools hold the tp = 1 tokens; a quantized pool's
        # codes may round the other way on a last-bit difference
        check(equal or case in ("q8", "q4"),
              f"narrow tp=2 {case}: tokens differ from tp=1")
        check(agree >= 0.75, f"narrow tp=2 {case}: agreement {agree}")
        check(got["digest"] == ref["digest"] or not equal,
              f"narrow tp=2 {case}: host state differs from tp=1")
        fired = {k: v for k, v in got["launches"].items() if v}
        check(fired, f"narrow tp=2 {case}: no paged kernel ran")
        log("tp", part="a narrow f32", case=case, backend="gloo",
            tokens_equal=equal, agreement=agree, launches=fired,
            prefix_hits=got["prefix_hits"], spec_ticks=got["spec_ticks"],
            fused_dispatches=got["fused_dispatches"])
    out["narrow"] = {"launch_s": two["launch_s"],
                     "cases": {c: {k: v for k, v in r.items()
                                   if k != "tokens"}
                               for c, r in two["cases"].items()}}
    # (b) full width at TP_GLOO_LAYERS: tp = 1 first, then freed
    prompts, single, ref_l = tp_single(
        torch, kernels, gen, (("bf16", True), ("bf16", False),
                              ("q8", False), ("q4", False)), TP_GLOO_LAYERS)
    parent_gb = torch.cuda.memory_reserved() / 1e9
    kernels.reset_launches()          # the tp path's launches are the ranks'
    full = tp_launch({"kind": "full", "prompts": prompts,
                      "formats": list(TP_FULL), "n_layers": TP_GLOO_LAYERS},
                     2, "gloo")
    rel, argmax_equal = logits_gap(full["bf16"].pop("first_logits"), ref_l)
    check(rel <= TP_LOGIT_REL_L2, f"tp=2 first-step logits rel L2 {rel} > "
          f"{TP_LOGIT_REL_L2}")
    rows = {}
    for fmt in TP_FULL:
        r = full[fmt]
        ref = single[f"{fmt} eager"]
        rows[fmt] = {
            "tokens_per_s": r["tokens_per_s"],
            "tp1_eager_tokens_per_s": ref["tokens_per_s"],
            "agreement": token_agreement(r["outputs"], ref["outputs"]),
            "paged_launches": r["paged_launches"], "ticks": r["ticks"],
            "warmup_s": r["warmup_s"], "pool_bytes": r["pool_bytes"]}
        if fmt == "bf16":
            rows[fmt]["tp1_graph_tokens_per_s"] = \
                single["bf16"]["tokens_per_s"]
            rows[fmt].update(tick_ms=r["tick_ms"],
                             tick_ms_no_collectives=r["tick_ms_no_collectives"],
                             collective_ms=r["tick_ms"]
                             - r["tick_ms_no_collectives"])
        log("tp", part="b Llama-3-8B bf16 weights", pool=fmt, tp=2,
            backend="gloo", graphs=False, n_layers=TP_GLOO_LAYERS,
            card=repr(name), **rows[fmt])
    peaks = [r["peak_gb"] for r in full["ranks"]]
    log("tp", part="b", first_logits_rel_l2=rel, tol=TP_LOGIT_REL_L2,
        first_argmax_equal=argmax_equal, rank_peak_gb=peaks,
        parent_reserved_gb=parent_gb, init_s=full["init_s"],
        launch_s=full["launch_s"],
        rank_launches=[{k: r["launches"][k] for k in PAGED_KERNELS}
                       for r in full["ranks"]])
    out["full"] = {"rows": rows, "n_layers": TP_GLOO_LAYERS,
                   "reduced": "n_layers 32 -> 8 (gloo on one card: a check)",
                   "first_logits_rel_l2": rel,
                   "first_argmax_equal": argmax_equal, "rank_peak_gb": peaks,
                   "parent_reserved_gb": parent_gb,
                   "init_s": full["init_s"], "launch_s": full["launch_s"]}
    launches = {k: full["launches"][k] + two["launches"][k]
                for k in PAGED_KERNELS}
    # (c) NCCL over the cards there are, with graphs, at all 32 layers
    # against a tp = 1 graph engine of its own
    if torch.cuda.device_count() >= 2:
        prompts, single, ref_l = tp_single(torch, kernels, gen,
                                           (("bf16", True),))
    out["nccl"] = tp_nccl(torch, name, prompts, single, ref_l)
    if out["nccl"] is not None:
        for k in PAGED_KERNELS:
            launches[k] += out["nccl"]["launches"][k]
    out["launches"] = launches
    out["single"] = {k: {x: v[x] for x in ("tokens_per_s", "wall_s",
                                           "ticks")}
                     for k, v in single.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    log("tp", phase_s=round(out["phase_s"], 1), launches=launches)
    return out


# -- phase 16: the serving pools at tp > 1 ------------------------------------

# (a): phase 15's narrow f32 config and engine, the prefix cache on, eager
TP_POOL_NARROW = dict({k: v for k, v in TP_NARROW_ENGINE.items()
                       if k != "device"}, prefix_cache=True, graphs=False)
# (b): Llama-3-8B's width at 4 of its 32 layers (gloo ranks sharing one
# card are a check, not a path: PERF.md §6; 4 since phase 18 was added,
# for the script's time limit); phase 11's engine shape;
# a window of 8 prompts of 200-512 tokens, 16 new tokens (a wave and a
# tick a replica)
TP_POOL_LAYERS = 4
TP_POOL_NEW = 16
# (c)'s throughput window: 32 prompts of 128 new tokens, at 8 slots two
# waves and 16 ticks a replica of the dp pool, four waves and 32 ticks
# for one gang
TP_POOL_LONG = 32
TP_POOL_LONG_NEW = 128
TP_POOL_ENGINE = dict(POOL_ENGINE, graphs=False)


def pool_rank_counts(state: dict, reset: bool = False) -> dict:
    """Gang body: this rank's kernel counters (zeroed after the read when
    ``reset``), its device, and the kv heads its engine serves."""
    from kubegpu_tpu_torch import kernels
    out = {"launches": dict(kernels.launches), "device": state["device"],
           "kv_heads": state["engine"]._lcfg.n_kv_heads}
    if reset:
        kernels.reset_launches()
    return out


def pool_rank_memory(state: dict) -> dict:
    """Gang body: this rank's peak and live allocations on its card."""
    import torch
    return {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "device": state["device"]}


def pool_rank_logits(state: dict, prompts: list):
    """Gang body: the first-step logits of ``prompts`` through this gang's
    engine (:func:`tp_first_logits`; every rank takes part), rank 0's."""
    import torch
    out = tp_first_logits(torch, state["engine"], prompts)
    return out if state["rank"] == 0 else None


def gang_counts(pool, reset: bool = False) -> list:
    """Every live gang replica's ranks' counters (see
    :func:`pool_rank_counts`), replica by replica."""
    return [pool.replicas[i].on_ranks(pool_rank_counts, reset)
            for i in pool._alive()]


def gang_launches(counts: list) -> dict:
    """The paged kernels' launches summed over every rank of ``counts``."""
    return {k: sum(r["launches"][k] for g in counts for r in g)
            for k in PAGED_KERNELS}


def pool_tp_window(torch, kernels, pool, prompts, n_new, kernel, label,
                   stride_layers: int) -> dict:
    """``pool_window`` on a warmed tp = 2 pool, its gangs' counters zeroed
    just before and read just after: every rank launched ``kernel``
    ``stride × n_layers`` times a tick its replica ran (``stride_layers``)
    at its local kv heads, and no other paged kernel; the round trips of
    the window's steps."""
    gang_counts(pool, reset=True)
    live = pool._alive()
    ticks0 = {i: pool.replicas[i]._tick for i in live}
    for i in live:
        pool.replicas[i].round_trip_ms.clear()
    run = pool_window(torch, pool, prompts, n_new, label=label)
    counts = gang_counts(pool)
    for i, ranks in zip(live, counts):
        ticks = pool.replicas[i]._tick - ticks0[i]
        for r in ranks:
            got = {k: r["launches"][k] for k in PAGED_KERNELS}
            check(got[kernel] == ticks * stride_layers
                  and sum(got.values()) == got[kernel],
                  f"{label}: replica {i} rank on {r['device']} launched "
                  f"{got} for {ticks} ticks")
    rt = [x for i in live for x in pool.replicas[i].round_trip_ms]
    run.update(launches=gang_launches(counts), round_trip_ms=rt,
               ticks=[pool.replicas[i]._tick - ticks0[i] for i in live],
               kv_heads=[r["kv_heads"] for g in counts for r in g],
               devices=[r["device"] for g in counts for r in g])
    return run


def pool_tp_narrow(torch, kernels) -> dict:
    """(a): the narrow f32 config, the 1 + 1 disaggregated pool at tp = 1
    and at tp = 2 (gloo ranks sharing the card): tokens, routes,
    migrations and every replica's host digest equal; kernel 4 ran in
    every rank.  (The dp pool at tp = 2 runs in (b); one pool here keeps
    the ranks this phase starts, which dominate its time, to three
    pools.)"""
    from kubegpu_tpu_torch.models import DisaggServePool, LlamaConfig, llama_init
    cfg = LlamaConfig.tiny(**TP_NARROW)
    params = llama_init(cfg, seed=SEED, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    prompts = pool_prompts(torch, cfg.vocab_size, g, 16, (4, 14), n=9)
    n_new = [12] * 8 + [1]
    out, launches = {}, dict.fromkeys(PAGED_KERNELS, 0)
    for label, cls, kw in (("disagg 1+1", DisaggServePool,
                            {"prefill": 1, "decode": 1}),):
        runs = {}
        for tp in (1, 2):
            with cls(params, cfg, tp=tp, devices=["cuda:0"] * 2 * tp,
                     **kw, **TP_POOL_NARROW) as pool:
                pool.warmup()
                if tp == 2:
                    gang_counts(pool, reset=True)
                run = pool_window(torch, pool, prompts, n_new,
                                  label=f"phase 16 (a) {label} tp={tp}")
                run["digests"] = [e.host_digest() for e in pool.replicas]
                run["migrations"] = getattr(pool, "migrations", 0)
                if tp == 2:
                    run["launches"] = gang_launches(gang_counts(pool))
                runs[tp] = run
        one, two = runs[1], runs[2]
        for key in ("tokens", "routes", "digests", "migrations"):
            check(two[key] == one[key],
                  f"phase 16 (a) {label}: {key} differ from tp = 1")
        check(two["launches"]["paged_decode"] > 0,
              f"phase 16 (a) {label}: kernel 4 never ran in the ranks")
        for k in PAGED_KERNELS:
            launches[k] += two["launches"][k]
        out[label] = {"migrations": two["migrations"],
                      "launches": two["launches"]}
        log("pool_tp", part="a narrow f32", pool=label, backend="gloo",
            tokens_equal=True, routes_equal=True, digests_equal=True,
            migrations=two["migrations"], launches=two["launches"])
    out["launches"] = launches
    return out


def chain_bytes_of(pool) -> list:
    """Wrap the prefill replica's ``take_export`` to note each chain's
    bytes (every leaf, full heads); returns the list it fills."""
    eng, sizes = pool.replicas[0], []
    real = eng.take_export

    def noted(rid):
        exp = real(rid)
        if exp is not None:
            sizes.append(sum(v.numel() * v.element_size()
                             for v in exp["chain"].values()))
        return exp

    eng.take_export = noted
    return sizes


def pool_tp_full(torch, kernels, gen, name, n_layers: int, devices: list,
                 graphs: bool, label: str, long: bool = False,
                 disagg_bits: int = 16) -> dict:
    """(b) and (c): Llama-3-8B's width at ``n_layers`` (bf16 weights from
    the seed, on card 0), the window's prompts from ``gen``.  The tp = 1
    dp pool on ``devices[:2]`` first (its tokens and tokens/s, one
    engine's first-step logits), then on ``devices`` (four entries, gang
    b on entries 2b, 2b+1): the dp = 2 × tp = 2 pool (tokens/s, round
    trips, logits, each rank's peak), then its replica 0 alone after
    ``retire_replica(1)`` on the same window; the 1 + 1 disaggregated pool
    (migrations, ms and bytes a chain) over ``disagg_bits`` pages (8:
    kernel 5).  With ``long``, the dp pool and then its replica 0 alone
    also run the throughput window (``TP_POOL_LONG`` prompts of
    ``TP_POOL_LONG_NEW`` new tokens)."""
    from dataclasses import replace

    from kubegpu_tpu_torch.models import (
        DataParallelServePool,
        DisaggServePool,
        LlamaConfig,
        llama_init,
    )
    cfg = replace(LlamaConfig.llama3_8b(), n_layers=n_layers)
    params = llama_init(cfg, seed=SEED, device="cuda")
    tree_gb = sum(x.numel() * x.element_size() for x in
                  [params["embed"], params["lm_head"],
                   *params["layers"].values()]) / 1e9
    prompts = window_prompts(torch, cfg, gen, n=8)
    n_new = [TP_POOL_NEW] * len(prompts)
    if long:
        long_prompts = window_prompts(torch, cfg, gen, n=TP_POOL_LONG)
        long_new = [TP_POOL_LONG_NEW] * TP_POOL_LONG
    kw = dict(TP_POOL_ENGINE, graphs=graphs)
    stride_layers = kw["stride"] * n_layers
    out = {"tree_gb": tree_gb, "n_layers": n_layers}
    # tp = 1
    t0 = time.perf_counter()
    with DataParallelServePool(params, cfg, dp=2, devices=devices[:2],
                               **kw) as pool:
        pool.warmup()
        one = pool_window(torch, pool, prompts, n_new,
                          label=f"phase 16 {label} tp=1")
        ref_logits = tp_first_logits(torch, pool.replicas[0], prompts)
    del pool          # its engines (and a copy of the weights on card 1)
    torch.cuda.empty_cache()
    out["tp1"] = {"tokens_per_s": one["tokens_per_s"],
                  "wall_s": time.perf_counter() - t0}
    # dp = 2 × tp = 2, bf16 pages; then one gang alone
    t0 = time.perf_counter()
    pool = DataParallelServePool(params, cfg, dp=2, tp=2, devices=devices,
                                 **kw)
    build_s = time.perf_counter() - t0
    try:
        t1 = time.perf_counter()
        pool.warmup()
        warm_s = time.perf_counter() - t1
        run = pool_tp_window(torch, kernels, pool, prompts, n_new,
                             "paged_decode", f"phase 16 {label} dp=2 tp=2",
                             stride_layers)
        if long:
            lrun = pool_tp_window(torch, kernels, pool, long_prompts,
                                  long_new, "paged_decode",
                                  f"phase 16 {label} dp=2 tp=2 long",
                                  stride_layers)
        logits = pool.replicas[0].on_ranks(pool_rank_logits, prompts)[0]
        memory = [pool.replicas[i].on_ranks(pool_rank_memory)
                  for i in range(2)]
        pool.retire_replica(1)
        pool.step()
        check(pool.dead_replicas == {1: "scale-down drain"},
              f"phase 16 {label}: the retire did not land")
        alone = pool_tp_window(torch, kernels, pool, prompts, n_new,
                               "paged_decode",
                               f"phase 16 {label} one tp=2 gang",
                               stride_layers)
        if long:
            lalone = pool_tp_window(torch, kernels, pool, long_prompts,
                                    long_new, "paged_decode",
                                    f"phase 16 {label} one tp=2 gang long",
                                    stride_layers)
    finally:
        pool.close()
    torch.cuda.empty_cache()
    rel, argmax_equal = logits_gap(logits, ref_logits)
    check(rel <= TP_LOGIT_REL_L2, f"phase 16 {label}: first-step logits "
          f"rel L2 {rel} > {TP_LOGIT_REL_L2}")
    peaks = [r["peak_gb"] for g in memory for r in g]
    check(max(peaks) < tree_gb, f"phase 16 {label}: a rank's peak "
          f"{max(peaks)} GB reaches the whole tree's {tree_gb} GB")
    check(run["kv_heads"] == [cfg.n_kv_heads // 2] * 4,
          f"phase 16 {label}: local kv heads {run['kv_heads']}")
    rt = sorted(run["round_trip_ms"])
    out["dp"] = {
        "tokens_per_s": run["tokens_per_s"],
        "one_gang_tokens_per_s": alone["tokens_per_s"],
        "tp1_pool_tokens_per_s": one["tokens_per_s"],
        "agreement_tp1": token_agreement(run["tokens"], one["tokens"]),
        "round_trip_ms_median": rt[len(rt) // 2],
        "round_trip_ms_mean": sum(rt) / len(rt), "steps": len(rt),
        "first_logits_rel_l2": rel, "first_argmax_equal": argmax_equal,
        "rank_peak_gb": peaks,
        "rank_allocated_gb": [r["allocated_gb"] for g in memory for r in g],
        "rank_devices": [r["device"] for g in memory for r in g],
        "build_s": build_s, "warmup_s": warm_s, "ticks": run["ticks"],
        "alone_ticks": alone["ticks"],
        "launches": run["launches"], "alone_launches": alone["launches"]}
    log("pool_tp", part=label, pool="dp=2 tp=2 bf16", graphs=graphs,
        card=repr(name), n_layers=n_layers, tree_gb=round(tree_gb, 3),
        **{k: v for k, v in out["dp"].items() if k != "rank_devices"})
    launches = {k: run["launches"][k] + alone["launches"][k]
                for k in PAGED_KERNELS}
    if long:
        lrt = sorted(lrun["round_trip_ms"])
        out["long"] = {
            "prompts": TP_POOL_LONG, "new_tokens": TP_POOL_LONG_NEW,
            "tokens_per_s": lrun["tokens_per_s"],
            "one_gang_tokens_per_s": lalone["tokens_per_s"],
            "ratio": lrun["tokens_per_s"] / lalone["tokens_per_s"],
            "wall_s": lrun["wall_s"], "one_gang_wall_s": lalone["wall_s"],
            "ticks": lrun["ticks"], "one_gang_ticks": lalone["ticks"],
            "round_trip_ms_median": lrt[len(lrt) // 2], "steps": len(lrt),
            "agreement_one_gang": token_agreement(
                lrun["tokens"], lalone["tokens"]),
            "launches": lrun["launches"],
            "one_gang_launches": lalone["launches"]}
        log("pool_tp", part=label, pool="dp=2 tp=2 bf16 long window",
            **out["long"])
        for k in PAGED_KERNELS:
            launches[k] += (lrun["launches"][k]
                            + lalone["launches"][k])
    # the 1 + 1 disaggregated pool over bf16 or int8 pages
    t0 = time.perf_counter()
    pages = {"kv_bits": 8} if disagg_bits == 8 else {}
    with DisaggServePool(params, cfg, prefill=1, decode=1, tp=2,
                         devices=devices, **pages, **kw) as pool:
        pool.warmup()
        sizes = chain_bytes_of(pool)
        dis = pool_tp_window(torch, kernels, pool, prompts, n_new,
                             "paged_decode_q8" if pages else "paged_decode",
                             f"phase 16 {label} disagg", stride_layers)
        check(pool.migrations == len(prompts) == len(sizes),
              f"phase 16 {label}: migrations {pool.migrations}")
        out["disagg"] = {
            "kv_bits": disagg_bits, "tokens_per_s": dis["tokens_per_s"],
            "agreement_tp1": token_agreement(dis["tokens"], one["tokens"]),
            "migrations": pool.migrations,
            "migrated_pages": pool.migrated_pages,
            "migration_ms": list(pool.migration_ms),
            "chain_bytes": sizes,
            "round_trip_ms_median": sorted(dis["round_trip_ms"])[
                len(dis["round_trip_ms"]) // 2],
            "wall_s": time.perf_counter() - t0, "launches": dis["launches"]}
    torch.cuda.empty_cache()
    log("pool_tp", part=label, pool=f"disagg 1+1 tp=2 kv{disagg_bits}",
        **{k: v for k, v in out["disagg"].items()})
    for k in PAGED_KERNELS:
        launches[k] += dis["launches"][k]
    del params
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def pool_tp_nccl(torch, kernels, gen, name) -> dict | None:
    """(c): the dp and disaggregated pools at Llama-3-8B's full 32 layers
    over NCCL with graphs, gang 0 on cards 0-1 and gang 1 on cards 2-3;
    None (and a line saying so) with fewer than four cards."""
    n = torch.cuda.device_count()
    if n < 4:
        log("pool_tp", part="c NCCL", run=False,
            reason=f"{n} card(s) visible; two tp = 2 gangs over NCCL need "
            "four (one rank a card)")
        return None
    devices = [f"cuda:{i}" for i in range(4)]
    return pool_tp_full(torch, kernels, gen, name, 32, devices, True,
                        "c NCCL", long=True)


def pool_tp_phase(torch, kernels, gen, name) -> dict:
    """Phase 16 (the module docstring): (a) narrow f32, (b) 4 layers over
    four gloo ranks on card 0, (c) NCCL over four cards where there are
    four.  The paged kernels' launches are the ranks'."""
    t_phase = time.perf_counter()
    out = {"narrow": pool_tp_narrow(torch, kernels)}
    torch.cuda.empty_cache()
    out["gloo"] = pool_tp_full(torch, kernels, gen, name, TP_POOL_LAYERS,
                               ["cuda:0"] * 4, False, "b gloo",
                               disagg_bits=8)
    out["nccl"] = pool_tp_nccl(torch, kernels, gen, name)
    launches = {k: sum(out[p]["launches"][k] for p in
                       ("narrow", "gloo", "nccl") if out[p] is not None)
                for k in PAGED_KERNELS}
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log("pool_tp", phase_s=round(out["phase_s"], 1), launches=launches)
    return out


# -- phase 17: the cluster layer ---------------------------------------------

CLUSTER_SPECS = ("config2-resnet-1gpu.json", "serve-llama.json")
# (c): mock H100 nodes, the gang sizes drawn, misses in a row that end it
SCALE_NODES = 32
SCALE_SIZES = (1, 2, 4, 8, 16)
SCALE_MISSES = 8


def smi_cards() -> list:
    """(name, uuid, memory MiB) of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,uuid,memory.total",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout
    return [tuple(x.strip() for x in line.split(","))
            for line in out.strip().splitlines()]


def cluster_discovery(torch) -> dict:
    """(a) ``NvmlBackend().discover()`` against ``torch.cuda`` and
    nvidia-smi: the same cards by UUID, names and memory (NVML's total is
    nvidia-smi's MiB; torch's is the part CUDA can allocate, no more), and
    the slice type the NVLink pairs pick."""
    from kubegpu_tpu_torch.topology import TOPOLOGY_REGISTRY
    from kubegpu_tpu_torch.tpuplugin import NvmlBackend
    be = NvmlBackend()
    adv = be.discover()
    cards, pairs = be.cards()
    smi = {row[1]: row for row in smi_cards()}
    n = torch.cuda.device_count()
    props = {f"GPU-{p.uuid}": p for p in
             (torch.cuda.get_device_properties(i) for i in range(n))}
    check(len(adv.chips) == len(cards) == n == len(smi),
          f"cluster: NVML {len(cards)} cards, torch {n}, nvidia-smi "
          f"{len(smi)}")
    check({c["uuid"] for c in cards} == set(props) == set(smi),
          "cluster: NVML's UUIDs differ from torch's or nvidia-smi's")
    for card, chip in zip(cards, adv.chips):
        p, row = props[card["uuid"]], smi[card["uuid"]]
        check(card["name"] == p.name == row[0],
              f"cluster: names {card['name']!r} {p.name!r} {row[0]!r}")
        check(card["memory_bytes"] == int(row[2]) << 20
              and p.total_memory <= card["memory_bytes"],
              f"cluster: memory {card['memory_bytes']} against nvidia-smi "
              f"{row[2]} MiB and torch {p.total_memory}")
        check(chip.uuid == card["uuid"]
              and chip.hbm_gib == card["memory_bytes"] / (1 << 30),
              "cluster: the advertisement differs from NVML")
    registered = (len(pairs) == n * (n - 1) // 2
                  and f"h100-sxm-{n}" in TOPOLOGY_REGISTRY
                  and all("H100" in c["name"] for c in cards))
    want = f"h100-sxm-{n}" if registered else f"local-{n}card"
    check(adv.slice_type == want and adv.switched == registered,
          f"cluster: slice type {adv.slice_type}, expected {want}")
    out = {"cards": n, "names": [c["name"] for c in cards],
           "memory_mib": [c["memory_bytes"] >> 20 for c in cards],
           "torch_memory_mib": [props[c["uuid"]].total_memory >> 20
                                for c in cards],
           "nvlink_pairs": pairs, "slice_type": adv.slice_type,
           "switched": adv.switched, "uuids_equal": True}
    log("cluster", part="(a) discovery", **out)
    return out


def pod_device(stdout: str) -> dict | None:
    """The ``pod_device`` line a program prints on the card."""
    for ln in stdout.splitlines():
        if ln.startswith('{"pod_device"'):
            return json.loads(ln)["pod_device"]
    return None


def cluster_pods() -> dict:
    """(b) The cluster ``apply --real --set backend.type=nvml`` builds
    (``SimCluster.from_config``: one node agent over ``NvmlBackend``,
    ``SubprocessRuntime``, ``DeviceScheduler`` over ``GangAllocator``): the
    two specs applied at once and run to the end on this node's cards,
    each pod asked to report its kernel launches."""
    from kubegpu_tpu_torch.cli import pods_from_spec
    from kubegpu_tpu_torch.cluster import SimCluster
    from kubegpu_tpu_torch.config import KubeTpuConfig, load_structured_file
    from kubegpu_tpu_torch.kernels import SIGNATURES as KERNEL_NAMES
    from kubegpu_tpu_torch.kubemeta import PodPhase

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = KubeTpuConfig.load(None, ["backend.type=nvml",
                                    "runtime.real_processes=true"])
    cfg.runtime.extra_env = {"KUBETPU_REPORT_LAUNCHES": "1"}
    cl = SimCluster.from_config(cfg)
    api, agent, runtime = cl.api, cl.agents[0], cl.runtime
    done = (PodPhase.SUCCEEDED, PodPhase.FAILED)
    pods = []
    for spec in CLUSTER_SPECS:
        pods += pods_from_spec(load_structured_file(os.path.join(
            root, "kubegpu_tpu_torch", "examples", spec)))[0]
    cl.submit(*pods)
    t0 = time.perf_counter()
    started, ended, most_running, waited = {}, {}, 0, False
    try:
        while time.perf_counter() - t0 < 600:
            for h in cl.step()[1]:
                started[h.pod_name] = time.perf_counter() - t0
            phases = {p.name: p.status.phase for p in api.list("Pod")}
            running = [k for k, v in phases.items()
                       if v == PodPhase.RUNNING]
            most_running = max(most_running, len(running))
            waited |= bool(running) and PodPhase.PENDING in phases.values()
            for name in cl.reap(timeout=0.25):
                ended[name] = time.perf_counter() - t0
            if all(p.status.phase in done for p in api.list("Pod")):
                break
    finally:
        cl.close()
    wall = time.perf_counter() - t0
    n_cards = len(agent.adv.chips)
    snap = cl.metrics.snapshot()
    handles = {h.pod_name: h for h in runtime.containers()}
    out = {"cards": n_cards, "wall_s": wall, "pods": {}}
    printed = {}    # metric -> the values the pods printed
    for pod in pods:
        h = handles.get(pod.name)
        check(h is not None and h.exit_code == 0,
              f"cluster pod {pod.name}: rc {h and h.exit_code}\n"
              f"{h and h.stdout[-2000:]}\n{h and h.stderr[-4000:]}")
        check(api.get("Pod", pod.name).status.phase == PodPhase.SUCCEEDED,
              f"cluster pod {pod.name}: not Succeeded")
        seen = pod_device(h.stdout)
        check(seen is not None and seen["uuid"] ==
              h.env["CUDA_VISIBLE_DEVICES"] and seen["count"] == 1,
              f"cluster pod {pod.name}: saw {seen and seen['count']} cards, "
              "not the one card of its grant")
        lines = metric_lines(h.stdout)
        for k, v in lines.items():
            printed.setdefault(k, []).append(v)
        launched = {k[len("launches_"):]: int(v) for k, v in lines.items()
                    if k.startswith("launches_")}
        check(set(launched) == set(KERNEL_NAMES),
              f"cluster pod {pod.name}: reported launches of "
              f"{sorted(launched)}")
        out["pods"][pod.name] = {
            "wall_s": ended[pod.name] - started[pod.name],
            "started_s": started[pod.name], "ended_s": ended[pod.name],
            "granted_uuid_seen": True, "cuda_device_count": seen["count"],
            "hbm_gib": float(h.env["KUBETPU_HBM_GIB"]),
            "harvested": sorted(lines), "launches": launched}
        log("cluster", part="(b) pod", pod=pod.name,
            wall_s=round(out["pods"][pod.name]["wall_s"], 2),
            cuda_device_count=seen["count"], granted_uuid_seen=True,
            hbm_gib=h.env["KUBETPU_HBM_GIB"], harvested=len(lines),
            launches={k: v for k, v in launched.items() if v})
    # harvested: every pod's line observed once, the gauge one pod's value
    check(all(snap["histograms"].get(f"workload_{k}", {}).get("count")
              == len(vs) and snap["gauges"].get(f"workload_{k}") in vs
              for k, vs in printed.items()),
          "cluster: the pods' metric lines were not harvested")
    serving = [k for k in out["pods"] if k.startswith("llama-serve")]
    check(all(len(out["pods"][k]["harvested"]) > len(KERNEL_NAMES)
              for k in serving),
          "cluster: a serving pod printed no metric line of its own")
    # the static pod's path runs no kernel of the port (as 5d's); the
    # continuous pod's engine decodes on int8 pages, kernel 5
    cb = out["pods"]["llama-serve-cb"]["launches"]
    check(cb["paged_decode_q8"] > 0,
          f"cluster: the continuous serving pod did not run kernel 5: {cb}")
    order = sorted(out["pods"], key=lambda k: started[k])
    uuids = {handles[k].env["CUDA_VISIBLE_DEVICES"] for k in out["pods"]}
    if n_cards >= 2:
        check(most_running >= 2 and len(uuids) >= 2,
              "cluster: two cards ran the pods one after the other")
    else:
        check(waited and most_running == 1
              and all(started[b] >= ended[a] for a, b in zip(order, order[1:])),
              "cluster: a pod did not wait for the one card")
    out["concurrent"] = most_running
    out["schedule_ms"] = [e.detail["detail"]["total_ms"]
                          for e in cl.trace.events("schedule")]
    log("cluster", part="(b) pods", cards=n_cards, concurrent=most_running,
        waited_pending=waited, wall_s=round(wall, 2),
        schedule_ms=[round(x, 3) for x in out["schedule_ms"]])
    return out


def cluster_apply() -> dict:
    """(b) ``python -m kubegpu_tpu_torch apply -f
    config2-resnet-1gpu.json --real --set backend.type=nvml``, as
    ``cli.main``: exit 0 and its one pod Succeeded in the table."""
    from kubegpu_tpu_torch.cli import main as cli_main

    root = os.path.dirname(os.path.abspath(__file__))
    spec = os.path.join(root, "kubegpu_tpu_torch", "examples",
                        CLUSTER_SPECS[0])
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["apply", "-f", spec, "--real", "--set",
                       "backend.type=nvml", "--timeout", "300"])
    wall = time.perf_counter() - t0
    table = buf.getvalue()
    check(rc == 0 and table.count(" Succeeded ") == 1,
          f"cluster apply --real: rc {rc}\n{table}")
    out = {"rc": rc, "wall_s": wall, "table": table.splitlines()}
    log("cluster", part="(b) apply --real", rc=rc, wall_s=round(wall, 2),
        row=out["table"][1].split())
    return out


def cluster_scale() -> dict:
    """(c) Host only: ``SCALE_NODES`` mock ``h100-sxm-8`` nodes filled by
    a seeded mix of gangs of ``SCALE_SIZES`` cards (16: two 8-card pods,
    multislice; k <= 8: k/c pods of c cards) in one scheduling pass each,
    until the cards run out or ``SCALE_MISSES`` gangs in a row do not
    fit (a gang that does not fit is deleted).  Every gang sits on one
    node unless it is a multislice 16, which spans two."""
    out, _ = scale_mix()
    log("cluster", part="(c) scale, host only", **out)
    return out


def scale_mix() -> tuple[dict, dict]:
    """Phase 17 (c)'s seeded mix (see ``cluster_scale``): its numbers,
    and its decisions (each pod's node and cards, each scheduled gang's
    locality in order)."""
    import random

    from kubegpu_tpu_torch.cluster import SimCluster, tpu_pod
    from kubegpu_tpu_torch.kubemeta import GangSpec, pod_allocation
    from kubegpu_tpu_torch.obs import percentiles

    cl = SimCluster(["h100-sxm-8"] * SCALE_NODES)
    rng = random.Random(SEED)
    free, misses, sizes = 8 * SCALE_NODES, 0, []
    t0 = time.perf_counter()
    try:
        while free and misses < SCALE_MISSES:
            k = rng.choice(SCALE_SIZES)
            c = 8 if k == 16 else rng.choice([d for d in (1, 2, 4, 8)
                                               if d <= k])
            n = k // c
            axes = {"dp": n, "tp": c} if n > 1 else {"tp": c}
            name = f"g{len(sizes)}-{k}"
            pods = [tpu_pod(f"{name}-{i}", chips=c, mesh_axes=axes,
                            gang=GangSpec(name=name, size=n, index=i),
                            multislice=k == 16, command=["noop"])
                    for i in range(n)]
            cl.submit(*pods)
            result, _ = cl.step()
            if result.scheduled:
                free -= k
                sizes.append(k)
                misses = 0
            else:
                misses += 1
                for p in pods:
                    cl.api.delete("Pod", p.name)
        spread, bindings = {}, {}
        for p in cl.api.list("Pod"):
            a = pod_allocation(p)
            spread.setdefault(a.gang_name, set()).add(a.node_name)
            bindings[p.name] = (a.node_name, [ch.coord for ch in a.chips])
        for gang, nodes in spread.items():
            want = 2 if gang.endswith("-16") else 1
            check(len(nodes) == want,
                  f"cluster scale: gang {gang} on {len(nodes)} nodes")
        events = cl.trace.events()
        ms = [e.detail["detail"]["total_ms"] for e in events
              if e.kind in ("schedule", "fail")]
        loc = [e.detail["detail"]["locality"] for e in events
               if e.kind == "schedule"]
    finally:
        cl.close()
    pct = percentiles(ms, (50, 99))
    out = {"nodes": SCALE_NODES, "cards": 8 * SCALE_NODES,
           "cards_placed": 8 * SCALE_NODES - free, "gangs": len(sizes),
           "gangs_by_size": {k: sizes.count(k) for k in SCALE_SIZES},
           "decisions": len(ms), "schedule_ms_p50": pct["p50"],
           "schedule_ms_p99": pct["p99"], "mean_locality": sum(loc) / len(loc),
           "seconds": time.perf_counter() - t0}
    return out, {"bindings": bindings, "localities": loc}


def cluster_phase(torch, kernels) -> dict:
    """Phase 17: the cluster layer on this node (see the docstring)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    kernels.reset_launches()          # the cluster path starts here
    out = {"discovery": cluster_discovery(torch),
           "pods": cluster_pods(), "apply": cluster_apply(),
           "scale": cluster_scale()}
    here = dict(kernels.launches)              # ... and ends here
    check(not any(here.values()),
          f"the cluster path launched a kernel in this process: {here}")
    # the pods' own counts, as they reported them
    out["launches"] = {name: sum(p["launches"][name]
                                 for p in out["pods"]["pods"].values())
                       for name in kernels.SIGNATURES}
    out["phase_s"] = time.perf_counter() - t0
    log("cluster", phase_s=round(out["phase_s"], 1))
    return out


# -- phase 18: the gang bootstrap and fault recovery -------------------------

GANG_SPECS = ("allreduce-bench.json", "dp-gang.json")
GANG_PROGRAM = "kubegpu_tpu_torch.workloads.programs."
# (c): all-reduce buffer sizes (bf16, MiB) and timed reduces at each
BUSBW_MIB = (4, 64, 256, 1024)
BUSBW_ITERS = 20
# (d): the recovery gang's steps (tiny f32 preset), and how long after its
# start the card fails (a process takes ~8 s to reach the card)
RECOVERY_STEPS = 1000
RECOVERY_FAULT_S = 12.0
# what the NCCL log says a pair of ranks rides: P2P, SHM, NET; NVLS
NCCL_CHANNEL = re.compile(
    r"Channel \d+/\d+ : (\d+)\[\w+\] -> (\d+)\[\w+\] via (\S+)")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nvml_cluster(extra_env: dict):
    """The cluster ``apply --real --set backend.type=nvml`` builds, each
    pod reporting its kernel launches, on a coordinator port of its own."""
    from kubegpu_tpu_torch.cluster import SimCluster
    from kubegpu_tpu_torch.config import KubeTpuConfig

    cfg = KubeTpuConfig.load(None, ["backend.type=nvml",
                                    "runtime.real_processes=true"])
    cfg.runtime.extra_env = {"KUBETPU_REPORT_LAUNCHES": "1", **extra_env}
    cfg.scheduler.coordinator_port = free_port()
    return SimCluster.from_config(cfg)


def gang_spec_pods(spec: str, workers: int) -> list:
    """The example spec's gang at ``workers`` pods (mesh dp = workers)."""
    from kubegpu_tpu_torch.cli import pods_from_spec
    from kubegpu_tpu_torch.config import load_structured_file

    root = os.path.dirname(os.path.abspath(__file__))
    doc = load_structured_file(os.path.join(root, "kubegpu_tpu_torch",
                                            "examples", spec))
    entry = dict(doc["pods"][0])
    entry["gang"] = dict(entry["gang"], size=workers)
    entry["mesh_axes"] = {"dp": workers}
    return pods_from_spec({"cluster": doc["cluster"], "pods": [entry]})[0]


def drive_pods(cl, pods, timeout_s: float = 300.0) -> dict:
    """Submit ``pods`` and step the cluster until each is terminal: the
    last container of each pod, and when each started and ended."""
    from kubegpu_tpu_torch.kubemeta import PodPhase

    done = (PodPhase.SUCCEEDED, PodPhase.FAILED)
    cl.submit(*pods)
    t0 = time.perf_counter()
    started, ended = {}, {}
    while time.perf_counter() - t0 < timeout_s:
        for h in cl.step()[1]:
            started[h.pod_name] = time.perf_counter() - t0
        for name in cl.reap(timeout=0.25):
            ended[name] = time.perf_counter() - t0
        if all(cl.pod_phase(p.name) in done for p in pods):
            break
    handles = {h.pod_name: h for h in cl.runtime.containers()}
    for p in pods:
        h = handles.get(p.name)
        check(h is not None and h.exit_code == 0
              and cl.pod_phase(p.name) == PodPhase.SUCCEEDED,
              f"gang pod {p.name}: rc {h and h.exit_code}\n"
              f"{h and h.stdout[-3000:]}\n{h and h.stderr[-4000:]}")
    return {"wall_s": time.perf_counter() - t0, "started": started,
            "ended": ended, "handles": {p.name: handles[p.name]
                                        for p in pods}}


def on_granted_cards(label: str, handles: dict) -> list:
    """Each worker ran on the one card its grant names; their UUIDs by
    worker id."""
    uuids = {}
    for name, h in handles.items():
        seen = pod_device(h.stdout)
        check(seen is not None and seen["uuid"] ==
              h.env["CUDA_VISIBLE_DEVICES"] and seen["count"] == 1,
              f"{label} {name}: saw {seen}, not the one card of its grant")
        uuids[int(h.env["TPU_WORKER_ID"])] = seen["uuid"]
    return [uuids[w] for w in sorted(uuids)]


def worker_zero(handles: dict):
    return next(h for h in handles.values()
                if h.env["TPU_WORKER_ID"] == "0")


def bench_line(label: str, handles: dict) -> dict:
    """Worker 0's ``allreduce_algo_bandwidth`` line (no other worker
    prints one)."""
    lines = {name: [json.loads(ln) for ln in h.stdout.splitlines()
                    if ln.startswith('{"metric": "allreduce_algo')]
             for name, h in handles.items()}
    zero = worker_zero(handles).pod_name
    check(len(lines[zero]) == 1 and not any(
        v for k, v in lines.items() if k != zero),
        f"{label}: the bandwidth lines {lines}; worker 0 printed\n"
        f"{handles[zero].stdout[-3000:]}")
    return lines[zero][0]


def nccl_transports(log_dir: str) -> dict:
    """What the pods' NCCL logs (``NCCL_DEBUG=INFO`` into files under
    ``log_dir``) say each pair of ranks rode, and whether NVLink SHARP
    (NVLS) came up."""
    pairs, version, nvls = {}, None, False
    for fname in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, fname)) as f:
            text = f.read()
        for a, b, via in NCCL_CHANNEL.findall(text):
            pairs.setdefault(f"{a}->{b}", set()).add(via)
        m = re.search(r"NCCL version (\S+)", text)
        version = version or (m and m.group(1))
        nvls |= "NVLS" in text and "NVLS multicast support is not" not in text
    return {"pairs": {k: sorted(v) for k, v in sorted(pairs.items())},
            "via": sorted({v.split("/")[0] for vs in pairs.values()
                           for v in vs}),
            "nvls": nvls, "nccl": version}


def gang_health(torch) -> dict:
    """(a) ``NvmlBackend().discover()`` with its health reads on every
    card: which queries the card answers, what they read, every card
    healthy and no bad link."""
    from kubegpu_tpu_torch.tpuplugin import NvmlBackend
    be = NvmlBackend()
    try:
        adv = be.discover()
        cards, pairs = be.cards()
    finally:
        be.close()
    n = torch.cuda.device_count()
    check(len(cards) == n and all(c.healthy for c in adv.chips)
          and adv.bad_links == (),
          f"gang health: {[c.healthy for c in adv.chips]}, bad links "
          f"{adv.bad_links}")
    out = {"cards": n, "slice_type": adv.slice_type, "nvlink_pairs": pairs,
           "remapped_rows": [c["remapped_rows"] for c in cards],
           "xid_watched": [c["xid_watched"] for c in cards],
           "xid": [c["xid"] for c in cards], "all_healthy": True,
           "supported": {
               "remapped_rows": all(c["remapped_rows"] is not None
                                    for c in cards),
               "xid_events": all(c["xid_watched"] for c in cards),
               "nvlink_p2p": len(pairs) == n * (n - 1) // 2}}
    log("gang", part="(a) health", **out)
    return out


def shared_card_gang() -> dict:
    """Two ``allreduce_bench`` workers with the env the crishim injects
    into a 2-pod gang of 500 millicards on this node's first card, started
    by ``SubprocessRuntime`` as the node agent starts pods.  The scheduler
    does not place such a gang (as the reference's, its allocator takes a
    fractional ask for one pod only), so this drives the bootstrap's
    shared-card branch alone: both workers hold one card, so gloo."""
    from kubegpu_tpu_torch.crishim import SubprocessRuntime
    from kubegpu_tpu_torch.tpuplugin import NvmlBackend
    from kubegpu_tpu_torch.tpuplugin.mock import build_gpu_env

    be = NvmlBackend()
    try:
        adv = be.discover()
    finally:
        be.close()
    runtime, port = SubprocessRuntime(), free_port()
    t0 = time.perf_counter()
    handles = {}
    for w in range(2):
        env = build_gpu_env(adv.host_block, [adv.chips[0]], w, 2,
                            f"127.0.0.1:{port}", [adv.node_name] * 2)
        env["KUBETPU_MILLITPU"] = "500"
        handles[f"allreduce-{w}"] = runtime.create_container(
            f"allreduce-{w}", "main",
            [sys.executable, "-m", GANG_PROGRAM + "allreduce_bench"], env)
    for name, h in handles.items():
        code = h.wait(timeout=300)
        if code is None:
            h.kill()
        check(code == 0, f"gang pod {name}: rc {code}\n{h.stdout[-3000:]}"
              f"\n{h.stderr[-4000:]}")
    return {"wall_s": time.perf_counter() - t0, "handles": handles}


def gang_pods(torch, kernels, n_cards: int) -> dict:
    """(b) The example gangs through the cluster ``apply --real --set
    backend.type=nvml`` builds.  Two or more cards: ``allreduce-bench``
    and ``dp-gang`` at ``min(4, cards)`` workers over NCCL, one card each
    (the pairs' NCCL transport from ``NCCL_DEBUG=INFO``; the dp gang's
    losses against one worker at the same global batch, in this process).
    One card: two ``allreduce_bench`` workers sharing it over gloo (a
    check, not a path: see :func:`shared_card_gang`)."""
    out = {}
    if n_cards < 2:
        run = shared_card_gang()
        uuids = on_granted_cards("(b) shared-card gang", run["handles"])
        line = bench_line("(b) shared-card gang", run["handles"])
        check(len(set(uuids)) == 1 and line["devices"] == 2
              and line["value"] > 0,
              f"(b) shared-card gang: cards {uuids}, line {line}")
        out["shared_card"] = {"workers": 2, "backend": "gloo",
                              "line": line, "wall_s": run["wall_s"]}
        log("gang", part="(b) allreduce_bench, 2 workers on one card, gloo",
            **line, wall_s=round(run["wall_s"], 2))
        log("gang", part="(b) NCCL gangs not run: one card (the allreduce "
            "and dp gangs take one card a worker)")
        return out
    n = min(4, n_cards)
    log_dir = tempfile.mkdtemp(prefix="nccl-log-")
    # NCCL logs to files (%p: the pid), out of the pods' metric lines
    cl = nvml_cluster({"NCCL_DEBUG": "INFO", "NCCL_DEBUG_FILE":
                       os.path.join(log_dir, "nccl.%p.log")})
    try:
        run = drive_pods(cl, gang_spec_pods(GANG_SPECS[0], n))
        transports = nccl_transports(log_dir)
    finally:
        cl.close()
        shutil.rmtree(log_dir, ignore_errors=True)
    uuids = on_granted_cards("(b) allreduce gang", run["handles"])
    line = bench_line("(b) allreduce gang", run["handles"])
    check(len(set(uuids)) == n and line["devices"] == n,
          f"(b) allreduce gang: cards {uuids}, line {line}")
    check(transports["nccl"] is not None,
          "(b) allreduce gang: no NCCL log line: the workers did not use NCCL")
    out["allreduce"] = {"workers": n, "backend": "nccl", "line": line,
                        "transports": transports, "wall_s": run["wall_s"]}
    log("gang", part=f"(b) allreduce_bench, {n} workers, NCCL", **line,
        wall_s=round(run["wall_s"], 2))
    log("gang", part="(b) NCCL transport", **transports)

    from kubegpu_tpu_torch.models import LlamaConfig
    from kubegpu_tpu_torch.workloads.programs import llama_pjit
    pods = gang_spec_pods(GANG_SPECS[1], n)
    steps = int(pods[0].spec.containers[0].env["LLAMA_STEPS"])
    cfg = LlamaConfig.tiny(n_heads=4, n_kv_heads=4, dtype="float32")
    one = llama_pjit.train(cfg, torch.device("cuda"), steps,
                           llama_pjit.global_batch({"dp": n}))
    cl = nvml_cluster({})
    try:
        run = drive_pods(cl, pods)
    finally:
        cl.close()
    uuids = on_granted_cards("(b) dp gang", run["handles"])
    got = train_program_line(worker_zero(run["handles"]).stdout, "llama_pjit")
    losses = [float(x) for x in got["losses"].strip("[]").split(",")]
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, one))
    launched = {}
    for name, h in run["handles"].items():
        counts = {k[len("launches_"):]: int(v)
                  for k, v in metric_lines(h.stdout).items()
                  if k.startswith("launches_")}
        check(all(counts.get(k, 0) > 0 for k in
                  ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
              f"(b) dp gang {name}: kernels 1-3 did not all run: {counts}")
        for k, v in counts.items():
            launched[k] = launched.get(k, 0) + v
    check(len(set(uuids)) == n and got["workers"] == str(n)
          and len(losses) == steps and all(map(math.isfinite, losses))
          and gap <= 1e-4,
          f"(b) dp gang: cards {uuids}, line {got}, one worker {one}")
    out["dp"] = {"workers": n, "losses": losses, "one_worker": one,
                 "max_rel_gap": gap, "launches": launched,
                 "wall_s": run["wall_s"]}
    log("gang", part=f"(b) dp gang, {n} workers, NCCL", losses=losses,
        one_worker=[round(x, 6) for x in one], max_rel_gap=gap,
        launches={k: v for k, v in launched.items() if v},
        wall_s=round(run["wall_s"], 2))
    return out


def busbw_rank(sizes_mib: tuple, iters: int) -> dict:
    """One rank of (c): each size's all-reduce of a bf16 buffer, its
    mean ms over ``iters`` after a warm-up, and its bus bandwidth."""
    import torch
    import torch.distributed as dist
    n = dist.get_world_size()
    out = {}
    for mib in sizes_mib:
        x = torch.ones(mib << 19, dtype=torch.bfloat16, device="cuda")
        for _ in range(3):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        out[mib] = {"ms": dt * 1e3,
                    "busbw_gbs": 2 * (n - 1) / n * x.numel() * 2 / dt / 1e9}
        del x
    return out


def gang_busbw(n_cards: int) -> dict | None:
    """(c) All-reduce bus bandwidth over NCCL, ``parallel.launch`` ranks
    one a card, beside the 450 GB/s a direction registered for
    ``h100-sxm-*``; None on one card."""
    if n_cards < 2:
        log("gang", part="(c) busBW not run: one card")
        return None
    from kubegpu_tpu_torch.parallel import launch
    from kubegpu_tpu_torch.topology import TOPOLOGY_REGISTRY
    n = min(4, n_cards)
    t0 = time.perf_counter()
    sizes = launch(busbw_rank, n, BUSBW_MIB, BUSBW_ITERS, backend="nccl",
                   device="cuda")
    link = TOPOLOGY_REGISTRY["h100-sxm-8"].ici_gbps_per_link
    out = {"ranks": n, "registered_gbs": link, "sizes": sizes,
           "seconds": time.perf_counter() - t0}
    for mib, r in sizes.items():
        log("gang", part=f"(c) busBW {n} ranks NCCL", mib=mib,
            ms=round(r["ms"], 4), busbw_gbs=round(r["busbw_gbs"], 2),
            of_registered=round(r["busbw_gbs"] / link, 3))
    return out


def gang_recovery(torch, n_cards: int) -> dict:
    """(d) A running ``llama_pjit`` gang (one 1-card pod on one card, a
    2-worker dp gang on more) loses a card it holds: the next tick kills
    every member and requeues the gang; with a healthy card for each
    worker left it is re-placed on them, else it pends until the card
    heals; then it runs to Succeeded."""
    from kubegpu_tpu_torch.cluster import tpu_pod
    from kubegpu_tpu_torch.kubemeta import GangSpec, PodPhase, pod_allocation

    workers = 2 if n_cards >= 2 else 1
    replaced = n_cards - 1 >= workers
    cl = nvml_cluster({})
    node = cl.agents[0].node_name
    names = [f"rec-{i}" for i in range(workers)]
    pods = [tpu_pod(name, chips=1,
                    gang=GangSpec(name="rec", size=workers, index=i),
                    mesh_axes={"dp": workers},
                    command=[sys.executable, "-m",
                             GANG_PROGRAM + "llama_pjit"],
                    env={"LLAMA_STEPS": str(RECOVERY_STEPS)})
             for i, name in enumerate(names)]
    done = (PodPhase.SUCCEEDED, PodPhase.FAILED)
    try:
        cl.submit(*pods)
        first = {h.pod_name: h for h in cl.step()[1]}
        check(set(first) == set(names), f"(d) started {sorted(first)}")
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < RECOVERY_FAULT_S:
            check(not cl.reap(timeout=0.25),
                  "(d) the gang ended before the fault")
        check(all(h.running() for h in first.values()),
              "(d) a member was not running at the fault")
        victim = pod_allocation(cl.api.get("Pod", names[0]))
        li = victim.chips[0].local_index
        failed = first[names[0]].env["CUDA_VISIBLE_DEVICES"]
        t_fault = time.perf_counter()
        cl.fail_chip(node, li)
        ticks, restarted = 0, {}
        while any(h.running() for h in first.values()):
            restarted.update({h.pod_name: h for h in cl.step()[1]})
            ticks += 1
            check(ticks <= 5, "(d) the gang's members outlived the fault")
        evict_ms = (time.perf_counter() - t_fault) * 1e3
        codes = [h.exit_code for h in first.values()]
        check(all(c is not None and c < 0 for c in codes)
              and cl.metrics.counter("gangs_evicted") == 1,
              f"(d) members' exit codes {codes} after the fault")
        out = {"workers": workers, "cards": n_cards, "failed_local_index": li,
               "evict_ms": evict_ms, "evict_ticks": ticks,
               "killed_codes": codes}
        log("gang", part="(d) fault to eviction", workers=workers,
            ms=round(evict_ms, 2), ticks=ticks, killed_codes=codes)
        if replaced:
            t_back, back_ticks = t_fault, ticks
        else:
            for _ in range(3):
                result, started = cl.step()
                check(not started and all(
                    cl.pod_phase(n) == PodPhase.PENDING for n in names),
                    "(d) the gang did not pend on the failed card")
            t_back, back_ticks = time.perf_counter(), 0
            cl.heal_chip(node, li)
        while not all(cl.pod_phase(n) in done for n in names):
            restarted.update({h.pod_name: h for h in cl.step()[1]})
            cl.reap(timeout=0.25)
            back_ticks += 1
            check(time.perf_counter() - t_back < 300,
                  "(d) the gang did not run to its end")
        back_ms = (time.perf_counter() - t_back) * 1e3
    finally:
        cl.close()
    check(set(restarted) == set(names), f"(d) restarted {sorted(restarted)}")
    uuids = on_granted_cards("(d) recovered gang", restarted)
    check(all(h.exit_code == 0 for h in restarted.values())
          and all(cl.pod_phase(n) == PodPhase.SUCCEEDED for n in names),
          f"(d) the recovered gang: "
          f"{[(h.exit_code, h.stderr[-2000:]) for h in restarted.values()]}")
    check(failed not in uuids if replaced else uuids == [failed],
          f"(d) re-placed on {uuids}, the failed card {failed}")
    launched = {}
    for h in restarted.values():
        for k, v in metric_lines(h.stdout).items():
            if k.startswith("launches_"):
                launched[k[len("launches_"):]] = launched.get(
                    k[len("launches_"):], 0) + int(v)
    out.update({"replaced": replaced, "back_ms": back_ms,
                "back_ticks": back_ticks, "launches": launched})
    log("gang", part=("(d) re-placement" if replaced else "(d) heal")
        + " to Succeeded", ms=round(back_ms, 2), ticks=back_ticks,
        excluded_failed_card=replaced)
    return out


def gang_phase(torch, kernels) -> dict:
    """Phase 18: the gang bootstrap and fault recovery (the docstring)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    out = {"health": gang_health(torch)}
    out["pods"] = gang_pods(torch, kernels, n)
    kernels.reset_launches()          # from here, launches are the pods'
    out["busbw"] = gang_busbw(n)
    out["recovery"] = gang_recovery(torch, n)
    here = dict(kernels.launches)
    check(not any(here.values()),
          f"the gang path launched a kernel in this process: {here}")
    out["launches"] = {
        k: (out["pods"].get("dp", {}).get("launches", {}).get(k, 0)
            + out["recovery"]["launches"].get(k, 0))
        for k in kernels.SIGNATURES}
    check(all(out["launches"][k] > 0 for k in
              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
          f"a kernel of the gang path never ran: {out['launches']}")
    out["phase_s"] = time.perf_counter() - t0
    log("gang", phase_s=round(out["phase_s"], 1))
    return out


# -- phase 19: the daemons ---------------------------------------------------

# (b): the serving pod the daemons run, and one-card ``python -c`` probe
# pods timed from their create to the SCHEDULED watch event at the client
DAEMON_POD = "llama-serve-cb"
DAEMON_PROBES = 8
DAEMON_TIMEOUT_S = 300.0


class Daemon:
    """One daemon of the phase as a process of its own (``python -m``),
    its stdout and stderr in files under ``log_dir``: a pipe nobody reads
    would stall it."""

    def __init__(self, label: str, log_dir: str, module: str, *args: str):
        self.label = label
        self.paths = [os.path.join(log_dir, f"{label}.{k}")
                      for k in ("out", "err")]
        out, err = (open(p, "w") for p in self.paths)
        with out, err:
            self.proc = subprocess.Popen([sys.executable, "-m", module, *args],
                                         stdout=out, stderr=err, text=True)

    def text(self) -> str:
        return "".join(open(p).read() for p in self.paths)

    def wait_for(self, needle: str, timeout: float = 120.0) -> str:
        """The first line of its output holding ``needle``."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            hit = [ln for ln in self.text().splitlines() if needle in ln]
            if hit:
                return hit[0]
            check(self.proc.poll() is None, f"daemons: the {self.label} "
                  f"exited {self.proc.returncode}:\n{self.text()[-3000:]}")
            time.sleep(0.05)
        check(False, f"daemons: no {needle!r} from the {self.label} in "
              f"{timeout} s:\n{self.text()[-3000:]}")

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            return self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()


def process_tree(roots) -> set:
    """The pids of every live descendant of ``roots`` (from /proc)."""
    children = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        children.setdefault(ppid, []).append(int(d))
    out, todo = set(), list(roots)
    while todo:
        for c in children.get(todo.pop(), []):
            if c not in out:
                out.add(c)
                todo.append(c)
    return out


def alive(pid: int) -> bool:
    """``pid`` exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def nvml_compute_pids() -> set:
    """The pids NVML lists as compute processes on any card
    (``nvmlDeviceGetComputeRunningProcesses_v3``)."""
    import ctypes

    from kubegpu_tpu_torch.tpuplugin.nvml import load_library

    class Info(ctypes.Structure):     # nvml.h's nvmlProcessInfo_t
        _fields_ = [("pid", ctypes.c_uint),
                    ("usedGpuMemory", ctypes.c_ulonglong),
                    ("gpuInstanceId", ctypes.c_uint),
                    ("computeInstanceId", ctypes.c_uint)]

    lib = load_library()
    check(lib.nvmlInit_v2() == 0, "daemons: nvmlInit_v2 failed")
    pids = set()
    try:
        count = ctypes.c_uint(0)
        check(lib.nvmlDeviceGetCount_v2(ctypes.byref(count)) == 0,
              "daemons: nvmlDeviceGetCount_v2 failed")
        for i in range(count.value):
            handle = ctypes.c_void_p()
            check(lib.nvmlDeviceGetHandleByIndex_v2(
                ctypes.c_uint(i), ctypes.byref(handle)) == 0,
                "daemons: nvmlDeviceGetHandleByIndex_v2 failed")
            n, infos = ctypes.c_uint(256), (Info * 256)()
            rc = lib.nvmlDeviceGetComputeRunningProcesses_v3(
                handle, ctypes.byref(n), infos)
            check(rc == 0, f"daemons: nvmlDeviceGetComputeRunningProcesses"
                  f"_v3 returned {rc} on card {i}")
            pids |= {infos[k].pid for k in range(n.value)}
    finally:
        lib.nvmlShutdown()
    return pids


def smi_compute_pids() -> set:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return {int(x) for x in out.split() if x.strip().isdigit()}


class PodWatch:
    """The client's watch: when each object first reached each phase (a
    Pod) or changed (a Node), on this process's clock."""

    def __init__(self, client):
        import threading
        self.cond = threading.Condition()
        self.seen = {}
        self.unsub = client.watch(self._on)

    def _on(self, ev) -> None:
        now = time.perf_counter()
        key = (ev.kind, ev.obj.metadata.name,
               ev.obj.status.phase.value if ev.kind == "Pod" else ev.type)
        with self.cond:
            self.seen.setdefault(key, now)
            self.cond.notify_all()

    def wait(self, kind: str, name: str, states, timeout: float):
        """(state, time) of the first of ``states`` ``name`` reached."""
        with self.cond:
            ok = self.cond.wait_for(lambda: any(
                (kind, name, s) in self.seen for s in states), timeout)
            check(ok, f"daemons: {kind} {name} reached none of {states} "
                  f"in {timeout} s")
            return min(((s, self.seen[(kind, name, s)]) for s in states
                        if (kind, name, s) in self.seen),
                       key=lambda x: x[1])


def http_text(url: str) -> str:
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def granted_uuids(client, pod_name: str) -> list:
    """The UUIDs of the cards a pod's ``AllocateFrom`` names, through its
    node's advertisement, both read over HTTP."""
    from kubegpu_tpu_torch.kubemeta import node_advertisement, pod_allocation
    pod = client.get("Pod", pod_name)
    alloc = pod_allocation(pod)
    check(alloc is not None, f"daemons: {pod_name} has no AllocateFrom")
    adv = node_advertisement(client.get("Node", alloc.node_name))
    by_index = {c.local_index: c.uuid for c in adv.chips}
    return [by_index[c.local_index] for c in alloc.chips]


def daemon_node(client) -> dict:
    """(a) The Node read back over HTTP advertises this host's cards: the
    UUIDs nvidia-smi lists, in NVML's order, and the slice type and
    switched flag an in-process ``NvmlBackend`` discovers (phase 17
    (a) holds those to torch and nvidia-smi)."""
    from kubegpu_tpu_torch.kubemeta import node_advertisement
    from kubegpu_tpu_torch.tpuplugin import NvmlBackend
    nodes = client.list("Node")
    check(len(nodes) == 1, f"daemons: {len(nodes)} nodes registered")
    adv = node_advertisement(nodes[0])
    be = NvmlBackend()
    try:
        local = be.discover()
    finally:
        be.close()
    smi = [row[1] for row in smi_cards()]
    uuids = [c.uuid for c in adv.chips]
    check(sorted(uuids) == sorted(smi)
          and uuids == [c.uuid for c in local.chips]
          and (adv.slice_type, adv.switched)
          == (local.slice_type, local.switched),
          f"daemons: the node advertises {uuids} as {adv.slice_type}, "
          f"NVML {[c.uuid for c in local.chips]} as {local.slice_type}")
    out = {"node": nodes[0].name, "cards": len(uuids),
           "slice_type": adv.slice_type, "switched": adv.switched,
           "uuids_equal": True}
    log("daemons", part="(a) node over HTTP", **out)
    return out


def daemon_serving_pod(client, watch, node_url: str) -> dict:
    """(b) ``serve-llama.json``'s continuous serving pod through the three
    daemons: created over HTTP, Succeeded on the watch; then over HTTP
    the card it saw (its log) against its grant, its kernel 5 launches
    and its metric lines among the node's harvested ones."""
    from kubegpu_tpu_torch.cli import pods_from_spec
    from kubegpu_tpu_torch.config import load_structured_file
    from kubegpu_tpu_torch.kernels import SIGNATURES as KERNEL_NAMES
    from kubegpu_tpu_torch.obs import parse_prometheus

    root = os.path.dirname(os.path.abspath(__file__))
    pods = pods_from_spec(load_structured_file(os.path.join(
        root, "kubegpu_tpu_torch", "examples", CLUSTER_SPECS[1])))[0]
    pod = next(p for p in pods if p.name == DAEMON_POD)
    t0 = time.perf_counter()
    client.create("Pod", pod)
    _, t_sched = watch.wait("Pod", DAEMON_POD, ("Scheduled",),
                            DAEMON_TIMEOUT_S)
    _, t_run = watch.wait("Pod", DAEMON_POD, ("Running",), DAEMON_TIMEOUT_S)
    # what the card's driver lists while the pod runs (a container in its
    # own pid namespace may list nothing: then the phase's last check
    # cannot see a process either)
    listed = {"nvml": len(nvml_compute_pids()),
              "nvidia_smi": len(smi_compute_pids())}
    state, t_end = watch.wait("Pod", DAEMON_POD, ("Succeeded", "Failed"),
                              DAEMON_TIMEOUT_S)
    container = pod.spec.containers[0].name
    logs = http_text(f"{node_url}/containerLogs/{DAEMON_POD}/{container}")
    check(state == "Succeeded", f"daemons: {DAEMON_POD} {state}: "
          f"{client.get('Pod', DAEMON_POD).status.message}\n{logs[-2000:]}")
    granted = granted_uuids(client, DAEMON_POD)
    seen = pod_device(logs)
    check(len(granted) == 1 and seen is not None
          and seen["uuid"] == granted[0] and seen["count"] == 1,
          f"daemons: {DAEMON_POD} saw {seen}, granted {granted}")
    lines = metric_lines(logs)
    prom = parse_prometheus(http_text(f"{node_url}/metrics"))

    def harvested(k):
        fam = prom.get(f"kubetpu_workload_{k}_last")
        return None if fam is None else next(iter(fam["samples"].values()))
    check(lines and all(harvested(k) == float(v) for k, v in lines.items()),
          f"daemons: the node's /metrics lacks {DAEMON_POD}'s lines: "
          f"{sorted(k for k in lines if harvested(k) is None)}")
    launched = {k: int(lines.get(f"launches_{k}", 0)) for k in KERNEL_NAMES}
    check(harvested("launches_paged_decode_q8") > 0,
          f"daemons: {DAEMON_POD} did not run kernel 5: {launched}")
    out = {"uuid": granted[0], "granted_uuid_seen": True,
           "create_to_scheduled_ms": (t_sched - t0) * 1e3,
           "scheduled_to_running_ms": (t_run - t_sched) * 1e3,
           "wall_s": t_end - t0, "harvested": sorted(lines),
           "launches": launched, "compute_processes_listed": listed}
    log("daemons", part="(b) serving pod", pod=DAEMON_POD,
        **{k: v for k, v in out.items() if k != "harvested"},
        harvested=len(lines))
    return out


def daemon_probes(client, watch) -> dict:
    """(b) One-card ``python -c`` probe pods, one at a time: ms from the
    create to the SCHEDULED event at this client (the quantity the
    reference's ``run_wire_bench`` records) and to Succeeded."""
    from kubegpu_tpu_torch.cluster import tpu_pod
    from kubegpu_tpu_torch.obs import percentiles
    sched, done = [], []
    for i in range(DAEMON_PROBES):
        name = f"probe-{i}"
        t0 = time.perf_counter()
        client.create("Pod", tpu_pod(name, chips=1, command=[
            sys.executable, "-c", "print('probe')"]))
        _, t_sched = watch.wait("Pod", name, ("Scheduled",), 60.0)
        state, t_end = watch.wait("Pod", name, ("Succeeded", "Failed"), 60.0)
        check(state == "Succeeded", f"daemons: {name} {state}")
        sched.append((t_sched - t0) * 1e3)
        done.append((t_end - t0) * 1e3)
        client.delete("Pod", name)
    p = percentiles(sched, (50, 99))
    out = {"probes": DAEMON_PROBES, "create_to_scheduled_ms": sched,
           "create_to_scheduled_ms_p50": p["p50"],
           "create_to_scheduled_ms_p99": p["p99"],
           "create_to_succeeded_ms_p50": percentiles(done, (50,))["p50"]}
    log("daemons", part="(b) probes", **{k: v for k, v in out.items()
                                         if k != "create_to_scheduled_ms"})
    return out


def daemon_webhook() -> dict:
    """(c) The extender webhook over HTTP, in this process: the cluster
    ``SimCluster.from_config`` builds with ``backend.type=nvml`` (this
    node, its own apiserver), a one-card pod through ``/filter``,
    ``/prioritize`` and ``/bind``; the ``AllocateFrom`` the bind writes
    names a card of this host (its UUID through the node's
    advertisement)."""
    import urllib.request

    from kubegpu_tpu_torch.cluster import SimCluster, tpu_pod
    from kubegpu_tpu_torch.config import KubeTpuConfig
    from kubegpu_tpu_torch.kubemeta import node_advertisement, pod_allocation
    from kubegpu_tpu_torch.kubemeta.codec import ALLOCATE_FROM_KEY
    from kubegpu_tpu_torch.scheduler.webhook import (
        ExtenderHTTPServer,
        pod_to_doc,
    )

    def post(url, payload):
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=30) as r:
            body = json.loads(r.read())
        return body, (time.perf_counter() - t0) * 1e3

    cl = SimCluster.from_config(KubeTpuConfig.load(None,
                                                   ["backend.type=nvml"]))
    srv = ExtenderHTTPServer(cl.scheduler, port=0).start()
    try:
        pod = tpu_pod("webhook-probe", chips=1, command=["noop"])
        cl.api.create("Pod", pod)
        nodes = [n.name for n in cl.api.list("Node")]
        base = f"{srv.address}/kubetpu"
        filt, f_ms = post(f"{base}/filter", {"Pod": pod_to_doc(pod),
                                             "NodeNames": nodes})
        check(filt["NodeNames"] == nodes and filt["Error"] == "",
              f"daemons: /filter {filt}")
        scores, p_ms = post(f"{base}/prioritize", {"Pod": pod_to_doc(pod),
                                                   "NodeNames": nodes})
        best = max(scores, key=lambda s: s["Score"])["Host"]
        bound, b_ms = post(f"{base}/bind", {
            "PodName": pod.name, "PodNamespace": "default",
            "PodUID": pod.metadata.uid, "Node": best})
        check(bound["Error"] == "", f"daemons: /bind {bound}")
        got = cl.api.get("Pod", pod.name)
        alloc = pod_allocation(got)
        adv = node_advertisement(cl.api.get("Node", best))
        uuid = {c.local_index: c.uuid for c in adv.chips}[
            alloc.chips[0].local_index]
        smi = [row[1] for row in smi_cards()]
        check(got.spec.node_name == best and ALLOCATE_FROM_KEY in
              got.metadata.annotations and len(alloc.chips) == 1
              and uuid in smi,
              f"daemons: the bind's AllocateFrom names {uuid}, not a card "
              f"of {smi}")
    finally:
        srv.close()
        cl.close()
    out = {"node": best, "uuid": uuid, "scores": scores,
           "filter_ms": f_ms, "prioritize_ms": p_ms, "bind_ms": b_ms}
    log("daemons", part="(c) extender webhook over HTTP", **out)
    return out


def daemon_gang(client, watch, node_url: str, n_cards: int) -> dict | None:
    """(d) Two or more cards: ``allreduce-bench.json``'s gang at
    ``min(4, cards)`` workers through the daemons, each worker on the card
    its grant names; worker 0's bandwidth line."""
    if n_cards < 2:
        log("daemons", part="(d) gang not run: one card (the gang takes "
            "one card a worker)")
        return None
    n = min(4, n_cards)
    pods = gang_spec_pods(GANG_SPECS[0], n)
    t0 = time.perf_counter()
    for p in pods:
        client.create("Pod", p)
    uuids, line = {}, None
    for p in pods:
        state, _ = watch.wait("Pod", p.name, ("Succeeded", "Failed"),
                              DAEMON_TIMEOUT_S)
        logs = http_text(f"{node_url}/containerLogs/{p.name}/"
                         f"{p.spec.containers[0].name}")
        check(state == "Succeeded", f"daemons: gang pod {p.name} {state}\n"
              f"{logs[-2000:]}")
        seen, granted = pod_device(logs), granted_uuids(client, p.name)
        check(seen is not None and [seen["uuid"]] == granted
              and seen["count"] == 1,
              f"daemons: gang pod {p.name} saw {seen}, granted {granted}")
        uuids[p.name] = seen["uuid"]
        for ln in logs.splitlines():
            if ln.startswith('{"metric": "allreduce_algo'):
                line = json.loads(ln)
    check(len(set(uuids.values())) == n and line is not None
          and line["value"] > 0, f"daemons: gang cards {uuids}, line {line}")
    out = {"workers": n, "uuids": uuids, "line": line,
           "wall_s": time.perf_counter() - t0}
    log("daemons", part=f"(d) allreduce gang, {n} workers", **line,
        wall_s=round(out["wall_s"], 2))
    return out


def daemons_phase(torch, kernels) -> dict:
    """Phase 19: the daemons (see the docstring)."""
    import threading

    from kubegpu_tpu_torch.kubemeta import HttpApiClient

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    kernels.reset_launches()          # the daemons' path starts here
    # the compute processes the card's driver lists before the phase: a
    # container may list them under other pids than its own, so the end
    # also holds their count to this one
    before = {"nvidia_smi": len(smi_compute_pids()),
              "nvml": len(nvml_compute_pids())}
    log_dir = tempfile.mkdtemp(prefix="daemons-")
    port, http_port = free_port(), free_port()
    url, node_url = (f"http://127.0.0.1:{port}",
                     f"http://127.0.0.1:{http_port}")
    daemons, client, watch, out = [], None, None, {}
    started, sampling = set(), threading.Event()

    def sample():                     # every process the daemons start
        while not sampling.wait(0.05):
            started.update(process_tree([d.proc.pid for d in daemons]))

    sampler = threading.Thread(target=sample, daemon=True)
    try:
        daemons.append(Daemon(
            "apiserver", log_dir, "kubegpu_tpu_torch.kubemeta.apiserver_serve",
            "--port", str(port)))
        daemons[0].wait_for("apiserver: listening on")
        daemons.append(Daemon(
            "scheduler", log_dir, "kubegpu_tpu_torch.scheduler.daemon",
            "--apiserver", url, "--tick", "0.2"))
        daemons.append(Daemon(
            "node", log_dir, "kubegpu_tpu_torch.crishim.serve",
            "--apiserver", url, "--backend", "nvml", "--real-processes",
            "--env", "KUBETPU_REPORT_LAUNCHES=1", "--tick", "0.05",
            "--advertise-interval", "2",
            "--cri-socket", os.path.join(log_dir, "cri.sock"),
            "--http-port", str(http_port)))
        sampler.start()
        daemons[1].wait_for("scheduler: connected")
        daemons[2].wait_for("crishim: http on port")
        out["start_s"] = time.perf_counter() - t_phase
        log("daemons", part="started", seconds=round(out["start_s"], 2),
            apiserver=url, node_http=node_url)
        client = HttpApiClient(url)
        out["node"] = daemon_node(client)
        watch = PodWatch(client)
        # the watch's first poll starts from "now": see one change first
        client.patch_annotations("Node", out["node"]["node"],
                                 {"kubetpu.io/watch-sync": "1"})
        watch.wait("Node", out["node"]["node"], ("MODIFIED",), 30.0)
        out["pod"] = daemon_serving_pod(client, watch, node_url)
        out["probes"] = daemon_probes(client, watch)
        out["webhook"] = daemon_webhook()
        out["gang"] = daemon_gang(client, watch, node_url,
                                  torch.cuda.device_count())
        for d in daemons:
            check(d.proc.poll() is None,
                  f"daemons: the {d.label} died:\n{d.text()[-3000:]}")
    finally:
        if watch is not None:
            watch.unsub()
        if client is not None:
            client.close()
        sampling.set()
        if sampler.is_alive():
            sampler.join()
        started.update(process_tree([d.proc.pid for d in daemons]))
        codes = {d.label: d.stop() for d in reversed(daemons)}
        logs = {d.label: d.text()[-2000:] for d in daemons}
        shutil.rmtree(log_dir, ignore_errors=True)
    check(codes["node"] == 0, f"daemons: the node daemon's stop: rc "
          f"{codes['node']}\n{logs['node']}")
    ours = started | {d.proc.pid for d in daemons}
    left = sorted(p for p in ours if alive(p))
    smi, nvml = smi_compute_pids(), nvml_compute_pids()
    after = {"nvidia_smi": len(smi), "nvml": len(nvml)}
    out["compute_processes"] = {"before": before, "after": after,
                                "self_listed": {"nvidia_smi": os.getpid()
                                                in smi, "nvml":
                                                os.getpid() in nvml}}
    check(not left and not (ours & smi) and not (ours & nvml)
          and all(after[k] <= before[k] for k in before),
          f"daemons: still alive {left}; on a card per nvidia-smi "
          f"{sorted(ours & smi)}, per NVML {sorted(ours & nvml)}; listed "
          f"before {before}, after {after}")
    here = dict(kernels.launches)     # ... and ends here
    check(not any(here.values()),
          f"the daemons' path launched a kernel in this process: {here}")
    out["processes_started"] = len(ours)
    out["stop_codes"] = codes
    out["launches"] = {k: out["pod"]["launches"].get(k, 0)
                       for k in kernels.SIGNATURES}
    out["phase_s"] = time.perf_counter() - t_phase
    log("daemons", part="stopped", processes_started=len(ours),
        left_alive=0, on_a_card=0, stop_codes=codes,
        **out["compute_processes"])
    log("daemons", phase_s=round(out["phase_s"], 1))
    return out


# -- phase 20: the allocator core and the workload surface -------------------

CORE_SPECS = ("h100-sxm-8", "v5e-256")
CORE_TRIALS = 6
WORKLOAD_PROGRAM = "kubegpu_tpu_torch.workloads.programs."
CORE_ENTRIES = ("find_free_placements", "rank_free_placements",
                "fragmentation_score", "eval_order", "orient_rings",
                "align_units", "connected_order")


@contextlib.contextmanager
def python_paths():
    """The allocator's Python paths (``KUBETPU_NO_NATIVE=1``), which the
    port reads at every call."""
    saved = os.environ.get("KUBETPU_NO_NATIVE")
    os.environ["KUBETPU_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("KUBETPU_NO_NATIVE")
        else:
            os.environ["KUBETPU_NO_NATIVE"] = saved


def core_build() -> dict:
    """(a) The core compiled afresh with this host's compiler (into a
    scratch directory: the library the cluster phases loaded stays)."""
    from kubegpu_tpu_torch.allocator import _native

    saved = _native.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        _native.BUILD_DIR = Path(tmp)
        try:
            t0 = time.perf_counter()
            warnings = _native.build()
            seconds = time.perf_counter() - t0
        finally:
            _native.BUILD_DIR = saved
    compiler = subprocess.run([_native.cxx(), "--version"],
                              capture_output=True, text=True,
                              timeout=60).stdout.splitlines()[0]
    check(not warnings.strip(), f"core: the build warned:\n{warnings}")
    out = {"compiler": compiler, "flags": " ".join(_native.CXX_FLAGS),
           "build_s": seconds}
    log("workloads", part="(a) core build", compiler=repr(compiler),
        build_s=round(seconds, 3))
    return out


def core_entries(name: str) -> dict:
    """(a) Each entry of the core against the Python path on
    ``CORE_TRIALS`` seeded occupancies of spec ``name``: every placement
    of 1-8 cards, the top 8 of 64 ranked, each of the first three
    placements' fragmentation score and the locality of its first four
    orders and a shuffled one, ring orientation and alignment over blocks
    of four cards, and the connected fallback of gangs of 1-3 pods of 1-3
    cards.  Returns the count of results compared, per entry: all equal."""
    import random

    from kubegpu_tpu_torch.allocator import _native, gang
    from kubegpu_tpu_torch.allocator.gang import GangRequest, SliceState
    from kubegpu_tpu_torch.allocator.ordering import candidate_orders
    from kubegpu_tpu_torch.topology import TOPOLOGY_REGISTRY
    from kubegpu_tpu_torch.topology.locality import (
        ici_locality,
        resolve_axis_weights,
        traffic_pairs_for_mesh_axes,
    )
    from kubegpu_tpu_torch.topology.slices import (
        find_free_placements,
        fragmentation_score,
        subslice_shapes,
    )

    rng = random.Random(SEED)
    st = SliceState("core", TOPOLOGY_REGISTRY[name])
    topo = st.topo
    coords = [ch.coord for ch in topo.chips]
    for i, c in enumerate(coords):
        st.available.add(c)
        st.local_index[c] = i % st.spec.chips_per_host
    counts = dict.fromkeys(CORE_ENTRIES, 0)

    def same(entry, got, want):
        check(got == want, f"core: {entry} on {name} differs from the "
              f"Python path: {got} against {want}")
        counts[entry] += 1

    for _ in range(CORE_TRIALS):
        occ = set(rng.sample(coords, rng.randrange(len(coords) // 2)))
        for total in (1, 2, 4, 8):
            for shape in subslice_shapes(total, topo.spec.mesh_shape):
                with python_paths():
                    py = find_free_placements(topo, occ, shape)
                    frags = [fragmentation_score(topo, occ, p)
                             for p in py[:64]]
                same("find_free_placements", find_free_placements(
                    topo, occ, shape), py)
                ranked = sorted(zip(frags, py), key=lambda t: -t[0])[:8]
                same("rank_free_placements",
                     _native.rank_free_placements_native(
                         topo, occ, shape, 64, 8), ranked)
                for pl, frag in zip(py[:3], frags):
                    same("fragmentation_score",
                         _native.fragmentation_score_native(
                             topo, occ, pl.coords), frag)
                    shuffled = list(pl.coords)
                    rng.shuffle(shuffled)
                    axes = {"dp": 2, "tp": total // 2} if total > 1 \
                        else {"dp": 1}
                    weights = resolve_axis_weights(axes, None)
                    for order in candidate_orders(pl)[:4] + [shuffled]:
                        same("eval_order", _native.eval_order_native(
                            topo, order, axes, weights), ici_locality(
                            topo, traffic_pairs_for_mesh_axes(
                                order, axes, weights)))
        picked = rng.sample(coords, 8)
        blocks = [picked[i:i + 4] for i in (0, 4)]
        units = [sorted(b) for b in blocks]
        for close in (False, True):
            with python_paths():
                want = gang._orient_rings(blocks, close)
            same("orient_rings", gang._orient_rings(blocks, close), want)
        with python_paths():
            want = gang._align_units(units, 1)
        same("align_units", gang._align_units(units, 1), want)
        st.used_millichips = {c: 1000 for c in occ}
        blocked = st.blocked_for_whole()
        for pods in (1, 2, 3):
            for cpp in (1, 2, 3):
                req = GangRequest("core", num_pods=pods, chips_per_pod=cpp)
                with python_paths():
                    want = gang._connected_order(st, req, blocked)
                same("connected_order",
                     gang._connected_order(st, req, blocked), want)
    log("workloads", part="(a) core entries", spec=name, **counts)
    return counts


def core_scale() -> dict:
    """(a) Phase 17 (c)'s seeded gang mix with the core and on the Python
    paths: equal bindings and localities; decision ms of each."""
    native, ours = scale_mix()
    with python_paths():
        python, theirs = scale_mix()
    check(ours == theirs, "core: phase 17 (c)'s mix binds otherwise with "
          "the core than on the Python paths")
    out = {"native": native, "python": python, "equal_bindings": True,
           "pods": len(ours["bindings"])}
    log("workloads", part="(a) the gang mix", pods=out["pods"],
        equal_bindings=True, gangs=native["gangs"],
        native_ms_p50=native["schedule_ms_p50"],
        native_ms_p99=native["schedule_ms_p99"],
        python_ms_p50=python["schedule_ms_p50"],
        python_ms_p99=python["schedule_ms_p99"],
        native_s=round(native["seconds"], 3),
        python_s=round(python["seconds"], 3))
    return out


def cli_text(argv: list, keep: list | None = None) -> tuple[int, str]:
    """``python -m kubegpu_tpu_torch <argv>`` as ``cli.main`` in this
    process: its exit code and what it printed.  With ``keep``, the
    cluster the command builds is appended to it."""
    from kubegpu_tpu_torch import cli

    build = cli._build_cluster
    if keep is not None:
        cli._build_cluster = lambda *a: keep.append(build(*a)) or keep[-1]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        cli._build_cluster = build
    return rc, buf.getvalue()


def demo_real(name: str) -> dict:
    """(b) ``demo <name> --real --set backend.type=nvml``: exit 0, every
    pod Succeeded, each pod's handle (stdout, env)."""
    kept = []
    t0 = time.perf_counter()
    rc, table = cli_text(["demo", name, "--real", "--set",
                          "backend.type=nvml", "--set",
                          "runtime.extra_env=KUBETPU_REPORT_LAUNCHES:1",
                          "--timeout", "300"], kept)
    wall = time.perf_counter() - t0
    handles = {h.pod_name: h for h in kept[0].runtime.containers()}
    check(rc == 0 and all(h.exit_code == 0 for h in handles.values()),
          f"demo {name} --real: rc {rc}\n{table}\n" + "\n".join(
              h.stderr[-2000:] for h in handles.values()))
    return {"rc": rc, "wall_s": wall, "table": table.splitlines()[:4],
            "handles": handles,
            "launches": {p: pod_launches(h) for p, h in handles.items()}}


def pod_launches(h) -> dict:
    """The kernel launches a pod run with ``KUBETPU_REPORT_LAUNCHES=1``
    reported: one count for each kernel of the port."""
    from kubegpu_tpu_torch.kernels import SIGNATURES as KERNEL_NAMES

    launched = {k[len("launches_"):]: int(v)
                for k, v in metric_lines(h.stdout).items()
                if k.startswith("launches_")}
    check(set(launched) == set(KERNEL_NAMES),
          f"pod {h.pod_name}: reported launches of {sorted(launched)}")
    return launched


def prefetch_check(torch) -> dict:
    """(b) ``prefetch_to_device``'s card branch against its numpy source,
    exactly, over three epochs each of two consumers of 1024-row MNIST-width
    batches: one that copies each batch back at once (a batch yielded
    before its copy ended shows stale rows), one whose stream sleeps ~20 ms
    before it clones each batch and drops it unsynchronized (a batch's memory
    handed to a later copy while the consumer's queued clone still reads
    it, as it would be without ``record_stream``, shows the later rows)."""
    import numpy as np

    from kubegpu_tpu_torch.workloads.data import (
        ShardedBatcher,
        prefetch_to_device,
        synthetic_features,
    )

    batcher = ShardedBatcher(synthetic_features(8192, 784, 10),
                             batch_size=1024, seed=SEED)
    batches = bad = 0
    for epoch in range(3):
        for src, got in zip(batcher.batches(epoch), prefetch_to_device(
                batcher.batches(epoch), size=2, device="cuda")):
            batches += 1
            bad += any(not np.array_equal(got[k].cpu().numpy(), src[k])
                       for k in src)
    for epoch in range(3, 6):
        srcs, snaps = [], []
        for src, got in zip(batcher.batches(epoch), prefetch_to_device(
                batcher.batches(epoch), size=2, device="cuda")):
            torch.cuda._sleep(40_000_000)     # ~20 ms at 1.98 GHz
            snaps.append({k: t.clone() for k, t in got.items()})
            srcs.append(src)
            del got
        torch.cuda.synchronize()
        batches += len(srcs)
        bad += sum(any(not np.array_equal(snap[k].cpu().numpy(), src[k])
                       for k in src) for src, snap in zip(srcs, snaps))
    check(bad == 0, f"prefetch_to_device: {bad} of {batches} batches on the "
          "card differ from their numpy source")
    return {"batches": batches, "equal": True}


def mnist_reference(torch, pod: dict) -> dict:
    """(b) The ``mnist_mlp`` pod's losses against ``mnist_mlp.train`` from
    the pod's initial parameters (``init_params`` on the card, seed 0): on
    the card in this process and on the CPU, every epoch's mean within
    rtol 1e-4 of the CPU's; the pod's printed first and last losses within
    the 4-decimal rounding of its line (5e-5) plus rtol 1e-4 of the CPU's."""
    from kubegpu_tpu_torch.workloads.data import ShardedBatcher, \
        synthetic_features
    from kubegpu_tpu_torch.workloads.programs import mnist_mlp

    batcher = ShardedBatcher(synthetic_features(256, 784, 10),
                             batch_size=64)
    init = mnist_mlp.init_params("cuda")
    card = mnist_mlp.train(init, batcher, "cuda")
    cpu = mnist_mlp.train({k: v.cpu() for k, v in init.items()}, batcher,
                          "cpu")
    err = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    check(err <= 1e-4, f"mnist_mlp: the card's epoch losses {card} are not "
          f"within rtol 1e-4 of the CPU's {cpu}")
    for k, want in (("first_loss", cpu[0]), ("last_loss", cpu[-1])):
        check(abs(pod[k] - want) <= 5e-5 + 1e-4 * abs(want),
              f"mnist_mlp pod: {k}={pod[k]} against the CPU's {want:.6f}")
    return {"card_losses": card, "cpu_losses": cpu, "max_rel_err": err}


def workload_commands(torch) -> dict:
    """(b) The workload surface on this node: ``configs``, ``demo config1
    --real`` (the 0-card pod sees no card), ``demo config2 --real`` (the
    ResNet pod on the card its grant names), ``metrics --format
    prometheus`` of ``config2-resnet-1gpu.json`` scheduled, and a
    ``mnist_mlp`` pod on its granted card whose loss falls."""
    from kubegpu_tpu_torch.cluster import SimCluster, tpu_pod
    from kubegpu_tpu_torch.config import KubeTpuConfig
    from kubegpu_tpu_torch.workloads.specs import ALL_CONFIGS

    out = {"launches": {}}
    rc, text = cli_text(["configs"])
    names = [ln.split(":")[0] for ln in text.splitlines()]
    check(rc == 0 and names == sorted(ALL_CONFIGS),
          f"configs: rc {rc}, names {names}")
    out["configs"] = names
    d1 = demo_real("config1")
    h = d1["handles"]["mnist-cpu"]
    check(h.env.get("CUDA_VISIBLE_DEVICES") == "" and
          h.stdout.strip().splitlines()[0].endswith("cards=0"),
          f"demo config1: the 0-card pod saw a card: {h.stdout[-500:]}")
    out["config1"] = {"wall_s": d1["wall_s"], "line": h.stdout.strip().
                      splitlines()[0]}
    out["launches"].update(d1["launches"])
    d2 = demo_real("config2")
    out["launches"].update(d2["launches"])
    h = d2["handles"]["resnet-1chip"]
    seen = pod_device(h.stdout)
    check(seen is not None and seen["uuid"] == h.env["CUDA_VISIBLE_DEVICES"]
          and seen["count"] == 1,
          f"demo config2: the pod saw {seen}, not its grant's card")
    out["config2"] = {"wall_s": d2["wall_s"], "card_seen": seen["name"],
                      "line": [ln for ln in h.stdout.splitlines()
                               if ln.startswith("resnet:")][0]}
    log("workloads", part="(b) demo --real", config1=repr(
        out["config1"]["line"]), config2=repr(out["config2"]["line"]),
        config2_on_granted_card=True,
        wall_s=[round(d1["wall_s"], 2), round(d2["wall_s"], 2)])
    spec = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "kubegpu_tpu_torch", "examples",
                        "config2-resnet-1gpu.json")
    rc, text = cli_text(["metrics", "-f", spec, "--schedule-only",
                         "--format", "prometheus", "--set",
                         "backend.type=nvml"])
    check(rc == 0 and "# TYPE kubetpu_schedule_latency_ms histogram" in text,
          f"metrics: rc {rc}\n{text[-1000:]}")
    out["metrics_lines"] = len(text.splitlines())
    cfg = KubeTpuConfig.load(None, ["backend.type=nvml",
                                    "runtime.real_processes=true"])
    cfg.runtime.extra_env = {"KUBETPU_REPORT_LAUNCHES": "1"}
    cl = SimCluster.from_config(cfg)
    t0 = time.perf_counter()
    try:
        cl.submit(tpu_pod("mnist-mlp", chips=1, command=[
            sys.executable, "-m", WORKLOAD_PROGRAM + "mnist_mlp"],
            env={"KUBETPU_EXPECT_CHIPS": "1"}))
        codes = cl.run_to_completion(timeout_s=300)
    finally:
        cl.close()
    h = cl.runtime.containers()[0]
    seen = pod_device(h.stdout)
    line = [ln for ln in h.stdout.splitlines()
            if ln.startswith("mnist_mlp:")]
    check(codes == {"mnist-mlp": 0} and line and seen is not None
          and seen["uuid"] == h.env["CUDA_VISIBLE_DEVICES"],
          f"mnist_mlp pod: {codes}\n{h.stdout[-1000:]}\n{h.stderr[-2000:]}")
    first, last = (float(line[0].split(k + "=")[1].split()[0])
                   for k in ("first_loss", "last_loss"))
    check(last < first, f"mnist_mlp pod: the loss did not fall: {line[0]}")
    out["launches"]["mnist-mlp"] = pod_launches(h)
    out["mnist_mlp"] = {"wall_s": time.perf_counter() - t0,
                        "first_loss": first, "last_loss": last,
                        "card_seen": seen["name"]}
    out["mnist_mlp"]["reference"] = mnist_reference(torch, out["mnist_mlp"])
    out["prefetch"] = prefetch_check(torch)
    log("workloads", part="(b) metrics and mnist_mlp",
        metrics_lines=out["metrics_lines"], mnist_first_loss=first,
        mnist_last_loss=last, mnist_on_granted_card=True,
        mnist_wall_s=round(out["mnist_mlp"]["wall_s"], 2),
        mnist_max_rel_err_card_vs_cpu=out["mnist_mlp"]["reference"][
            "max_rel_err"],
        prefetch_batches_equal=out["prefetch"]["batches"],
        pod_launches=out["launches"])
    return out


def workloads_phase(torch, kernels) -> dict:
    """Phase 20: the allocator core and the workload surface (see the
    docstring)."""
    t0 = time.perf_counter()
    kernels.reset_launches()          # the workloads' path starts here
    out = {"core_build": core_build(),
           "core_entries": {n: core_entries(n) for n in CORE_SPECS},
           "core_scale": core_scale(),
           "commands": workload_commands(torch)}
    here = dict(kernels.launches)     # ... and ends here
    check(not any(here.values()),
          f"the workloads' path launched a kernel in this process: {here}")
    # what the pods (ResNet, the MLPs) reported launching
    out["launches"] = {k: sum(pod[k] for pod in
                              out["commands"]["launches"].values())
                       for k in kernels.SIGNATURES}
    out["phase_s"] = time.perf_counter() - t0
    log("workloads", phase_s=round(out["phase_s"], 1))
    return out


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
                    help="also trace steady engine ticks, a T5 paged block "
                    "and one train step (torch.profiler)")
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
        from kubegpu_tpu_torch.models.decode import draft_view
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
    # the NaN checks and phase 10 draw from generators of their own, so
    # every other phase gets the inputs it got before they existed
    nan_checks = paged_nan_checks(
        torch, torch.Generator(device="cuda").manual_seed(SEED + 1),
        slice_rows)
    results["paged_decode_q8"] = quant["q8"]
    results["paged_decode_q4"] = quant["q4g16"]
    results["paged_decode"]["mass"] = quant["bf16"]
    results["paged_decode_bias"] = paged_bias_checks(torch, gen)
    chunk = chunk_shape_checks(torch, gen)
    verify = verify_shape_checks(torch, gen, slice_lens)
    # kernel 4 at phase 5h's shapes draws from a generator of its own, so
    # every other phase gets the inputs it got before
    search_shapes = search_shape_checks(
        torch, torch.Generator(device="cuda").manual_seed(SEED + 12))
    results["paged_decode"]["search_shapes"] = search_shapes
    # kernels 4-6 at the tensor-parallel local shapes (phase 15) draw from
    # a generator of their own, so every other phase gets the inputs it got
    tp_shapes = tp_shape_checks(
        torch, torch.Generator(device="cuda").manual_seed(SEED + 15),
        slice_rows)
    for kname, r in tp_shapes.items():
        results[kname]["tp_shapes"] = r
    for kname, fmt in (("paged_decode", "bf16"), ("paged_decode_q8", "q8"),
                       ("paged_decode_q4", "q4g16")):
        results[kname]["chunk_shape"] = chunk[fmt]
        results[kname]["verify_shape"] = verify[fmt]
    torch.cuda.empty_cache()
    bwd, fwd_train = flash_bwd_checks(torch, gen)
    results.update(bwd)
    # kernels 1-3 at ViT-B/16's shape draw from a generator of their own,
    # so every other phase gets the inputs it got before
    vit_shape = vit_shape_checks(
        torch, torch.Generator(device="cuda").manual_seed(SEED + 9))
    for kname, r in vit_shape.items():
        results[kname]["vit_shape"] = r
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
    serve, engine, eager, windows = serving_phase(torch, kernels, cfg,
                                                  params, gen, name)
    fused = fused_phase(torch, kernels, cfg, params, gen, engine, name)
    serve_launches = dict(kernels.launches)   # ... and ends here
    check(all(serve_launches[k] > 0 for k in ("flash_fwd", "paged_decode")),
          f"a kernel of the serving path never ran: {serve_launches}")
    only_tc(serve_launches, ("flash_fwd",), "serving")
    kernels.reset_launches()          # the prefix-cache path starts here
    prefix = prefix_phase(torch, kernels, cfg, params, gen, name, engine,
                          args.profile)
    prefix_launches = prefix["path_launches"]   # its windows' end
    check(prefix_launches["paged_decode"] > 0,
          f"kernel 4 never ran on the prefix-cache path: {prefix_launches}")
    kernels.reset_launches()          # the speculative path starts here
    spec = spec_phase(torch, kernels, cfg, params, gen, name, engine,
                      windows[0]["prompts"], args.profile)
    spec_launches = spec["path_launches"]   # ... and ends in the phase
    check(all(spec_launches[k] > 0 for k in PAGED_KERNELS),
          f"a paged kernel never ran on the speculative path: "
          f"{spec_launches}")
    prof = (profile_pair(torch, engine, eager, windows[-1]["prompts"], "bf16")
            if args.profile else None)
    del engine, eager
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

    kernels.reset_launches()          # the int8-weight serving path starts here
    qweights, qparams = quant_weights_phase(torch, kernels, cfg, params, gen,
                                            name, windows[0], args.profile)
    qw_launches = dict(kernels.launches)   # ... and ends here
    check(all(qw_launches[k] > 0 for k in ("flash_fwd", "paged_decode_q8")),
          f"a kernel of the int8-weight path never ran: {qw_launches}")
    only_tc(qw_launches, ("flash_fwd",), "int8-weight serving")
    log("quant", what="paged engine, int8 weights vs bf16 weights (both "
        "int8 pages, graph, first window's prompts)",
        int8w_tokens_per_s=qweights["tokens_per_s"],
        bf16w_tokens_per_s=quant_serve["int8"]["tokens_per_s_windows"][0])
    kernels.reset_launches()          # the search decoders' path starts here
    search = search_phase(
        torch, kernels, llama3_8b_at(SEARCH_LAYERS),
        draft_view(qparams, SEARCH_LAYERS),
        torch.Generator(device="cuda").manual_seed(SEED + 10), name)
    search_launches = dict(kernels.launches)   # ... and ends here
    check(search_launches["paged_decode"] > 0,
          f"kernel 4 never ran on the search decoders' path: "
          f"{search_launches}")
    kernels.reset_launches()          # the static and dense paths start here
    static = static_phase(torch, cfg, (("int8", qparams, True),
                                       ("bf16", params, False)),
                          name, args.profile)
    del qparams
    torch.cuda.empty_cache()
    dense = dense_engine_phase(torch, kernels, cfg, params, gen, name,
                               windows[0], args.profile)
    plain_launches = dict(kernels.launches)   # ... and end here
    check(not any(plain_launches.values()),
          f"the static and dense paths launched a kernel: {plain_launches}")
    kernels.reset_launches()          # the sampling and lifecycle path starts
    lifecycle = lifecycle_phase(
        torch, kernels, cfg, params,
        torch.Generator(device="cuda").manual_seed(SEED + 2), name)
    lifecycle_launches = dict(kernels.launches)   # ... and ends here
    check(all(lifecycle_launches[k] > 0 for k in ("paged_decode",
                                                  "paged_decode_q8")),
          f"a kernel of the lifecycle path never ran: {lifecycle_launches}")
    kernels.reset_launches()          # the pools' path starts here
    pools = pool_phase(torch, kernels, cfg, params,
                       torch.Generator(device="cuda").manual_seed(SEED + 4),
                       name)
    pool_launches = dict(kernels.launches)   # ... and ends here
    check(all(pool_launches[k] > 0 for k in ("paged_decode",
                                             "paged_decode_q8")),
          f"a kernel of the pools' path never ran: {pool_launches}")
    kernels.reset_launches()          # the load harness's path starts here
    load = load_phase(torch, kernels, llama3_8b_at(LOAD_LAYERS),
                      draft_view(params, LOAD_LAYERS),
                      torch.Generator(device="cuda").manual_seed(SEED + 5),
                      name, args.profile)
    load_launches = dict(kernels.launches)   # ... and ends here
    check(all(load_launches[k] > 0 for k in ("paged_decode",
                                             "paged_decode_q8")),
          f"a kernel of the load harness's path never ran: {load_launches}")
    log("static", what="int8 weights + int8 cache over bf16",
        decode=static["int8"]["serve_decode_tokens_per_s"]
        / static["bf16"]["serve_decode_tokens_per_s"],
        e2e=static["int8"]["serve_e2e_tokens_per_s"]
        / static["bf16"]["serve_e2e_tokens_per_s"])

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

    t5_stats = t5_phase(torch, kernels, gen, name, profile=args.profile)
    t5_launches = t5_stats["serving"]["launches"]
    torch.cuda.empty_cache()

    program = program_phase(torch, kernels, gen, name)
    program_launches = program["launches"]
    check(all(program_launches[k] > 0 for k in PAGED_KERNELS),
          f"a paged kernel never ran on the program's path: "
          f"{program_launches}")
    torch.cuda.empty_cache()

    kernels.reset_launches()          # the MoE serving path starts here
    moe = moe_phase(torch, kernels,
                    torch.Generator(device="cuda").manual_seed(SEED + 7),
                    name)
    moe_launches = moe["launches"]    # ... and ends in the phase
    check(all(moe_launches[k] > 0 for k in ("flash_fwd", "paged_decode",
                                            "paged_decode_q8")),
          f"a kernel of the MoE serving path never ran: {moe_launches}")
    only_tc(moe_launches, ("flash_fwd",), "MoE serving")
    torch.cuda.empty_cache()

    # the training families' paths: each leg zeroes the counters just
    # before its steps and reads them just after
    train14 = train_families_phase(
        torch, kernels, torch.Generator(device="cuda").manual_seed(SEED + 8),
        name)
    train14_launches = train14["launches"]
    check(all(train14_launches[k] > 0 for k in
              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
          f"a kernel of the training families never ran: {train14_launches}")
    only_tc(train14_launches, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
            "the training families")
    torch.cuda.empty_cache()

    kernels.reset_launches()          # the tensor-parallel path starts here
    tp = tp_phase(torch, kernels,
                  torch.Generator(device="cuda").manual_seed(SEED + 16), name)
    tp_launches = {**dict.fromkeys(kernels.launches, 0), **tp["launches"]}
    check(all(tp_launches[k] > 0 for k in PAGED_KERNELS),
          f"a paged kernel never ran on the tensor-parallel path: "
          f"{tp['launches']}")
    torch.cuda.empty_cache()

    kernels.reset_launches()          # the pools at tp > 1 start here
    pool_tp = pool_tp_phase(
        torch, kernels, torch.Generator(device="cuda").manual_seed(SEED + 18),
        name)
    pool_tp_launches = {**dict.fromkeys(kernels.launches, 0),
                        **pool_tp["launches"]}
    check(all(pool_tp_launches[k] > 0 for k in ("paged_decode",
                                                 "paged_decode_q8")),
          f"a kernel of the pools at tp > 1 never ran: {pool_tp['launches']}")

    cluster = cluster_phase(torch, kernels)
    gang = gang_phase(torch, kernels)
    daemons = daemons_phase(torch, kernels)
    workloads = workloads_phase(torch, kernels)

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
    paths = (serve_launches, prefix_launches, spec_launches, quant_launches,
             qw_launches, search_launches, train_launches, t5_launches,
             program_launches, lifecycle_launches, pool_launches,
             load_launches, moe_launches, train14_launches, tp_launches,
             pool_tp_launches, cluster["launches"], gang["launches"],
             daemons["launches"], workloads["launches"])
    # kernels 4-6 at llama_serve.py's bench shape, by their pool format
    program_rows = {k: program["program_shape"][fmt]
                    for k, fmt in zip(PAGED_KERNELS, ("bf16", "q8", "q4g16"))}
    # launches: each kernel's count over the paths that run it (the
    # forward runs on serving and training)
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": routes[k][0],
         "replaces": routes[k][1],
         "launches": sum(path[k] for path in paths),
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         **({"verify_shape": {g: {x: v[x] for x in (
             "ms", "plain_ms", "bound_ms", "max_abs_err")}
             for g, v in r["verify_shape"].items()}}
            if "verify_shape" in r else {}),
         **({"search_shapes": {c: {x: v[x] for x in (
             "ms", "plain_ms", "bound_ms", "max_abs_err")}
             for c, v in r["search_shapes"].items()}}
            if "search_shapes" in r else {}),
         **({"program_shape": {x: program_rows[k][x] for x in (
             "ms", "plain_ms", "bound_ms", "max_abs_err")}}
            if k in program_rows else {}),
         **({"vit_shape": {x: r["vit_shape"][x] for x in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "max_abs_err")}} if "vit_shape" in r else {}),
         **({"tp_shapes": {g: {x: v[x] for x in (
             "ms", "plain_ms", "bound_ms", "share_of_bound",
             "max_abs_err")} for g, v in r["tp_shapes"].items()}}
            if "tp_shapes" in r else {})}
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
               "forward": fwd, "serving": serve, "fused": fused,
               "prefix": prefix, "paged_chunk_shape": chunk,
               "spec": spec, "paged_verify_shape": verify,
               "search": search, "paged_search_shapes": search_shapes,
               "parity": parity,
               "quantized_serving": quant_serve,
               "quantized_weights": qweights, "static": static,
               "dense_engine": dense,
               "paged_mass": quant["bf16"], "paged_rounding": rounding,
               "paged_nan": nan_checks, "lifecycle": lifecycle,
               "pools": pools, "load": load,
               "profile": prof, "training": train,
               "flash_fwd_training_shape": fwd_train,
               "t5": t5_stats, "program": program, "moe": moe,
               "flash_vit_shape": vit_shape, "train_families": train14,
               "paged_tp_shapes": tp_shapes, "tensor_parallel": tp,
               "pools_tp": pool_tp, "cluster": cluster, "gang": gang,
               "daemons": daemons, "workloads": workloads,
               "launches": {"serving": serve_launches,
                            "prefix_cache": prefix_launches,
                            "speculative": spec_launches,
                            "quantized_serving": quant_launches,
                            "int8_weight_serving": qw_launches,
                            "search_decoders": search_launches,
                            "static_and_dense": plain_launches,
                            "training": train_launches,
                            "t5_paged_serving": t5_launches,
                            "llama_serve": program_launches,
                            "sampling_and_lifecycle": lifecycle_launches,
                            "pools": pool_launches,
                            "load_and_fleet": load_launches,
                            "moe_serving": moe_launches,
                            "train_families": train14_launches,
                            "tensor_parallel": tp["launches"],
                            "pools_tp": pool_tp["launches"],
                            "cluster": cluster["launches"],
                            "gang": gang["launches"],
                            "daemons": daemons["launches"],
                            "workloads": workloads["launches"]},
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
