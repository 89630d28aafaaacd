// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` inside `flash_attention`
// (kubegpu_tpu/ops/flash_attention.py:200, pallas_call at :273): blocked
// attention with grouped GQA, an online softmax in f32 with log2(e) folded
// into the score scale (exp2), an end-aligned causal offset s - t, causal
// key-tile skipping, and an optional natural-log lse.
//
// Two instances, chosen by `route` (ops/flash_attention.py `_flash_route`
// holds the rule; this file refuses a route that cannot take the shape):
//
// route 1, tensor cores (bf16 at head dims 64 and 128).  What bounds it on
// the H100: at the training shape ([4, 32, 2048, 128] vs [4, 8, 2048, 128],
// causal) the two products are ~1.4e11 FLOP against ~70 MB moved, so the
// tensor cores' 989 TFLOP/s set the floor (~0.14 ms); at the serving shape
// ([1, 32, 512, 128]) one wave of 128 CTAs runs and latency sets the time.
// Design (FA3's forward without its ping-pong schedule): a CTA serves 128
// query rows of one query head with two warpgroups of 64.  Q comes in once
// and 128-key K and V tiles stream through two 3-stage rings by TMA (3-D
// maps [B*H, rows, D] in 64-channel boxes with the 128-byte swizzle; rows
// past T or S fill zeros and never reach the next head), each stage
// completing on an mbarrier; the CTA's first thread keeps the rings filled
// between its own products, refilling a K stage as soon as both
// warpgroups' S = Q.K^T of it is done.  S is an SS wgmma; the online
// softmax runs on the accumulator fragment (a row's max and sum reduce over
// the 4 threads that hold it; the max is taken over the raw scores, so the
// scale and the max fold into one FFMA before each ex2); P is rounded to
// bf16 in registers, as the reference rounds p before P.V, and fed as the
// A operand of an RS wgmma against V (MN-major, the transpose flag).  S of
// tile n is issued before P.V of tile n - 1, so each softmax overlaps the
// previous product.  Only tiles on the causal diagonal or the ragged key
// edge test the mask, with selects (a branch an element is far slower:
// experiments/torch_flash_ab.py); a masked p is zeroed explicitly (a
// zero-filled key scores 0, not -inf, and NEG_INF is finite).  The G query
// heads of one kv head are adjacent in the grid, so their K/V come from
// L2, and the longest causal query tiles are scheduled first.  There is no
// producer warp: ptxas caps each thread of a 9- or 12-warp CTA at 168
// registers (see flash_bwd_dkv.cu), and 8 warps leave room for S, P, and
// O at once.
//
// route 0, CUDA cores (f32, and bf16 at any other head dim up to 256):
// one CTA of 8 warps serves 32 query rows that share one K/V tile in
// shared memory.  Those rows are all `group` query heads of ONE kv head
// over 32 / group consecutive positions (the TPU kernel's GQA reuse).  Each
// warp owns 4 rows; lane j scores key j of the 32-key tile, the warp
// reduces max and sum with shuffles, and the P.V product walks the tile
// with each lane owning D/32 output channels, all as f32 FMA loops (67
// TFLOP/s peak).  It stays for f32, where the tensor cores would compute in
// TF32 (about three decimal digits, short of the f32 checks' 1e-4), and
// for head dims that do not tile by 64 (LlamaConfig.tiny()'s 16): f32 at
// 64 and 128 runs instances with 16-byte tile loads; any other head dim up
// to 256 runs an instance padded to the next of 32/64/128/256 channels,
// with scalar loads and the padding zeroed in shared memory (bf16 at 64
// and 128 has no instance here: route 1 takes it).  Ragged T and S
// edges mask in-kernel in both instances, so every shape runs here.

#include "common.cuh"
#include "sm90.cuh"

#include <math.h>

#include <type_traits>

namespace {

using namespace kubetpu;

// -- route 0: CUDA cores -------------------------------------------------------

constexpr float LN2 = 0.6931471805599453f;
constexpr int ROWS = 32;   // query rows per CTA
constexpr int BK = 32;     // keys per tile, one per lane
constexpr int WARPS = 8;
constexpr int RPW = ROWS / WARPS;

// DP: channels held per row (a multiple of 32); FULL: the head dim is DP.
// Otherwise the head dim is Dh < DP and channels Dh..DP-1 are zero.
template <typename T, int DP, bool FULL>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int Tq, int S,
                 int Dh, int gc, int bq, int n_gchunks, int causal,
                 float sscale) {
    constexpr int D = DP;
    constexpr int DPL = D / 32;
    const int Dg = FULL ? D : Dh;      // row stride in global memory
    extern __shared__ float smem[];
    float* qs = smem;                  // [ROWS][D]
    float* ks = qs + ROWS * D;         // [BK][D + 1]  (padded: lane j reads row j)
    float* vs = ks + BK * (D + 1);     // [BK][D]

    const int G = Hq / Hkv;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int by = blockIdx.y;
    const int gchunk = by % n_gchunks;
    by /= n_gchunks;
    const int hk = by % Hkv;
    const int b = by / Hkv;
    const int q0 = blockIdx.x * bq;
    const int off = S - Tq;   // end-aligned causal offset

    // CTA row r is query head gchunk * gc + r / bq at position q0 + r % bq.
    load_tile<T, D, FULL>(qs, D, ROWS, Dh, [&](int r) -> const T* {
        const int gl = r / bq, g = gchunk * gc + gl, qi = q0 + r % bq;
        if (gl >= gc || g >= G || qi >= Tq) return nullptr;
        return q + (((size_t)b * Hq + hk * G + g) * Tq + qi) * Dg;
    });

    int qi_r[RPW], h_r[RPW];
    bool ok_r[RPW];
    bool warp_live = false;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int r = warp * RPW + i;
        const int gl = r / bq, g = gchunk * gc + gl;
        qi_r[i] = q0 + r % bq;
        h_r[i] = hk * G + g;
        ok_r[i] = gl < gc && g < G && qi_r[i] < Tq;
        warp_live |= ok_r[i];
    }

    float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
    }

    int n_kt = (S + BK - 1) / BK;
    if (causal) {
        // key tiles wholly past the last row's horizon contribute nothing
        const int q_last = min(q0 + bq, Tq) - 1;
        n_kt = min(n_kt, (off + q_last) / BK + 1);
    }
    const T* kb = k + ((size_t)b * Hkv + hk) * S * Dg;
    const T* vb = v + ((size_t)b * Hkv + hk) * S * Dg;

    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();   // the previous tile is consumed (and qs is loaded)
        load_tile<T, D, FULL>(ks, D + 1, BK, Dh, [&](int j) -> const T* {
            return k0 + j < S ? kb + (size_t)(k0 + j) * Dg : nullptr;
        });
        load_tile<T, D, FULL>(vs, D, BK, Dh, [&](int j) -> const T* {
            return k0 + j < S ? vb + (size_t)(k0 + j) * Dg : nullptr;
        });
        __syncthreads();
        if (!warp_live) continue;

        const int key = k0 + lane;
        float s[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) s[i] = 0.f;
        const float* krow = ks + lane * (D + 1);
        const float* qrow = qs + warp * RPW * D;
#pragma unroll 8
        for (int dd = 0; dd < D; ++dd) {
            const float kv = krow[dd];
#pragma unroll
            for (int i = 0; i < RPW; ++i) s[i] = fmaf(qrow[i * D + dd], kv, s[i]);
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
            const bool valid = ok_r[i] && key < S &&
                               (!causal || key <= qi_r[i] + off);
            const float sc = valid ? s[i] * sscale : NEG_INF;
            const float m_new = fmaxf(m[i], warp_max(sc));
            // NEG_INF is finite: mask the exponent explicitly
            const float p = valid ? exp2f(sc - m_new) : 0.f;
            const float alpha = exp2f(m[i] - m_new);
            l[i] = l[i] * alpha + warp_sum(p);
            m[i] = m_new;
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[i][d] *= alpha;
            s[i] = p;
        }
        for (int jj = 0; jj < BK; ++jj) {
            float vv[DPL];
#pragma unroll
            for (int d = 0; d < DPL; ++d) vv[d] = vs[jj * D + lane + 32 * d];
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                const float pj = __shfl_sync(FULL_MASK, s[i], jj);
#pragma unroll
                for (int d = 0; d < DPL; ++d) acc[i][d] = fmaf(pj, vv[d], acc[i][d]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        if (!ok_r[i]) continue;
        const float l_safe = fmaxf(l[i], 1e-30f);
        const size_t row = ((size_t)b * Hq + h_r[i]) * Tq + qi_r[i];
#pragma unroll
        for (int d = 0; d < DPL; ++d)
            if (FULL || lane + 32 * d < Dh)
                o[row * Dg + lane + 32 * d] = from_f<T>(acc[i][d] / l_safe);
        if (lse != nullptr && lane == 0)
            lse[row] = m[i] * LN2 + logf(l_safe);   // natural log
    }
}

template <typename T, int DP, bool FULL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Hq, int Hkv, int Tq, int S, int Dh,
                   int causal, cudaStream_t stream) {
    const int G = Hq / Hkv;
    const int gc = G < ROWS ? G : ROWS;   // query heads per CTA
    const int bq = ROWS / gc;             // query positions per CTA
    const int n_gchunks = (G + gc - 1) / gc;
    const float sscale =
        (float)(1.0 / sqrt((double)Dh) * 1.4426950408889634);
    const size_t smem = (size_t)(ROWS * DP + BK * (DP + 1) + BK * DP) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DP, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Tq + bq - 1) / bq, B * Hkv * n_gchunks);
    flash_fwd_kernel<T, DP, FULL><<<grid, WARPS * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), Hq, Hkv, Tq, S, Dh, gc, bq, n_gchunks,
        causal, sscale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int Hq, int Hkv, int Tq, int S, int D,
                       int causal, cudaStream_t st) {
    if constexpr (std::is_same<T, float>::value) {
        if (D == 64) return launch<T, 64, true>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
        if (D == 128) return launch<T, 128, true>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
    } else if (D == 64 || D == 128) {
        return cudaErrorInvalidValue;   // bf16 here runs on route 1
    }
    if (D < 1) return cudaErrorInvalidValue;
    if (D <= 32) return launch<T, 32, false>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
    if (D <= 64) return launch<T, 64, false>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
    if (D <= 128) return launch<T, 128, false>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
    if (D <= 256) return launch<T, 256, false>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
    return cudaErrorInvalidValue;
}


// -- route 1: tensor cores -----------------------------------------------------

namespace tc {

using namespace kubetpu::sm90;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;        // query rows per CTA: two warpgroups of 64
constexpr int BN = 128;        // keys per K/V tile
constexpr int STAGES = 3;
constexpr int THREADS = 256;

// Shared memory (bytes): Q [D/64][BM][64], then the K and V rings
// [STAGES][D/64][BN][64], each box 1024-byte aligned; then the mbarriers.
template <int D> struct Smem {
    static constexpr int Q = 0;
    static constexpr int K = Q + BM * D * 2;
    static constexpr int V = K + STAGES * BN * D * 2;
    static constexpr int BAR = V + STAGES * BN * D * 2;
    static constexpr int BYTES = BAR + (1 + 4 * STAGES) * 8;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
             float* __restrict__ lse, int Hq, int Hkv, int Tq, int S,
             int causal, float sscale, int n_mb, int n_bh) {
    using L = Smem<D>;
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
    uint64_t* k_full = q_full + 1;
    uint64_t* v_full = k_full + STAGES;
    uint64_t* k_empty = v_full + STAGES;
    uint64_t* v_empty = k_empty + STAGES;

    const int bh = blockIdx.x % n_bh;              // b * Hq + h
    const int mb = n_mb - 1 - blockIdx.x / n_bh;   // longest causal tiles first
    const int bhk = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
    const int m0 = mb * BM;
    const int off = S - Tq;   // end-aligned causal offset
    int n_kt = (S + BN - 1) / BN;
    if (causal)   // key tiles wholly past the last row's horizon
        n_kt = min(n_kt, (off + min(m0 + BM, Tq) - 1) / BN + 1);

    // Thread 0 also issues every TMA load (a producer warp would cost the
    // consumers registers: see the header).  K and V have rings of their
    // own, so a K stage is refilled as soon as its S = Q.K^T is done.
    const bool loader = threadIdx.x == 0;
    int k_next = 0, v_next = 0;   // the loader's next K / V tile to issue
    auto load_k = [&](int n, int s) {
        mbar_expect_tx(k_full + s, BN * D * 2);
        tma_load_rows<D>(smem + L::K + s * BN * D * 2, &tm_k, BN, n * BN, bhk,
                         k_full + s);
    };
    auto load_v = [&](int n, int s) {
        mbar_expect_tx(v_full + s, BN * D * 2);
        tma_load_rows<D>(smem + L::V + s * BN * D * 2, &tm_v, BN, n * BN, bhk,
                         v_full + s);
    };
    // every tile up to `need` issued (waiting if it must), then as many
    // more as free stages allow
    auto feed = [&](int need_k, int need_v) {
        if (loader) {
            ring_feed<STAGES>(k_next, min(need_k, n_kt), k_empty, true, load_k);
            ring_feed<STAGES>(v_next, min(need_v, n_kt), v_empty, true, load_v);
            ring_feed<STAGES>(k_next, n_kt, k_empty, false, load_k);
            ring_feed<STAGES>(v_next, n_kt, v_empty, false, load_v);
        }
        __syncwarp();
    };

    if (loader) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(k_full + s, 1);
            mbar_init(v_full + s, 1);
            mbar_init(k_empty + s, THREADS / 32);   // one arrival a warp
            mbar_init(v_empty + s, THREADS / 32);
        }
        mbar_fence_init();
    }
    __syncthreads();
    if (loader) {
        mbar_expect_tx(q_full, BM * D * 2);
        tma_load_rows<D>(smem + L::Q, &tm_q, BM, m0, bh, q_full);
    }
    feed(STAGES, STAGES);

    const int c = threadIdx.x / 128;    // this warpgroup's 64 rows
    const int lane = threadIdx.x % 32;
    const int r0 = 16 * (threadIdx.x % 128 / 32) + lane / 4;   // rows r0, r0 + 8
    const int cq = 2 * (lane % 4);      // columns 8j + cq + {0, 1}
    const int qbase = m0 + 64 * c;
    const uint32_t q_addr = smem_u32(smem + L::Q) + c * 64 * 128;

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
    uint32_t pa[BN / 16][4];   // p of the previous tile in bf16, as the
                               // reference rounds it before P.V

    // S = Q.K^T of tile n into sacc (issued, not waited for)
    auto issue_s = [&](int n, float (&sacc)[BN / 2]) {
        const int s = n % STAGES;
        mbar_wait(k_full + s, (n / STAGES) & 1);
        const uint32_t k_addr = smem_u32(smem + L::K + s * BN * D * 2);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
            wgmma_ss<BN, 0>(sacc, desc_kmajor(q_addr, j, BM * 128),
                            desc_kmajor(k_addr, j, BN * 128), j > 0);
        wgmma_commit();
    };
    // O += P.V of tile n, from pa (issued, not waited for)
    auto issue_pv = [&](int n) {
        const int s = n % STAGES;
        mbar_wait(v_full + s, (n / STAGES) & 1);
        const uint32_t v_addr = smem_u32(smem + L::V + s * BN * D * 2);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BN / 16; ++j)
            wgmma_rs<D, 1>(oacc, pa[j], desc_mnmajor(v_addr, j, BN * 128), 1);
        wgmma_commit();
    };
    // the online softmax of tile n's scores: sacc becomes p (f32), and
    // the rows' new max, their rescale factors and partial sums come back
    auto softmax = [&](int n, float (&sacc)[BN / 2], float (&alpha)[2],
                       float (&ls)[2]) {
        const int k0 = n * BN;
        // the raw max first; the scale folds into one FFMA an element
        float mx[2] = {NEG_INF, NEG_INF};
        if (k0 + BN > S || (causal && k0 + BN - 1 > qbase + off)) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) {
                const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
                const int qi = qbase + r0 + 8 * ((i >> 1) & 1);
                const bool ok = (key < S) & (!causal | (key <= qi + off));
                sacc[i] = ok ? sacc[i] : NEG_INF;
                mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
            }
        } else {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i)
                mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL_MASK, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL_MASK, mx[h], 2));
            mx[h] = fmaxf(m_r[h], mx[h] * sscale);
            alpha[h] = exp2_approx(m_r[h] - mx[h]);
            m_r[h] = mx[h];
            ls[h] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
            const int h = (i >> 1) & 1;
            // NEG_INF is finite: a masked score's p is zeroed explicitly
            const float p = sacc[i] == NEG_INF
                ? 0.f : exp2_approx(fmaf(sacc[i], sscale, -m_r[h]));
            ls[h] += p;
            sacc[i] = p;
        }
    };

    mbar_wait(q_full, 0);
    if (n_kt > 0) {
        float sacc[BN / 2], alpha[2], ls[2];
        issue_s(0, sacc);
        wgmma_wait<0>();
        fence_regs(sacc);
        mbar_arrive_warp(k_empty);
        softmax(0, sacc, alpha, ls);
        l_r[0] = ls[0];
        l_r[1] = ls[1];
        acc_to_a<BN>(sacc, pa);
        // FA3's overlap: S of tile n is issued before P.V of tile n - 1,
        // so the softmax of tile n runs while P.V of tile n - 1 does
        for (int n = 1; n < n_kt; ++n) {
            feed(n + 1, n);
            issue_s(n, sacc);
            issue_pv(n - 1);
            wgmma_wait<1>();   // S of tile n has landed
            fence_regs(sacc);
            mbar_arrive_warp(k_empty + n % STAGES);
            softmax(n, sacc, alpha, ls);
            wgmma_wait<0>();   // P.V of tile n - 1 too
            fence_regs(oacc);
            mbar_arrive_warp(v_empty + (n - 1) % STAGES);
            feed(0, 0);
#pragma unroll
            for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + ls[h];
#pragma unroll
            for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
            acc_to_a<BN>(sacc, pa);
        }
        feed(n_kt, n_kt);
        issue_pv(n_kt - 1);
        wgmma_wait<0>();
        fence_regs(oacc);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l_r[h] += __shfl_xor_sync(FULL_MASK, l_r[h], 1);
        l_r[h] += __shfl_xor_sync(FULL_MASK, l_r[h], 2);
        const int qi = qbase + r0 + 8 * h;
        if (qi >= Tq) continue;
        const float l_safe = fmaxf(l_r[h], 1e-30f);
        const size_t row = (size_t)bh * Tq + qi;
        bf16* orow = o + row * D + cq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(orow + 8 * j) =
                pack_bf16(oacc[4 * j + 2 * h] / l_safe,
                          oacc[4 * j + 2 * h + 1] / l_safe);
        if (lse != nullptr && cq == 0)
            lse[row] = m_r[h] * LN2 + logf(l_safe);   // natural log
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Hq, int Hkv, int Tq, int S,
                   int causal, cudaStream_t stream) {
    CUtensorMap mq, mk, mv;
    if (!map_rows_bf16(&mq, q, B * Hq, Tq, D, BM) ||
        !map_rows_bf16(&mk, k, B * Hkv, S, D, BN) ||
        !map_rows_bf16(&mv, v, B * Hkv, S, D, BN))
        return cudaErrorInvalidValue;
    const int n_mb = (Tq + BM - 1) / BM, n_bh = B * Hq;
    const float sscale = (float)(1.0 / sqrt((double)D) * 1.4426950408889634);
    const int smem = Smem<D>::BYTES + 1024;   // + the 1024-byte alignment
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_tc<D><<<n_mb * n_bh, THREADS, smem, stream>>>(
        mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), Hq, Hkv,
        Tq, S, causal, sscale, n_mb, n_bh);
    return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q [B, Hq, T, D]; k/v [B, Hkv, S, D] (contiguous, f32 or bf16, D <= 256);
// o like q; lse f32 [B, Hq, T] or null.  route 1: the tensor-core instance
// (bf16, D 64 or 128, 16-byte aligned pointers), 0: the CUDA-core one.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a shape the
// route cannot take).
extern "C" int kubetpu_flash_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int Hq, int Hkv,
                                 int Tq, int S, int D, int causal, int is_bf16,
                                 int route, void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0 || (causal && Tq > S)) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (route == 1) {
        if (!is_bf16) return cudaErrorInvalidValue;
        if (D == 64) return tc::launch<64>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, causal, st);
        if (D == 128) return tc::launch<128>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, causal, st);
        return cudaErrorInvalidValue;
    }
    if (route != 0) return cudaErrorInvalidValue;
    if (is_bf16)
        return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
    return dispatch_d<float>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
}
