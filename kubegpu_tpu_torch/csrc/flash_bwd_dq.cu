// Flash-attention backward, dq, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dq_kernel` inside `flash_attention_bwd`
// (kubegpu_tpu/ops/flash_attention.py:383, pallas_call at :500): dq from the
// recomputed probabilities, with no T x S residual.  Per key tile,
//   p  = exp2(q.k * scale*log2e - lse*log2e)   (lse saved in natural log)
//   dp = dO.v,   ds = p * (dp - delta) * scale  (ds keeps the NATURAL scale:
//                                                the fold only re-bases exp)
//   dq += ds . K
// with the end-aligned causal mask qpos + (s - t) >= kpos.  delta =
// rowsum(dO o O) comes in precomputed, as on the TPU.  Every CTA writes its
// own rows of dq from f32 registers: no atomics, and two runs give equal
// bits.
//
// Two instances, chosen by `route` (ops/flash_attention.py `_flash_route`
// holds the rule; this file refuses a route that cannot take the shape):
//
// route 1, tensor cores (bf16 at head dims 64 and 128).  What bounds it on
// the H100: at the training shape (q/dO [4, 32, 2048, 128] and k/v
// [4, 8, 2048, 128], causal) it moves ~0.23 GB and does three causal
// products, ~2.1e11 FLOP: the tensor cores bind it (~0.21 ms against
// ~0.07 ms of memory).  Design: a CTA owns 128 query rows of one query head
// with two warpgroups of 64.  Q and dO, with their lse and delta, come in
// once by TMA; 64-key K and V tiles stream through a 3-stage ring (TMA, an
// mbarrier per stage), which the CTA's first thread keeps filled between
// its own products (no producer warp: ptxas caps each thread of a 9- or
// 12-warp CTA at 168 registers, see flash_bwd_dkv.cu).  Per tile and
// warpgroup, S = Q.K^T and dP = dO.V^T are SS wgmmas with K and V K-major;
// p = exp2 of S is formed on the accumulator fragment while dP runs, then
// dS = p (dP - delta) scale, rounded to bf16 in registers as the reference
// rounds ds, is the A operand of dQ += dS.K, an RS wgmma with K as the
// MN-major B (the transpose flag).  The 64 x D f32 dQ accumulator stays in
// registers across all key tiles (64 a thread at D = 128); 64-key tiles
// keep S and dP at 32 registers each.  Masks: key tiles past the CTA's last
// row are never loaded, a warpgroup skips the tiles past its own last row,
// and only a tile on the causal diagonal or a ragged edge tests the mask,
// as one uniform branch with selects inside (a masked p is zeroed
// explicitly: NEG_INF is finite and zero-filled rows score 0).  The CTAs
// with the most key tiles (the latest queries) are scheduled first, and the
// G query heads of one kv head are adjacent in the grid, so their K/V come
// from L2.
//
// route 0, CUDA cores (f32, and bf16 at other head dims; f32 on the tensor
// cores would be TF32, short of the f32 checks' 1e-4): as the forward's
// (csrc/flash_fwd.cu).  One CTA of 8 warps owns 32 query rows that are all
// `group` query heads of ONE kv head over 32 / group positions, so one K/V
// tile in shared memory serves the whole group; the key axis is a loop
// inside the CTA up to the causal horizon of its last row.  Each warp owns
// 4 rows; lane j scores key j of the 32-key tile (s and dp), and in the dq
// update each lane owns D/32 channels while ds is broadcast from lane jj by
// a shuffle, as f32 FMA loops (67 TFLOP/s peak).  f32 at head dims 64 and
// 128 runs instances with 16-byte loads, any other head dim up to 256 an
// instance padded to 32/64/128/256 channels with the padding zeroed in
// shared memory (bf16 at 64 and 128 has no instance here: route 1 takes
// it).  Ragged T and S edges mask in-kernel in both instances.

#include "common.cuh"
#include "sm90.cuh"

#include <math.h>

#include <type_traits>

namespace {

using namespace kubetpu;

// -- route 0: CUDA cores -------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROWS = 32;   // query rows per CTA
constexpr int BK = 32;     // keys per tile, one per lane
constexpr int WARPS = 8;
constexpr int RPW = ROWS / WARPS;

template <typename T, int DP, bool FULL>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Hq, int Hkv, int Tq, int S, int Dh, int gc, int bq,
                    int n_gchunks, int causal, float sscale, float scale) {
    constexpr int D = DP;
    constexpr int DPL = D / 32;
    const int Dg = FULL ? D : Dh;      // row stride in global memory
    extern __shared__ float smem[];
    float* qs = smem;                  // [ROWS][D]
    float* dos = qs + ROWS * D;        // [ROWS][D]
    float* ks = dos + ROWS * D;        // [BK][D + 1]  (lane j reads row j)
    float* vs = ks + BK * (D + 1);     // [BK][D + 1]

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

    // CTA row r is query head gchunk * gc + r / bq at position q0 + r % bq
    auto row_index = [&](int r) -> long long {
        const int gl = r / bq, g = gchunk * gc + gl, qi = q0 + r % bq;
        if (gl >= gc || g >= G || qi >= Tq) return -1;
        return ((long long)b * Hq + hk * G + g) * Tq + qi;
    };
    load_tile<T, D, FULL>(qs, D, ROWS, Dh, [&](int r) -> const T* {
        const long long i = row_index(r);
        return i < 0 ? nullptr : q + i * Dg;
    });
    load_tile<T, D, FULL>(dos, D, ROWS, Dh, [&](int r) -> const T* {
        const long long i = row_index(r);
        return i < 0 ? nullptr : dout + i * Dg;
    });

    int qi_r[RPW];
    long long row_r[RPW];
    float lse2_r[RPW], dl_r[RPW];
    bool warp_live = false;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int r = warp * RPW + i;
        qi_r[i] = q0 + r % bq;
        row_r[i] = row_index(r);
        const bool ok = row_r[i] >= 0;
        lse2_r[i] = ok ? lse[row_r[i]] * LOG2E : 0.f;
        dl_r[i] = ok ? delta[row_r[i]] : 0.f;
        warp_live |= ok;
    }

    float acc[RPW][DPL];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;

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
        load_tile<T, D, FULL>(vs, D + 1, BK, Dh, [&](int j) -> const T* {
            return k0 + j < S ? vb + (size_t)(k0 + j) * Dg : nullptr;
        });
        __syncthreads();
        if (!warp_live) continue;

        const int key = k0 + lane;
        float s[RPW], dp[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) s[i] = dp[i] = 0.f;
        const float* krow = ks + lane * (D + 1);
        const float* vrow = vs + lane * (D + 1);
        const float* qrow = qs + warp * RPW * D;
        const float* dorow = dos + warp * RPW * D;
#pragma unroll 8
        for (int dd = 0; dd < D; ++dd) {
            const float kv = krow[dd], vv = vrow[dd];
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                s[i] = fmaf(qrow[i * D + dd], kv, s[i]);
                dp[i] = fmaf(dorow[i * D + dd], vv, dp[i]);
            }
        }
        float ds[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
            const bool valid = row_r[i] >= 0 && key < S &&
                               (!causal || key <= qi_r[i] + off);
            // NEG_INF is finite: mask the probability explicitly
            const float p = valid ? exp2f(s[i] * sscale - lse2_r[i]) : 0.f;
            ds[i] = p * (dp[i] - dl_r[i]) * scale;
        }
        for (int jj = 0; jj < BK; ++jj) {
            float kk[DPL];
#pragma unroll
            for (int d = 0; d < DPL; ++d) kk[d] = ks[jj * (D + 1) + lane + 32 * d];
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                const float dsj = __shfl_sync(FULL_MASK, ds[i], jj);
#pragma unroll
                for (int d = 0; d < DPL; ++d) acc[i][d] = fmaf(dsj, kk[d], acc[i][d]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        if (row_r[i] < 0) continue;
#pragma unroll
        for (int d = 0; d < DPL; ++d)
            if (FULL || lane + 32 * d < Dh)
                dq[row_r[i] * Dg + lane + 32 * d] = from_f<T>(acc[i][d]);
    }
}

template <typename T, int DP, bool FULL>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int Hq, int Hkv, int Tq, int S, int Dh,
                   int causal, cudaStream_t stream) {
    const int G = Hq / Hkv;
    const int gc = G < ROWS ? G : ROWS;   // query heads per CTA
    const int bq = ROWS / gc;             // query positions per CTA
    const int n_gchunks = (G + gc - 1) / gc;
    const double scale = 1.0 / sqrt((double)Dh);
    const size_t smem =
        (size_t)(2 * ROWS * DP + 2 * BK * (DP + 1)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, DP, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Tq + bq - 1) / bq, B * Hkv * n_gchunks);
    flash_bwd_dq_kernel<T, DP, FULL><<<grid, WARPS * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), Hq, Hkv, Tq, S, Dh, gc, bq, n_gchunks, causal,
        (float)(scale * 1.4426950408889634), (float)scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int B, int Hq, int Hkv, int Tq, int S, int D,
                       int causal, cudaStream_t st) {
#define KUBETPU_DQ(DP, FULL) \
    launch<T, DP, FULL>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Tq, S, D, causal, st)
    if constexpr (std::is_same<T, float>::value) {
        if (D == 64) return KUBETPU_DQ(64, true);
        if (D == 128) return KUBETPU_DQ(128, true);
    } else if (D == 64 || D == 128) {
        return cudaErrorInvalidValue;   // bf16 here runs on route 1
    }
    if (D < 1) return cudaErrorInvalidValue;
    if (D <= 32) return KUBETPU_DQ(32, false);
    if (D <= 64) return KUBETPU_DQ(64, false);
    if (D <= 128) return KUBETPU_DQ(128, false);
    if (D <= 256) return KUBETPU_DQ(256, false);
#undef KUBETPU_DQ
    return cudaErrorInvalidValue;
}


// -- route 1: tensor cores -----------------------------------------------------

namespace tc {

using namespace kubetpu::sm90;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;        // query rows per CTA: two warpgroups of 64
constexpr int BN = 64;         // keys per K/V tile
constexpr int STAGES = 3;
constexpr int THREADS = 256;

// Shared memory (bytes): Q and dO [D/64][BM][64], then the K and V rings
// [STAGES][D/64][BN][64] (boxes 1024-byte aligned), lse and delta [BM] f32,
// then the mbarriers.
template <int D> struct Smem {
    static constexpr int Q = 0;
    static constexpr int DO = Q + BM * D * 2;
    static constexpr int K = DO + BM * D * 2;
    static constexpr int V = K + STAGES * BN * D * 2;
    static constexpr int LSE = V + STAGES * BN * D * 2;
    static constexpr int DELTA = LSE + BM * 4;
    static constexpr int BAR = DELTA + BM * 4;
    static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_lse,
                const __grid_constant__ CUtensorMap tm_delta,
                bf16* __restrict__ dq, int Hq, int Hkv, int Tq, int S,
                int causal, float sscale, float scale, int n_mb, int n_bh) {
    using L = Smem<D>;
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
    uint64_t* full = q_full + 1;
    uint64_t* empty = full + STAGES;

    const int bh = blockIdx.x % n_bh;              // b * Hq + h
    const int mb = n_mb - 1 - blockIdx.x / n_bh;   // longest causal tiles first
    const int bhk = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
    const int m0 = mb * BM;
    const int off = S - Tq;   // end-aligned causal offset
    int n_kt = (S + BN - 1) / BN;
    if (causal)   // key tiles wholly past the last row's horizon
        n_kt = min(n_kt, (off + min(m0 + BM, Tq) - 1) / BN + 1);

    // Thread 0 also issues every TMA load (a producer warp would cost the
    // consumers registers: see the header).
    const bool loader = threadIdx.x == 0;
    int next = 0;   // the loader's next K/V tile to issue
    auto load = [&](int n, int s) {
        mbar_expect_tx(full + s, 2 * BN * D * 2);
        tma_load_rows<D>(smem + L::K + s * BN * D * 2, &tm_k, BN, n * BN, bhk,
                         full + s);
        tma_load_rows<D>(smem + L::V + s * BN * D * 2, &tm_v, BN, n * BN, bhk,
                         full + s);
    };
    // every tile up to `need` issued (waiting if it must), then as many
    // more as free stages allow
    auto feed = [&](int need) {
        if (loader) {
            ring_feed<STAGES>(next, min(need, n_kt), empty, true, load);
            ring_feed<STAGES>(next, n_kt, empty, false, load);
        }
        __syncwarp();
    };

    if (loader) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, THREADS / 32);   // one arrival a warp
        }
        mbar_fence_init();
    }
    __syncthreads();
    if (loader) {
        mbar_expect_tx(q_full, 2 * BM * D * 2 + 2 * BM * 4);
        tma_load_rows<D>(smem + L::Q, &tm_q, BM, m0, bh, q_full);
        tma_load_rows<D>(smem + L::DO, &tm_do, BM, m0, bh, q_full);
        // [B*Hq*T] flat: a ragged tile's tail reads the next head's values
        // (or zeros), which the mask below never uses
        tma_load_1d(smem + L::LSE, &tm_lse, bh * Tq + m0, q_full);
        tma_load_1d(smem + L::DELTA, &tm_delta, bh * Tq + m0, q_full);
    }
    feed(STAGES);

    const int c = threadIdx.x / 128;    // this warpgroup's 64 rows
    const int lane = threadIdx.x % 32;
    const int r0 = 16 * (threadIdx.x % 128 / 32) + lane / 4;   // rows r0, r0 + 8
    const int cq = 2 * (lane % 4);      // columns 8j + cq + {0, 1}
    const int qbase = m0 + 64 * c;
    const uint32_t q_addr = smem_u32(smem + L::Q) + c * 64 * 128;
    const uint32_t do_addr = smem_u32(smem + L::DO) + c * 64 * 128;
    // this warpgroup's key tiles: none past its last row's horizon, none
    // at all when its rows lie past T
    int my_kt = qbase < Tq ? n_kt : 0;
    if (causal && qbase < Tq)
        my_kt = min(my_kt, (off + min(qbase + 64, Tq) - 1) / BN + 1);

    float dqacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;

    mbar_wait(q_full, 0);
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = 64 * c + r0 + 8 * h;
        lse2[h] = reinterpret_cast<const float*>(smem + L::LSE)[r] * LOG2E;
        dl[h] = reinterpret_cast<const float*>(smem + L::DELTA)[r];
    }

    for (int n = 0; n < n_kt; ++n) {
        const int s = n % STAGES;
        feed(n + 1);
        // a warpgroup that skips the tile waits for it all the same: its
        // release below then never runs ahead of the ring
        mbar_wait(full + s, (n / STAGES) & 1);
        if (n < my_kt) {
            const int k0 = n * BN;
            const uint32_t k_addr = smem_u32(smem + L::K + s * BN * D * 2);
            const uint32_t v_addr = smem_u32(smem + L::V + s * BN * D * 2);
            float sacc[BN / 2], dpacc[BN / 2];
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) sacc[i] = dpacc[i] = 0.f;
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < D / 16; ++j)
                wgmma_ss<BN, 0>(sacc, desc_kmajor(q_addr, j, BM * 128),
                                desc_kmajor(k_addr, j, BN * 128), j > 0);
            wgmma_commit();
#pragma unroll
            for (int j = 0; j < D / 16; ++j)
                wgmma_ss<BN, 0>(dpacc, desc_kmajor(do_addr, j, BM * 128),
                                desc_kmajor(v_addr, j, BN * 128), j > 0);
            wgmma_commit();
            wgmma_wait<1>();   // S has landed; dP still runs
            fence_regs(sacc);

            // p = exp2(s * scale * log2e - lse * log2e); the mask only where
            // the tile crosses the causal diagonal or a ragged edge, one
            // uniform branch a tile with selects inside
            if (k0 + BN > S || qbase + 64 > Tq ||
                (causal && k0 + BN - 1 > qbase + off)) {
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) {
                    const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
                    const int qi = qbase + r0 + 8 * ((i >> 1) & 1);
                    const bool ok = (qi < Tq) & (key < S) &
                                    (!causal | (key <= qi + off));
                    // NEG_INF is finite: mask the probability explicitly
                    const float p = exp2_approx(
                        fmaf(sacc[i], sscale, -lse2[(i >> 1) & 1]));
                    sacc[i] = ok ? p : 0.f;
                }
            } else {
#pragma unroll
                for (int i = 0; i < BN / 2; ++i)
                    sacc[i] = exp2_approx(
                        fmaf(sacc[i], sscale, -lse2[(i >> 1) & 1]));
            }
            wgmma_wait<0>();
            fence_regs(dpacc);
            // the stage is read once more, by dQ += dS.K below
#pragma unroll
            for (int i = 0; i < BN / 2; ++i)
                dpacc[i] = sacc[i] * (dpacc[i] - dl[(i >> 1) & 1]) * scale;
            // dQ += dS.K, with ds in bf16 as the reference rounds it
            uint32_t dsa[BN / 16][4];
            acc_to_a<BN>(dpacc, dsa);
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < BN / 16; ++j)
                wgmma_rs<D, 1>(dqacc, dsa[j], desc_mnmajor(k_addr, j, BN * 128),
                               1);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dqacc);
        }
        mbar_arrive_warp(empty + s);
        feed(0);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int qi = qbase + r0 + 8 * h;
        if (qi >= Tq) continue;
        bf16* row = dq + ((size_t)bh * Tq + qi) * D + cq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(
                dqacc[4 * j + 2 * h], dqacc[4 * j + 2 * h + 1]);
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int Hq, int Hkv, int Tq, int S, int causal,
                   cudaStream_t stream) {
    CUtensorMap mq, mk, mv, mdo, mlse, mdelta;
    const long long n_rows = (long long)B * Hq * Tq;
    if (!map_rows_bf16(&mq, q, B * Hq, Tq, D, BM) ||
        !map_rows_bf16(&mdo, dout, B * Hq, Tq, D, BM) ||
        !map_rows_bf16(&mk, k, B * Hkv, S, D, BN) ||
        !map_rows_bf16(&mv, v, B * Hkv, S, D, BN) ||
        !map_vec_f32(&mlse, lse, n_rows, BM) ||
        !map_vec_f32(&mdelta, delta, n_rows, BM))
        return cudaErrorInvalidValue;
    const double scale = 1.0 / sqrt((double)D);
    const int n_mb = (Tq + BM - 1) / BM, n_bh = B * Hq;
    const int smem = Smem<D>::BYTES + 1024;   // + the 1024-byte alignment
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_tc<D><<<n_mb * n_bh, THREADS, smem, stream>>>(
        mq, mk, mv, mdo, mlse, mdelta, static_cast<bf16*>(dq), Hq, Hkv, Tq,
        S, causal, (float)(scale * 1.4426950408889634), (float)scale, n_mb,
        n_bh);
    return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q/dout/dq [B, Hq, T, D]; k/v [B, Hkv, S, D] (contiguous, f32 or bf16,
// D <= 256); lse/delta f32 [B, Hq, T].  route 1: the tensor-core instance
// (bf16, D 64 or 128, 16-byte aligned pointers), 0: the CUDA-core one.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a shape the
// route cannot take).
extern "C" int kubetpu_flash_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int B, int Hq, int Hkv, int Tq,
                                    int S, int D, int causal, int is_bf16,
                                    int route, void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0 || (causal && Tq > S)) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (route == 1) {
        if (!is_bf16) return cudaErrorInvalidValue;
        if (D == 64) return tc::launch<64>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Tq, S, causal, st);
        if (D == 128) return tc::launch<128>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Tq, S, causal, st);
        return cudaErrorInvalidValue;
    }
    if (route != 0) return cudaErrorInvalidValue;
    if (is_bf16)
        return dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Tq, S, D, causal, st);
    return dispatch_d<float>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Tq, S, D, causal, st);
}
