// Flash-attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dkv_kernel` inside `flash_attention_bwd`
// (kubegpu_tpu/ops/flash_attention.py:425, pallas_call at :530): dk and dv
// of one kv head, summed over its query group, from the recomputed
// probabilities, with no T x S residual.  Per query tile,
//   p  = exp2(q.k * scale*log2e - lse*log2e)   (lse saved in natural log)
//   dp = dO.v,   ds = p * (dp - delta) * scale  (the NATURAL scale)
//   dv += p^T . dO,   dk += ds^T . Q
// with the end-aligned causal mask qpos + (s - t) >= kpos.  Each CTA owns a
// tile of keys of ONE kv head and loops over the group's query heads and,
// for each, over query tiles from the causal lower bound (the first tile
// holding a query that sees the CTA's first key) to the end.  dk and dv
// accumulate in f32 registers across the whole group, so the kernel writes
// Hkv heads directly, as the TPU kernel does: the group is summed in-kernel
// with no atomics, and two runs give equal bits.  Because the query tiles
// stream, no [group * T, D] panel has to stay resident, so the TPU's
// de-grouped fallback for panels that outgrow VMEM has no counterpart.
//
// Two instances, chosen by `route` (ops/flash_attention.py `_flash_route`):
//
// route 1, tensor cores (bf16 at head dims 64 and 128).  What bounds it on
// the H100: at the training shape (q/dO [4, 32, 2048, 128], k/v
// [4, 8, 2048, 128], causal) it moves ~0.18 GB and does four causal
// products, ~2.8e11 FLOP (it recomputes q.k as dq does): the tensor cores
// bind it (~0.28 ms against ~0.05 ms of memory).  Design: a CTA owns 128
// keys with two warpgroups of 64.  K and V come in once by TMA; 64-row Q
// and dO tiles, with their lse and delta, stream through a 3-stage ring
// (TMA, an mbarrier per stage; lse and delta only when T % 4 == 0, since a
// 1-D TMA box must start 16-byte aligned: at T = 197 each thread reads its
// columns' values from global memory), which the CTA's first thread keeps filled
// between its own products.  Each warpgroup computes key-major:
// S^T = K.Q^T and dP^T = V.dO^T are SS wgmmas; P^T comes from the
// accumulator fragment (lse is per query, so per column here: read from the
// stage in shared memory), is rounded to bf16 in registers as the reference
// rounds p before dV, and feeds dV += P^T.dO as the A operand of an RS
// wgmma (dO MN-major, the transpose flag); while that runs, dS^T =
// P^T (dP^T - delta) scale is formed, rounded to bf16 as the reference
// rounds ds, and fed to dK += dS^T.Q the same way.  The two 64 x D f32
// accumulators stay in registers for the whole group: 128 registers a
// thread at D = 128 before S^T and dP^T.  So there is no producer warp:
// ptxas gives each thread of a 9- or 12-warp CTA at most 168 registers (a
// scheduler's quarter of the file over its 3 warps) and spilled here, with
// or without setmaxnreg, while 8 warps get 255.  A masked p is zeroed
// explicitly by a select (not a branch an element:
// experiments/torch_flash_ab.py), since NEG_INF is finite and zero-filled
// rows score 0.  The CTAs with the earliest keys (the most query tiles
// under the causal mask) are scheduled first.
//
// route 0, CUDA cores (f32, and bf16 at other head dims; f32 on the tensor
// cores would be TF32, short of the f32 checks' 1e-4): one CTA of 8 warps
// owns 32 keys in shared memory and streams 32-row query tiles; each warp
// owns 4 keys, lane i scores query i of the tile (s and dp), and in the
// update each lane owns D/32 channels of dk and dv while p and ds are
// broadcast from lane ii by a shuffle, as f32 FMA loops (67 TFLOP/s peak).
// Ragged T and S edges mask in-kernel in both instances.  Head dims as
// csrc/flash_bwd_dq.cu, except that bf16 at 64 and 128 has no instance
// here (route 1 takes it).

#include "common.cuh"
#include "sm90.cuh"

#include <math.h>

#include <type_traits>

namespace {

using namespace kubetpu;

// -- route 0: CUDA cores -------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BKV = 32;    // keys per CTA
constexpr int BQ = 32;     // queries per tile, one per lane
constexpr int WARPS = 8;
constexpr int KPW = BKV / WARPS;

template <typename T, int DP, bool FULL>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Hq, int Hkv, int Tq, int S,
                     int Dh, int causal, float sscale, float scale) {
    constexpr int D = DP;
    constexpr int DPL = D / 32;
    const int Dg = FULL ? D : Dh;      // row stride in global memory
    extern __shared__ float smem[];
    float* ks = smem;                  // [BKV][D]  (read as broadcasts)
    float* vs = ks + BKV * D;          // [BKV][D]
    float* qs = vs + BKV * D;          // [BQ][D + 1]  (lane i reads row i)
    float* dos = qs + BQ * (D + 1);    // [BQ][D + 1]

    const int G = Hq / Hkv;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int hk = blockIdx.y % Hkv;
    const int b = blockIdx.y / Hkv;
    const int k0 = blockIdx.x * BKV;
    const int off = S - Tq;   // end-aligned causal offset

    const size_t kv_head = (size_t)b * Hkv + hk;
    const T* kb = k + kv_head * S * Dg;
    const T* vb = v + kv_head * S * Dg;
    load_tile<T, D, FULL>(ks, D, BKV, Dh, [&](int j) -> const T* {
        return k0 + j < S ? kb + (size_t)(k0 + j) * Dg : nullptr;
    });
    load_tile<T, D, FULL>(vs, D, BKV, Dh, [&](int j) -> const T* {
        return k0 + j < S ? vb + (size_t)(k0 + j) * Dg : nullptr;
    });

    int kj_r[KPW];
#pragma unroll
    for (int r = 0; r < KPW; ++r) kj_r[r] = k0 + warp * KPW + r;

    float acc_k[KPW][DPL], acc_v[KPW][DPL];
#pragma unroll
    for (int r = 0; r < KPW; ++r)
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc_k[r][d] = acc_v[r][d] = 0.f;

    // query tiles wholly before the first key's horizon see no key here
    const int qt_lo = causal ? max(0, k0 - off) / BQ : 0;
    const int n_qt = (Tq + BQ - 1) / BQ;
    const float* krows = ks + warp * KPW * D;
    const float* vrows = vs + warp * KPW * D;

    for (int g = 0; g < G; ++g) {
        const size_t head = (size_t)b * Hq + hk * G + g;
        const T* qb = q + head * Tq * Dg;
        const T* ob = dout + head * Tq * Dg;
        for (int qt = qt_lo; qt < n_qt; ++qt) {
            const int q0 = qt * BQ;
            __syncthreads();   // the previous tile is consumed
            load_tile<T, D, FULL>(qs, D + 1, BQ, Dh, [&](int i) -> const T* {
                return q0 + i < Tq ? qb + (size_t)(q0 + i) * Dg : nullptr;
            });
            load_tile<T, D, FULL>(dos, D + 1, BQ, Dh, [&](int i) -> const T* {
                return q0 + i < Tq ? ob + (size_t)(q0 + i) * Dg : nullptr;
            });
            __syncthreads();

            const int qi = q0 + lane;
            const bool row_ok = qi < Tq;
            const float lse2 = row_ok ? lse[head * Tq + qi] * LOG2E : 0.f;
            const float dl = row_ok ? delta[head * Tq + qi] : 0.f;
            float s[KPW], dp[KPW];
#pragma unroll
            for (int r = 0; r < KPW; ++r) s[r] = dp[r] = 0.f;
            const float* qrow = qs + lane * (D + 1);
            const float* dorow = dos + lane * (D + 1);
#pragma unroll 8
            for (int dd = 0; dd < D; ++dd) {
                const float qv = qrow[dd], ov = dorow[dd];
#pragma unroll
                for (int r = 0; r < KPW; ++r) {
                    s[r] = fmaf(qv, krows[r * D + dd], s[r]);
                    dp[r] = fmaf(ov, vrows[r * D + dd], dp[r]);
                }
            }
            float p[KPW], ds[KPW];
#pragma unroll
            for (int r = 0; r < KPW; ++r) {
                const bool valid = row_ok && kj_r[r] < S &&
                                   (!causal || kj_r[r] <= qi + off);
                // NEG_INF is finite: mask the probability explicitly
                p[r] = valid ? exp2f(s[r] * sscale - lse2) : 0.f;
                ds[r] = p[r] * (dp[r] - dl) * scale;
            }
            for (int ii = 0; ii < BQ; ++ii) {
                float qq[DPL], oo[DPL];
#pragma unroll
                for (int d = 0; d < DPL; ++d) {
                    qq[d] = qs[ii * (D + 1) + lane + 32 * d];
                    oo[d] = dos[ii * (D + 1) + lane + 32 * d];
                }
#pragma unroll
                for (int r = 0; r < KPW; ++r) {
                    const float pi = __shfl_sync(FULL_MASK, p[r], ii);
                    const float dsi = __shfl_sync(FULL_MASK, ds[r], ii);
#pragma unroll
                    for (int d = 0; d < DPL; ++d) {
                        acc_v[r][d] = fmaf(pi, oo[d], acc_v[r][d]);
                        acc_k[r][d] = fmaf(dsi, qq[d], acc_k[r][d]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < KPW; ++r) {
        if (kj_r[r] >= S) continue;
        const size_t row = (kv_head * S + kj_r[r]) * Dg;
#pragma unroll
        for (int d = 0; d < DPL; ++d)
            if (FULL || lane + 32 * d < Dh) {
                dk[row + lane + 32 * d] = from_f<T>(acc_k[r][d]);
                dv[row + lane + 32 * d] = from_f<T>(acc_v[r][d]);
            }
    }
}

template <typename T, int DP, bool FULL>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int Hq, int Hkv, int Tq, int S,
                   int Dh, int causal, cudaStream_t stream) {
    const double scale = 1.0 / sqrt((double)Dh);
    const size_t smem =
        (size_t)(2 * BKV * DP + 2 * BQ * (DP + 1)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, DP, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((S + BKV - 1) / BKV, B * Hkv);
    flash_bwd_dkv_kernel<T, DP, FULL><<<grid, WARPS * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Tq, S, Dh, causal,
        (float)(scale * 1.4426950408889634), (float)scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Hq, int Hkv, int Tq,
                       int S, int D, int causal, cudaStream_t st) {
#define KUBETPU_DKV(DP, FULL) \
    launch<T, DP, FULL>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Tq, S, D, causal, st)
    if constexpr (std::is_same<T, float>::value) {
        if (D == 64) return KUBETPU_DKV(64, true);
        if (D == 128) return KUBETPU_DKV(128, true);
    } else if (D == 64 || D == 128) {
        return cudaErrorInvalidValue;   // bf16 here runs on route 1
    }
    if (D < 1) return cudaErrorInvalidValue;
    if (D <= 32) return KUBETPU_DKV(32, false);
    if (D <= 64) return KUBETPU_DKV(64, false);
    if (D <= 128) return KUBETPU_DKV(128, false);
    if (D <= 256) return KUBETPU_DKV(256, false);
#undef KUBETPU_DKV
    return cudaErrorInvalidValue;
}


// -- route 1: tensor cores -----------------------------------------------------

namespace tc {

using namespace kubetpu::sm90;
using bf16 = __nv_bfloat16;

constexpr int BN = 128;        // keys per CTA: two warpgroups of 64
constexpr int BM = 64;         // queries per streamed tile
constexpr int STAGES = 3;
constexpr int THREADS = 256;

// Shared memory (bytes): K and V [D/64][BN][64], the Q and dO rings
// [STAGES][D/64][BM][64] (boxes 1024-byte aligned), the lse and delta rings
// [STAGES][BM] f32, then the mbarriers.
template <int D> struct Smem {
    static constexpr int K = 0;
    static constexpr int V = K + BN * D * 2;
    static constexpr int Q = V + BN * D * 2;
    static constexpr int DO = Q + STAGES * BM * D * 2;
    static constexpr int LSE = DO + STAGES * BM * D * 2;
    static constexpr int DELTA = LSE + STAGES * BM * 4;
    static constexpr int BAR = DELTA + STAGES * BM * 4;
    static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
};

// LSE_TMA: lse and delta come by TMA, which needs each head's values to
// start 16-byte aligned (T % 4 == 0); otherwise (ViT's T = 197) each thread
// reads its columns' values from global memory.  A template argument, not a
// flag, so the TMA instance keeps every register it had (the D = 128
// instance sits at the 255 cap)
template <int D, bool LSE_TMA>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_tc(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_lse,
                 const __grid_constant__ CUtensorMap tm_delta,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq,
                 int Hkv, int Tq, int S, int causal, float sscale,
                 float scale, int n_bhk) {
    using L = Smem<D>;
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
    uint64_t* full = kv_full + 1;
    uint64_t* empty = full + STAGES;

    const int bhk = blockIdx.x % n_bhk;   // b * Hkv + hk
    const int k0 = blockIdx.x / n_bhk * BN;   // earliest keys first
    const int G = Hq / Hkv;
    const int head0 = (bhk / Hkv) * Hq + (bhk % Hkv) * G;   // the group's first
    const int off = S - Tq;   // end-aligned causal offset
    // query tiles wholly before the first key's horizon see no key here
    const int qt_lo = causal ? max(0, k0 - off) / BM : 0;
    const int per_head = max(0, (Tq + BM - 1) / BM - qt_lo);
    const int n_it = G * per_head;

    // Thread 0 also issues every TMA load (a producer warp would cost the
    // consumers registers: see the header).
    const bool loader = threadIdx.x == 0;
    int next = 0;   // the loader's next query tile to issue
    auto load = [&](int it, int s) {
        const int head = head0 + it / per_head;
        const int q0 = (qt_lo + it % per_head) * BM;
        mbar_expect_tx(full + s, 2 * BM * D * 2 + (LSE_TMA ? 2 * BM * 4 : 0));
        tma_load_rows<D>(smem + L::Q + s * BM * D * 2, &tm_q, BM, q0, head,
                         full + s);
        tma_load_rows<D>(smem + L::DO + s * BM * D * 2, &tm_do, BM, q0, head,
                         full + s);
        // [B*Hq*T] flat: a ragged tile's tail reads the next head's values
        // (or zeros), which the mask below never uses
        if constexpr (LSE_TMA) {
            tma_load_1d(smem + L::LSE + s * BM * 4, &tm_lse, head * Tq + q0,
                        full + s);
            tma_load_1d(smem + L::DELTA + s * BM * 4, &tm_delta,
                        head * Tq + q0, full + s);
        }
    };
    // every tile up to `need` issued (waiting if it must), then as many
    // more as free stages allow
    auto feed = [&](int need) {
        if (loader) {
            ring_feed<STAGES>(next, min(need, n_it), empty, true, load);
            ring_feed<STAGES>(next, n_it, empty, false, load);
        }
        __syncwarp();
    };

    if (loader) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, THREADS / 32);   // one arrival a warp
        }
        mbar_fence_init();
    }
    __syncthreads();
    if (loader) {
        mbar_expect_tx(kv_full, 2 * BN * D * 2);
        tma_load_rows<D>(smem + L::K, &tm_k, BN, k0, bhk, kv_full);
        tma_load_rows<D>(smem + L::V, &tm_v, BN, k0, bhk, kv_full);
    }
    feed(STAGES);

    const int c = threadIdx.x / 128;    // this warpgroup's 64 keys
    const int lane = threadIdx.x % 32;
    const int r0 = 16 * (threadIdx.x % 128 / 32) + lane / 4;   // keys r0, r0 + 8
    const int cq = 2 * (lane % 4);      // queries 8j + cq + {0, 1}
    const int kbase = k0 + 64 * c;
    const uint32_t k_addr = smem_u32(smem + L::K) + c * 64 * 128;
    const uint32_t v_addr = smem_u32(smem + L::V) + c * 64 * 128;

    float dkacc[D / 2], dvacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        const int q0 = (qt_lo + it % per_head) * BM;
        const uint32_t q_addr = smem_u32(smem + L::Q + s * BM * D * 2);
        const uint32_t do_addr = smem_u32(smem + L::DO + s * BM * D * 2);
        const float* lse_s =
            reinterpret_cast<const float*>(smem + L::LSE) + s * BM;
        const float* delta_s =
            reinterpret_cast<const float*>(smem + L::DELTA) + s * BM;
        const size_t hrow = (size_t)(head0 + it / per_head) * Tq;
        // the values of queries q0 + 8j + cq + {0, 1}: from the stage, or
        // from global memory (zero past T, where the mask drops them)
        auto pair = [&](const float* stage, const float* g, int j) {
            if constexpr (LSE_TMA) {
                return *reinterpret_cast<const float2*>(stage + 8 * j + cq);
            } else {
                const int qi = q0 + 8 * j + cq;
                return make_float2(qi < Tq ? g[hrow + qi] : 0.f,
                                   qi + 1 < Tq ? g[hrow + qi + 1] : 0.f);
            }
        };

        feed(it + 1);
        float sacc[BM / 2], dpacc[BM / 2];
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) sacc[i] = dpacc[i] = 0.f;
        mbar_wait(full + s, (it / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
            wgmma_ss<BM, 0>(sacc, desc_kmajor(k_addr, j, BN * 128),
                            desc_kmajor(q_addr, j, BM * 128), j > 0);
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
            wgmma_ss<BM, 0>(dpacc, desc_kmajor(v_addr, j, BN * 128),
                            desc_kmajor(do_addr, j, BM * 128), j > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(dpacc);

        // p = exp2(s * scale * log2e - lse * log2e); the mask only where the
        // tile crosses the causal diagonal or a ragged edge, one uniform
        // branch a tile with selects inside (no branch an element)
        auto p_of = [&](int i, float lse) {
            return exp2_approx(sacc[i] * sscale - lse * LOG2E);
        };
        if (q0 + BM > Tq || kbase + 64 > S ||
            (causal && kbase + 63 > q0 + off)) {
#pragma unroll
            for (int j = 0; j < BM / 8; ++j) {
                const float2 lv = pair(lse_s, lse, j);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qi = q0 + 8 * j + cq + (e & 1);
                    const int kj = kbase + r0 + 8 * (e >> 1);
                    const bool ok = (qi < Tq) & (kj < S) &
                                    (!causal | (kj <= qi + off));
                    // NEG_INF is finite: mask the probability explicitly
                    const float p = p_of(4 * j + e, (e & 1) ? lv.y : lv.x);
                    sacc[4 * j + e] = ok ? p : 0.f;
                }
            }
        } else {
#pragma unroll
            for (int j = 0; j < BM / 8; ++j) {
                const float2 lv = pair(lse_s, lse, j);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    sacc[4 * j + e] = p_of(4 * j + e, (e & 1) ? lv.y : lv.x);
            }
        }
        // dV += P^T.dO, with p in bf16 as the reference rounds it; dS^T is
        // computed while it runs
        uint32_t pa[BM / 16][4];
        acc_to_a<BM>(sacc, pa);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BM / 16; ++j)
            wgmma_rs<D, 1>(dvacc, pa[j], desc_mnmajor(do_addr, j, BM * 128), 1);
        wgmma_commit();
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
            const float2 dl = pair(delta_s, delta, j);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = 4 * j + e;
                dpacc[i] = sacc[i] * (dpacc[i] - ((e & 1) ? dl.y : dl.x)) * scale;
            }
        }
        // dK += dS^T.Q, with ds in bf16 as the reference rounds it
        uint32_t dsa[BM / 16][4];
        acc_to_a<BM>(dpacc, dsa);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BM / 16; ++j)
            wgmma_rs<D, 1>(dkacc, dsa[j], desc_mnmajor(q_addr, j, BM * 128), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dvacc);
        fence_regs(dkacc);
        mbar_arrive_warp(empty + s);
        feed(0);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int kj = kbase + r0 + 8 * h;
        if (kj >= S) continue;
        const size_t row = ((size_t)bhk * S + kj) * D + cq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
            *reinterpret_cast<uint32_t*>(dk + row + 8 * j) = pack_bf16(
                dkacc[4 * j + 2 * h], dkacc[4 * j + 2 * h + 1]);
            *reinterpret_cast<uint32_t*>(dv + row + 8 * j) = pack_bf16(
                dvacc[4 * j + 2 * h], dvacc[4 * j + 2 * h + 1]);
        }
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int Hq, int Hkv, int Tq, int S,
                   int causal, cudaStream_t stream) {
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
    const int n_bhk = B * Hkv;
    const int smem = Smem<D>::BYTES + 1024;   // + the 1024-byte alignment
    auto kernel = (Tq & 3) == 0 ? flash_bwd_dkv_tc<D, true>
                                : flash_bwd_dkv_tc<D, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(S + BN - 1) / BN * n_bhk, THREADS, smem, stream>>>(
        mq, mk, mv, mdo, mlse, mdelta, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), Hq, Hkv, Tq, S, causal,
        (float)(scale * 1.4426950408889634), (float)scale, n_bhk);
    return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q/dout [B, Hq, T, D]; k/v/dk/dv [B, Hkv, S, D] (contiguous, f32 or bf16,
// D <= 256); lse/delta f32 [B, Hq, T].  route 1: the tensor-core instance
// (bf16, D 64 or 128, 16-byte aligned pointers), 0: the CUDA-core one.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a shape the
// route cannot take).
extern "C" int kubetpu_flash_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int Hq,
                                     int Hkv, int Tq, int S, int D,
                                     int causal, int is_bf16, int route,
                                     void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0 || (causal && Tq > S)) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (route == 1) {
        if (!is_bf16) return cudaErrorInvalidValue;
        if (D == 64) return tc::launch<64>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Tq, S, causal, st);
        if (D == 128) return tc::launch<128>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Tq, S, causal, st);
        return cudaErrorInvalidValue;
    }
    if (route != 0) return cudaErrorInvalidValue;
    if (is_bf16)
        return dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Tq, S, D, causal, st);
    return dispatch_d<float>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Tq, S, D, causal, st);
}
