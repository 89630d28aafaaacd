// Flash-attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dkv_kernel` inside `flash_attention_bwd`
// (kubegpu_tpu/ops/flash_attention.py:425, pallas_call at :530): dk and dv
// of one kv head, summed over its query group, from the recomputed
// probabilities, with no T x S residual.  Per query tile,
//   p  = exp2(q.k * scale*log2e - lse*log2e)   (lse saved in natural log)
//   dp = dO.v,   ds = p * (dp - delta) * scale  (the NATURAL scale)
//   dv += p^T . dO,   dk += ds^T . Q
// with the end-aligned causal mask qpos + (s - t) >= kpos.
//
// What bounds it on the H100: at the training shape (q/dO [4, 32, 2048, 128]
// and k/v [4, 8, 2048, 128], bf16, causal) it moves ~0.18 GB and does four
// causal products, ~2.8e11 FLOP (it recomputes q.k as dq does): operations
// bind it (~0.28 ms on the tensor cores against ~0.05 ms of memory).  This
// first version runs the products as f32 FMA loops on the CUDA cores
// (67 TFLOP/s peak), so its own floor is ~4 ms; wgmma tiles fed by TMA are
// later work.
//
// Design: one CTA of 8 warps owns a tile of 32 keys of ONE kv head, held in
// shared memory.  It loops over the group's query heads and, for each, over
// 32-row query tiles from the causal lower bound (the first tile holding a
// query that sees the CTA's first key) to the end, streaming each Q/dO tile
// through shared memory.  dk and dv accumulate in f32 registers across the
// whole group, so the kernel writes Hkv heads directly, as the TPU kernel
// does: the group is summed in-kernel with no atomics, and both gradients
// come out the same from run to run.  Because the query tiles stream, no
// [group * T, D] panel has to stay resident, so the TPU's de-grouped
// fallback for panels that outgrow VMEM has no counterpart.  Each warp owns
// 4 keys; lane i scores query i of the tile (s and dp), and in the update
// each lane owns D/32 channels of dk and dv while p and ds are broadcast
// from lane ii by a shuffle.  Ragged T and S edges mask in-kernel; a masked
// p is zeroed explicitly, since NEG_INF is finite.  Head dims as
// csrc/flash_bwd_dq.cu.

#include "common.cuh"

#include <math.h>

namespace {

using namespace kubetpu;

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
    if (D == 64) return KUBETPU_DKV(64, true);
    if (D == 128) return KUBETPU_DKV(128, true);
    if (D < 1) return cudaErrorInvalidValue;
    if (D <= 32) return KUBETPU_DKV(32, false);
    if (D <= 64) return KUBETPU_DKV(64, false);
    if (D <= 128) return KUBETPU_DKV(128, false);
    if (D <= 256) return KUBETPU_DKV(256, false);
#undef KUBETPU_DKV
    return cudaErrorInvalidValue;
}

}  // namespace

// q/dout [B, Hq, T, D]; k/v/dk/dv [B, Hkv, S, D] (contiguous, f32 or bf16,
// D <= 256); lse/delta f32 [B, Hq, T].  Returns the launch's cudaError_t.
extern "C" int kubetpu_flash_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int Hq,
                                     int Hkv, int Tq, int S, int D,
                                     int causal, int is_bf16, void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0 || (causal && Tq > S)) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Tq, S, D, causal, st);
    return dispatch_d<float>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Tq, S, D, causal, st);
}
