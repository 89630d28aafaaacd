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
// rowsum(dO o O) comes in precomputed, as on the TPU.
//
// What bounds it on the H100: at the training shape (q/dO [4, 32, 2048, 128]
// and k/v [4, 8, 2048, 128], bf16, causal) it moves ~0.23 GB and does three
// causal products, ~2.1e11 FLOP: operations bind it (~0.21 ms on the tensor
// cores against ~0.07 ms of memory).  This first version runs the products
// as f32 FMA loops on the CUDA cores (67 TFLOP/s peak), so its own floor is
// ~3 ms; wgmma tiles fed by TMA are later work.
//
// Design: as the forward (csrc/flash_fwd.cu).  One CTA of 8 warps owns 32
// query rows that are all `group` query heads of ONE kv head over
// 32 / group positions, so one K/V tile in shared memory serves the whole
// group.  The TPU kernel's sequential key axis becomes a loop inside the
// CTA, up to the causal horizon of the CTA's last row, and dq accumulates in
// f32 registers: no atomics, and the same sums in the same order on every
// run.  Each warp owns 4 rows; lane j scores key j of the 32-key tile
// (s and dp), and in the dq update each lane owns D/32 channels while ds is
// broadcast from lane jj by a shuffle.  Ragged T and S edges mask in-kernel
// (the TPU path fell back to XLA when blocks did not tile); a masked p is
// zeroed explicitly, since NEG_INF is finite.  Head dims 64 and 128 run
// instances with 16-byte loads, any other up to 256 an instance padded to
// 32/64/128/256 channels with the padding zeroed in shared memory.

#include "common.cuh"

#include <math.h>

namespace {

using namespace kubetpu;

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
    if (D == 64) return KUBETPU_DQ(64, true);
    if (D == 128) return KUBETPU_DQ(128, true);
    if (D < 1) return cudaErrorInvalidValue;
    if (D <= 32) return KUBETPU_DQ(32, false);
    if (D <= 64) return KUBETPU_DQ(64, false);
    if (D <= 128) return KUBETPU_DQ(128, false);
    if (D <= 256) return KUBETPU_DQ(256, false);
#undef KUBETPU_DQ
    return cudaErrorInvalidValue;
}

}  // namespace

// q/dout/dq [B, Hq, T, D]; k/v [B, Hkv, S, D] (contiguous, f32 or bf16,
// D <= 256); lse/delta f32 [B, Hq, T].  Returns the launch's cudaError_t.
extern "C" int kubetpu_flash_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int B, int Hq, int Hkv, int Tq,
                                    int S, int D, int causal, int is_bf16,
                                    void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0 || (causal && Tq > S)) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Tq, S, D, causal, st);
    return dispatch_d<float>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Tq, S, D, causal, st);
}
