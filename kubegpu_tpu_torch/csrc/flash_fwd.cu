// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` inside `flash_attention`
// (kubegpu_tpu/ops/flash_attention.py:200, pallas_call at :273): blocked
// attention with grouped GQA, an online softmax in f32 with log2(e) folded
// into the score scale (exp2), an end-aligned causal offset s - t, causal
// key-tile skipping, and an optional natural-log lse.
//
// What bounds it on the H100: at the shapes of the Llama forward
// ([1, 32, 512, 128] causal) the function moves ~10 MB and does ~2 GFLOP,
// so the card's floor is the memory time (~3 us).  This first version is
// bound by its own arithmetic instead: it runs both products as f32 FMA
// loops on the CUDA cores (67 TFLOP/s peak), not on the tensor cores.
//
// Design: one CTA of 8 warps serves 32 query rows that share one K/V tile in
// shared memory.  Those rows are all `group` query heads of ONE kv head over
// 32 / group consecutive positions (the TPU kernel's GQA reuse: each K/V tile
// is read once per CTA for the whole query group).  Each warp owns 4 rows;
// lane j scores key j of the 32-key tile, the warp reduces max and sum with
// shuffles, and the P.V product walks the tile with each lane owning D/32
// output channels.  Ragged T and S edges mask in-kernel, so every shape runs
// here (the TPU kernel fell back to XLA when blocks did not tile).  Head dims
// 64 and 128 run instances with 16-byte tile loads; any other head dim up to
// 256 runs an instance padded to the next of 32/64/128/256 channels, with
// scalar loads and the padding zeroed in shared memory.  Moving both products
// onto wgmma with TMA-fed tiles is later work.

#include "common.cuh"

#include <math.h>

namespace {

using namespace kubetpu;

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
    constexpr int VEC = Vec16<T>::N;
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
    for (int idx = threadIdx.x; idx < ROWS * D; idx += blockDim.x) {
        const int r = idx / D, dd = idx % D;
        const int gl = r / bq, g = gchunk * gc + gl, qi = q0 + r % bq;
        float val = 0.f;
        if (gl < gc && g < G && qi < Tq && (FULL || dd < Dh))
            val = to_f(q[(((size_t)b * Hq + hk * G + g) * Tq + qi) * Dg + dd]);
        qs[idx] = val;
    }

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
        if constexpr (FULL) {
            for (int vi = threadIdx.x; vi < BK * D / VEC; vi += blockDim.x) {
                const int e = vi * VEC, j = e / D, dd = e % D;
                float kf[VEC], vf[VEC];
                if (k0 + j < S) {
                    Vec16<T>::load(kb + (size_t)(k0 + j) * D + dd, kf);
                    Vec16<T>::load(vb + (size_t)(k0 + j) * D + dd, vf);
                } else {
#pragma unroll
                    for (int x = 0; x < VEC; ++x) kf[x] = vf[x] = 0.f;
                }
#pragma unroll
                for (int x = 0; x < VEC; ++x) {
                    ks[j * (D + 1) + dd + x] = kf[x];
                    vs[j * D + dd + x] = vf[x];
                }
            }
        } else {
            for (int e = threadIdx.x; e < BK * D; e += blockDim.x) {
                const int j = e / D, dd = e % D;
                const bool in = k0 + j < S && dd < Dh;
                const size_t gi = (size_t)(k0 + j) * Dh + dd;
                ks[j * (D + 1) + dd] = in ? to_f(kb[gi]) : 0.f;
                vs[j * D + dd] = in ? to_f(vb[gi]) : 0.f;
            }
        }
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
    if (D == 64) return launch<T, 64, true>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
    if (D == 128) return launch<T, 128, true>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
    if (D < 1) return cudaErrorInvalidValue;
    if (D <= 32) return launch<T, 32, false>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
    if (D <= 64) return launch<T, 64, false>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
    if (D <= 128) return launch<T, 128, false>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
    if (D <= 256) return launch<T, 256, false>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
    return cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hq, T, D]; k/v [B, Hkv, S, D] (contiguous, f32 or bf16, D <= 256);
// o like q; lse f32 [B, Hq, T] or null.  Returns the launch's cudaError_t.
extern "C" int kubetpu_flash_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int Hq, int Hkv,
                                 int Tq, int S, int D, int causal, int is_bf16,
                                 void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0 || (causal && Tq > S)) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
    return dispatch_d<float>(q, k, v, o, lse, B, Hq, Hkv, Tq, S, D, causal, st);
}
