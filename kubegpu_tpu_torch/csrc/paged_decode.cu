// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` (kubegpu_tpu/ops/paged_attention.py
// :229, pallas_call at :795) for bf16/f32 pools without the per-page mass
// output: one decode query per q head attends the flushed history of its row,
// read from the page pool through the row's page table, and the kernel emits
// the softmax partials o (normalized), m and l for the serving engine's
// flash-decoding merge with its in-block write buffer.
//
// What bounds it on the H100: bytes.  Each (row, kv head) reads its used
// pages once (~21 MB per call at the serving shapes), with only 2*G flops per
// key element, far below the card's ~295 flop/byte balance point.
//
// Design: one CTA per (row b, kv head, chunk of <= 8 query heads of that kv
// head), so a decode batch launches B * Hkv CTAs instead of the TPU's one
// program per row.  Each CTA reads layer, t, t_pad, d and its page-table row
// itself and walks only the used pages in the TPU kernel's order (prompt
// pages [0, ceil(t/P)), then decode pages from t_pad/P), cut into 32-key
// chunks.  The 16 warps take chunks round-robin, so a row's pages are in
// flight in parallel; lane j of a warp scores key j with 16-byte loads straight
// from the pool (each key row is read once, by one lane), the warp runs the
// online softmax with shuffles, and the P.V product reads each value row
// coalesced across the warp.  Validity is the TPU kernel's predicate
// (phys < t | t_pad <= phys < t_pad + d, page id != 0), masked explicitly after
// the exp because NEG_INF is finite.  The warps' partials merge through
// shared memory at the end (the same logsumexp merge as merge_partials).
// Head dims 64 and 128 run instances with 16-byte key loads and one instance
// per query-group size; any other head dim up to 256 runs an instance padded
// to the next of 32/64/128/256 channels with scalar loads (8 query heads per
// CTA, whatever the group).

#include "common.cuh"

#include <math.h>

namespace {

using namespace kubetpu;

constexpr int WARPS = 16;
constexpr int KC = 32;    // keys per chunk, one per lane
constexpr int GMAX = 8;   // query heads per CTA

// DP: channels held per query (a multiple of 32); FULL: the head dim is DP.
// Otherwise the head dim is Dh < DP and channels Dh..DP-1 are zero.
template <typename T, int DP, int GR, bool FULL>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v, const int* __restrict__ pt,
                    const int* __restrict__ layer_p, const int* __restrict__ t_p,
                    const int* __restrict__ tpad_p, const int* __restrict__ d_p,
                    float* __restrict__ o, float* __restrict__ m_out,
                    float* __restrict__ l_out, int Hq, int Hkv, int n_pages,
                    int P, int Dh, int max_pages, int n_gchunks, float scale) {
    constexpr int D = DP;
    constexpr int DPL = D / 32;
    constexpr int VEC = Vec16<T>::N;
    const int Dg = FULL ? D : Dh;   // row stride in global memory
    constexpr int RS = D + 2;   // merge record: acc[D], m, l
    extern __shared__ float smem[];
    float* qs = smem;            // [GR][D]
    float* red = qs + GR * D;    // [WARPS][GR][RS]

    const int G = Hq / Hkv;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.x;
    const int gchunk = blockIdx.y % n_gchunks;
    const int hk = blockIdx.y / n_gchunks;
    const int g0 = gchunk * GMAX;
    const int ng = min(GR, G - g0);

    for (int idx = threadIdx.x; idx < GR * D; idx += blockDim.x) {
        const int gl = idx / D, dd = idx % D;
        qs[idx] = gl < ng && (FULL || dd < Dh)
            ? to_f(q[((size_t)b * Hq + hk * G + g0 + gl) * Dg + dd])
            : 0.f;
    }

    const int layer = *layer_p;
    const int tb = t_p[b], tpb = tpad_p[b], db = d_p[b];
    const int n_prompt = (tb + P - 1) / P;   // row-local pages 0..n_prompt-1
    const int dstart = tpb / P;              // first decode page (row-local)
    const int n_dec = (db + P - 1) / P;
    const int cpp = (P + KC - 1) / KC;       // chunks per page
    const int n_chunks = (n_prompt + n_dec) * cpp;
    const size_t page_elems = (size_t)P * Dg;
    __syncthreads();

    float m[GR], l[GR], acc[GR][DPL];
#pragma unroll
    for (int g = 0; g < GR; ++g) {
        m[g] = NEG_INF;
        l[g] = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;
    }

    for (int c = warp; c < n_chunks; c += WARPS) {
        const int i = c / cpp, sub = c % cpp;
        const int rl = i < n_prompt ? i : dstart + (i - n_prompt);
        const int pid = rl < max_pages ? pt[(size_t)b * max_pages + rl] : 0;
        const int pofs = sub * KC + lane;
        const int phys = rl * P + pofs;
        const bool valid = pofs < P && pid != 0 &&
                           (phys < tb || (phys >= tpb && phys < tpb + db));
        const size_t page_off =
            (((size_t)layer * n_pages + pid) * Hkv + hk) * page_elems;

        float s[GR];
#pragma unroll
        for (int g = 0; g < GR; ++g) s[g] = 0.f;
        if (valid) {
            const T* krow = pool_k + page_off + (size_t)pofs * Dg;
            if constexpr (FULL) {
#pragma unroll 4
                for (int d0 = 0; d0 < D; d0 += VEC) {
                    float kf[VEC];
                    Vec16<T>::load(krow + d0, kf);
#pragma unroll
                    for (int e = 0; e < VEC; ++e)
#pragma unroll
                        for (int g = 0; g < GR; ++g)
                            s[g] = fmaf(qs[g * D + d0 + e], kf[e], s[g]);
                }
            } else {
                for (int dd = 0; dd < Dh; ++dd) {
                    const float kf = to_f(krow[dd]);
#pragma unroll
                    for (int g = 0; g < GR; ++g)
                        s[g] = fmaf(qs[g * D + dd], kf, s[g]);
                }
            }
        }
#pragma unroll
        for (int g = 0; g < GR; ++g) {
            const float sc = valid ? s[g] * scale : NEG_INF;
            const float m_new = fmaxf(m[g], warp_max(sc));
            const float w = valid ? expf(sc - m_new) : 0.f;
            const float alpha = expf(m[g] - m_new);
            l[g] = l[g] * alpha + warp_sum(w);
            m[g] = m_new;
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[g][d] *= alpha;
            s[g] = w;
        }
        // P.V over the chunk's valid keys only (the set is warp-uniform)
        unsigned vmask = __ballot_sync(FULL_MASK, valid);
        const T* vbase = pool_v + page_off + (size_t)(sub * KC) * Dg + lane * DPL;
        while (vmask) {
            const int jj = __ffs(vmask) - 1;
            vmask &= vmask - 1;
            float vv[DPL];
#pragma unroll
            for (int d = 0; d < DPL; ++d)
                vv[d] = FULL || lane * DPL + d < Dh
                    ? to_f(vbase[(size_t)jj * Dg + d]) : 0.f;
#pragma unroll
            for (int g = 0; g < GR; ++g) {
                const float wj = __shfl_sync(FULL_MASK, s[g], jj);
#pragma unroll
                for (int d = 0; d < DPL; ++d) acc[g][d] = fmaf(wj, vv[d], acc[g][d]);
            }
        }
    }

    // merge the warps' partials (logsumexp merge; empty warps have l = 0)
    float* mine = red + (size_t)warp * GR * RS;
#pragma unroll
    for (int g = 0; g < GR; ++g) {
#pragma unroll
        for (int d = 0; d < DPL; ++d) mine[g * RS + lane * DPL + d] = acc[g][d];
        if (lane == 0) {
            mine[g * RS + D] = m[g];
            mine[g * RS + D + 1] = l[g];
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < ng * Dg; idx += blockDim.x) {
        const int g = idx / Dg, dd = idx % Dg;
        float mx = NEG_INF;
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red[(w * GR + g) * RS + D]);
        float lt = 0.f, ot = 0.f;
        for (int w = 0; w < WARPS; ++w) {
            const float* rec = red + (w * GR + g) * RS;
            const float f = expf(rec[D] - mx);
            lt += f * rec[D + 1];
            ot += f * rec[dd];
        }
        const size_t row = (size_t)b * Hq + hk * G + g0 + g;
        o[row * Dg + dd] = ot / fmaxf(lt, 1e-30f);
        if (dd == 0) {
            m_out[row] = mx;
            l_out[row] = lt;
        }
    }
}

template <typename T, int DP, int GR, bool FULL>
cudaError_t launch(const void* q, const void* pk, const void* pv, const int* pt,
                   const int* layer, const int* t, const int* tpad,
                   const int* d, void* o, void* m, void* l, int B, int Hq,
                   int Hkv, int n_pages, int P, int Dh, int max_pages,
                   cudaStream_t stream) {
    const int G = Hq / Hkv;
    const int n_gchunks = (G + GMAX - 1) / GMAX;
    const size_t smem = (size_t)(GR * DP + WARPS * GR * (DP + 2)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, DP, GR, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(B, Hkv * n_gchunks);
    paged_decode_kernel<T, DP, GR, FULL><<<grid, WARPS * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(pk),
        static_cast<const T*>(pv), pt, layer, t, tpad, d,
        static_cast<float*>(o), static_cast<float*>(m),
        static_cast<float*>(l), Hq, Hkv, n_pages, P, Dh, max_pages, n_gchunks,
        (float)(1.0 / sqrt((double)Dh)));
    return cudaGetLastError();
}

#define PAGED_ARGS q, pk, pv, pt, layer, t, tpad, d, o, m, l, B, Hq, Hkv, n_pages, P, D, max_pages, st

template <typename T, int DP>
cudaError_t dispatch_g(const void* q, const void* pk, const void* pv,
                       const int* pt, const int* layer, const int* t,
                       const int* tpad, const int* d, void* o, void* m,
                       void* l, int B, int Hq, int Hkv, int n_pages, int P,
                       int D, int max_pages, cudaStream_t st) {
    const int G = Hq / Hkv;
    if (G <= 1) return launch<T, DP, 1, true>(PAGED_ARGS);
    if (G <= 2) return launch<T, DP, 2, true>(PAGED_ARGS);
    if (G <= 4) return launch<T, DP, 4, true>(PAGED_ARGS);
    return launch<T, DP, GMAX, true>(PAGED_ARGS);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* pk, const void* pv,
                       const int* pt, const int* layer, const int* t,
                       const int* tpad, const int* d, void* o, void* m,
                       void* l, int B, int Hq, int Hkv, int n_pages, int P,
                       int D, int max_pages, cudaStream_t st) {
    if (D == 64) return dispatch_g<T, 64>(PAGED_ARGS);
    if (D == 128) return dispatch_g<T, 128>(PAGED_ARGS);
    if (D < 1) return cudaErrorInvalidValue;
    if (D <= 32) return launch<T, 32, GMAX, false>(PAGED_ARGS);
    if (D <= 64) return launch<T, 64, GMAX, false>(PAGED_ARGS);
    if (D <= 128) return launch<T, 128, GMAX, false>(PAGED_ARGS);
    if (D <= 256) return launch<T, 256, GMAX, false>(PAGED_ARGS);
    return cudaErrorInvalidValue;
}

#undef PAGED_ARGS

}  // namespace

// q [B, Hq, D]; pools [L, n_pages, Hkv, P, D] (f32 or bf16, like q; D <= 256);
// page_table [B, max_pages] i32; layer [1] i32; t/t_pad/d [B] i32 (all on
// the device).  Outputs o f32 [B, Hq, D], m/l f32 [B, Hq].  Returns the
// launch's cudaError_t.
extern "C" int kubetpu_paged_decode(const void* q, const void* pool_k,
                                    const void* pool_v, const void* pt,
                                    const void* layer, const void* t,
                                    const void* tpad, const void* d, void* o,
                                    void* m, void* l, int B, int Hq, int Hkv,
                                    int n_pages, int P, int D, int max_pages,
                                    int is_bf16, void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0 || B == 0) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* pti = static_cast<const int*>(pt);
    const int* li = static_cast<const int*>(layer);
    const int* ti = static_cast<const int*>(t);
    const int* tpi = static_cast<const int*>(tpad);
    const int* di = static_cast<const int*>(d);
    if (is_bf16)
        return dispatch_d<__nv_bfloat16>(q, pool_k, pool_v, pti, li, ti, tpi, di, o, m, l, B, Hq, Hkv, n_pages, P, D, max_pages, st);
    return dispatch_d<float>(q, pool_k, pool_v, pti, li, ti, tpi, di, o, m, l, B, Hq, Hkv, n_pages, P, D, max_pages, st);
}
