// Paged decode attention for Hopper (sm_90a): the page walk shared by the
// three page formats, each built from its own thin source.
//
//   paged_decode.cu     bf16/f32 pages   (TPU `_paged_kernel`,    kernel 4)
//   paged_decode_q8.cu  int8 pages       (TPU `_paged_kernel_q8`, kernel 5)
//   paged_decode_q4.cu  packed int4      (TPU `_paged_kernel_q4`, kernel 6)
//   paged_decode_bias.cu bf16/f32 pages + T5's relative-position bias
//                        (TPU `_paged_kernel_bias`, kernel 7)
//
// One decode query per q head attends the flushed history of its row, read
// from the page pool through the row's page table, and the kernel emits the
// softmax partials o (normalized), m and l for the serving engine's
// flash-decoding merge with its in-block write buffer, plus, on request, the
// per-page attention mass the engine's mass eviction reads.
//
// What bounds it on the H100: bytes.  Each (row, kv head) reads its used
// pages once, with only 2*G flops per key element, far below the card's
// ~295 flop/byte balance point; int8 pages halve the bytes of bf16 and int4
// pages quarter them.
//
// Design: one CTA per (row b, kv head, chunk of <= 8 query heads of that kv
// head), so a decode batch launches B * Hkv CTAs instead of the TPU's one
// program per row.  Each CTA reads layer, t, t_pad, d and its page-table row
// itself and walks only the used pages in the TPU kernel's order (prompt
// pages [0, ceil(t/P)), then decode pages from t_pad/P), cut into 32-key
// chunks.  The 16 warps take chunks round-robin, so a row's pages are in
// flight in parallel; lane j of a warp scores key j with 16-byte loads
// straight from the pool (each key row is read once, by one lane), the warp
// runs the online softmax with shuffles, and the P.V product reads each
// value row coalesced across the warp.  Validity is the TPU kernel's
// predicate (phys < t | t_pad <= phys < t_pad + d, page id != 0), masked
// explicitly after the exp because NEG_INF is finite.  The warps' partials
// merge through shared memory at the end (the same logsumexp merge as
// merge_partials).
//
// Page formats (the policy KV): a policy widens a key row into the score
// and a lane's value channels into f32, in registers.  Quantized pools carry
// f32 scales [L, n_pages, Hkv, n_scale], one per group of P / n_scale keys
// (1 for int8); the k-scale multiplies the score after * D^-0.5 and the
// v-scale multiplies the key's weight only for the P.V product, so l and
// the mass are taken from the unscaled weights, as in the TPU kernels.
//
// The mass (MASS): a page's mass is the sum over its keys of exp(s - M)/L,
// with M and L the final max and sum of each query head, averaged over the
// Hq heads.  A warp records each chunk's sum of weights with the running
// max it was taken against; after the merge, when M and L are known, the
// CTA rescales each record by exp(m_chunk - M)/L and sums a page's records
// over its chunks and heads into a per-CTA partial.  A second small kernel
// adds the partials of a row's CTAs in a fixed order and divides by Hq: no
// float atomics, so eviction reads the same mass from run to run.
//
// Head dims 64 and 128 run instances with 16-byte key loads and one
// instance per query-group size; any other head dim up to 256 runs an
// instance padded to the next of 32/64/128/256 channels with scalar loads
// (8 query heads per CTA, whatever the group).
//
// The bias (BIAS, kernel 7 only; MHA, no mass): each lane buckets its key's
// distance n = max(q_pos - phys, 0) with T5's causal log-spaced rule, in the
// reference's f32 order (logf, IEEE division: no fast math, so the bucket is
// the plain version's), and adds the table entry of the query head to the
// score after * D^-0.5.  The CTA's rows of the [Hq, n_buckets] f32 table sit
// in shared memory.  Validity drops the page-id test, as the TPU kernel has
// no hole mask: a 0 in the used range attends page 0's keys; a row-local page
// past the table is not a key.  With BIAS false the walk is kernels 4-6's.
#pragma once

#include "common.cuh"

#include <math.h>

namespace kubetpu {
namespace paged {

constexpr int WARPS = 16;
constexpr int KC = 32;    // keys per chunk, one per lane
constexpr int GMAX = 8;   // query heads per CTA

// Everything the host passes; pointers to device memory.
struct Args {
    const void* q;
    const void* pool_k;
    const void* pool_v;
    const float* k_scale;   // quantized pools only
    const float* v_scale;
    const int* pt;
    const int* layer;
    const int* t;
    const int* tpad;
    const int* d;
    float* o;
    float* m;
    float* l;
    float* mass;            // nullptr: no mass output
    float* scratch;         // mass records and per-CTA partials
    int B, Hq, Hkv, n_pages, P, Dh, max_pages, n_scale, scratch_floats;
    cudaStream_t st;
    // kernel 7 only: per-row query position, [Hq, n_buckets] f32 bias table
    const int* qpos = nullptr;
    const float* table = nullptr;
    int n_buckets = 0, max_dist = 0;
};

// Floats of scratch the mass output needs: a (sum, max) record per chunk
// and query head of every CTA, then one partial per page of every CTA.
inline long long mass_scratch_floats(const Args& a) {
    const long long ctas = (long long)a.B * a.Hkv *
                           ((a.Hq / a.Hkv + GMAX - 1) / GMAX);
    const long long cpp = (a.P + KC - 1) / KC;
    return ctas * a.max_pages * (cpp * GMAX * 2 + 1);
}

// -- page formats -------------------------------------------------------------
// dot: s[g] += q_g . key over the row's channels (qs holds GR query rows of
// D floats, zero past Dh).  load_v: lane's DPL = D/32 value channels
// lane*DPL .. lane*DPL + DPL - 1 (0 past Dh).  row_elems: a row's stride.

// bf16/f32 pages of q's type.
template <typename T>
struct PlainPages {
    using Elem = T;
    static constexpr bool SCALED = false;
    static bool ok_dim(int) { return true; }
    __host__ __device__ static int row_elems(int dh) { return dh; }

    template <int D, int GR, bool FULL>
    __device__ __forceinline__ static void dot(const Elem* krow,
                                               const float* qs, int Dh,
                                               float (&s)[GR]) {
        if constexpr (FULL) {
            constexpr int VEC = Vec16<T>::N;
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

    template <int D, bool FULL>
    __device__ __forceinline__ static void load_v(const Elem* vrow, int lane,
                                                  int Dh,
                                                  float (&vv)[D / 32]) {
        constexpr int DPL = D / 32;
#pragma unroll
        for (int d = 0; d < DPL; ++d)
            vv[d] = FULL || lane * DPL + d < Dh
                ? to_f(vrow[lane * DPL + d]) : 0.f;
    }
};

// int8 pages, per-token scales (n_scale == P).  A key row is Dh bytes: 128
// at D = 128, eight 16-byte loads.
template <typename T>
struct Int8Pages {
    using Elem = int8_t;
    static constexpr bool SCALED = true;
    static bool ok_dim(int) { return true; }
    __host__ __device__ static int row_elems(int dh) { return dh; }

    template <int D, int GR, bool FULL>
    __device__ __forceinline__ static void dot(const Elem* krow,
                                               const float* qs, int Dh,
                                               float (&s)[GR]) {
        if constexpr (FULL) {
#pragma unroll 2
            for (int d0 = 0; d0 < D; d0 += 16) {
                const uint4 r = *reinterpret_cast<const uint4*>(krow + d0);
                const int8_t* by = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
                for (int e = 0; e < 16; ++e) {
                    const float kf = (float)by[e];
#pragma unroll
                    for (int g = 0; g < GR; ++g)
                        s[g] = fmaf(qs[g * D + d0 + e], kf, s[g]);
                }
            }
        } else {
            for (int dd = 0; dd < Dh; ++dd) {
                const float kf = (float)krow[dd];
#pragma unroll
                for (int g = 0; g < GR; ++g)
                    s[g] = fmaf(qs[g * D + dd], kf, s[g]);
            }
        }
    }

    template <int D, bool FULL>
    __device__ __forceinline__ static void load_v(const Elem* vrow, int lane,
                                                  int Dh,
                                                  float (&vv)[D / 32]) {
        constexpr int DPL = D / 32;
#pragma unroll
        for (int d = 0; d < DPL; ++d)
            vv[d] = FULL || lane * DPL + d < Dh
                ? (float)vrow[lane * DPL + d] : 0.f;
    }
};

// Packed int4 pages, one scale per group of P / n_scale keys.  A key row is
// Dh/2 bytes; byte c holds channel c in its low nibble and channel
// c + Dh/2 in its high nibble, each biased by +8, so the byte 0x88 is 0.
template <typename T>
struct Int4Pages {
    using Elem = uint8_t;
    static constexpr bool SCALED = true;
    static bool ok_dim(int dh) { return dh % 2 == 0; }
    __host__ __device__ static int row_elems(int dh) { return dh / 2; }

    __device__ __forceinline__ static float lo(unsigned b) {
        return (float)((int)(b & 0xFu) - 8);
    }
    __device__ __forceinline__ static float hi(unsigned b) {
        return (float)((int)(b >> 4) - 8);
    }

    template <int D, int GR, bool FULL>
    __device__ __forceinline__ static void dot(const Elem* krow,
                                               const float* qs, int Dh,
                                               float (&s)[GR]) {
        if constexpr (FULL) {
            constexpr int H = D / 2;
#pragma unroll
            for (int c0 = 0; c0 < H; c0 += 16) {
                const uint4 r = *reinterpret_cast<const uint4*>(krow + c0);
                const uint8_t* by = reinterpret_cast<const uint8_t*>(&r);
#pragma unroll
                for (int e = 0; e < 16; ++e) {
                    const float kl = lo(by[e]), kh = hi(by[e]);
#pragma unroll
                    for (int g = 0; g < GR; ++g) {
                        s[g] = fmaf(qs[g * D + c0 + e], kl, s[g]);
                        s[g] = fmaf(qs[g * D + H + c0 + e], kh, s[g]);
                    }
                }
            }
        } else {
            const int h = Dh / 2;
            for (int c = 0; c < h; ++c) {
                const unsigned b = krow[c];
                const float kl = lo(b), kh = hi(b);
#pragma unroll
                for (int g = 0; g < GR; ++g) {
                    s[g] = fmaf(qs[g * D + c], kl, s[g]);
                    s[g] = fmaf(qs[g * D + h + c], kh, s[g]);
                }
            }
        }
    }

    // Lanes whose channels lie below Dh/2 take low nibbles, the others the
    // high nibbles of the same bytes (lanes 0-15 and 16-31 at full width).
    template <int D, bool FULL>
    __device__ __forceinline__ static void load_v(const Elem* vrow, int lane,
                                                  int Dh,
                                                  float (&vv)[D / 32]) {
        constexpr int DPL = D / 32;
        const int h = FULL ? D / 2 : Dh / 2;
#pragma unroll
        for (int d = 0; d < DPL; ++d) {
            const int ch = lane * DPL + d;
            if (!FULL && ch >= Dh)
                vv[d] = 0.f;
            else
                vv[d] = ch < h ? lo(vrow[ch]) : hi(vrow[ch - h]);
        }
    }
};

// -- the page walk --------------------------------------------------------------

// DP: channels held per query (a multiple of 32); FULL: the head dim is DP.
// Otherwise the head dim is Dh < DP and channels Dh..DP-1 are zero.
template <typename T, typename KV, int DP, int GR, bool FULL, bool MASS,
          bool BIAS>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(Args a, int n_gchunks, float scale) {
    using E = typename KV::Elem;
    constexpr int D = DP;
    constexpr int DPL = D / 32;
    const T* __restrict__ q = static_cast<const T*>(a.q);
    const E* __restrict__ pool_k = static_cast<const E*>(a.pool_k);
    const E* __restrict__ pool_v = static_cast<const E*>(a.pool_v);
    const int Hq = a.Hq, Hkv = a.Hkv, P = a.P, max_pages = a.max_pages;
    const int Dg = FULL ? D : a.Dh;        // q/o row stride
    const int Rs = KV::row_elems(Dg);      // pool row stride, in elements
    constexpr int RS = D + 2;   // merge record: acc[D], m, l
    extern __shared__ float smem[];
    float* qs = smem;            // [GR][D]
    float* red = qs + GR * D;    // [WARPS][GR][RS]
    float* tab = red + WARPS * GR * RS;   // BIAS: [GR][n_buckets]

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
        qs[idx] = gl < ng && (FULL || dd < a.Dh)
            ? to_f(q[((size_t)b * Hq + hk * G + g0 + gl) * Dg + dd])
            : 0.f;
    }
    const int nb = a.n_buckets;
    if constexpr (BIAS) {
        for (int idx = threadIdx.x; idx < GR * nb; idx += blockDim.x) {
            const int gl = idx / nb;
            tab[idx] = gl < ng
                ? a.table[(size_t)(hk * G + g0 + gl) * nb + idx % nb] : 0.f;
        }
    }

    const int layer = *a.layer;
    const int tb = a.t[b], tpb = a.tpad[b], db = a.d[b];
    const int n_prompt = (tb + P - 1) / P;   // row-local pages 0..n_prompt-1
    const int dstart = tpb / P;              // first decode page (row-local)
    const int n_dec = (db + P - 1) / P;
    const int cpp = (P + KC - 1) / KC;       // chunks per page
    const int n_chunks = (n_prompt + n_dec) * cpp;
    const size_t page_elems = (size_t)P * Rs;
    const int gsz = KV::SCALED ? P / a.n_scale : 1;   // keys per scale
    const int qp = BIAS ? a.qpos[b] : 0;
    const int max_exact = nb / 2;
    // the reference's f32 log of (max_dist / max_exact) taken in double
    const float log_denom =
        BIAS ? logf((float)((double)a.max_dist / (double)max_exact)) : 1.f;
    // this CTA's mass records: (sum of w, running max) per chunk and head
    float2* rec = MASS
        ? reinterpret_cast<float2*>(a.scratch) +
              ((size_t)b * gridDim.y + blockIdx.y) * max_pages * cpp * GR
        : nullptr;
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
        const int pid = rl < max_pages ? a.pt[(size_t)b * max_pages + rl] : 0;
        const int pofs = sub * KC + lane;
        const int phys = rl * P + pofs;
        const bool valid = pofs < P && (BIAS ? rl < max_pages : pid != 0) &&
                           (phys < tb || (phys >= tpb && phys < tpb + db));
        int bucket = 0;
        if constexpr (BIAS) {
            const int n = max(qp - phys, 0);
            bucket = n < max_exact ? n
                : min(max_exact + (int)(logf((float)n / (float)max_exact) /
                                        log_denom * (float)(nb - max_exact)),
                      nb - 1);
        }
        const size_t page_id = ((size_t)layer * a.n_pages + pid) * Hkv + hk;
        const size_t page_off = page_id * page_elems;

        float s[GR];
#pragma unroll
        for (int g = 0; g < GR; ++g) s[g] = 0.f;
        float ksc = 1.f, vsc = 1.f;
        if (valid) {
            KV::template dot<D, GR, FULL>(pool_k + page_off +
                                          (size_t)pofs * Rs, qs, a.Dh, s);
            if constexpr (KV::SCALED) {
                const size_t si = page_id * a.n_scale + pofs / gsz;
                ksc = a.k_scale[si];
                vsc = a.v_scale[si];
            }
        }
#pragma unroll
        for (int g = 0; g < GR; ++g) {
            float sc = valid ? s[g] * scale * ksc : NEG_INF;
            if constexpr (BIAS) {
                if (valid) sc += tab[g * nb + bucket];
            }
            const float m_new = fmaxf(m[g], warp_max(sc));
            const float w = valid ? expf(sc - m_new) : 0.f;
            const float alpha = expf(m[g] - m_new);
            const float wsum = warp_sum(w);
            l[g] = l[g] * alpha + wsum;
            m[g] = m_new;
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[g][d] *= alpha;
            s[g] = w;
            if constexpr (MASS) {
                if (lane == 0 && i < max_pages)
                    rec[(size_t)c * GR + g] = make_float2(wsum, m_new);
            }
        }
        // P.V over the chunk's valid keys only (the set is warp-uniform)
        unsigned vmask = __ballot_sync(FULL_MASK, valid);
        const E* vbase = pool_v + page_off + (size_t)(sub * KC) * Rs;
        while (vmask) {
            const int jj = __ffs(vmask) - 1;
            vmask &= vmask - 1;
            float vv[DPL];
            KV::template load_v<D, FULL>(vbase + (size_t)jj * Rs, lane, a.Dh,
                                         vv);
            float vj = 1.f;
            if constexpr (KV::SCALED) vj = __shfl_sync(FULL_MASK, vsc, jj);
#pragma unroll
            for (int g = 0; g < GR; ++g) {
                const float wj = __shfl_sync(FULL_MASK, s[g], jj) * vj;
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
    float* ml = qs;   // [GR][2]: final (m, l) per head, for the mass
    for (int idx = threadIdx.x; idx < ng * Dg; idx += blockDim.x) {
        const int g = idx / Dg, dd = idx % Dg;
        float mx = NEG_INF;
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red[(w * GR + g) * RS + D]);
        float lt = 0.f, ot = 0.f;
        for (int w = 0; w < WARPS; ++w) {
            const float* rec_w = red + (w * GR + g) * RS;
            const float f = expf(rec_w[D] - mx);
            lt += f * rec_w[D + 1];
            ot += f * rec_w[dd];
        }
        const size_t row = (size_t)b * Hq + hk * G + g0 + g;
        a.o[row * Dg + dd] = ot / fmaxf(lt, 1e-30f);
        if (dd == 0) {
            a.m[row] = mx;
            a.l[row] = lt;
            if constexpr (MASS) {
                ml[2 * g] = mx;
                ml[2 * g + 1] = lt;
            }
        }
    }
    if constexpr (MASS) {
        __syncthreads();   // ml and every warp's records are in place
        float* part = a.scratch +
                      (size_t)a.B * gridDim.y * max_pages * cpp * GMAX * 2 +
                      ((size_t)b * gridDim.y + blockIdx.y) * max_pages;
        // a walked page's records over its chunks and heads, rescaled to
        // the final max and normalized by the final sum
        auto page_mass = [&](int i) {
            float acc_m = 0.f;
            for (int sub = 0; sub < cpp; ++sub)
                for (int g = 0; g < ng; ++g) {
                    const float2 r = rec[(size_t)(i * cpp + sub) * GR + g];
                    acc_m += r.x * expf(r.y - ml[2 * g]) /
                             fmaxf(ml[2 * g + 1], 1e-30f);
                }
            return acc_m;
        };
        for (int rl = threadIdx.x; rl < max_pages; rl += blockDim.x) {
            float pm = 0.f;
            if (rl < n_prompt) pm += page_mass(rl);
            const int i = n_prompt + rl - dstart;
            if (rl >= dstart && rl < dstart + n_dec && i < max_pages)
                pm += page_mass(i);
            part[rl] = pm;
        }
    }
}

// mass[b, p] = sum over the row's CTAs of their partials, in CTA order, / Hq
__global__ void mass_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ mass, int n_cta,
                                   int max_pages, int Hq) {
    const int b = blockIdx.x;
    for (int p = threadIdx.x; p < max_pages; p += blockDim.x) {
        float s = 0.f;
        for (int y = 0; y < n_cta; ++y)
            s += part[((size_t)b * n_cta + y) * max_pages + p];
        mass[(size_t)b * max_pages + p] = s / (float)Hq;
    }
}

template <typename T, typename KV, int DP, int GR, bool FULL, bool MASS,
          bool BIAS>
cudaError_t launch_one(const Args& a) {
    const int G = a.Hq / a.Hkv;
    const int n_gchunks = (G + GMAX - 1) / GMAX;
    const size_t smem = sizeof(float) * (size_t)(
        GR * DP + WARPS * GR * (DP + 2) + (BIAS ? GR * a.n_buckets : 0));
    auto kern = paged_decode_kernel<T, KV, DP, GR, FULL, MASS, BIAS>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(a.B, a.Hkv * n_gchunks);
    kern<<<grid, WARPS * 32, smem, a.st>>>(a, n_gchunks,
                                            (float)(1.0 / sqrt((double)a.Dh)));
    err = cudaGetLastError();
    if (err != cudaSuccess || !MASS) return err;
    const float* part = a.scratch +
        (size_t)a.B * grid.y * a.max_pages * ((a.P + KC - 1) / KC) * GMAX * 2;
    mass_reduce_kernel<<<a.B, 128, 0, a.st>>>(part, a.mass, (int)grid.y,
                                              a.max_pages, a.Hq);
    return cudaGetLastError();
}

// BIAS instantiates only what kernel 7 runs: no mass, one query head a CTA.
template <typename T, typename KV, int DP, int GR, bool FULL, bool BIAS>
cudaError_t launch(const Args& a) {
    if constexpr (BIAS) {
        return launch_one<T, KV, DP, GR, FULL, false, true>(a);
    } else {
        if (a.mass != nullptr)
            return launch_one<T, KV, DP, GR, FULL, true, false>(a);
        return launch_one<T, KV, DP, GR, FULL, false, false>(a);
    }
}

template <typename T, typename KV, int DP, bool BIAS>
cudaError_t dispatch_g(const Args& a) {
    const int G = a.Hq / a.Hkv;
    if (BIAS || G <= 1) return launch<T, KV, DP, 1, true, BIAS>(a);
    if constexpr (!BIAS) {
        if (G <= 2) return launch<T, KV, DP, 2, true, false>(a);
        if (G <= 4) return launch<T, KV, DP, 4, true, false>(a);
        return launch<T, KV, DP, GMAX, true, false>(a);
    }
    return cudaErrorInvalidValue;
}

template <typename T, typename KV, bool BIAS>
cudaError_t dispatch_d(const Args& a) {
    constexpr int GP = BIAS ? 1 : GMAX;   // query heads a padded CTA holds
    const int D = a.Dh;
    if (D == 64) return dispatch_g<T, KV, 64, BIAS>(a);
    if (D == 128) return dispatch_g<T, KV, 128, BIAS>(a);
    if (D < 1) return cudaErrorInvalidValue;
    if (D <= 32) return launch<T, KV, 32, GP, false, BIAS>(a);
    if (D <= 64) return launch<T, KV, 64, GP, false, BIAS>(a);
    if (D <= 128) return launch<T, KV, 128, GP, false, BIAS>(a);
    if (D <= 256) return launch<T, KV, 256, GP, false, BIAS>(a);
    return cudaErrorInvalidValue;
}

// The sources' C entry: checks what the kernel relies on, then picks the
// instance for q's dtype, the head dim and the group size.
template <template <typename> class KVT, bool BIAS = false>
int entry(const Args& a, int is_bf16) {
    if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.B == 0 || a.P <= 0 ||
        !KVT<float>::ok_dim(a.Dh))
        return cudaErrorInvalidValue;
    if (BIAS && (a.Hq != a.Hkv || a.qpos == nullptr || a.table == nullptr ||
                 a.n_buckets < 2 || a.max_dist <= a.n_buckets / 2 ||
                 a.mass != nullptr))
        return cudaErrorInvalidValue;
    if (KVT<float>::SCALED &&
        (a.k_scale == nullptr || a.v_scale == nullptr || a.n_scale <= 0 ||
         a.P % a.n_scale != 0))
        return cudaErrorInvalidValue;
    if (a.mass != nullptr &&
        (a.scratch == nullptr || a.scratch_floats < mass_scratch_floats(a)))
        return cudaErrorInvalidValue;
    if (is_bf16) return dispatch_d<__nv_bfloat16, KVT<__nv_bfloat16>, BIAS>(a);
    return dispatch_d<float, KVT<float>, BIAS>(a);
}

}  // namespace paged
}  // namespace kubetpu

// The C interface of kernels 4-6: q [B, Hq, D] (f32 or bf16; D <=
// 256); pools [L, n_pages, Hkv, P, row] with row D (bf16/f32 like q, or
// int8) or D/2 (packed int4); k_scale/v_scale f32 [L, n_pages, Hkv, n_scale]
// (quantized pools; else null); page_table [B, max_pages] i32; layer [1]
// i32; t/t_pad/d [B] i32.  Outputs o f32 [B, Hq, D], m/l f32 [B, Hq] and,
// when `mass` is not null, mass f32 [B, max_pages] with `scratch` of
// `scratch_floats` floats.  All on the device.  Returns the launch's
// cudaError_t.
#define KUBETPU_PAGED_ENTRY(NAME, POLICY)                                      \
    extern "C" int NAME(const void* q, const void* pool_k, const void* pool_v,\
                        const void* k_scale, const void* v_scale,             \
                        const void* pt, const void* layer, const void* t,     \
                        const void* tpad, const void* d, void* o, void* m,    \
                        void* l, void* mass, void* scratch, int B, int Hq,    \
                        int Hkv, int n_pages, int P, int D, int max_pages,    \
                        int n_scale, int scratch_floats, int is_bf16,         \
                        void* stream) {                                       \
        kubetpu::paged::Args a{                                               \
            q, pool_k, pool_v, static_cast<const float*>(k_scale),            \
            static_cast<const float*>(v_scale), static_cast<const int*>(pt),  \
            static_cast<const int*>(layer), static_cast<const int*>(t),       \
            static_cast<const int*>(tpad), static_cast<const int*>(d),        \
            static_cast<float*>(o), static_cast<float*>(m),                   \
            static_cast<float*>(l), static_cast<float*>(mass),                \
            static_cast<float*>(scratch), B, Hq, Hkv, n_pages, P, D,          \
            max_pages, n_scale, scratch_floats,                               \
            static_cast<cudaStream_t>(stream)};                               \
        return kubetpu::paged::entry<POLICY>(a, is_bf16);                     \
    }
