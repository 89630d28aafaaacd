// Paged decode attention for Hopper (sm_90a): the page walks shared by the
// page formats, each kernel built from its own thin source.
//
//   paged_decode.cu      bf16/f32 pages   (TPU `_paged_kernel`,    kernel 4)
//   paged_decode_q8.cu   int8 pages       (TPU `_paged_kernel_q8`, kernel 5)
//   paged_decode_q4.cu   packed int4      (TPU `_paged_kernel_q4`, kernel 6)
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
// Two walks.  Kernels 4-6 run the chunk walk (paged_decode_kernel); kernel 7
// runs the split walk (paged_split_kernel), which kernels 4-6 are to move
// onto.  Both are templated on the page format (the policy KV).
//
// The chunk walk: one CTA per (row b, kv head, chunk of <= 8 query heads of
// that kv head), so a decode batch launches B * Hkv CTAs instead of the
// TPU's one program per row.  Each CTA reads layer, t, t_pad, d and its
// page-table row itself and walks only the used pages in the TPU kernel's
// order (prompt pages [0, ceil(t/P)), then decode pages from t_pad/P), cut
// into 32-key chunks.  The 16 warps take chunks round-robin; lane j of a
// warp scores key j with 16-byte loads straight from the pool (each key row
// is read once, by one lane), the warp runs the online softmax with
// shuffles, and the P.V product reads each value row coalesced across the
// warp.  Validity is the TPU kernel's predicate (phys < t | t_pad <= phys <
// t_pad + d, page id != 0), masked explicitly after the exp because NEG_INF
// is finite.  The warps' partials merge through shared memory at the end
// (the same logsumexp merge as merge_partials).  Few bytes are in flight
// per SM this way: a row of a few pages leaves most warps idle and pays the
// memory latency once per chunk.
//
// The split walk: the row's pages are cut into splits on the host, from
// the page table's width alone (t, t_pad and d live on the device and are
// never read by the host): ops/paged_attention.py takes one split a page,
// up to MAX_SPLITS = 32, so a split holds ceil(max_pages / n_splits)
// pages.  One CTA of 4 warps per (row, query head, split); a split with no
// used page loads nothing.  Otherwise the CTA's first thread puts its
// tiles in flight at entry with bulk async copies into a 2-stage ring of
// shared memory (a page of one head is P x D contiguous: 16 KB at bf16,
// D 64), each stage completing on an mbarrier; a tile holds at most 16 KB
// of keys, so head dims up to 256 and f32 pages stage a page in several
// tiles.  Lanes cooperate on a key row: DP / 8 lanes hold 8 channels each
// of the query and of the key (one 16-byte load at bf16), so a warp scores
// 256 / DP keys a step and sums each by shuffles inside the lane group.
// Each lane buckets one key of the warp's tile share once, and the warp
// reads it back by a shuffle.  A warp keeps an online softmax over its
// share of each tile (one rescale a tile); the CTA merges its warps
// through shared memory and writes its split's partial (acc, m, l) to
// scratch, or with one split a row the output itself.  The last CTA of a
// (row, head), found by an integer counter that it resets, merges the
// splits' partials in a fixed order (one lane a split, a shuffle tree for
// the max and the sum, then split order for acc): no float atomics, so two
// launches give equal bits.  Each dependent memory round trip costs ~1 us
// at this size, so the row's state and the first page id are fetched
// together, and the bias lookups run while the tile is in flight.  One
// page a split beat fewer, longer splits at every row length but the
// shortest (experiments/torch_paged_bias_scan.py): the merge costs a few
// microseconds, a CTA that turns its ring over waits a round trip a tile.
// Head dims other than 32/64/128/256, or a pool that is not 16-byte
// aligned, run an instance padded to the next of those that reads the rows
// from the pool with scalar loads instead of staging them.
//
// Page formats (the policy KV): a policy widens a key row into the score
// and a lane's value channels into f32, in registers (the split walk: 8
// channels of a row, `load8`).  Quantized pools carry f32 scales [L,
// n_pages, Hkv, n_scale], one per group of P / n_scale keys (1 for int8);
// the k-scale multiplies the score after * D^-0.5 and the v-scale multiplies
// the key's weight only for the P.V product, so l and the mass are taken
// from the unscaled weights, as in the TPU kernels.
//
// The mass (MASS, chunk walk): a page's mass is the sum over its keys of
// exp(s - M)/L, with M and L the final max and sum of each query head,
// averaged over the Hq heads.  A warp records each chunk's sum of weights
// with the running max it was taken against; after the merge, when M and L
// are known, the CTA rescales each record by exp(m_chunk - M)/L and sums a
// page's records over its chunks and heads into a per-CTA partial.  A
// second small kernel adds the partials of a row's CTAs in a fixed order
// and divides by Hq: no float atomics, so eviction reads the same mass from
// run to run.  Head dims 64 and 128 run chunk-walk instances with 16-byte
// key loads and one instance per query-group size; any other head dim up
// to 256 runs an instance padded to the next of 32/64/128/256 channels with
// scalar loads (8 query heads per CTA, whatever the group).
//
// The bias (kernel 7, split walk; MHA, no mass): each key's distance n =
// max(q_pos - phys, 0) is bucketed with T5's causal log-spaced rule, in the
// reference's f32 order (logf, IEEE division: no fast math, so the bucket
// is the plain version's), and the table entry of the query head is added
// to the score after * D^-0.5.  Validity has no page-id test, as the TPU
// kernel has no hole mask: a 0 in the used range attends page 0's keys; a
// row-local page past the table is not a key.  The weights are rounded to
// the pool's type before P.V, as the reference rounds them; l sums them in
// f32.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

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
    // the split walk: splits per row, the (row, head) counters (zero between
    // launches) and the splits' partials in `scratch`
    int n_splits = 0;
    int* count = nullptr;
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

    // The split walk: channels 8g .. 8g + 7 of a row as f32, 0 past Dh.
    // FULL: the row holds all of them, 16-byte aligned (vector loads).
    template <bool FULL>
    __device__ __forceinline__ static void load8(const Elem* row, int g,
                                                 int Dh, float (&out)[8]) {
        if constexpr (FULL) {
#pragma unroll
            for (int e = 0; e < 8; e += Vec16<T>::N)
                Vec16<T>::load(row + 8 * g + e, out + e);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
                out[e] = 8 * g + e < Dh ? to_f(row[8 * g + e]) : 0.f;
        }
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

// -- the chunk walk (kernels 4-6) ----------------------------------------------

// DP: channels held per query (a multiple of 32); FULL: the head dim is DP.
// Otherwise the head dim is Dh < DP and channels Dh..DP-1 are zero.
template <typename T, typename KV, int DP, int GR, bool FULL, bool MASS>
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

    const int layer = *a.layer;
    const int tb = a.t[b], tpb = a.tpad[b], db = a.d[b];
    const int n_prompt = (tb + P - 1) / P;   // row-local pages 0..n_prompt-1
    const int dstart = tpb / P;              // first decode page (row-local)
    const int n_dec = (db + P - 1) / P;
    const int cpp = (P + KC - 1) / KC;       // chunks per page
    const int n_chunks = (n_prompt + n_dec) * cpp;
    const size_t page_elems = (size_t)P * Rs;
    const int gsz = KV::SCALED ? P / a.n_scale : 1;   // keys per scale
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
        const bool valid = pofs < P && pid != 0 &&
                           (phys < tb || (phys >= tpb && phys < tpb + db));
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
            const float sc = valid ? s[g] * scale * ksc : NEG_INF;
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

template <typename T, typename KV, int DP, int GR, bool FULL, bool MASS>
cudaError_t launch_one(const Args& a) {
    const int G = a.Hq / a.Hkv;
    const int n_gchunks = (G + GMAX - 1) / GMAX;
    const size_t smem =
        sizeof(float) * (size_t)(GR * DP + WARPS * GR * (DP + 2));
    auto kern = paged_decode_kernel<T, KV, DP, GR, FULL, MASS>;
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

template <typename T, typename KV, int DP, int GR, bool FULL>
cudaError_t launch(const Args& a) {
    if (a.mass != nullptr) return launch_one<T, KV, DP, GR, FULL, true>(a);
    return launch_one<T, KV, DP, GR, FULL, false>(a);
}

template <typename T, typename KV, int DP>
cudaError_t dispatch_g(const Args& a) {
    const int G = a.Hq / a.Hkv;
    if (G <= 1) return launch<T, KV, DP, 1, true>(a);
    if (G <= 2) return launch<T, KV, DP, 2, true>(a);
    if (G <= 4) return launch<T, KV, DP, 4, true>(a);
    return launch<T, KV, DP, GMAX, true>(a);
}

template <typename T, typename KV>
cudaError_t dispatch_d(const Args& a) {
    const int D = a.Dh;
    if (D == 64) return dispatch_g<T, KV, 64>(a);
    if (D == 128) return dispatch_g<T, KV, 128>(a);
    if (D < 1) return cudaErrorInvalidValue;
    if (D <= 32) return launch<T, KV, 32, GMAX, false>(a);
    if (D <= 64) return launch<T, KV, 64, GMAX, false>(a);
    if (D <= 128) return launch<T, KV, 128, GMAX, false>(a);
    if (D <= 256) return launch<T, KV, 256, GMAX, false>(a);
    return cudaErrorInvalidValue;
}

// The chunk walk's C entry: checks what the kernel relies on, then picks
// the instance for q's dtype, the head dim and the group size.
template <template <typename> class KVT>
int entry(const Args& a, int is_bf16) {
    if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.B == 0 || a.P <= 0 ||
        !KVT<float>::ok_dim(a.Dh))
        return cudaErrorInvalidValue;
    if (KVT<float>::SCALED &&
        (a.k_scale == nullptr || a.v_scale == nullptr || a.n_scale <= 0 ||
         a.P % a.n_scale != 0))
        return cudaErrorInvalidValue;
    if (a.mass != nullptr &&
        (a.scratch == nullptr || a.scratch_floats < mass_scratch_floats(a)))
        return cudaErrorInvalidValue;
    if (is_bf16) return dispatch_d<__nv_bfloat16, KVT<__nv_bfloat16>>(a);
    return dispatch_d<float, KVT<float>>(a);
}

// -- the split walk (kernel 7) --------------------------------------------------

namespace split {

using namespace kubetpu::sm90;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 2;
constexpr int TILE_BYTES = 16384;   // the keys of one K (or V) tile
constexpr int MAX_SPLITS = 32;      // one lane each in the last CTA's merge

// Keys a tile holds at DP channels of E: 128, or fewer where a row is wide.
template <typename E, int DP>
__host__ __device__ constexpr int tile_keys() {
    return TILE_BYTES / (DP * (int)sizeof(E)) < 128
        ? TILE_BYTES / (DP * (int)sizeof(E)) : 128;
}

// Pages a split holds, for a page table `max_pages` wide.
__host__ __device__ inline int pages_per_split(int max_pages, int n_splits) {
    return (max_pages + n_splits - 1) / n_splits;
}

// Floats of scratch for the splits' partials: acc[Dh], m, l of each.
inline long long scratch_floats(const Args& a) {
    return (long long)a.B * a.Hq * a.n_splits * (a.Dh + 2);
}

// Shared memory (bytes): the mbarriers and the last-CTA flag, the warps'
// partials [WARPS][DP + 2] f32, then the ring's stages, each a K tile and
// a V tile [KT][DP] (a split of one tile allocates one stage).
template <int DP> struct Smem {
    static constexpr int BAR = 0;
    static constexpr int LAST = BAR + 2 * STAGES * 8;
    static constexpr int RED = 128;
    static constexpr int TILES =
        (RED + WARPS * (DP + 2) * 4 + 127) / 128 * 128;
    template <typename E>
    static constexpr size_t bytes(int stages) {
        return TILES + (size_t)stages * 2 * tile_keys<E, DP>() * DP *
                           sizeof(E);
    }
};

// DP: channels a lane group holds (8 a lane); FULL: the head dim is DP and
// the pool is 16-byte aligned, so tiles are staged by bulk copies.
// Otherwise the head dim is Dh <= DP and rows are read from the pool.
template <typename T, typename KV, int DP, bool FULL>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(Args a, float scale) {
    using E = typename KV::Elem;
    constexpr int LPK = DP / 8;            // lanes on one key row
    constexpr int KPW = 32 / LPK;          // keys a warp scores a step
    constexpr int KT = tile_keys<E, DP>();
    constexpr int KW = KT / WARPS;         // a warp's keys of a tile
    constexpr int NS = KW / KPW;           // its steps over them
    static_assert(KW <= 32 && KW % KPW == 0, "a tile's keys split by warp");
    const E* __restrict__ pool_k = static_cast<const E*>(a.pool_k);
    const E* __restrict__ pool_v = static_cast<const E*>(a.pool_v);
    const int P = a.P, Dh = a.Dh, Hq = a.Hq, max_pages = a.max_pages;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int grp = lane / LPK, gl = lane % LPK;
    const int split = blockIdx.x % a.n_splits;
    const int bh = blockIdx.x / a.n_splits;   // b * Hq + h
    const int b = bh / Hq, h = bh % Hq;
    const int hk = h / (Hq / a.Hkv);

    using L = Smem<DP>;
    extern __shared__ __align__(128) uint8_t smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
    uint64_t* empty = full + STAGES;
    int* last = reinterpret_cast<int*>(smem + L::LAST);
    float* red = reinterpret_cast<float*>(smem + L::RED);
    E* kst = reinterpret_cast<E*>(smem + L::TILES);

    // the split's used pages, in row order, each in tpp tiles of KT keys;
    // the loader fetches its first page's id with the row's state, not
    // after it
    const int pps = pages_per_split(max_pages, a.n_splits);
    const int p_lo = split * pps, p_hi = min(p_lo + pps, max_pages);
    const int pid_lo = FULL && threadIdx.x == 0 && p_lo < p_hi
        ? a.pt[(size_t)b * max_pages + p_lo] : 0;
    const int tb = a.t[b], tpb = a.tpad[b], db = a.d[b];
    auto used = [&](int rl) {
        const int k0 = rl * P;
        return k0 < tb || (db > 0 && k0 < tpb + db && k0 + P > tpb);
    };
    auto next_used = [&](int rl) {
        while (rl < p_hi && !used(rl)) ++rl;
        return rl;
    };
    const int tpp = (P + KT - 1) / KT;
    int n_tiles = 0;
    for (int rl = p_lo; rl < p_hi; ++rl) n_tiles += used(rl) ? tpp : 0;
    const int layer = *a.layer;
    auto page_row = [&](int rl) {   // the page's first key row in the pool
        const int pid = FULL && rl == p_lo
            ? pid_lo : a.pt[(size_t)b * max_pages + rl];
        return (((size_t)layer * a.n_pages + pid) * a.Hkv + hk) * P;
    };

    // the first thread keeps the ring filled (a cursor of its own)
    int l_rl = next_used(p_lo), l_sub = 0, next = 0;
    auto load = [&](int, int s) {
        const size_t row = page_row(l_rl) + (size_t)l_sub * KT;
        const int nk = min(KT, P - l_sub * KT);
        const uint32_t bytes = (uint32_t)(nk * DP * sizeof(E));
        E* kd = kst + (size_t)s * 2 * KT * DP;
        mbar_expect_tx(full + s, 2 * bytes);
        bulk_load(kd, pool_k + row * DP, bytes, full + s);
        bulk_load(kd + KT * DP, pool_v + row * DP, bytes, full + s);
        if (++l_sub == tpp) {
            l_sub = 0;
            l_rl = next_used(l_rl + 1);
        }
    };
    auto feed = [&](int need) {
        if (FULL && threadIdx.x == 0) {
            ring_feed<STAGES>(next, min(need, n_tiles), empty, true, load);
            ring_feed<STAGES>(next, n_tiles, empty, false, load);
        }
        __syncwarp();
    };
    if constexpr (FULL) {
        if (threadIdx.x == 0) {
            for (int s = 0; s < STAGES; ++s) {
                mbar_init(full + s, 1);
                mbar_init(empty + s, WARPS);   // one arrival a warp
            }
            mbar_fence_init();
        }
        __syncthreads();
        feed(STAGES);   // every byte of a one-tile split is in flight now
    }

    // this lane's 8 channels of the query
    float qv[8];
    {
        const T* qrow = static_cast<const T*>(a.q) + (size_t)bh * Dh;
#pragma unroll
        for (int e = 0; e < 8; ++e)
            qv[e] = 8 * gl + e < Dh ? to_f(qrow[8 * gl + e]) : 0.f;
    }
    const int nb = a.n_buckets, max_exact = nb / 2;
    const int qp = a.qpos[b];
    // the reference's f32 log of (max_dist / max_exact) taken in double
    const float log_denom =
        logf((float)((double)a.max_dist / (double)max_exact));
    const float* tab = a.table + (size_t)h * nb;

    float m = NEG_INF, l = 0.f, acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    int rl = next_used(p_lo), sub = 0;
    for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        feed(it + 1);
        const int key0 = sub * KT;
        // lane j buckets key j of the warp's share, once, and fetches its
        // bias while the tile is in flight
        float bias = 0.f;
        bool valid = false;
        if (lane < KW) {
            const int pofs = key0 + warp * KW + lane;
            const int phys = rl * P + pofs;
            valid = pofs < P && (phys < tb || (phys >= tpb && phys < tpb + db));
            const int n = max(qp - phys, 0);
            const int bucket = n < max_exact ? n
                : min(max_exact + (int)(logf((float)n / (float)max_exact) /
                                        log_denom * (float)(nb - max_exact)),
                      nb - 1);
            bias = valid ? __ldg(tab + bucket) : 0.f;
        }
        const unsigned vmask = __ballot_sync(FULL_MASK, valid);
        const E* kt;
        const E* vt;
        if constexpr (FULL) {
            mbar_wait(full + s, (it / STAGES) & 1);
            kt = kst + (size_t)s * 2 * KT * DP;
            vt = kt + KT * DP;
        } else {
            const size_t row = page_row(rl) + key0;
            kt = pool_k + row * Dh;
            vt = pool_v + row * Dh;
        }
        const int rs = FULL ? DP : Dh;   // row stride, in elements

        float sc[NS];
        float mt = NEG_INF;
#pragma unroll
        for (int st = 0; st < NS; ++st) {
            const int j = st * KPW + grp;            // the warp's key j
            const bool ok = (vmask >> j) & 1u;
            float part = 0.f;
            if (ok) {
                float kf[8];
                KV::template load8<FULL>(kt + (size_t)(warp * KW + j) * rs,
                                         gl, Dh, kf);
#pragma unroll
                for (int e = 0; e < 8; ++e) part = fmaf(qv[e], kf[e], part);
            }
#pragma unroll
            for (int o = LPK / 2; o; o >>= 1)
                part += __shfl_xor_sync(FULL_MASK, part, o);
            const float bj = __shfl_sync(FULL_MASK, bias, j);
            // NEG_INF is finite: the weight below is masked explicitly
            sc[st] = ok ? part * scale + bj : NEG_INF;
            mt = fmaxf(mt, sc[st]);
        }
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1)
            mt = fmaxf(mt, __shfl_xor_sync(FULL_MASK, mt, o));
        const float m_new = fmaxf(m, mt);
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] *= alpha;
#pragma unroll
        for (int st = 0; st < NS; ++st) {
            const int j = st * KPW + grp;
            if ((vmask >> j) & 1u) {
                const float w = expf(sc[st] - m_new);
                l += w;
                // P.V with the weight in the pool's type, as the reference
                const float wv = to_f(from_f<E>(w));
                float vf[8];
                KV::template load8<FULL>(vt + (size_t)(warp * KW + j) * rs,
                                         gl, Dh, vf);
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[e] = fmaf(wv, vf[e], acc[e]);
            }
        }
        m = m_new;
        if constexpr (FULL) mbar_arrive_warp(empty + s);
        feed(0);
        if (++sub == tpp) {
            sub = 0;
            rl = next_used(rl + 1);
        }
    }

    // the warp's lane groups, then the CTA's warps (logsumexp merge)
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
        l += __shfl_xor_sync(FULL_MASK, l, o);
#pragma unroll
        for (int e = 0; e < 8; ++e)
            acc[e] += __shfl_xor_sync(FULL_MASK, acc[e], o);
    }
    float* mine = red + warp * (DP + 2);
    if (grp == 0) {
#pragma unroll
        for (int e = 0; e < 8; ++e) mine[8 * gl + e] = acc[e];
    }
    if (lane == 0) {
        mine[DP] = m;
        mine[DP + 1] = l;
    }
    __syncthreads();
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red[w * (DP + 2) + DP]);
    float f[WARPS], lt = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        f[w] = expf(red[w * (DP + 2) + DP] - mx);
        lt += f[w] * red[w * (DP + 2) + DP + 1];
    }
    // one split: the CTA's merge is the output; else its split's partial
    const bool single = a.n_splits == 1;
    const int rec = Dh + 2;   // a split's partial: acc[Dh], m, l
    float* part = a.scratch + ((size_t)bh * a.n_splits + split) * rec;
    for (int dd = threadIdx.x; dd < Dh; dd += THREADS) {
        float ot = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) ot += f[w] * red[w * (DP + 2) + dd];
        if (single) a.o[(size_t)bh * Dh + dd] = ot / fmaxf(lt, 1e-30f);
        else part[dd] = ot;
    }
    if (single) {
        if (threadIdx.x == 0) {
            a.m[bh] = mx;
            a.l[bh] = lt;
        }
        return;
    }
    if (threadIdx.x == 0) {
        part[Dh] = mx;
        part[Dh + 1] = lt;
    }

    // the last CTA of (row, head) merges the splits in split order
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        const int done = atomicAdd(a.count + bh, 1);
        *last = done == a.n_splits - 1;
    }
    __syncthreads();
    if (!*last) return;
    __threadfence();
    // lane sp holds split sp's (m, l); every warp reduces them by the same
    // shuffle tree, so the order is fixed
    const float* parts = a.scratch + (size_t)bh * a.n_splits * rec;
    const bool has = lane < a.n_splits;
    const float ms = has ? __ldcg(parts + lane * rec + Dh) : NEG_INF;
    const float mm = warp_max(ms);
    const float fs = has ? expf(ms - mm) : 0.f;
    const float ll = warp_sum(has ? fs * __ldcg(parts + lane * rec + Dh + 1)
                                  : 0.f);
    for (int d0 = 0; d0 < Dh; d0 += THREADS) {   // uniform: shuffles inside
        const int dd = d0 + threadIdx.x;
        float ot = 0.f;
        for (int sp = 0; sp < a.n_splits; ++sp) {
            const float f = __shfl_sync(FULL_MASK, fs, sp);
            if (dd < Dh) ot += f * __ldcg(parts + sp * rec + dd);
        }
        if (dd < Dh) a.o[(size_t)bh * Dh + dd] = ot / fmaxf(ll, 1e-30f);
    }
    if (threadIdx.x == 0) {
        a.m[bh] = mm;
        a.l[bh] = ll;
        a.count[bh] = 0;   // ready for the next launch
    }
}

template <typename T, typename KV, int DP, bool FULL>
cudaError_t launch_split(const Args& a) {
    using E = typename KV::Elem;
    constexpr int KT = tile_keys<E, DP>();
    // a split of one tile needs one stage
    const int tiles = pages_per_split(a.max_pages, a.n_splits) *
                      ((a.P + KT - 1) / KT);
    const size_t smem = Smem<DP>::template bytes<E>(
        FULL ? (tiles > 1 ? STAGES : 1) : 0);
    auto kern = paged_split_kernel<T, KV, DP, FULL>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<a.B * a.Hq * a.n_splits, THREADS, smem, a.st>>>(
        a, (float)(1.0 / sqrt((double)a.Dh)));
    return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch_split(const Args& a) {
    const int D = a.Dh;
    // bulk copies need 16-byte aligned rows and pool
    const bool aligned = ((reinterpret_cast<uintptr_t>(a.pool_k) |
                           reinterpret_cast<uintptr_t>(a.pool_v)) & 15) == 0;
    if (aligned && D == 32) return launch_split<T, KV, 32, true>(a);
    if (aligned && D == 64) return launch_split<T, KV, 64, true>(a);
    if (aligned && D == 128) return launch_split<T, KV, 128, true>(a);
    if (aligned && D == 256) return launch_split<T, KV, 256, true>(a);
    if (D < 1) return cudaErrorInvalidValue;
    if (D <= 32) return launch_split<T, KV, 32, false>(a);
    if (D <= 64) return launch_split<T, KV, 64, false>(a);
    if (D <= 128) return launch_split<T, KV, 128, false>(a);
    if (D <= 256) return launch_split<T, KV, 256, false>(a);
    return cudaErrorInvalidValue;
}

// The split walk's C entry for kernel 7 (the bias, MHA, no mass).
template <template <typename> class KVT>
int entry_bias(const Args& a, int is_bf16) {
    if (a.Hkv <= 0 || a.Hq != a.Hkv || a.B == 0 || a.P <= 0 ||
        !KVT<float>::ok_dim(a.Dh) || a.max_pages <= 0 || a.qpos == nullptr ||
        a.table == nullptr || a.n_buckets < 2 ||
        a.max_dist <= a.n_buckets / 2 || a.mass != nullptr ||
        a.n_splits < 1 || a.n_splits > min(a.max_pages, MAX_SPLITS) ||
        a.count == nullptr || a.scratch == nullptr ||
        a.scratch_floats < scratch_floats(a))
        return cudaErrorInvalidValue;
    if (is_bf16) return dispatch_split<__nv_bfloat16, KVT<__nv_bfloat16>>(a);
    return dispatch_split<float, KVT<float>>(a);
}

}  // namespace split

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
