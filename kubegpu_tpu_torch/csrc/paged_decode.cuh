// Paged decode attention for Hopper (sm_90a): the page walk shared by the
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
// The split walk (paged_split_kernel, templated on the page format, the
// policy KV): the row's pages are cut into splits on the host, from
// the page table's width alone (t, t_pad and d live on the device and are
// never read by the host): ops/paged_attention.py takes one split a page,
// up to MAX_SPLITS = 32, so a split holds ceil(max_pages / n_splits)
// pages.  One CTA of 4 warps per (row, kv head, chunk of <= 8 query heads
// of that kv head, split); a split with no used page loads nothing.  A page
// is used when it holds a valid key (and, for kernels 4-6, its table
// entry is not the hole 0), and only its rows [0, hi) are read, hi the end
// of its last valid key.  Validity is the TPU kernels' predicate (phys < t
// | t_pad <= phys < t_pad + d), masked explicitly after the exp because
// NEG_INF is finite.  The CTA's first thread puts its tiles in flight
// at entry with bulk async copies into a 2-stage ring of shared memory (a
// page of one kv head is P contiguous rows), each stage completing on an
// mbarrier; a tile holds at most 16 KB of key rows and at most 8192 / DP
// keys, so wide rows stage a page in several tiles.  Each key row read from
// shared memory is scored against all of the CTA's query heads, in one of
// two inner loops.  The tensor-core walk (walk_tc: kernels 4-6 with bf16
// queries at head dims 64 and 128, the serving engine's) runs Q K^T and
// P V as mma.sync tiles, the heads the rows of the A operand, its tiles
// staged by cp.async into padded rows.  The CUDA-core walk (f32, other
// head dims, kernel 7): DP / 8 lanes hold 8 channels each of the key
// and of every query head of the CTA (GR of them), so a warp scores
// 256 / DP keys a step, summing each by shuffles inside the lane group; it
// was the first design for kernels 4 and 6 too, and spent most of their
// time on those shuffles and f32 FMAs (int4 rows at 4096 keys took longer
// than bf16 ones; PERF.md).  Each lane checks one key of the warp's tile
// share once (validity, bias bucket, quantization scales), and the warp
// reads it back by a shuffle.  A warp keeps an online softmax per query
// head over its share of each tile (the CUDA-core walk rescales once per
// NSUB steps); the CTA merges its warps through shared memory (aliasing
// the spent ring) and writes its split's partial (acc, m, l) per head to
// scratch, or with one split a row the output itself.  The last CTA of a
// (row, kv head, chunk), found by an integer counter that it resets,
// merges the splits' partials in a fixed order (one lane a split, a
// shuffle tree for the max and the sum, then split order for acc): no
// float atomics, so two launches give equal bits.  Each dependent memory
// round trip costs ~1 us at this size, so the row's state and the first
// page id are fetched together, and the per-key lookups (bias, scales) run
// while the tile is in flight.  One page a split beat fewer, longer splits
// at every row length but the shortest
// (experiments/torch_paged_bias_scan.py): the merge costs a few
// microseconds, a CTA that turns its ring over waits a round trip a tile.
// Head dims 64 and 128 (kernel 7: 32/64/128/256) over a 16-byte aligned
// pool run staged instances: the tensor-core one for bf16 queries (8 query
// heads a CTA), one per query-group size (GR 1, 2, 4, 8) for f32; any
// other head dim up to 256, or a misaligned pool, runs a CUDA-core
// instance padded to the next of 32/64/128/256 channels (8 query heads per
// CTA) that reads the rows from the pool with scalar loads instead of
// staging them.
//
// Page formats (the policy KV): a policy widens a lane's 8 channels of a
// row into f32 in registers for the CUDA-core walk (`load8`) and names its
// format (`FMT`) for the tensor-core walk, which reads bf16 rows as they
// are and turns int8 and int4 rows into bf16 fragments itself.
// Quantized pools carry f32 scales [L, n_pages, Hkv, n_scale], one per
// group of P / n_scale keys (one a key for int8); the k-scale multiplies
// the score after * D^-0.5 and the v-scale multiplies the key's weight only
// for the P.V product, so l and the mass are taken from the unscaled
// weights, as in the TPU kernels.  The weight of the P.V product is rounded
// to q's type after the v-scale (w.astype(v.dtype) and (w * vs).astype(
// v.dtype) in the TPU kernels, whose v has q's type); in f32 that is the
// identity.
//
// The mass (MASS), in the same launch: a page's mass is the sum over its
// keys of exp(s - M)/L, with M and L the final max and sum of each query
// head, averaged over the Hq heads.  At the end of each page it walked a
// warp records, per query head, the sum of its weights over the page and
// the running max it was taken against; the last CTA of a (row, kv head,
// chunk), which knows M and L, turns the records into the chunk's page
// masses, and the last of a row's (kv head, chunk) merges, found by a
// second counter, adds them in (kv head, chunk) order, divides by Hq and
// resets its counter.  No float atomics, so eviction reads the same mass
// from run to run.
//
// The bias (kernel 7; MHA, no mass): each key's distance n = max(q_pos -
// phys, 0) is bucketed with T5's causal log-spaced rule, in the
// reference's f32 order (logf, IEEE division: no fast math, so the bucket
// is the plain version's), and the table entry of the query head is added
// to the score after * D^-0.5.  Validity has no page-id test, as the TPU
// kernel has no hole mask: a 0 in the used range attends page 0's keys; a
// row-local page past the table is not a key.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

#include <math.h>
#include <type_traits>

namespace kubetpu {
namespace paged {

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
    float* scratch;         // partials and mass records
    int B, Hq, Hkv, n_pages, P, Dh, max_pages, n_scale, scratch_floats;
    cudaStream_t st;
    // kernel 7 only: per-row query position, [Hq, n_buckets] f32 bias table
    const int* qpos = nullptr;
    const float* table = nullptr;
    int n_buckets = 0, max_dist = 0;
    // splits per row and the counters (zero between launches): one per
    // (row, kv head, query chunk), then one per row
    int n_splits = 0;
    int* count = nullptr;
};

// -- page formats -------------------------------------------------------------
// load8 (the CUDA-core walk): channels 8g .. 8g + 7 of a row as f32, 0 past
// Dh; FULL: the row holds all DP of them and is 16-byte aligned (vector
// loads).  FMT (the tensor-core walk): how a row's bytes become bf16
// fragments.  row_elems: a row's stride in elements of Elem.

enum class Fmt { PLAIN, INT8, PACKED };

// 2^23 + byte k of w, exactly: the byte goes into the mantissa of 2^23 by a
// byte permute (no integer to float conversion, a quarter-rate instruction)
__device__ __forceinline__ float byte_2p23(uint32_t w, int k) {
    return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | k));
}

// bf16/f32 pages of q's type.
template <typename T>
struct PlainPages {
    using Elem = T;
    static constexpr bool SCALED = false;
    static constexpr Fmt FMT = Fmt::PLAIN;
    static bool ok_dim(int) { return true; }
    __host__ __device__ static constexpr int row_elems(int dh) { return dh; }

    template <int DP, bool FULL>
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

// int8 pages, one scale a key (n_scale == P).  A key row is Dh bytes, 128
// at D = 128; lane group lane g's channels 8g .. 8g + 7 are one 8-byte
// load.
template <typename T>
struct Int8Pages {
    using Elem = int8_t;
    static constexpr bool SCALED = true;
    static constexpr Fmt FMT = Fmt::INT8;
    static bool ok_dim(int) { return true; }
    __host__ __device__ static constexpr int row_elems(int dh) { return dh; }

    template <int DP, bool FULL>
    __device__ __forceinline__ static void load8(const Elem* row, int g,
                                                 int Dh, float (&out)[8]) {
        if constexpr (FULL) {
            // x ^ 0x80 is x + 128 as an unsigned byte
            const uint2 r = *reinterpret_cast<const uint2*>(row + 8 * g);
            const uint32_t x = r.x ^ 0x80808080u, y = r.y ^ 0x80808080u;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                out[e] = byte_2p23(x, e) - 8388736.f;   // 2^23 + 128
                out[4 + e] = byte_2p23(y, e) - 8388736.f;
            }
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
                out[e] = 8 * g + e < Dh ? (float)row[8 * g + e] : 0.f;
        }
    }
};

// Packed int4 pages, one scale per group of P / n_scale keys.  A key row is
// Dh/2 bytes; byte c holds channel c in its low nibble and channel
// c + Dh/2 in its high nibble, each biased by +8, so the byte 0x88 is 0.
// Lane group lane g's channels 8g .. 8g + 7 are the low nibbles of bytes
// 8g .. 8g + 7 below Dh/2 and the high nibbles of bytes 8g - Dh/2 ..
// above it: one 8-byte load, read by two lanes of the group.
template <typename T>
struct Int4Pages {
    using Elem = uint8_t;
    static constexpr bool SCALED = true;
    static constexpr Fmt FMT = Fmt::PACKED;
    static bool ok_dim(int dh) { return dh % 2 == 0; }
    __host__ __device__ static constexpr int row_elems(int dh) {
        return dh / 2;
    }

    __device__ __forceinline__ static float nib(unsigned b, int shift) {
        return (float)((int)((b >> shift) & 0xFu) - 8);
    }

    template <int DP, bool FULL>
    __device__ __forceinline__ static void load8(const Elem* row, int g,
                                                 int Dh, float (&out)[8]) {
        if constexpr (FULL) {
            constexpr int H = DP / 2;
            static_assert(H % 8 == 0, "a lane's 8 bytes lie in one half");
            const bool high = 8 * g >= H;
            const uint2 r = *reinterpret_cast<const uint2*>(
                row + (high ? 8 * g - H : 8 * g));
            const int sh = high ? 4 : 0;
            const unsigned x = (r.x >> sh) & 0x0F0F0F0Fu;
            const unsigned y = (r.y >> sh) & 0x0F0F0F0Fu;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                out[e] = byte_2p23(x, e) - 8388616.f;   // 2^23 + 8
                out[4 + e] = byte_2p23(y, e) - 8388616.f;
            }
        } else {
            const int h = Dh / 2;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int ch = 8 * g + e;
                out[e] = ch >= Dh ? 0.f
                    : ch < h ? nib(row[ch], 0) : nib(row[ch - h], 4);
            }
        }
    }
};

// -- the split walk ----------------------------------------------------------

namespace split {

using namespace kubetpu::sm90;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 2;
constexpr int TILE_BYTES = 16384;   // the key rows of one K (or V) tile
constexpr int MAX_SPLITS = 32;      // one lane each in the last CTA's merge

__host__ __device__ constexpr int cmin(int x, int y) { return x < y ? x : y; }

// Bytes of a key row of DP channels in the page format.
template <typename KV, int DP>
__host__ __device__ constexpr int row_bytes() {
    return KV::row_elems(DP) * (int)sizeof(typename KV::Elem);
}

// Keys a tile holds: at most 16 KB of rows and at most 8 score steps a
// warp (8192 / DP keys), at most 128.
template <typename KV, int DP>
__host__ __device__ constexpr int tile_keys() {
    return cmin(cmin(TILE_BYTES / row_bytes<KV, DP>(), 8192 / DP), 128);
}

// Pages a split holds, for a page table `max_pages` wide.
__host__ __device__ inline int pages_per_split(int max_pages, int n_splits) {
    return (max_pages + n_splits - 1) / n_splits;
}

// Chunks of <= GMAX query heads a kv head's group is cut into.
inline int query_chunks(const Args& a) {
    return (a.Hq / a.Hkv + GMAX - 1) / GMAX;
}

// Floats of scratch: the splits' partials, acc[Dh], m, l per query head and
// split; with the mass also a (sum, max) record per query head, page and
// warp (before the partials) and one page-mass partial per (row, kv head,
// query chunk) and page (after them).
inline long long scratch_floats(const Args& a) {
    long long n = (long long)a.B * a.Hq * a.n_splits * (a.Dh + 2);
    if (a.mass != nullptr)
        n += (long long)a.B * a.max_pages *
             ((long long)a.Hq * WARPS * 2 +
              (long long)a.Hkv * query_chunks(a));
    return n;
}

// Shared memory (bytes): the mbarriers, the last-CTA flag and each query
// head's final (m, l), then the ring's stages, each a K tile and a V tile of
// KT rows (a split of one tile allocates one stage); once the walk is done
// the warps' partials [WARPS][GR][DP + 2] f32 reuse the ring.
template <typename KV, int DP, int GR> struct Smem {
    static constexpr int BAR = 0;
    static constexpr int LAST = BAR + 2 * STAGES * 8;
    static constexpr int HEADS = LAST + 16;   // [GMAX][2] f32
    static constexpr int TILES = 128;
    static constexpr int TILE = tile_keys<KV, DP>() * row_bytes<KV, DP>();
    static constexpr int RED = WARPS * GR * (DP + 2) * 4;
    // the tensor-core walk's tiles: rows padded by 16 bytes
    static constexpr int TILE_TC = tile_keys<KV, DP>() *
                                   (row_bytes<KV, DP>() + 16);
    static_assert(HEADS + GMAX * 2 * 4 <= TILES, "header fits");
    static size_t bytes(int stages, bool tc) {
        const size_t ring = (size_t)stages * 2 * (tc ? TILE_TC : TILE);
        return TILES + (ring > (size_t)RED ? ring : (size_t)RED);
    }
};

// Kernels 4-6 (bf16, int8 and int4 pages) with bf16 queries at head dims
// 64 and 128 run the tensor-core walk; everything else (f32, other head
// dims, a misaligned pool, kernel 7) the CUDA-core walk.
template <typename T, int DP, bool FULL, bool BIAS>
__host__ __device__ constexpr bool use_tc() {
    return std::is_same<T, __nv_bfloat16>::value && FULL && !BIAS &&
           (DP == 64 || DP == 128);
}

// A split's pages [p_lo, p_hi) of one row: a used page's valid keys lie in
// its rows [0, hi), hi = 0 for a page the walk skips (no valid key or, with
// HOLE, the table's hole 0).  A cursor walks the used pages a tile of KT
// keys at a time.
template <bool HOLE, int KT>
struct Pages {
    const int* pt;   // the row's page table
    int p_lo, p_hi, pid_lo, P, t, tpad, d;
    size_t head0;    // the index of page 0 of this layer and kv head
    int hkv;
    struct Cursor { int rl, pid, hi, sub; };

    // the index of page `id` of the layer and kv head: [n_pages, Hkv]
    __device__ __forceinline__ size_t head_page(int id) const {
        return head0 + (size_t)id * hkv;
    }
    __device__ __forceinline__ int pid(int rl) const {
        return rl == p_lo ? pid_lo : pt[rl];
    }
    __device__ __forceinline__ int extent(int rl, int id) const {
        const int k0 = rl * P;
        int hi = k0 < t ? min(P, t - k0) : 0;
        if (d > 0 && k0 < tpad + d && k0 + P > tpad)
            hi = max(hi, min(P, tpad + d - k0));
        return HOLE && id == 0 ? 0 : hi;
    }
    __device__ __forceinline__ void seek(Cursor& c, int rl) const {
        for (; rl < p_hi; ++rl) {
            const int id = pid(rl), hi = extent(rl, id);
            if (hi > 0) {
                c = Cursor{rl, id, hi, 0};
                return;
            }
        }
        c = Cursor{p_hi, 0, 0, 0};
    }
    __device__ __forceinline__ void advance(Cursor& c) const {
        if (++c.sub * KT >= c.hi) seek(c, c.rl + 1);
    }
};

// Where a CTA of the split walk works: its split, its (row, kv head, query
// chunk) index `cta`, the row b, the kv head hk and its query heads h0 ..
// h0 + ng - 1.  The block index is read with a volatile move, so the
// epilogue's second call is not merged with the first: the walk's
// registers then hold only what the walk itself uses.
struct Place { int split, cta, b, hk, h0, ng; };

template <int GR>
__device__ __forceinline__ Place place(const Args& a, int n_chunks) {
    unsigned bid;
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bid));
    Place at;
    at.split = (int)bid % a.n_splits;
    at.cta = (int)bid / a.n_splits;   // (b * Hkv + hk) * n_chunks + chunk
    at.b = at.cta / n_chunks / a.Hkv;
    at.hk = at.cta / n_chunks % a.Hkv;
    const int G = a.Hq / a.Hkv;
    at.h0 = at.hk * G + at.cta % n_chunks * GMAX;
    at.ng = min(GR, at.hk * G + G - at.h0);
    return at;
}

// The split's pages of row at.b, its state and first page id fetched
// together, and the number of KT-key tiles they hold.
template <bool HOLE, int KT>
__device__ __forceinline__ Pages<HOLE, KT> split_pages(const Args& a,
                                                       const Place& at,
                                                       int& n_tiles) {
    const int pps = pages_per_split(a.max_pages, a.n_splits);
    const int p_lo = at.split * pps, p_hi = min(p_lo + pps, a.max_pages);
    const int* ptb = a.pt + (size_t)at.b * a.max_pages;
    const Pages<HOLE, KT> pages{
        ptb, p_lo, p_hi, p_lo < p_hi ? ptb[p_lo] : 0, a.P, a.t[at.b],
        a.tpad[at.b], a.d[at.b], (size_t)*a.layer * a.n_pages * a.Hkv + at.hk,
        a.Hkv};
    n_tiles = 0;
    for (int rl = p_lo; rl < p_hi; ++rl)
        n_tiles += (pages.extent(rl, pages.pid(rl)) + KT - 1) / KT;
    return pages;
}

// -- the tensor-core walk -----------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// four 8x8 b16 matrices, rows at the lanes' addresses (lanes 8i .. 8i + 7
// give matrix i's), as mma B fragments; .trans: transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}
// d += A B, m16n8k16, bf16 in, f32 out, for A's rows 0-7 only: rows 8-15
// are zero, so only a0 (k 2c, 2c + 1) and a2 (k 2c + 8, 2c + 9) are
// passed, and only row g's accumulators (columns 2c, 2c + 1) are kept
__device__ __forceinline__ void mma_bf16(float (&d)[2], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
    float z0, z1;
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%10,%10};\n"
        : "+f"(d[0]), "+f"(d[1]), "=f"(z0), "=f"(z1)
        : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f));
}
// The nibbles at bit sh of x's two 16-bit halves as bf16x2, minus 8:
// 0x4300 | n is bf16 128 + n, and 136 comes off, exactly.
__device__ __forceinline__ uint32_t nib2_bf16(uint32_t x, int sh) {
    const uint32_t v = ((x >> sh) & 0x000F000Fu) | 0x43004300u;
    const uint32_t k = 0x43084308u;   // bf16x2 (136, 136)
    __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                               *reinterpret_cast<const __nv_bfloat162*>(&k));
    return *reinterpret_cast<uint32_t*>(&r);
}
// The int8 bytes 0 and 2 of x as bf16x2 (byte 0 the low half), exactly,
// in two LOP3s and one HSUB2 (bytes 1 and 3 are ignored): 0x4300 | (b &
// 0x7F) is bf16 128 + (b & 0x7F), and 0x4300 | (b & 0x80) is 128, or 256
// for a negative byte, which comes off.  |b| <= 128 fits bf16's
// significand; the 2^23 route (a byte permute and an FADD a byte, an F2FP a
// pair) costs 5.5 instructions a pair against these 3.5 to 4.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t x) {
    const uint32_t v = (x & 0x007F007Fu) | 0x43004300u;
    const uint32_t k = (x & 0x00800080u) | 0x43004300u;
    __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                               *reinterpret_cast<const __nv_bfloat162*>(&k));
    return *reinterpret_cast<uint32_t*>(&r);
}
// N contiguous bytes of shared memory (4 to 32, aligned to min(N, 16)) as
// N / 4 words
template <int N>
__device__ __forceinline__ void lds_words(uint32_t (&w)[N / 4],
                                          const uint8_t* src) {
    if constexpr (N >= 16) {
#pragma unroll
        for (int i = 0; i < N / 16; ++i) {
            const uint4 v = reinterpret_cast<const uint4*>(src)[i];
            w[4 * i] = v.x; w[4 * i + 1] = v.y;
            w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
        }
    } else if constexpr (N == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        w[0] = v.x; w[1] = v.y;
    } else {
        w[0] = *reinterpret_cast<const uint32_t*>(src);
    }
}

// The tensor-core walk of kernels 4-6 (bf16 queries, head dims 64 and
// 128): each warp takes KW keys of every tile and runs S^T = Q K^T and
// O += P V as mma.sync m16n8k16 (bf16 in, f32 accumulate), the CTA's <= 8
// query heads the rows of the A operand (rows 8-15 zero), so a key row
// read from shared memory serves all of them in one instruction.  Lane
// (g = lane / 4, c = lane % 4) holds head g's scores of keys 8j + 2c + e,
// its online softmax (m, l per head, reduced over the quad at the end) and
// its o fragments.  Tiles come in by cp.async from every thread into rows
// padded by 16 bytes, so ldmatrix's 8 rows at one column hit 8 different
// banks; a tile is reused once all warps pass a barrier.  Quantized rows
// become bf16 fragments in registers, read from shared memory with the
// head dims permuted, consistently for q, K, V and o, so that a lane's
// fragments come from contiguous bytes:
//   int8 (BPT = D/4 bytes of a K row, BPG = D/8 of a V row): in a QK step
//     s, k = 2c + e is dim BPT c + 4s + 2e and k = 8 + 2c + e is dim
//     BPT c + 4s + 1 + 2e (a lane's word s, bytes 0, 2 and 1, 3); o's
//     column n of dim tile i is dim BPG n + i (byte i of the lane's V
//     slice, two keys' bytes interleaved into a fragment);
//   int4 (BPT = D/8, BPG = D/16): k = 2c + e is dim BPT c + 2s + e (a
//     low nibble) and k = 8 + 2c + e is dim D/2 + BPT c + 2s + e (the high
//     nibble of the same byte); o's column n of dim tile i is dim BPG n + i
//     (low nibbles) or D/2 + BPG n + i - BPG (high).
// The weights are rounded to bf16 after the v-scale as P V's A operand, as
// the reference rounds them.  Leaves each warp's (acc, m, l) of each head
// in `red`.
template <typename KV, int DP, int GR, bool MASS>
__device__ __forceinline__ void walk_tc(const Args& a, float scale,
                                        int n_chunks, uint8_t* smem) {
    using BF = __nv_bfloat16;
    using L = Smem<KV, DP, GR>;
    constexpr Fmt F = KV::FMT;
    constexpr bool SC = KV::SCALED;
    constexpr int KT = tile_keys<KV, DP>();
    constexpr int KW = KT / WARPS;          // a warp's keys of a tile
    constexpr int NT = KW / 8, KQ = KW / 16;
    constexpr int RB = row_bytes<KV, DP>(), SR = RB + 16;
    constexpr int NKS = DP / 16, NDT = DP / 8;
    // quantized bytes a lane reads of a K row (QK) and of a V row (P V)
    constexpr int BPT = F == Fmt::INT8 ? DP / 4 : DP / 8;
    constexpr int BPG = F == Fmt::INT8 ? DP / 8 : DP / 16;
    static_assert(KW % 16 == 0 && NKS % 2 == 0 && NDT % 2 == 0,
                  "a warp's keys and the dims in whole mma tiles");
    const int P = a.P, Dh = a.Dh, Hq = a.Hq, max_pages = a.max_pages;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, c = lane & 3;
    const Place at = place<GR>(a, n_chunks);
    int n_tiles;
    const auto pages = split_pages<true, KT>(a, at, n_tiles);
    using Cursor = typename Pages<true, KT>::Cursor;
    const int p_lo = pages.p_lo, p_hi = pages.p_hi;
    const int tb = pages.t, tpb = pages.tpad, db = pages.d;
    uint8_t* ring = smem + L::TILES;

    // every thread copies its share of a tile's used rows into stage s
    Cursor lc;
    pages.seek(lc, p_lo);
    auto issue = [&](int s) {
        if (lc.rl < p_hi) {
            constexpr int CPR = RB / 16;   // 16-byte chunks a row
            const size_t row0 =
                pages.head_page(lc.pid) * P + (size_t)lc.sub * KT;
            const int nk = min(KT, lc.hi - lc.sub * KT);
            uint8_t* dk = ring + (size_t)s * 2 * KT * SR;
            const uint8_t* gk =
                static_cast<const uint8_t*>(a.pool_k) + row0 * RB;
            const uint8_t* gv =
                static_cast<const uint8_t*>(a.pool_v) + row0 * RB;
            for (int ch = threadIdx.x; ch < nk * CPR; ch += THREADS) {
                const int r = ch / CPR, o16 = ch % CPR * 16;
                cp_async16(dk + r * SR + o16, gk + (size_t)r * RB + o16);
                cp_async16(dk + (KT + r) * SR + o16,
                           gv + (size_t)r * RB + o16);
            }
            // P V multiplies the tile's rows past nk by a zero weight: bf16
            // V rows there are zeroed, as stale bits could be NaN (an int8
            // byte or an int4 nibble is always finite; K's scores there are
            // masked)
            if constexpr (F == Fmt::PLAIN) {
                for (int ch = threadIdx.x; ch < (KT - nk) * CPR;
                     ch += THREADS) {
                    const int r = nk + ch / CPR, o16 = ch % CPR * 16;
                    *reinterpret_cast<uint4*>(dk + (KT + r) * SR + o16) =
                        make_uint4(0u, 0u, 0u, 0u);
                }
            }
            pages.advance(lc);
        }
        cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < STAGES; ++s) issue(s);

    // q as the A operand: row g < ng, k in the pool format's dim order
    uint32_t qa[NKS][2];
    {
        const BF* qr =
            static_cast<const BF*>(a.q) + ((size_t)at.b * Hq + at.h0 + g) * Dh;
        auto word = [&](int d0) {
            return g < at.ng ? *reinterpret_cast<const uint32_t*>(qr + d0)
                             : 0u;
        };
#pragma unroll
        for (int s = 0; s < NKS; ++s) {
            if constexpr (F == Fmt::INT8) {
                // dims d0 .. d0 + 3 as (d0, d0 + 2) and (d0 + 1, d0 + 3)
                const uint32_t lo = word(BPT * c + 4 * s);
                const uint32_t hi = word(BPT * c + 4 * s + 2);
                qa[s][0] = __byte_perm(lo, hi, 0x5410);
                qa[s][1] = __byte_perm(lo, hi, 0x7632);
            } else if constexpr (F == Fmt::PACKED) {
                qa[s][0] = word(BPT * c + 2 * s);
                qa[s][1] = word(DP / 2 + BPT * c + 2 * s);
            } else {
                qa[s][0] = word(16 * s + 2 * c);
                qa[s][1] = word(16 * s + 8 + 2 * c);
            }
        }
    }
    // keys a scale (int8: one a key)
    const int gsz = F == Fmt::PACKED ? P / a.n_scale : 1;

    float o[NDT][2], m = NEG_INF, l = 0.f, lp = 0.f;
#pragma unroll
    for (int i = 0; i < NDT; ++i) o[i][0] = o[i][1] = 0.f;
    Cursor cu;
    pages.seek(cu, p_lo);
    for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        // lane j checks key j of the warp's share once, and fetches its
        // scales while the tile is in flight
        float ksc = 1.f, vsc = 1.f;
        bool valid = false;
        if (lane < KW) {
            const int pofs = cu.sub * KT + warp * KW + lane;
            const int phys = cu.rl * P + pofs;
            valid = pofs < cu.hi &&
                    (phys < tb || (phys >= tpb && phys < tpb + db));
            if constexpr (SC) {
                if (valid) {
                    const size_t si =
                        pages.head_page(cu.pid) * a.n_scale + pofs / gsz;
                    ksc = __ldg(a.k_scale + si);
                    vsc = __ldg(a.v_scale + si);
                }
            }
        }
        const unsigned vmask = __ballot_sync(FULL_MASK, valid);
        cp_async_wait<STAGES - 1>();
        __syncthreads();   // tile it is in stage s, from every thread
        const uint8_t* kt = ring + (size_t)s * 2 * KT * SR + warp * KW * SR;
        const uint8_t* vt = kt + KT * SR;

        // S^T = Q K^T over the warp's keys: n8 tile j holds keys 8j .. 8j+7
        float sa[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            sa[j][0] = sa[j][1] = 0.f;
            if constexpr (F == Fmt::PLAIN) {
#pragma unroll
                for (int s2 = 0; s2 < NKS; s2 += 2) {
                    uint32_t r[4];
                    ldsm_x4(r, kt + (8 * j + (lane & 7)) * SR +
                                   ((s2 + (lane >> 4)) * 16 +
                                    ((lane >> 3) & 1) * 8) * 2);
                    mma_bf16(sa[j], qa[s2][0], qa[s2][1], r[0], r[1]);
                    mma_bf16(sa[j], qa[s2 + 1][0], qa[s2 + 1][1], r[2], r[3]);
                }
            } else {
                // key 8j + g: bytes BPT c .. BPT c + BPT - 1, four (int8)
                // or two (int4) a step
                uint32_t w[BPT / 4];
                lds_words<BPT>(w, kt + (8 * j + g) * SR + BPT * c);
#pragma unroll
                for (int st = 0; st < NKS; ++st) {
                    if constexpr (F == Fmt::INT8) {
                        mma_bf16(sa[j], qa[st][0], qa[st][1],
                                 i8x2_bf16(w[st]), i8x2_bf16(w[st] >> 8));
                    } else {
                        const int p0 = 2 * (st % 2);
                        const uint32_t x =
                            __byte_perm(w[st / 2], 0u, p0 | ((p0 + 1) << 8));
                        mma_bf16(sa[j], qa[st][0], qa[st][1],
                                 nib2_bf16(x, 0), nib2_bf16(x, 4));
                    }
                }
            }
        }
        // the online softmax of head g over the quad's keys
        float sc[NT][2], mt = NEG_INF;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int kk = 8 * j + 2 * c + e;
                const float kj =
                    SC ? __shfl_sync(FULL_MASK, ksc, kk) : 1.f;
                // NEG_INF is finite: the weight below is masked explicitly
                sc[j][e] = (vmask >> kk) & 1u
                    ? (SC ? sa[j][e] * scale * kj : sa[j][e] * scale)
                    : NEG_INF;
                mt = fmaxf(mt, sc[j][e]);
            }
        mt = fmaxf(mt, __shfl_xor_sync(FULL_MASK, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(FULL_MASK, mt, 2));
        const float m_new = fmaxf(m, mt);
        const float alpha = expf(m - m_new);
        l *= alpha;
        if constexpr (MASS) lp *= alpha;
#pragma unroll
        for (int i = 0; i < NDT; ++i) {
            o[i][0] *= alpha;
            o[i][1] *= alpha;
        }
        m = m_new;
        // O += P V, k16 step q over keys 16q .. 16q + 15
#pragma unroll
        for (int q = 0; q < KQ; ++q) {
            uint32_t pa[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float wv[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int kk = 16 * q + 8 * h + 2 * c + e;
                    const float vj =
                        SC ? __shfl_sync(FULL_MASK, vsc, kk) : 1.f;
                    const float w = (vmask >> kk) & 1u
                        ? expf(sc[2 * q + h][e] - m) : 0.f;
                    l += w;
                    if constexpr (MASS) lp += w;
                    wv[e] = SC ? w * vj : w;
                }
                // the weights in bf16 after the v-scale, as the reference
                pa[h] = pack_bf16(wv[0], wv[1]);
            }
            if constexpr (F == Fmt::PLAIN) {
#pragma unroll
                for (int i2 = 0; i2 < NDT; i2 += 2) {
                    uint32_t r[4];
                    ldsm_x4_t(r, vt + (16 * q + ((lane >> 3) & 1) * 8 +
                                       (lane & 7)) * SR +
                                      (8 * i2 + (lane >> 4) * 8) * 2);
                    mma_bf16(o[i2], pa[0], pa[1], r[0], r[1]);
                    mma_bf16(o[i2 + 1], pa[0], pa[1], r[2], r[3]);
                }
            } else {
                // keys 2c, 2c + 1, 2c + 8, 2c + 9 of the step: BPG bytes
                // from BPG g of each row, byte i two keys' column of dim
                // tile i (int8), or of tiles i and i + BPG (int4: a low
                // and a high nibble)
                uint32_t v[4][BPG / 4];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    lds_words<BPG>(v[k], vt + (16 * q + 2 * c + (k & 1) +
                                               (k >> 1) * 8) * SR + BPG * g);
#pragma unroll
                for (int i = 0; i < BPG; ++i) {
                    const int p0 = i % 4, wi = i / 4;
                    const uint32_t sel = p0 | ((p0 + 4) << 8);
                    const uint32_t x01 = __byte_perm(v[0][wi], v[1][wi], sel);
                    const uint32_t x23 = __byte_perm(v[2][wi], v[3][wi], sel);
                    if constexpr (F == Fmt::INT8) {
                        mma_bf16(o[i], pa[0], pa[1], i8x2_bf16(x01),
                                 i8x2_bf16(x23));
                    } else {
                        mma_bf16(o[i], pa[0], pa[1], nib2_bf16(x01, 0),
                                 nib2_bf16(x23, 0));
                        mma_bf16(o[i + BPG], pa[0], pa[1], nib2_bf16(x01, 4),
                                 nib2_bf16(x23, 4));
                    }
                }
            }
        }
        __syncthreads();   // every warp is done with stage s
        issue(s);          // tile it + STAGES, if the split has it
        if constexpr (MASS) {
            if ((cu.sub + 1) * KT >= cu.hi) {
                // the page's last tile: head g's sum of weights over the
                // page and the max it was taken against
                float x = lp + __shfl_xor_sync(FULL_MASK, lp, 1);
                x += __shfl_xor_sync(FULL_MASK, x, 2);
                const Place here = place<GR>(a, n_chunks);
                if (c == 0 && g < here.ng) {
                    const size_t r = (((size_t)here.b * Hq + here.h0 + g) *
                                      max_pages + cu.rl) * WARPS + warp;
                    a.scratch[2 * r] = x;
                    a.scratch[2 * r + 1] = m;
                }
                lp = 0.f;
            }
        }
        pages.advance(cu);
    }
    cp_async_wait<0>();
    l += __shfl_xor_sync(FULL_MASK, l, 1);
    l += __shfl_xor_sync(FULL_MASK, l, 2);
    __syncthreads();   // the ring is spent: the warps' records reuse it
    if (g < GR) {
        float* mine = reinterpret_cast<float*>(ring) + (warp * GR + g) *
                                                        (DP + 2);
#pragma unroll
        for (int i = 0; i < NDT; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int n = 2 * c + e;
                const int dim = F == Fmt::PLAIN ? 8 * i + n
                    : F == Fmt::INT8 ? BPG * n + i
                    : i < BPG ? BPG * n + i : DP / 2 + BPG * n + i - BPG;
                mine[dim] = o[i][e];
            }
        if (c == 0) {
            mine[DP] = m;
            mine[DP + 1] = l;
        }
    }
}

// DP: channels a lane group holds (8 a lane); GR: query heads a CTA holds;
// FULL: the head dim is DP and the pool is 16-byte aligned, so tiles are
// staged by bulk copies.  Otherwise the head dim is Dh <= DP and rows are
// read from the pool.  BIAS: kernel 7 (T5's bias, no hole mask, one head a
// CTA); otherwise kernels 4-6 (the hole mask; the mass with MASS).
template <typename T, typename KV, int DP, int GR, bool FULL, bool BIAS,
          bool MASS>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(Args a, float scale, int n_chunks) {
    using E = typename KV::Elem;
    constexpr int LPK = DP / 8;            // lanes on one key row
    constexpr int KPW = 32 / LPK;          // keys a warp scores a step
    constexpr int KT = tile_keys<KV, DP>();
    constexpr int KW = KT / WARPS;         // a warp's keys of a tile
    constexpr int NS = KW / KPW;           // its steps over them
    // steps between two rescales: at most 32 scores a lane in registers
    constexpr int NSUB = NS * GR <= 32 ? NS : (32 / GR > 0 ? 32 / GR : 1);
    constexpr int RE = KV::row_elems(DP);  // a staged row, in elements
    static_assert(KW <= 32 && KW % KPW == 0 && NS % NSUB == 0,
                  "a tile's keys split by warp and step");
    static_assert(!BIAS || (GR == 1 && !MASS), "kernel 7: MHA, no mass");
    const E* __restrict__ pool_k = static_cast<const E*>(a.pool_k);
    const E* __restrict__ pool_v = static_cast<const E*>(a.pool_v);
    const int P = a.P, Dh = a.Dh, Hq = a.Hq, Hkv = a.Hkv;
    const int max_pages = a.max_pages;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int grp = lane / LPK, gl = lane % LPK;

    using L = Smem<KV, DP, GR>;
    extern __shared__ __align__(128) uint8_t smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
    uint64_t* empty = full + STAGES;
    int* last = reinterpret_cast<int*>(smem + L::LAST);
    float* heads = reinterpret_cast<float*>(smem + L::HEADS);
    E* kst = reinterpret_cast<E*>(smem + L::TILES);

    // the walk: each warp's online softmax per query head over its share
    // of the split's tiles, left as its record of each head (acc[DP], m, l)
    // in the spent ring
    if constexpr (use_tc<T, DP, FULL, BIAS>()) {
        walk_tc<KV, DP, GR, MASS>(a, scale, n_chunks, smem);
    } else {
        float m[GR], l[GR], acc[GR][8];
        const Place at = place<GR>(a, n_chunks);
        const int b = at.b, h0 = at.h0, ng = at.ng;
        int n_tiles;
        const auto pages = split_pages<!BIAS, KT>(a, at, n_tiles);
        using Cursor = typename Pages<!BIAS, KT>::Cursor;
        const int p_lo = pages.p_lo, p_hi = pages.p_hi;
        const int tb = pages.t, tpb = pages.tpad, db = pages.d;

        // the first thread keeps the ring filled (a cursor of its own), copying
        // only the rows below the page's hi
        Cursor lc;
        pages.seek(lc, p_lo);
        int next = 0;
        auto load = [&](int, int s) {
            const size_t row =
                pages.head_page(lc.pid) * P + (size_t)lc.sub * KT;
            const int nk = min(KT, lc.hi - lc.sub * KT);
            const uint32_t bytes = (uint32_t)(nk * RE * sizeof(E));
            E* kd = kst + (size_t)s * 2 * KT * RE;
            mbar_expect_tx(full + s, 2 * bytes);
            bulk_load(kd, pool_k + row * RE, bytes, full + s);
            bulk_load(kd + KT * RE, pool_v + row * RE, bytes, full + s);
            pages.advance(lc);
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

        // this lane's 8 channels of each of the CTA's query heads
        float qv[GR][8];
        {
            const T* qb =
                static_cast<const T*>(a.q) + ((size_t)b * Hq + h0) * Dh;
#pragma unroll
            for (int g = 0; g < GR; ++g)
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    qv[g][e] = g < ng && 8 * gl + e < Dh
                        ? to_f(qb[(size_t)g * Dh + 8 * gl + e]) : 0.f;
        }
        // kernel 7: the bias of head h0 (the reference's f32 log of
        // max_dist / max_exact, taken in double)
        const int nb = a.n_buckets, max_exact = nb / 2;
        const int qp = BIAS ? a.qpos[b] : 0;
        const float log_denom =
            BIAS ? logf((float)((double)a.max_dist / (double)max_exact)) : 0.f;
        const float* tab = BIAS ? a.table + (size_t)h0 * nb : nullptr;
        const int gsz = KV::SCALED ? P / a.n_scale : 1;   // keys a scale

        float lp[GR];
#pragma unroll
        for (int g = 0; g < GR; ++g) {
            m[g] = NEG_INF;
            l[g] = lp[g] = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
        }
        const int rs = KV::row_elems(FULL ? DP : Dh);   // row stride, elements
        Cursor c;
        pages.seek(c, p_lo);
        for (int it = 0; it < n_tiles; ++it) {
            const int s = it % STAGES;
            feed(it + 1);
            const int key0 = c.sub * KT;
            // lane j checks key j of the warp's share once, and fetches its
            // bias or scales while the tile is in flight
            float bias = 0.f, ksc = 1.f, vsc = 1.f;
            bool valid = false;
            if (lane < KW) {
                const int pofs = key0 + warp * KW + lane;
                const int phys = c.rl * P + pofs;
                valid = pofs < c.hi &&
                        (phys < tb || (phys >= tpb && phys < tpb + db));
                if constexpr (BIAS) {
                    const int n = max(qp - phys, 0);
                    const int bucket = n < max_exact ? n
                        : min(max_exact +
                                  (int)(logf((float)n / (float)max_exact) /
                                        log_denom * (float)(nb - max_exact)),
                              nb - 1);
                    bias = valid ? __ldg(tab + bucket) : 0.f;
                }
                if constexpr (KV::SCALED) {
                    if (valid) {
                        const size_t si =
                            pages.head_page(c.pid) * a.n_scale + pofs / gsz;
                        ksc = __ldg(a.k_scale + si);
                        vsc = __ldg(a.v_scale + si);
                    }
                }
            }
            const unsigned vmask = __ballot_sync(FULL_MASK, valid);
            const E* kt;
            const E* vt;
            if constexpr (FULL) {
                mbar_wait(full + s, (it / STAGES) & 1);
                kt = kst + (size_t)s * 2 * KT * RE;
                vt = kt + KT * RE;
            } else {
                const size_t row = pages.head_page(c.pid) * P + key0;
                kt = pool_k + row * rs;
                vt = pool_v + row * rs;
            }

#pragma unroll
            for (int s0 = 0; s0 < NS; s0 += NSUB) {
                float sc[NSUB][GR], mt[GR];
#pragma unroll
                for (int g = 0; g < GR; ++g) mt[g] = NEG_INF;
#pragma unroll
                for (int st = 0; st < NSUB; ++st) {
                    const int j = (s0 + st) * KPW + grp;   // the warp's key j
                    const bool ok = (vmask >> j) & 1u;
                    float part[GR];
#pragma unroll
                    for (int g = 0; g < GR; ++g) part[g] = 0.f;
                    if (ok) {
                        float kf[8];
                        KV::template load8<DP, FULL>(
                            kt + (size_t)(warp * KW + j) * rs, gl, Dh, kf);
#pragma unroll
                        for (int g = 0; g < GR; ++g)
#pragma unroll
                            for (int e = 0; e < 8; ++e)
                                part[g] = fmaf(qv[g][e], kf[e], part[g]);
                    }
#pragma unroll
                    for (int o = LPK / 2; o; o >>= 1)
#pragma unroll
                        for (int g = 0; g < GR; ++g)
                            part[g] += __shfl_xor_sync(FULL_MASK, part[g], o);
                    const float bj =
                        BIAS ? __shfl_sync(FULL_MASK, bias, j) : 0.f;
                    const float kj =
                        KV::SCALED ? __shfl_sync(FULL_MASK, ksc, j) : 1.f;
#pragma unroll
                    for (int g = 0; g < GR; ++g) {
                        // NEG_INF is finite: the weight below is masked
                        // explicitly
                        const float x = BIAS ? part[g] * scale + bj
                            : KV::SCALED ? part[g] * scale * kj
                                         : part[g] * scale;
                        sc[st][g] = ok ? x : NEG_INF;
                        mt[g] = fmaxf(mt[g], sc[st][g]);
                    }
                }
#pragma unroll
                for (int g = 0; g < GR; ++g) {
#pragma unroll
                    for (int o = LPK; o < 32; o <<= 1)
                        mt[g] = fmaxf(mt[g],
                                      __shfl_xor_sync(FULL_MASK, mt[g], o));
                    const float m_new = fmaxf(m[g], mt[g]);
                    const float alpha = expf(m[g] - m_new);
                    l[g] *= alpha;
                    if constexpr (MASS) lp[g] *= alpha;
#pragma unroll
                    for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
                    m[g] = m_new;
                }
#pragma unroll
                for (int st = 0; st < NSUB; ++st) {
                    const int j = (s0 + st) * KPW + grp;
                    const float vj =
                        KV::SCALED ? __shfl_sync(FULL_MASK, vsc, j) : 1.f;
                    if ((vmask >> j) & 1u) {
                        float vf[8];
                        KV::template load8<DP, FULL>(
                            vt + (size_t)(warp * KW + j) * rs, gl, Dh, vf);
#pragma unroll
                        for (int g = 0; g < GR; ++g) {
                            const float w = expf(sc[st][g] - m[g]);
                            l[g] += w;
                            if constexpr (MASS) lp[g] += w;
                            // P.V with the weight in q's type after the
                            // v-scale, as the reference rounds it
                            const float wv =
                                to_f(from_f<T>(KV::SCALED ? w * vj : w));
#pragma unroll
                            for (int e = 0; e < 8; ++e)
                                acc[g][e] = fmaf(wv, vf[e], acc[g][e]);
                        }
                    }
                }
            }
            if constexpr (FULL) mbar_arrive_warp(empty + s);
            feed(0);
            if constexpr (MASS) {
                if ((c.sub + 1) * KT >= c.hi) {
                    // the page's last tile: each head's sum of weights over
                    // the page and the max it was taken against, indexed
                    // from the place read again (nothing of it is kept
                    // through the walk)
                    const Place here = place<GR>(a, n_chunks);
#pragma unroll
                    for (int g = 0; g < GR; ++g) {
                        float x = lp[g];
#pragma unroll
                        for (int o = LPK; o < 32; o <<= 1)
                            x += __shfl_xor_sync(FULL_MASK, x, o);
                        if (lane == 0 && g < here.ng) {
                            const size_t r =
                                (((size_t)here.b * Hq + here.h0 + g) *
                                     max_pages + c.rl) * WARPS + warp;
                            a.scratch[2 * r] = x;
                            a.scratch[2 * r + 1] = m[g];
                        }
                        lp[g] = 0.f;
                    }
                }
            }
            pages.advance(c);
        }

        // the warp's lane groups, then its record of each head in the spent
        // ring
#pragma unroll
        for (int g = 0; g < GR; ++g)
#pragma unroll
            for (int o = LPK; o < 32; o <<= 1) {
                l[g] += __shfl_xor_sync(FULL_MASK, l[g], o);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    acc[g][e] += __shfl_xor_sync(FULL_MASK, acc[g][e], o);
            }
        __syncthreads();   // every warp is done with the ring
#pragma unroll
        for (int g = 0; g < GR; ++g) {
            float* mine = reinterpret_cast<float*>(smem + L::TILES) +
                          (warp * GR + g) * (DP + 2);
            if (grp == 0) {
#pragma unroll
                for (int e = 0; e < 8; ++e) mine[8 * gl + e] = acc[g][e];
            }
            if (lane == 0) {
                mine[DP] = m[g];
                mine[DP + 1] = l[g];
            }
        }
    }

    // the CTA's warps (logsumexp merge)
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem + L::TILES);
    constexpr int RR = DP + 2;   // a warp's record of a head: acc[DP], m, l
    const Place at = place<GR>(a, n_chunks);
    const int split = at.split, cta = at.cta, b = at.b, h0 = at.h0;
    const int ng = at.ng;
    // one split: the CTA's merge is the output; else its split's partial.
    // Scratch: the mass records (with the mass), then the splits'
    // partials, then the chunks' page masses.
    const bool single = a.n_splits == 1;
    const int rec = Dh + 2;   // a split's partial: acc[Dh], m, l
    float* recs = a.scratch;
    float* parts =
        recs + (MASS ? (size_t)a.B * Hq * max_pages * WARPS * 2 : 0);
    for (int idx = threadIdx.x; idx < ng * Dh; idx += THREADS) {
        const int g = idx / Dh, dd = idx % Dh;
        const float* rg = red + g * RR;   // warp w's at rg + w * GR * RR
        float mx = NEG_INF;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, rg[w * GR * RR + DP]);
        float lt = 0.f, ot = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const float f = expf(rg[w * GR * RR + DP] - mx);
            lt += f * rg[w * GR * RR + DP + 1];
            ot += f * rg[w * GR * RR + dd];
        }
        const size_t row = (size_t)b * Hq + h0 + g;
        float* part = parts + (row * a.n_splits + split) * rec;
        if (single) a.o[row * Dh + dd] = ot / fmaxf(lt, 1e-30f);
        else part[dd] = ot;
        if (dd == 0) {
            if (single) {
                a.m[row] = mx;
                a.l[row] = lt;
            } else {
                part[Dh] = mx;
                part[Dh + 1] = lt;
            }
            if constexpr (MASS) {
                heads[2 * g] = mx;
                heads[2 * g + 1] = lt;
            }
        }
    }

    if (!single) {
        // the last CTA of (row, kv head, chunk) merges the splits in split
        // order
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) {
            const int done = atomicAdd(a.count + cta, 1);
            *last = done == a.n_splits - 1;
        }
        __syncthreads();
        if (!*last) return;
        __threadfence();
        // a head's merge on WPH warps: lane sp holds split sp's (m, l), and
        // every warp reduces them by the same shuffle tree, so the order is
        // fixed
        constexpr int WPH = WARPS / GR > 0 ? WARPS / GR : 1;
        // a lane's channels; SB splits' partials are loaded together, so
        // the merge waits one L2 round trip per SB splits, not one a split
        constexpr int NDD = (DP + WPH * 32 - 1) / (WPH * 32);
        constexpr int SB = 8;
        for (int g = warp / WPH; g < ng; g += WARPS / WPH) {
            const size_t row = (size_t)b * Hq + h0 + g;
            const float* ph = parts + row * a.n_splits * rec;
            const bool has = lane < a.n_splits;
            const float ms = has ? __ldcg(ph + lane * rec + Dh) : NEG_INF;
            const float mm = warp_max(ms);
            const float fs = has ? expf(ms - mm) : 0.f;
            const float ll = warp_sum(
                has ? fs * __ldcg(ph + lane * rec + Dh + 1) : 0.f);
            const int dd0 = warp % WPH * 32 + lane;
            float ot[NDD];
#pragma unroll
            for (int i = 0; i < NDD; ++i) ot[i] = 0.f;
            for (int sp0 = 0; sp0 < a.n_splits; sp0 += SB) {
                float v[SB][NDD];
#pragma unroll
                for (int k = 0; k < SB; ++k)
#pragma unroll
                    for (int i = 0; i < NDD; ++i) {
                        const int dd = dd0 + i * WPH * 32;
                        v[k][i] = sp0 + k < a.n_splits && dd < Dh
                            ? __ldcg(ph + (sp0 + k) * rec + dd) : 0.f;
                    }
                // in split order; a split past n_splits adds 0 * 0
#pragma unroll
                for (int k = 0; k < SB; ++k) {
                    const float f = __shfl_sync(FULL_MASK, fs, sp0 + k);
#pragma unroll
                    for (int i = 0; i < NDD; ++i) ot[i] += f * v[k][i];
                }
            }
#pragma unroll
            for (int i = 0; i < NDD; ++i) {
                const int dd = dd0 + i * WPH * 32;
                if (dd < Dh) a.o[row * Dh + dd] = ot[i] / fmaxf(ll, 1e-30f);
            }
            if (warp % WPH == 0 && lane == 0) {
                a.m[row] = mm;
                a.l[row] = ll;
                if constexpr (MASS) {
                    heads[2 * g] = mm;
                    heads[2 * g + 1] = ll;
                }
            }
        }
        if (threadIdx.x == 0) a.count[cta] = 0;   // ready for the next launch
    }

    if constexpr (MASS) {
        // this chunk's page masses from the records of every split and
        // warp, rescaled to its heads' final (M, L): one (page, head, warp)
        // term a thread, summed per page in (head, warp) order through the
        // spent ring (a stale record of a page not walked is dropped by
        // the select, never multiplied)
        if (single) __threadfence();   // this CTA's own records
        __syncthreads();
        const int* ptb = a.pt + (size_t)b * max_pages;
        const Pages<!BIAS, KT> pages{ptb, 0, 0, 0, P, a.t[b], a.tpad[b],
                                     a.d[b], 0, 0};
        float* cparts = parts + (size_t)a.B * Hq * a.n_splits * rec;
        constexpr int TPP = GR * WARPS;            // terms a page
        constexpr int PB = L::RED / 4 / TPP;       // pages a batch
        for (int p0 = 0; p0 < max_pages; p0 += PB) {
            const int np = min(PB, max_pages - p0);
            for (int i = threadIdx.x; i < np * TPP; i += THREADS) {
                const int rl = p0 + i / TPP, g = i % TPP / WARPS;
                const float* r = recs + ((((size_t)b * Hq + h0 + g) *
                                          max_pages + rl) * WARPS +
                                         i % WARPS) * 2;
                red[i] = g < ng ? __ldcg(r) * expf(__ldcg(r + 1) -
                                                   heads[2 * g]) /
                                      fmaxf(heads[2 * g + 1], 1e-30f)
                                : 0.f;
            }
            __syncthreads();
            for (int i = threadIdx.x; i < np; i += THREADS) {
                float pm = 0.f;
                for (int k = 0; k < TPP; ++k) pm += red[i * TPP + k];
                cparts[(size_t)cta * max_pages + p0 + i] =
                    pages.extent(p0 + i, ptb[p0 + i]) > 0 ? pm : 0.f;
            }
            __syncthreads();
        }
        // the last of the row's chunks adds them in (kv head, chunk) order,
        // 8 chunks' partials loaded together
        __threadfence();
        __syncthreads();
        int* row_count = a.count + (size_t)a.B * Hkv * n_chunks + b;
        if (threadIdx.x == 0) {
            const int done = atomicAdd(row_count, 1);
            *last = done == Hkv * n_chunks - 1;
        }
        __syncthreads();
        if (!*last) return;
        __threadfence();
        const float* rowp = cparts + (size_t)b * Hkv * n_chunks * max_pages;
        const int n_parts = Hkv * n_chunks;
        for (int rl = threadIdx.x; rl < max_pages; rl += THREADS) {
            float sm = 0.f;
            for (int y0 = 0; y0 < n_parts; y0 += 8) {
                float v[8];
#pragma unroll
                for (int k = 0; k < 8; ++k)
                    v[k] = y0 + k < n_parts
                        ? __ldcg(rowp + (size_t)(y0 + k) * max_pages + rl)
                        : 0.f;
#pragma unroll
                for (int k = 0; k < 8; ++k) sm += v[k];
            }
            a.mass[(size_t)b * max_pages + rl] = sm / (float)Hq;
        }
        if (threadIdx.x == 0) *row_count = 0;
    }
}

template <typename T, typename KV, int DP, int GR, bool FULL, bool BIAS,
          bool MASS>
cudaError_t launch_split(const Args& a) {
    constexpr int KT = tile_keys<KV, DP>();
    const int n_chunks = query_chunks(a);
    // a split of one tile needs one stage
    const int tiles = pages_per_split(a.max_pages, a.n_splits) *
                      ((a.P + KT - 1) / KT);
    // the tensor-core walk's cp.async pipeline always has STAGES stages
    constexpr bool TC = use_tc<T, DP, FULL, BIAS>();
    const size_t smem = Smem<KV, DP, GR>::bytes(
        TC ? STAGES : FULL ? (tiles > 1 ? STAGES : 1) : 0, TC);
    auto kern = paged_split_kernel<T, KV, DP, GR, FULL, BIAS, MASS>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<a.B * a.Hkv * n_chunks * a.n_splits, THREADS, smem, a.st>>>(
        a, (float)(1.0 / sqrt((double)a.Dh)), n_chunks);
    return cudaGetLastError();
}

// bulk copies need a 16-byte aligned pool (rows are multiples of 16 bytes
// in every staged instance)
inline bool aligned(const Args& a) {
    return ((reinterpret_cast<uintptr_t>(a.pool_k) |
             reinterpret_cast<uintptr_t>(a.pool_v)) & 15) == 0;
}

// Kernels 4-6: at head dims 64 and 128 the tensor-core instance (bf16
// queries) or one instance per query-group size (f32), the padded
// instances (8 query heads a CTA) otherwise.
template <typename T, typename KV, int DP, bool MASS>
cudaError_t dispatch_group(const Args& a) {
    // the tensor-core walk holds 8 query heads whatever the group
    if constexpr (use_tc<T, DP, true, false>()) {
        return launch_split<T, KV, DP, GMAX, true, false, MASS>(a);
    } else {
        const int G = a.Hq / a.Hkv;
        if (G <= 1) return launch_split<T, KV, DP, 1, true, false, MASS>(a);
        if (G <= 2) return launch_split<T, KV, DP, 2, true, false, MASS>(a);
        if (G <= 4) return launch_split<T, KV, DP, 4, true, false, MASS>(a);
        return launch_split<T, KV, DP, GMAX, true, false, MASS>(a);
    }
}

template <typename T, typename KV, bool MASS>
cudaError_t dispatch_pages(const Args& a) {
    const int D = a.Dh;
    if (aligned(a) && D == 64) return dispatch_group<T, KV, 64, MASS>(a);
    if (aligned(a) && D == 128) return dispatch_group<T, KV, 128, MASS>(a);
    if (D < 1) return cudaErrorInvalidValue;
    if (D <= 32) return launch_split<T, KV, 32, GMAX, false, false, MASS>(a);
    if (D <= 64) return launch_split<T, KV, 64, GMAX, false, false, MASS>(a);
    if (D <= 128) return launch_split<T, KV, 128, GMAX, false, false, MASS>(a);
    if (D <= 256) return launch_split<T, KV, 256, GMAX, false, false, MASS>(a);
    return cudaErrorInvalidValue;
}

// Kernel 7: head dims 32/64/128/256 staged, the others padded.
template <typename T, typename KV>
cudaError_t dispatch_bias(const Args& a) {
    const int D = a.Dh;
    const bool al = aligned(a);
    if (al && D == 32) return launch_split<T, KV, 32, 1, true, true, false>(a);
    if (al && D == 64) return launch_split<T, KV, 64, 1, true, true, false>(a);
    if (al && D == 128)
        return launch_split<T, KV, 128, 1, true, true, false>(a);
    if (al && D == 256)
        return launch_split<T, KV, 256, 1, true, true, false>(a);
    if (D < 1) return cudaErrorInvalidValue;
    if (D <= 32) return launch_split<T, KV, 32, 1, false, true, false>(a);
    if (D <= 64) return launch_split<T, KV, 64, 1, false, true, false>(a);
    if (D <= 128) return launch_split<T, KV, 128, 1, false, true, false>(a);
    if (D <= 256) return launch_split<T, KV, 256, 1, false, true, false>(a);
    return cudaErrorInvalidValue;
}

// What every split-walk launch relies on.
inline bool ok_split(const Args& a) {
    return a.Hkv > 0 && a.Hq % a.Hkv == 0 && a.B > 0 && a.P > 0 &&
           a.max_pages > 0 && a.n_splits >= 1 &&
           a.n_splits <= min(a.max_pages, MAX_SPLITS) &&
           a.count != nullptr && a.scratch != nullptr &&
           a.scratch_floats >= scratch_floats(a);
}

// The split walk's C entry for kernels 4-6 (GQA, the hole mask, the mass
// on request).
template <template <typename> class KVT>
int entry_pages(const Args& a, int is_bf16) {
    if (!ok_split(a) || !KVT<float>::ok_dim(a.Dh) || a.qpos != nullptr)
        return cudaErrorInvalidValue;
    if (KVT<float>::SCALED &&
        (a.k_scale == nullptr || a.v_scale == nullptr || a.n_scale <= 0 ||
         a.P % a.n_scale != 0))
        return cudaErrorInvalidValue;
    using BF = __nv_bfloat16;
    if (is_bf16)
        return a.mass != nullptr ? dispatch_pages<BF, KVT<BF>, true>(a)
                                 : dispatch_pages<BF, KVT<BF>, false>(a);
    return a.mass != nullptr ? dispatch_pages<float, KVT<float>, true>(a)
                             : dispatch_pages<float, KVT<float>, false>(a);
}

// The split walk's C entry for kernel 7 (the bias, MHA, no mass).
template <template <typename> class KVT>
int entry_bias(const Args& a, int is_bf16) {
    if (!ok_split(a) || a.Hq != a.Hkv || !KVT<float>::ok_dim(a.Dh) ||
        a.qpos == nullptr || a.table == nullptr || a.n_buckets < 2 ||
        a.max_dist <= a.n_buckets / 2 || a.mass != nullptr)
        return cudaErrorInvalidValue;
    if (is_bf16) return dispatch_bias<__nv_bfloat16, KVT<__nv_bfloat16>>(a);
    return dispatch_bias<float, KVT<float>>(a);
}

}  // namespace split

}  // namespace paged
}  // namespace kubetpu

// The C interface of kernels 4-6: q [B, Hq, D] (f32 or bf16; D <= 256);
// pools [L, n_pages, Hkv, P, row] of row D (bf16/f32 like q, or int8 with
// scales [L, n_pages, Hkv, P]) or D/2 (packed int4, scales [L, n_pages,
// Hkv, n_scale] with n_scale dividing P); page_table [B, max_pages] i32;
// layer [1] i32; t/t_pad/d [B] i32.  The row's pages are cut into n_splits
// (1 <= n_splits <= min(max_pages, 32)) splits; scratch holds
// scratch_floats floats (split::scratch_floats) and count B * Hkv *
// ceil(Hq / Hkv / 8) + B i32 that are 0 between launches (the kernel
// leaves them so).  Outputs o f32 [B, Hq, D], m/l f32 [B, Hq] and, when
// `mass` is not null, mass f32 [B, max_pages].  All on the device.
// Returns the launch's cudaError_t.
#define KUBETPU_PAGED_SPLIT_ENTRY(NAME, POLICY)                                \
    extern "C" int NAME(const void* q, const void* pool_k, const void* pool_v,\
                        const void* k_scale, const void* v_scale,             \
                        const void* pt, const void* layer, const void* t,     \
                        const void* tpad, const void* d, void* o, void* m,    \
                        void* l, void* mass, void* scratch, void* count,      \
                        int B, int Hq, int Hkv, int n_pages, int P, int D,    \
                        int max_pages, int n_scale, int n_splits,             \
                        int scratch_floats, int is_bf16, void* stream) {      \
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
        a.n_splits = n_splits;                                                \
        a.count = static_cast<int*>(count);                                   \
        return kubetpu::paged::split::entry_pages<POLICY>(a, is_bf16);        \
    }
