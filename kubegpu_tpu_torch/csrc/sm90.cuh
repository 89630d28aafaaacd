// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels,
// as inline PTX with no CUTLASS/CuTe headers (they would add minutes to
// every build):
//   - TMA: a tensor map per operand (built on the host through the driver's
//     entry point, so a library loaded with ctypes needs no -lcuda), and the
//     1-D and 3-D tile loads that complete on an mbarrier;
//   - mbarriers: init, arrive, arrive with an expected byte count, and the
//     parity wait;
//   - wgmma: the shared-memory matrix descriptor for the 128-byte swizzle
//     that TMA writes, fence / commit / wait, and m64nNk16 bf16 -> f32 for
//     N = 64 and 128, with A from shared memory (SS) or registers (RS).
//
// Operand layout.  A bf16 tile of R rows and D = 64c channels sits in
// shared memory as c column blocks of [R][64], one TMA box each: 128 bytes
// a row, 16-byte chunks XOR-swizzled by (row % 8) in 1024-byte atoms of 8
// rows (CU_TENSOR_MAP_SWIZZLE_128B).  wgmma reads such a block with
// layout type 1 (128B swizzle):
//   - K-major (the reduction runs along the 64 channels): SBO = 1024 (the
//     next 8 rows), LBO unused; k-slice j of 16 starts 32 * (j % 4) bytes
//     into column block j / 4;
//   - MN-major (the reduction runs along the rows, B with the transpose
//     flag): SBO = 1024 (the next 8 rows of the reduction), LBO = the
//     column block's size in bytes (the next 64 output columns); k-slice
//     j starts 2048 * j bytes (16 rows) in.
//
// Accumulator fragment of m64nNk16 (f32, N/2 registers a thread): thread t
// of the warpgroup, warp w = t / 32, lane l = t % 32, holds rows
// 16w + l/4 (registers 4j, 4j+1) and 16w + l/4 + 8 (4j+2, 4j+3), columns
// 8j + 2(l%4) + {0, 1}.  The A fragment of an RS wgmma (m64k16, four
// bf16x2 registers) has the same layout over 16 columns, so the packed
// pairs (8i .. 8i+7) of an accumulator are the A operand of k-slice i.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kubetpu {
namespace sm90 {

// -- host: tensor maps --------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault, &q) == cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A bf16 tensor [heads, rows, d] (contiguous, d a multiple of 64) read in
// boxes of [box_rows, 64] with the 128-byte swizzle.  Reads past `rows`
// fill zeros, so a ragged tile never reaches the next head.  An empty
// tensor leaves the map zeroed (the kernel loads no tile of it).
inline bool map_rows_bf16(CUtensorMap* m, const void* base, int heads, int rows,
                          int d, int box_rows) {
    *m = CUtensorMap{};
    if (heads == 0 || rows == 0) return true;
    EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return false;
    cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
    cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)d * rows * 2};
    cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
    cuuint32_t elem[3] = {1, 1, 1};
    return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
               dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A flat f32 vector of n values read in boxes of `box` (past n: zeros).
inline bool map_vec_f32(CUtensorMap* m, const void* base, long long n, int box) {
    *m = CUtensorMap{};
    if (n == 0) return true;
    EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return false;
    cuuint64_t dims[1] = {(cuuint64_t)n};
    cuuint64_t strides[1] = {(cuuint64_t)n * 4};   // unused at rank 1
    cuuint32_t boxd[1] = {(cuuint32_t)box};
    cuuint32_t elem[1] = {1};
    return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base),
               dims, strides, boxd, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// -- device: shared memory, mbarriers, TMA ------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the inits visible to the async proxy (TMA) and the other threads;
// a __syncthreads() follows it.
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// One arrival for the calling warp, from its first lane once every lane
// has passed __syncwarp (so the warp's reads of the stage are done).  An
// arrival from every thread costs a shared-memory atomic each, and 256 of
// them on one barrier serialize: count warps instead.
__device__ __forceinline__ void mbar_arrive_warp(uint64_t* bar) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Returns once the phase of parity `parity` has completed (a barrier starts
// in phase 0; waiting on parity 1 before any completion returns at once).
// A phase that never completes (a lost TMA, a miscounted arrival) traps
// after ~2^30 polls, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    for (uint32_t polls = 0; !done; ++polls) {
        if (polls == (1u << 30)) __trap();
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
}

// Whether the phase of parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, unsigned parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    return done != 0;
}

// Issues loads of a ring's items in order, each into stage item % STAGES
// once the consumers have released that stage's previous item (its empty
// barrier's phase item / STAGES - 1).  One thread calls it.  With `block`
// it waits for a stage still in use; without, it stops there and a later
// call goes on.  `load(item, stage)` arms the stage's full barrier and
// issues the copies.
template <int STAGES, typename Load>
__device__ __forceinline__ void ring_feed(int& next, int upto, uint64_t* empty,
                                          bool block, Load&& load) {
    for (; next < upto; ++next) {
        const int s = next % STAGES;
        if (next >= STAGES) {
            const unsigned parity = (next / STAGES - 1) & 1;
            if (block) mbar_wait(empty + s, parity);
            else if (!mbar_test(empty + s, parity)) return;
        }
        load(next, s);
    }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            int c0, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0)
        : "memory");
}

// The D / 64 boxes of rows [row, row + box_rows) of head `head`, column
// block j landing at dst + j * box_rows * 128 bytes.
template <int D>
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map,
                                              int box_rows, int row, int head,
                                              uint64_t* bar) {
#pragma unroll
    for (int j = 0; j < D / 64; ++j)
        tma_load_3d(static_cast<char*>(dst) + j * box_rows * 128, map, j * 64,
                    row, head, bar);
}

// -- device: wgmma -------------------------------------------------------------

// Matrix descriptor of a 128-byte-swizzled operand at shared address
// `addr` (its atoms 1024-byte aligned); byte offsets as above.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major: k-slice j (16 channels) of a [rows][D] tile at `addr`, whose
// column blocks are `block_bytes` apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, int j,
                                                uint32_t block_bytes) {
    return desc_sw128(addr + (j / 4) * block_bytes + (j % 4) * 32, 16, 1024);
}

// MN-major: k-slice j (16 rows) of a [rows][D] tile at `addr` read as
// B[rows, D] with the transpose flag; column blocks `block_bytes` apart.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, int j,
                                                 uint32_t block_bytes) {
    return desc_sw128(addr + j * 2048, block_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins registers that an in-flight wgmma reads or writes: the compiler may
// not move their uses across this point (call it after wgmma_wait and
// before issuing into registers written since).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// 2^x in one MUFU.EX2 (relative error ~2^-22, results below 2^-126 flush
// to zero).  exp2f wraps it in range checks, which the tensor-core
// kernels' softmax pays for on every element
// (experiments/torch_flash_ab.py).
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// Rounds an m64nNk16 accumulator to bf16 as the A operands of N / 16
// k-slices.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r)
            a[i][r] = pack_bf16(acc[8 * i + 2 * r], acc[8 * i + 2 * r + 1]);
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d), "n"(TRANS_B));
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N]; TRANS_B: B is MN-major.
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
    static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
    if constexpr (N == 64) wgmma_ss_n64<TRANS_B>(d, desc_a, desc_b, scale_d);
    else wgmma_ss_n128<TRANS_B>(d, desc_a, desc_b, scale_d);
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
    static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
    if constexpr (N == 64) wgmma_rs_n64<TRANS_B>(d, a, desc_b, scale_d);
    else wgmma_rs_n128<TRANS_B>(d, a, desc_b, scale_d);
}

}  // namespace sm90
}  // namespace kubetpu
