// Helpers shared by the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kubetpu {

// Finite masking sentinel, as ops/flash_attention.py's NEG_INF.
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// One 16-byte load of VEC = 16 / sizeof(T) elements, widened to f32.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
    static constexpr int N = 4;
    __device__ __forceinline__ static void load(const float* p, float* out) {
        float4 r = *reinterpret_cast<const float4*>(p);
        out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
    }
};
template <> struct Vec16<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                                float* out) {
        uint4 r = *reinterpret_cast<const uint4*>(p);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float2 f = __bfloat1622float2(h[i]);
            out[2 * i] = f.x;
            out[2 * i + 1] = f.y;
        }
    }
};

// Copy a tile of `rows` rows into shared memory as f32, row r at dst + r * ld,
// all threads of the block taking part.  Row r comes from src(r), a pointer to
// its first channel in global memory, or nullptr for a zero row.  FULL: the
// head dim is D and rows are 16-byte aligned (vector loads); otherwise the
// head dim is Dh < D, loads are scalar and channels Dh..D-1 are zeroed.
template <typename T, int D, bool FULL, typename RowPtr>
__device__ __forceinline__ void load_tile(float* dst, int ld, int rows,
                                          int Dh, RowPtr src) {
    if constexpr (FULL) {
        constexpr int VEC = Vec16<T>::N;
        for (int vi = threadIdx.x; vi < rows * D / VEC; vi += blockDim.x) {
            const int e = vi * VEC, r = e / D, dd = e % D;
            const T* p = src(r);
            float f[VEC];
            if (p != nullptr) {
                Vec16<T>::load(p + dd, f);
            } else {
#pragma unroll
                for (int x = 0; x < VEC; ++x) f[x] = 0.f;
            }
#pragma unroll
            for (int x = 0; x < VEC; ++x) dst[r * ld + dd + x] = f[x];
        }
    } else {
        for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
            const int r = e / D, dd = e % D;
            const T* p = src(r);
            dst[r * ld + dd] = (p != nullptr && dd < Dh) ? to_f(p[dd]) : 0.f;
        }
    }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
    return x;
}

}  // namespace kubetpu
