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
