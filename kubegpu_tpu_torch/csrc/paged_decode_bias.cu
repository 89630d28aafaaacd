// Paged decode attention with T5's relative-position bias (kernel 7).
//
// Replaces the TPU kernel `_paged_kernel_bias` (kubegpu_tpu/ops/
// paged_attention.py:567, pallas_call at :682): the T5 decoder's
// self-attention over its flushed history.  Pages hold q's own type (bf16 or
// f32) and the heads are MHA (Hq == Hkv).  Each key's score gets
// table[h, bucket(max(q_pos - phys, 0))], the bucket computed in-kernel with
// T5's causal log-spaced rule; the TPU kernel's one-hot matmul against the
// table (a gather does not vectorize on its VPU) becomes one shared-memory
// read per key.  There is no page-id-0 hole mask, as in the TPU kernel.
//
// What bounds it on the H100: bytes, as kernel 4 (K and V of the valid keys
// once, 2 flops per key element and head); the bucket is one logf per key.
// The page walk is paged_decode.cuh's with its BIAS flag on.

#include "paged_decode.cuh"

// q [B, H, D] (f32 or bf16, D <= 256); pools [L, n_pages, H, P, D] of q's
// type; page_table [B, max_pages] i32; layer [1] i32; t/t_pad/d/q_pos [B]
// i32; table [H, n_buckets] f32 (n_buckets >= 2, max_dist > n_buckets / 2).
// Outputs o f32 [B, H, D], m/l f32 [B, H].  All on the device.  Returns the
// launch's cudaError_t.
extern "C" int kubetpu_paged_decode_bias(
        const void* q, const void* pool_k, const void* pool_v, const void* pt,
        const void* layer, const void* t, const void* tpad, const void* d,
        const void* qpos, const void* table, void* o, void* m, void* l, int B,
        int H, int n_pages, int P, int D, int max_pages, int n_buckets,
        int max_dist, int is_bf16, void* stream) {
    kubetpu::paged::Args a{
        q, pool_k, pool_v, nullptr, nullptr, static_cast<const int*>(pt),
        static_cast<const int*>(layer), static_cast<const int*>(t),
        static_cast<const int*>(tpad), static_cast<const int*>(d),
        static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
        nullptr, nullptr, B, H, H, n_pages, P, D, max_pages, 0, 0,
        static_cast<cudaStream_t>(stream)};
    a.qpos = static_cast<const int*>(qpos);
    a.table = static_cast<const float*>(table);
    a.n_buckets = n_buckets;
    a.max_dist = max_dist;
    return kubetpu::paged::entry<kubetpu::paged::PlainPages, true>(a, is_bf16);
}
