// Paged decode attention over bf16/f32 pages (kernel 4).
//
// Replaces the TPU kernel `_paged_kernel` (kubegpu_tpu/ops/paged_attention.py
// :229, pallas_call at :795), with its optional per-page attention mass.
// The page walk, its bound and its design are in paged_decode.cuh; pages
// here hold q's own type, so the policy only widens bf16 to f32.

#include "paged_decode.cuh"

KUBETPU_PAGED_ENTRY(kubetpu_paged_decode, kubetpu::paged::PlainPages)
