// Paged decode attention over bf16/f32 pages (kernel 4).
//
// Replaces the TPU kernel `_paged_kernel` (kubegpu_tpu/ops/paged_attention.py
// :229, pallas_call at :795), with its hole mask and optional per-page
// attention mass.  Pages here hold q's own type, so the policy only widens
// bf16 to f32.
//
// What bounds it on the H100: bytes (the K and V rows of the valid keys,
// once).  It runs paged_decode.cuh's split walk: one CTA per (row, kv head,
// query chunk, page), the page's used rows in flight at entry, each staged
// key row scored against every query head of the CTA (on the tensor cores,
// mma.sync, for bf16 queries at head dims 64 and 128), the splits and the
// mass merged in a fixed order by the last CTAs.

#include "paged_decode.cuh"

KUBETPU_PAGED_SPLIT_ENTRY(kubetpu_paged_decode, kubetpu::paged::PlainPages)
