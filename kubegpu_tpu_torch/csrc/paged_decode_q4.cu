// Paged decode attention over packed int4 pages (kernel 6).
//
// Replaces the TPU kernel `_paged_kernel_q4` (kubegpu_tpu/ops/
// paged_attention.py:449, pallas_call at :795), with its optional per-page
// attention mass.  Pages hold two channels per byte ([L, n_pages, Hkv, P,
// D/2] uint8: channel d in the low nibble, d + D/2 in the high one, both
// +8) with one f32 scale per group of g = P / n_scale keys.  A key row is
// D/2 bytes, read in 16-byte loads and unpacked in registers as
// (b & 0xF) - 8 and (b >> 4) - 8; key j takes scale j / g.  A value lane
// below D/2 takes low nibbles, one above it the high nibbles of the same
// bytes.  The engine's empty byte 0x88 unpacks to exact zero.
//
// What bounds it on the H100: bytes, a quarter of kernel 4's per key (D/2
// bytes of K and of V plus the group scales).  The page walk is
// paged_decode.cuh's.

#include "paged_decode.cuh"

KUBETPU_PAGED_ENTRY(kubetpu_paged_decode_q4, kubetpu::paged::Int4Pages)
