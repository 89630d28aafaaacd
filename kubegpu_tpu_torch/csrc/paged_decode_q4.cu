// Paged decode attention over packed int4 pages (kernel 6).
//
// Replaces the TPU kernel `_paged_kernel_q4` (kubegpu_tpu/ops/
// paged_attention.py:449, pallas_call at :795), with its hole mask and
// optional per-page attention mass.  Pages hold two channels per byte
// ([L, n_pages, Hkv, P, D/2] uint8: channel d in the low nibble, d + D/2 in
// the high one, both +8) with one f32 scale per group of g = P / n_scale keys, read with __ldg
// (a scale can be 4 bytes a page, too small for a bulk copy).  A key row is
// D/2 bytes, staged whole and unpacked in registers as (b & 0xF) - 8 and
// (b >> 4) - 8: for bf16 queries at head dims 64 and 128 into bf16 mma
// fragments (nibble n as bf16 128 + n, minus 136), the head dims permuted
// so that a lane's fragments come from contiguous bytes; otherwise 8
// channels a lane from one 8-byte load, a lane below D/2 taking low
// nibbles, one above it the high nibbles of the same bytes.  Key j takes
// scale j / g.  The engine's empty byte 0x88 unpacks to exact zero.
//
// What bounds it on the H100: bytes, a quarter of kernel 4's per key (D/2
// bytes of K and of V plus the group scales).  It runs paged_decode.cuh's
// split walk, as kernel 4.

#include "paged_decode.cuh"

KUBETPU_PAGED_SPLIT_ENTRY(kubetpu_paged_decode_q4, kubetpu::paged::Int4Pages)
