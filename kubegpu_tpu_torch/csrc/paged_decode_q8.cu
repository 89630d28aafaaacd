// Paged decode attention over int8 pages (kernel 5).
//
// Replaces the TPU kernel `_paged_kernel_q8` (kubegpu_tpu/ops/
// paged_attention.py:347, pallas_call at :795), with its hole mask and
// optional per-page attention mass.  Pages hold int8 K/V with one f32
// scale per key ([L, n_pages, Hkv, P], read with __ldg while the tile is in
// flight): a key row is D bytes, staged whole; the k-scale folds into the
// key's score after * D^-0.5, the v-scale into its weight for the P.V
// product only, which is then rounded to q's type as the TPU kernel rounds
// it.  For bf16 queries at head dims 64 and 128 the bytes become bf16 mma
// fragments exactly (two LOP3s and an HSUB2 a pair: 0x4300 | (b & 0x7F)
// minus 0x4300 | (b & 0x80)), the head dims permuted so that a lane's
// fragments come from contiguous bytes; otherwise 8 channels a lane from
// one 8-byte load, widened through the mantissa of 2^23.
//
// What bounds it on the H100: bytes, half of kernel 4's per key (D bytes of
// K and of V plus two f32 scales).  It runs paged_decode.cuh's split walk,
// as kernels 4 and 6.

#include "paged_decode.cuh"

KUBETPU_PAGED_SPLIT_ENTRY(kubetpu_paged_decode_q8, kubetpu::paged::Int8Pages)
