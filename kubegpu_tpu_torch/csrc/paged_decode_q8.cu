// Paged decode attention over int8 pages (kernel 5).
//
// Replaces the TPU kernel `_paged_kernel_q8` (kubegpu_tpu/ops/
// paged_attention.py:347, pallas_call at :795), with its optional per-page
// attention mass.  Pages hold int8 K/V with one f32 scale per key
// ([L, n_pages, Hkv, P]): a key row is D bytes, read in 16-byte loads and
// widened in registers; the k-scale folds into the key's score after
// * D^-0.5, the v-scale into its weight for the P.V product only, which is
// then rounded to q's type as the TPU kernel rounds it.
//
// What bounds it on the H100: bytes, half of kernel 4's per key (D bytes of
// K and of V plus two f32 scales).  It still runs paged_decode.cuh's chunk
// walk.

#include "paged_decode.cuh"

KUBETPU_PAGED_ENTRY(kubetpu_paged_decode_q8, kubetpu::paged::Int8Pages)
