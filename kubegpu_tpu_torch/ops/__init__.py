"""Attention ops: each a Hopper kernel on CUDA tensors, a plain version on
CPU tensors.  The kernel wrappers ``flash_attention``, ``paged_attention``
and ``paged_attention_biased`` live in the submodules of the same names."""

from kubegpu_tpu_torch.ops.flash_attention import (  # noqa: F401
    NEG_INF,
    attention,
    repeat_kv,
    xla_attention,
)
from kubegpu_tpu_torch.ops.paged_attention import (  # noqa: F401
    decode_capacity,
    fold_chunk_queries,
    gather_pages,
    merge_partials,
    page_table_size,
    paged_attention_biased_ref,
    paged_attention_ref,
    rel_pos_bucket,
    scatter_pages,
)
