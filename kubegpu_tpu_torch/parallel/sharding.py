"""Tensor-parallel sharding of the serving engine's state (the port's
counterpart of ``kubegpu_tpu/parallel/sharding.py`` and the reference
engine's ``_serve_param_specs``).

A spec is a tuple with one entry per dim of its leaf, as a JAX
``PartitionSpec``: ``"tp"`` marks the dim cut over the tensor-parallel
ranks, ``None`` a whole dim.  Rank r of tp holds the r-th of tp equal
slices along that dim; a spec without ``"tp"`` keeps the leaf whole on
every rank.  An int8 weight (:class:`~kubegpu_tpu_torch.models.quant.
QTensor`) carries a pair of specs, one for its values and one for its
scales, in a ``QTensor`` of specs, as the reference's spec tree does.
"""

from __future__ import annotations

import torch

from kubegpu_tpu_torch.models.quant import QTensor

TP = "tp"


def serve_param_specs(quant_weights: bool = False) -> dict:
    """Per-leaf specs of the Llama serving weights, split Megatron-style
    over ``tp``: wq/wk/wv and w_gate/w_up by columns (their output
    features: whole heads and d_ff slices), wo and w_down by rows (so each
    rank's product is a partial sum, all-reduced), ``lm_head`` by
    vocabulary (the logits are all-gathered before a token is picked).
    The embedding and the norms stay whole: decode looks a row up once a
    step.  ``quant_weights`` mirrors the tree onto QTensor leaves: a
    per-output-channel scale is cut with its values on a column split and
    stays whole on a row split (its channel dim is the uncut output)."""

    def col(n_dims: int = 3):
        v = (None,) * (n_dims - 1) + (TP,)
        return QTensor(v, v) if quant_weights else v

    def row():
        v = (None, TP, None)
        return QTensor(v, (None, None, None)) if quant_weights else v

    return {
        "embed": (None, None),
        "layers": {
            "attn_norm": (None, None),
            "wq": col(), "wk": col(), "wv": col(),
            "wo": row(),
            "mlp_norm": (None, None),
            "w_gate": col(), "w_up": col(),
            "w_down": row(),
        },
        "final_norm": (None,),
        "lm_head": col(2),
    }


def pool_specs(pool: dict) -> dict:
    """Specs of a page pool's leaves: the KV-head dim 2 of the values
    ``[L, N, Hkv, P, D]`` (``D/2`` for packed int4) and of the scales
    ``[L, N, Hkv, n]``."""
    return {name: (None, None, TP) + (None,) * (x.dim() - 3)
            for name, x in pool.items()}


def _cut(x: torch.Tensor, spec: tuple, rank: int, tp: int,
         device: torch.device | None = None) -> torch.Tensor:
    """Rank ``rank``'s slice of ``x`` under ``spec``, as a contiguous
    copy on ``device`` (default: ``x``'s; a view would keep the whole
    leaf's storage alive); ``x`` itself, moved to ``device`` where it lies
    elsewhere, when the spec keeps it whole.  Only the slice is copied:
    the whole leaf never lands on ``device``."""
    device = x.device if device is None else torch.device(device)
    if TP not in spec:
        return x.to(device)
    dim = spec.index(TP)
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"tp={tp} must divide dim {dim} of a leaf of shape "
                         f"{tuple(x.shape)}")
    part = x.narrow(dim, rank * (n // tp), n // tp)
    return torch.empty(part.shape, dtype=part.dtype,
                       device=device).copy_(part)


def shard_tree(tree, specs, rank: int, tp: int,
               device: torch.device | None = None):
    """Rank ``rank``'s shard of every leaf of ``tree`` under the matching
    ``specs`` (a tree of the same nesting, QTensor leaves matched by
    QTensor specs), on ``device`` (default: where each leaf lies); ``tree``
    is not changed.  A tree on the host or on another card is cut where
    it lies and only the shard moves."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], rank, tp, device)
                for k, v in tree.items()}
    if isinstance(tree, QTensor):
        if not isinstance(specs, QTensor):
            raise TypeError("a QTensor leaf needs a QTensor spec pair")
        return QTensor(_cut(tree.values, specs.values, rank, tp, device),
                       _cut(tree.scale, specs.scale, rank, tp, device))
    if isinstance(specs, QTensor):
        raise TypeError("a QTensor spec pair matches a plain tensor leaf")
    return _cut(tree, specs, rank, tp, device)
