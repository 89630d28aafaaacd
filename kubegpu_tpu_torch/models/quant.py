"""Weight-only int8 quantization for serving (counterpart of
``kubegpu_tpu/models/quant.py``).

Symmetric per-output-channel int8: a matmul weight ``w`` becomes int8
``values`` and f32 ``scale`` with ``w ≈ values * scale``.  :class:`QTensor`
holds the pair, and ``x @ qt`` computes ``(x @ values.to(x.dtype)) *
scale.to(x.dtype)``, the reference's contract.  Python reaches
:meth:`QTensor.__rmatmul__` on its own: ``Tensor.__matmul__`` returns
``NotImplemented`` to a foreign right-hand operand.  Since the model code
uses weights only through ``@`` (and :meth:`QTensor.unbind` and slicing
for stacked layers), :func:`quantize_llama`, :func:`quantize_moe` and
:func:`quantize_t5` swap leaves in place and the forward, decode and
serving paths run unchanged on the result.
Norms, embeddings and relative-bias tables stay full precision.

Eager PyTorch materialises ``values.to(x.dtype)`` on every call, so the
int8 bytes are read and a model-dtype copy is written and read again: on
the card this path moves more bytes than the model-dtype weights it
replaces (PERF.md §5).
"""

from __future__ import annotations

import torch

from kubegpu_tpu_torch.tree import tree_leaves


class QTensor:
    """Symmetric per-output-channel int8 weight: ``values`` [..., out] int8
    and ``scale`` f32 with the reduced axes kept as size 1 (a stacked
    ``[L, in, out]`` leaf has a ``[L, 1, out]`` scale, so :meth:`unbind`
    slices both in lockstep)."""

    def __init__(self, values: torch.Tensor, scale: torch.Tensor):
        self.values = values
        self.scale = scale

    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self) -> int:
        return self.values.ndim

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.values, self.scale))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.values.float() * self.scale).to(dtype)

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.scale.to(x.dtype)
        if x.ndim == 1 and scale.ndim >= 2:
            # a 1-D x contributes no batch dim: the product is [..., out]
            # with the contracted slot gone, so drop its size-1 slot from
            # the scale ([out] * [1, out] would give [1, out])
            scale = scale.squeeze(-2)
        # a batched x keeps the scale as it is: [B, out] * [1, out], and
        # stacked values give [L, B, out] * [L, 1, out]
        return (x @ self.values.to(x.dtype)) * scale

    def unbind(self, dim: int = 0) -> tuple["QTensor", ...]:
        """The slices along a kept (batch) dim, values and scales
        together."""
        return tuple(QTensor(v, s) for v, s in zip(self.values.unbind(dim),
                                                   self.scale.unbind(dim)))

    def __getitem__(self, idx: slice) -> "QTensor":
        """A slice along the leading (stacked) dim, values and scales
        together: both are views, so nothing is copied."""
        if not isinstance(idx, slice):
            raise TypeError("a QTensor takes a slice of its leading dim "
                            f"only, got {idx!r}")
        return QTensor(self.values[idx], self.scale[idx])

    def to(self, device) -> "QTensor":
        return QTensor(self.values.to(device), self.scale.to(device))

    def tree_flatten(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The tensors of the pair (:func:`kubegpu_tpu_torch.tree.
        tree_leaves` lists both, as ``jax.tree.leaves`` does)."""
        return self.values, self.scale

    def __repr__(self) -> str:
        return f"QTensor(shape={tuple(self.values.shape)}, int8)"


def quantize(w: torch.Tensor, batch_dims: int = 0) -> QTensor:
    """Per-output-channel (last dim) symmetric int8; ``batch_dims``
    leading axes keep their own scales (stacked ``[L, ...]`` weights get
    one scale per layer and channel).  Round half to even and clip to
    ±127, as the reference; a stacked leaf is rated one slice at a time,
    which gives the same bytes with one slice's f32 transient."""
    if batch_dims:
        parts = [quantize(x, batch_dims - 1) for x in w.unbind(0)]
        return QTensor(torch.stack([p.values for p in parts]),
                       torch.stack([p.scale for p in parts]))
    wf = w.float()
    # amax over no axes is |w| itself (torch's amax(dim=()) would reduce
    # every axis)
    amax = (wf.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
            if w.ndim > 1 else wf.abs())
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def quantize_tree(params: dict, quant_keys: frozenset,
                  stacked_subtrees: frozenset,
                  stacked_batch_dims: dict | None = None) -> dict:
    """Quantize the named matmul-weight leaves of a parameter tree in one
    pass: keys under a subtree named in ``stacked_subtrees`` are stacked
    ``[L, ...]`` weights with per-(layer, channel) scales, the rest get
    per-channel scales.  ``stacked_batch_dims`` overrides the kept leading
    axes of given stacked keys (MoE's ``[L, E, in, out]`` experts keep 2).
    Other leaves are kept as they are (the same tensors)."""
    overrides = stacked_batch_dims or {}

    def walk(tree: dict, stacked: bool) -> dict:
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k in stacked_subtrees)
            elif k in quant_keys:
                out[k] = quantize(
                    v, batch_dims=overrides.get(k, 1) if stacked else 0)
            else:
                out[k] = v
        return out
    return walk(params, False)


# the big matmul weights; norms are tiny and the embedding feeds a lookup
_LLAMA_QUANT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"})

# T5: encoder attention (w*), decoder self (s*) and cross (c*) attention,
# the gated-GELU FFN and the head; the relative-bias tables feed a lookup
_T5_QUANT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "sq", "sk", "sv", "so",
     "cq", "ck", "cv", "co", "wi_0", "wi_1", "wo_ff", "lm_head"})


def quantize_llama(params: dict) -> dict:
    """A Llama parameter tree with int8 matmul weights; it drops into
    ``llama_forward``, ``prefill``, ``greedy_generate`` and the serving
    engine unchanged."""
    return quantize_tree(params, _LLAMA_QUANT_KEYS, frozenset({"layers"}))


def quantize_moe(params: dict) -> dict:
    """A MoE parameter tree with int8 matmul weights: attention and the
    head as Llama's, the stacked experts ``[L, E, in, out]`` with
    per-(layer, expert, channel) scales ``[L, E, 1, out]``, so an expert
    product ``[E, N, in] @ [E, in, out]`` scales each expert by its own;
    the f32 router stays as it is."""
    return quantize_tree(
        params, _LLAMA_QUANT_KEYS, frozenset({"layers"}),
        stacked_batch_dims={"w_gate": 2, "w_up": 2, "w_down": 2})


def quantize_t5(params: dict) -> dict:
    """A T5 encoder-decoder tree with int8 matmul weights; it drops into
    ``t5_encode`` and both greedy generates unchanged (the cross K/V
    projection dequantizes its weights once per call)."""
    return quantize_tree(params, _T5_QUANT_KEYS,
                         frozenset({"encoder", "decoder"}))


def tree_nbytes(tree) -> int:
    """Bytes of every tensor of ``tree``, both halves of a QTensor
    included."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
