"""Parameter conversion from the reference's pytree layout.

The port keeps the reference's parameter layout (stacked layers on a
leading ``L`` dim, ``W`` stored ``[in, out]``), so conversion is a copy of
each leaf.  The input is the reference's nested dict with numpy leaves
(for example ``jax.tree.map(np.asarray, params)``); bfloat16 leaves from
``ml_dtypes`` are reinterpreted bit for bit.  A quantized leaf (anything
with ``.values`` and ``.scale``, as the reference's ``QTensor`` after that
map) becomes the port's :class:`~kubegpu_tpu_torch.models.quant.QTensor`,
its int8 values and f32 scales copied as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from kubegpu_tpu_torch.models.quant import QTensor


def _leaf(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    # dtype casts float leaves only: int8 values stay int8
    return t.to(device=device,
                dtype=dtype if dtype and t.is_floating_point() else t.dtype)


def _tree(tree: dict, device, dtype, keep=frozenset()) -> dict:
    """Convert every leaf; leaves named in ``keep`` keep their dtype."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _tree(v, device, dtype, keep)
        elif hasattr(v, "values") and hasattr(v, "scale"):
            out[k] = QTensor(_leaf(v.values, device, None),
                             _leaf(v.scale, device, None))
        else:
            out[k] = _leaf(v, device, None if k in keep else dtype)
    return out


def convert_llama_params(tree: dict, device="cuda",
                         dtype: torch.dtype | None = None) -> dict:
    """Reference Llama params (nested dict of numpy arrays, int8 leaves
    allowed) → the port's params (the same nesting, torch tensors on
    ``device``, float leaves cast to ``dtype`` when given; a quantized
    leaf keeps its int8 values and f32 scales)."""
    return _tree(tree, device, dtype)


def convert_t5_params(tree: dict, device="cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """Reference T5 params → the port's, as :func:`convert_llama_params`
    (the layouts match leaf for leaf)."""
    return _tree(tree, device, dtype)


def convert_moe_params(tree: dict, device="cuda",
                       dtype: torch.dtype | None = None) -> dict:
    """Reference MoE params (``moe_init``'s tree, or ``quantize_moe``'s with
    int8 experts and per-(layer, expert, channel) f32 scales) → the
    port's, as :func:`convert_llama_params`, except that ``w_router`` stays
    f32 whatever ``dtype`` (routing is precision-critical)."""
    return _tree(tree, device, dtype, keep=frozenset({"w_router"}))


def convert_vit_params(tree: dict, device="cuda",
                       dtype: torch.dtype | None = None) -> dict:
    """Reference ViT params → the port's, as :func:`convert_llama_params`
    (the layouts match leaf for leaf)."""
    return _tree(tree, device, dtype)


def convert_lora_adapters(tree: dict, device="cuda",
                          dtype: torch.dtype | None = None) -> dict:
    """Reference LoRA adapters (``{target: {"a", "b"}}``) → the port's, a
    copy of each leaf."""
    return _tree(tree, device, dtype)


def convert_resnet_variables(variables: dict, device="cuda") -> dict:
    """Reference ResNet variables (flax's ``{"params", "batch_stats"}`` of
    numpy arrays) → a state dict for the port's
    :class:`~kubegpu_tpu_torch.models.resnet.ResNet` (``load_state_dict``):
    the key is the flax path joined by dots (``Bottleneck_3.Conv_1``), a
    convolution's HWIO ``kernel`` becomes the OIHW ``weight``, and the
    rest (batch-norm ``scale``/``bias``/``mean``/``var``, the dense
    ``kernel`` [in, out] and ``bias``) is copied as it is."""
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            t = _leaf(v, device, None)
            if k == "kernel" and t.ndim == 4:
                k, t = "weight", t.permute(3, 2, 0, 1).contiguous()
            out[".".join(path + (k,))] = t

    for coll in ("params", "batch_stats"):
        walk(variables.get(coll, {}), ())
    return out
