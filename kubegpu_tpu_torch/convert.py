"""Parameter conversion from the reference's pytree layout.

The port keeps the reference's parameter layout (stacked layers on a
leading ``L`` dim, ``W`` stored ``[in, out]``), so conversion is a copy of
each leaf.  The input is the reference's nested dict with numpy leaves
(for example ``jax.tree.map(np.asarray, params)``); bfloat16 leaves from
``ml_dtypes`` are reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def _tree(tree: dict, device, dtype) -> dict:
    return {k: (_tree(v, device, dtype) if isinstance(v, dict)
                else _leaf(v, device, dtype))
            for k, v in tree.items()}


def convert_llama_params(tree: dict, device="cuda",
                         dtype: torch.dtype | None = None) -> dict:
    """Reference Llama params (nested dict of numpy arrays) → the port's
    params (the same nesting, torch tensors on ``device``, cast to
    ``dtype`` when given)."""
    return _tree(tree, device, dtype)


def convert_t5_params(tree: dict, device="cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """Reference T5 params → the port's, as :func:`convert_llama_params`
    (the layouts match leaf for leaf; int8 ``QTensor`` leaves are not
    ported yet)."""
    return _tree(tree, device, dtype)
