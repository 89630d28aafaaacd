"""AdamW and Adam with ``optax``'s arithmetic (port-only, as ``convert.py``
is).

The reference trains with ``optax.adamw(learning_rate)`` (and ResNet with
``optax.adam(learning_rate)``); the port keeps its own copy of that
arithmetic (optax 0.2.6), in optax's order:

1. moments in the parameters' dtype: ``mu = (1 - b1) g + b1 mu``,
   ``nu = (1 - b2) g² + b2 nu``;
2. bias correction by the step count, ``1 - b**count`` taken in f32;
3. ``u = mu_hat / (sqrt(nu_hat) + eps)``;
4. ``u += weight_decay * p`` (decoupled decay, on every leaf; ``adam`` has
   no such step);
5. ``u *= -learning_rate`` and ``p += u``.

``torch.optim.AdamW`` is not used: its ``weight_decay`` defaults to 1e-2
where optax's is 1e-4, and it folds the decay in before the Adam step.
Parameters and moments update in place to save memory (the reference
returns new arrays), a large leaf in slices along its first dim of at most
``CHUNK`` elements, so the step's temporaries are a slice's and not a
leaf's (the arithmetic is elementwise: the same numbers); state is
``{"count", "mu", "nu"}`` with ``mu``/``nu`` trees shaped like the
parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kubegpu_tpu_torch.tree import tree_leaves

# elements a slice of a leaf's update (Llama-3-8B's stacked FFN leaves are
# 1.9 G elements: whole, AdamW's two temporaries would be 7.5 GB)
CHUNK = 1 << 26


def _slices(*leaves):
    """Matching views of same-shaped leaves, along dim 0, each at most
    ``CHUNK`` elements where a row allows."""
    x = leaves[0]
    if x.dim() == 0 or x.numel() <= CHUNK:
        return [leaves]
    rows = max(1, CHUNK // (x.numel() // x.shape[0]))
    return list(zip(*(t.split(rows, 0) for t in leaves)))


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree, requires_grad=False)


@dataclass(frozen=True)
class _AdamW:
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params) -> dict:
        """Zero moments in each parameter's dtype, step count 0."""
        return {"count": 0, "mu": _zeros_like(params),
                "nu": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, state: dict, params) -> dict:
        """One AdamW step: ``params`` and the state's moments change in
        place; returns the new state.  ``grads`` and ``params`` are trees
        (or lists) with the leaves in the same order."""
        count = state["count"] + 1
        bc1 = float(1 - np.float32(self.b1) ** count)
        bc2 = float(1 - np.float32(self.b2) ** count)
        for leaf in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                        tree_leaves(state["nu"]), tree_leaves(params),
                        strict=True):
            for g, mu, nu, p in _slices(*leaf):
                mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
                nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                u = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
                if self.weight_decay:
                    u.add_(p, alpha=self.weight_decay)
                p.add_(u.mul_(-self.learning_rate))
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> _AdamW:
    """optax's spelling and defaults (weight decay 1e-4, not torch's
    1e-2): an optimizer with ``init(params)`` and ``update(grads, state,
    params)``."""
    return _AdamW(learning_rate, b1, b2, eps, weight_decay)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> _AdamW:
    """``optax.adam``: :func:`adamw`'s steps with no decay term (moments in
    the parameters' dtype, updates in place)."""
    return _AdamW(learning_rate, b1, b2, eps, weight_decay=0.0)
