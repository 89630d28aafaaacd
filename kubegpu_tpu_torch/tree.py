"""Nested-dict parameter trees (the counterpart of ``jax.tree_util``'s
``tree_leaves`` for the port's plain-dict parameters)."""

from __future__ import annotations

import torch


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict (or list) in insertion order."""
    items = tree.values() if isinstance(tree, dict) else tree
    return [x for v in items
            for x in (tree_leaves(v) if isinstance(v, (dict, list, tuple))
                      else [v])]
