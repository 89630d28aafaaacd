"""The collectives of the tensor-parallel serving engine: one process a
rank, and explicit ``torch.distributed`` calls on plain local tensors (the
reference's ``lax.psum`` and ``lax.all_gather`` inside its ``shard_map``).
This module imports nothing of the port, so the model code can import it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x``, in place (a row-split product's
    partials: the reference's ``lax.psum``)."""
    dist.all_reduce(x, group=group)
    return x


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` side by side along ``dim``, rank order (the
    reference's tiled ``lax.all_gather``).  A list ``all_gather`` takes
    CUDA tensors over NCCL and over gloo alike."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` [..., n] side by side along the last dim:
    [..., tp·n] (the vocabulary shards of the logits)."""
    return all_gather_dim(x, -1, group)


def broadcast_float(value: float, group) -> float:
    """Rank 0's ``value`` on every rank: a host decision that reads a
    clock is taken from rank 0, so no two ranks' schedules part.  The
    scalar travels on the CPU over gloo and on the current card over
    NCCL."""
    dev = ("cuda" if dist.get_backend(group) == dist.Backend.NCCL
           else "cpu")
    t = torch.full((1,), value, dtype=torch.float64, device=dev)
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return float(t.item())
