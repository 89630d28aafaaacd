"""``jax.random`` as the reference uses it, on torch tensors (port-only).

JAX's default generator is threefry2x32 under its *partitionable* layout
(``jax_threefry_partitionable``, the default in the reference's JAX): a
key is two uint32 words, ``split`` and ``random_bits`` hash counters made
of the high and low words of a flat int64 index, and ``fold_in`` hashes
the counter ``(0, data)``.  The hash is 32-bit adds, rotations and xors
only, so here it runs on int64 tensors holding uint32 values (every
intermediate masked with ``& 0xFFFFFFFF``; no shift or add reaches 2^63)
and gives the reference's bits exactly, on any device, with no generator
state: a key is an int64 tensor ``[2]`` on the device of what it keys.
``data`` may be a device tensor (an engine's tick), so a CUDA graph that
folds it in replays fresh noise every tick.

The floats follow ``jax.random``'s own recipe (mantissa bits under an
exponent of 1, minus 1), so :func:`uniform` is bit-equal (on [0, 1) and
[tiny, 1) always) and :func:`gumbel` differs only where torch's ``log``
and XLA's round their last bit apart.  JAX lowers all of this to XLA, not to Pallas: there is
no kernel, only plain ops.
"""

from __future__ import annotations

import numpy as np
import torch

_M = 0xFFFFFFFF
# the threefry2x32 key-schedule parity and the two rotation schedules
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def prng_key(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (32-bit seeds, JAX's default without
    x64): the words ``(0, seed & 0xFFFFFFFF)``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return torch.tensor([0, seed & _M], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (``jax._src.prng._threefry2x32_lowering``):
    20 rounds over the counter words ``(x1, x2)`` under the key ``(k1,
    k2)``, all int64 tensors of uint32 values that broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M
    x2 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M
    return x1, x2


def _counters(n: int, device):
    """High and low words of the flat int64 indices ``[0, n)`` (the
    partitionable layout's ``iota_2x32_shape``)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry of the counter ``(0,
    data & 0xFFFFFFFF)``.  ``data`` is an int or a one-element integer
    tensor (on the key's device; a graph may replay it with new
    values)."""
    if isinstance(data, torch.Tensor):
        x2 = data.reshape(()).to(torch.int64) & _M
    else:
        x2 = torch.full((), int(data) & _M, dtype=torch.int64,
                        device=key.device)
    o1, o2 = threefry2x32(key[0], key[1], torch.zeros_like(x2), x2)
    return torch.stack([o1, o2])


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)``: row i is threefry of the counter
    ``(0, i)``.  Returns ``[n, 2]``."""
    hi, lo = _counters(n, key.device)
    o1, o2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 values in int64): for flat
    index i, the xor of threefry's two words over ``(i >> 32, i &
    0xFFFFFFFF)``.  Every element depends on the whole shape's row-major
    layout, so a batch is always drawn whole."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    hi, lo = _counters(n, key.device)
    o1, o2 = threefry2x32(key[0], key[1], hi, lo)
    return (o1 ^ o2).reshape(shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits as the mantissa of a float in [1, 2), minus 1, scaled
    into ``[minval, maxval)`` and raised to ``minval`` where it rounded
    below (``lax.max(minval, ·)``)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their span rounded to f32, as the reference casts
    # them; XLA fuses ``floats * span + lo`` into one rounding (an FMA):
    # the f64 product is exact, so one f32 rounding of the f64 result
    # matches it wherever the f64 sum itself is exact (always for the
    # [0, 1) and [tiny, 1) draws; otherwise but for a rare double rounding)
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    out = (floats.double() * float(span) + float(lo)).float()
    return torch.clamp(out, min=float(lo))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (its default "low" mode, f32):
    ``-log(-log(u))`` for u uniform in ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the Gumbel-max
    draw ``argmax(logits + gumbel(key, logits.shape))`` along the last
    axis (the first index on an exact tie, as ``jnp.argmax``)."""
    return (gumbel(key, logits.shape) + logits).argmax(dim=-1)
