"""The port's ``prng`` (JAX's threefry2x32 key schedule on torch tensors)
against ``jax.random`` on the CPU: keys, ``fold_in``, ``split``,
``random_bits`` and ``uniform`` bit for bit; ``gumbel`` within the last
bits of ``log`` (torch's and XLA's may round it apart, and ``-log(-log
u)`` cancels near 0: |diff| <= 1e-6 + 4e-7 |value|); ``categorical`` to
the same index.  ``jax_threefry_partitionable`` is JAX's default, and the
layout the port follows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from kubegpu_tpu_torch import prng

SEEDS = [0, 1, 7, 1234, 2 ** 31 - 1, -1, -5]


def _key(seed):
    return jax.random.PRNGKey(seed), prng.prng_key(seed, device="cpu")


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_partitionable_layout_is_jax_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    kj, kt = _key(seed)
    np.testing.assert_array_equal(_np(kj), kt.numpy())


def test_prng_key_refuses_a_seed_past_32_bits():
    with pytest.raises(ValueError, match="32-bit"):
        prng.prng_key(2 ** 31, device="cpu")


def test_threefry2x32_against_jax():
    """The hash itself over random counters (both words non-zero): JAX's
    ``threefry_2x32`` splits an even count vector into its two halves."""
    rng = np.random.default_rng(0)
    for _ in range(4):
        key = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
        count = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(
            np.uint32)
        want = _np(jprng.threefry_2x32(jnp.asarray(key), jnp.asarray(count)))
        k = torch.from_numpy(key.astype(np.int64))
        c = torch.from_numpy(count.astype(np.int64))
        o1, o2 = prng.threefry2x32(k[0], k[1], c[:32], c[32:])
        np.testing.assert_array_equal(torch.cat([o1, o2]).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31 - 1, 123456789])
def test_fold_in(seed, data):
    kj, kt = _key(seed)
    want = _np(jax.random.fold_in(kj, data))
    np.testing.assert_array_equal(prng.fold_in(kt, data).numpy(), want)
    # a device scalar (an engine's tick), 0-d or [1], int32 or int64
    for t in (torch.tensor(data, dtype=torch.int32),
              torch.tensor([data], dtype=torch.int64)):
        np.testing.assert_array_equal(prng.fold_in(kt, t).numpy(), want)


def test_fold_in_chain_then_split():
    """The engine's tick keys: ``split(fold_in(fold_in(key, 0), tick),
    stride)``."""
    kj, kt = _key(1234)
    for tick in (0, 1, 57):
        want = _np(jax.random.split(jax.random.fold_in(
            jax.random.fold_in(kj, 0), tick), 4))
        got = prng.split(prng.fold_in(prng.fold_in(kt, 0), tick), 4)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("n", [1, 2, 5, 33])
def test_split(seed, n):
    kj, kt = _key(seed)
    got = prng.split(kt, n)
    assert got.shape == (n, 2)
    np.testing.assert_array_equal(got.numpy(), _np(jax.random.split(kj, n)))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (2, 3, 4),
                                   (129,), (8, 257)])
def test_random_bits(seed, shape):
    kj, kt = _key(seed)
    key_j = jax.random.fold_in(kj, 3)
    key_t = prng.fold_in(kt, 3)
    want = _np(jax.random.bits(key_j, shape))
    got = prng.random_bits(key_t, shape)
    assert tuple(got.shape) == tuple(shape)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-2.0, 3.0),
                                    (float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_bit_equal(bounds):
    for seed in SEEDS[:3]:
        kj, kt = _key(seed)
        want = np.asarray(jax.random.uniform(kj, (8, 1000), jnp.float32,
                                             *bounds))
        got = prng.uniform(kt, (8, 1000), *bounds)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_gumbel_within_the_last_bits_of_log(seed):
    kj, kt = _key(seed)
    want = np.asarray(jax.random.gumbel(kj, (8, 32000)))
    got = prng.gumbel(kt, (8, 32000)).numpy()
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=1e-6)
    assert (got == want).mean() > 0.5


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(8, 32000), (3, 50), (1, 7)])
def test_categorical_same_tokens(seed, shape):
    kj, kt = _key(seed)
    logits = np.random.default_rng(seed % 7).standard_normal(
        shape).astype(np.float32) * 3
    want = np.asarray(jax.random.categorical(kj, jnp.asarray(logits)))
    got = prng.categorical(kt, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
