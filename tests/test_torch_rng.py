"""vpt_tpu_torch.core.rng reproduces jax.random's threefry stream bit for
bit (jax_threefry_partitionable=True)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from vpt_tpu_torch.core import rng

SEEDS = [0, 1, 7, 123456, 2**31 - 1]


def _pair(k):
    return tuple(int(v) for v in np.asarray(k))


def test_partitionable_mode():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_fold_in_split(seed):
    k = jax.random.PRNGKey(seed)
    assert _pair(k) == rng.PRNGKey(seed)
    for data in (0, 1, 17, 1000, 1 << 20, 2**32 - 1):
        assert _pair(jax.random.fold_in(k, data)) == rng.fold_in(
            rng.PRNGKey(seed), data)
    kf = jax.random.fold_in(k, 5)
    for num in (2, 3):
        got = rng.split(rng.fold_in(rng.PRNGKey(seed), 5), num)
        want = [_pair(s) for s in jax.random.split(kf, num)]
        assert got == want


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("shape", [(1,), (7,), (33, 5), (4, 6, 2), (1000,)])
def test_uniform_bits(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    got = rng.uniform(_pair(key), shape, "cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_random_bits_match_jax():
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.bits(key, (257,), jnp.uint32))
    got = rng.random_bits(_pair(key), 257, "cpu").numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 99])
def test_threefry_primitive_high_word(seed):
    """Counters with a non-zero high word (flat indices >= 2**32) go
    through the primitive the same way."""
    r = np.random.default_rng(seed)
    x0 = r.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    x1 = r.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    x0[:4] = [1, 2, 0xFFFFFFFF, 0x80000000]
    k0, k1 = (int(v) for v in r.integers(0, 2**32, 2, dtype=np.uint64))
    y0, y1 = jprng.threefry2x32_p.bind(
        jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(x0), jnp.asarray(x1))
    t0, t1 = rng.threefry2x32(k0, k1, torch.as_tensor(x0.astype(np.int64)),
                              torch.as_tensor(x1.astype(np.int64)))
    np.testing.assert_array_equal(t0.numpy().astype(np.uint32),
                                  np.asarray(y0))
    np.testing.assert_array_equal(t1.numpy().astype(np.uint32),
                                  np.asarray(y1))


def test_render_key():
    for seed, it in ((0, 0), (3, 17), (5, 1023)):
        want = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.uint32(it))
        assert rng.render_key(seed, it) == _pair(want)


def test_seed_out_of_range():
    with pytest.raises(ValueError):
        rng.PRNGKey(-1)
