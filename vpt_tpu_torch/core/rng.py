"""jax.random's threefry-2x32 stream, bit for bit, in torch.

The reference (vpt_tpu/core/rng.py) draws every random number from
``jax.random`` keys: ``render_key(seed, it)``, then ``fold_in`` /
``split`` per call site and ``uniform`` per batch.  jax 0.9 runs with
``jax_threefry_partitionable=True``, in which element ``i`` of a 32-bit
draw of any shape is ``b1 ^ b2`` with ``(b1, b2) = threefry2x32(key,
(hi32(i), lo32(i)))`` and ``i`` the flat index — so every element is
addressable on its own, and a CUDA thread can compute its own ray's
draws (csrc/vpt_common.cuh carries the same function).

Keys are pairs of python ints (the two uint32 words).  Counters are
int64 tensors holding uint32 values: torch's uint32 lacks most ops, so
the arithmetic is int64 masked to 32 bits.
"""

from __future__ import annotations

import torch

from vpt_tpu_torch.core.device import DEFAULT_DEVICE

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    # x < 2**32 and r <= 29, so x << r stays inside int64
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (jax/_src/prng.py::_threefry2x32).

    Works on python ints and on int64 tensors alike."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def PRNGKey(seed: int) -> tuple[int, int]:
    """jax.random.PRNGKey for a non-negative 32-bit seed."""
    if not 0 <= int(seed) <= MASK:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return (0, int(seed))


def fold_in(key, data: int) -> tuple[int, int]:
    """jax.random.fold_in: threefry of the key over (0, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """jax.random.split (fold-like in partitionable mode): subkey i is
    threefry of the key over (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def random_bits(key, n: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """(n,) int64 tensor of the 32-bit draws of a flat shape of n."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], i >> 32, i & MASK)
    return b1 ^ b2


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1): the top 23 bits as a mantissa
    of [1, 2), minus 1 (jax.random.uniform)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, shape, device=DEFAULT_DEVICE) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) with minval 0, maxval 1."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= int(s)
    return bits_to_unit(random_bits(key, n, device)).reshape(shape)


def render_key(seed: int, iteration: int) -> tuple[int, int]:
    """Key for one progressive iteration (= one sample per pixel)."""
    return fold_in(PRNGKey(seed), iteration)

