"""Threefry-2x32 in numpy: the bits ``jax.random`` draws, without JAX.

The plane fits of the JAX package draw their RANSAC samples from
``jax.random`` (cartslam_tpu/utils/plane_math.py): a per-pixel tie-break
key ``randint(PRNGKey(0), (H*W,), 0, 1 << 20)`` and, per hypothesis,
``randint(split(PRNGKey(seed), H)[h], (L, 3), 0, 1 << 30)``.  Those draws
are the port's "weights": with other bits its RANSAC would try other
hypotheses.  This is a copy of the algorithm (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011, with the 20-round key
schedule of JAX's ``threefry2x32`` primitive) and of the partitionable bit
layout, the default of jax 0.9 (``jax_threefry_partitionable``): element i
of a draw of shape S hashes the 64-bit counter i, split into its high and
low words, and 32-bit bits are the xor of the two output words.

uint32 arithmetic wraps, as it does in XLA.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under key (k1, k2)."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _counters(shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """The 64-bit iota over `shape` as (high, low) uint32 words."""
    i = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^31) (JAX's 32-bit
    mode): the key (0, seed)."""
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed {seed} outside [0, 2^31)")
    return np.array([0, seed], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: [num, 2] keys."""
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key[0], key[1], *_counters((num,)))
    return np.stack([b1, b2], axis=-1)


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits a element, uint32 of `shape`."""
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key[0], key[1], *_counters(tuple(shape)))
    return b1 ^ b2


def randint(key: np.ndarray, shape: tuple[int, ...], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32: two
    draws of bits (from the two halves of ``split(key)``) combined modulo
    the span, with JAX's uint32 multiplier ``(2**16 % span)**2 % span``."""
    if not (-2**31 <= minval < maxval <= 2**31 - 1):
        raise ValueError(f"randint range [{minval}, {maxval}) outside int32")
    k_hi, k_lo = split(key)
    hi, lo = random_bits(k_hi, shape), random_bits(k_lo, shape)
    span = np.uint32(maxval - minval)
    with np.errstate(over="ignore"):
        mult = np.uint32(2**16) % span
        mult = np.uint32(np.uint64(mult) * np.uint64(mult) & np.uint64(0xFFFFFFFF)) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
