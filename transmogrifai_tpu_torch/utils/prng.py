"""Counter-based random draws that reproduce the JAX package's bagging draws
bit for bit: threefry2x32 keys (``PRNGKey``, ``split``), ``uniform`` and the
Poisson draw for rates below 10 (Knuth's loop), as ``jax.random`` computes
them with ``jax_threefry_partitionable`` on.

Everything here is numpy on the host, over uint32. A key is a uint32 array
of shape (2,).

One known difference remains: Knuth's loop sums f32 logarithms and compares
the sum with ``-lam``. XLA's f32 ``log`` is not correctly rounded, and this
module's is (float64 ``log`` rounded to f32), so a count can differ where
the running sum lands within an ulp or two of ``-lam``.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(
    k1: np.ndarray, k2: np.ndarray, x1: np.ndarray, x2: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher, 20 rounds, elementwise over uint32
    counter pairs (x1, x2) under the key (k1, k2)."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = (x[1] + ks[(i + 2) % 3]) + np.uint32(i + 1)
    return x[0], x[1]


def _counters(num: int) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) uint32 words of the 64-bit counters 0 .. num-1."""
    c = np.arange(num, dtype=np.uint64)
    return (c >> np.uint64(32)).astype(np.uint32), c.astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    return np.array([0, np.uint32(seed & 0xFFFFFFFF)], dtype=np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> [num, 2] uint32 keys."""
    hi, lo = _counters(num)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=1)


def random_bits(key: np.ndarray, num: int) -> np.ndarray:
    """``num`` uint32 words: the two cipher outputs of each counter xor'ed."""
    hi, lo = _counters(num)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def uniform(key: np.ndarray, num: int) -> np.ndarray:
    """``jax.random.uniform(key, (num,))``: f32 in [0, 1) from the top 23
    bits of each word, as the mantissa of a number in [1, 2), minus 1."""
    bits = (random_bits(key, num) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def _log_f32(u: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.log(u.astype(np.float64)).astype(np.float32)


def poisson(key: np.ndarray, lam: float, num: int) -> np.ndarray:
    """``jax.random.poisson(key, lam, (num,))`` for 0 <= lam < 10 (Knuth's
    loop, the branch JAX takes below 10) -> int32 [num]."""
    lam = np.float32(lam)
    if not 0.0 <= lam < 10.0:
        raise NotImplementedError(
            f"poisson: only rates in [0, 10) are ported (got {lam})"
        )
    if lam == 0:
        return np.zeros(num, dtype=np.int32)
    k = np.zeros(num, dtype=np.int32)
    log_prod = np.zeros(num, dtype=np.float32)
    rng = np.asarray(key, dtype=np.uint32)
    while (log_prod > -lam).any():
        rng, sub = split(rng)
        k = np.where(log_prod > -lam, k + 1, k).astype(np.int32)
        log_prod = log_prod + _log_f32(uniform(sub, num))
    return (k - 1).astype(np.int32)
