"""Counter-based random draws that reproduce the JAX package's draws bit for
bit: threefry2x32 keys (``PRNGKey``, ``split``), ``uniform``, ``normal``,
``gamma`` and the Poisson draw for rates below 10 (Knuth's loop), as
``jax.random`` computes them with ``jax_threefry_partitionable`` on.

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


def _uniform_of(bits: np.ndarray) -> np.ndarray:
    """f32 in [0, 1) from the top 23 bits of each word, as the mantissa of a
    number in [1, 2), minus 1."""
    bits = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def uniform(key: np.ndarray, num: int) -> np.ndarray:
    """``jax.random.uniform(key, (num,))``."""
    return _uniform_of(random_bits(key, num))


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


# --------------------------------------------------------------------------
# jax.random.normal: uniform on (-1, 1), then sqrt(2) * erfinv, with the
# float32 erfinv XLA's CPU backend emits (Giles' polynomial over -log1p(-x^2))
# and that backend's log1p and log, every multiply-add fused as it fuses
# them. Exact IEEE operations in a fixed order, so the same bits anywhere.
# --------------------------------------------------------------------------
_F = np.float32
_ERFINV_LT5 = np.array(
    [2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941],
    dtype=np.float32)
_ERFINV_GE5 = np.array(
    [-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682],
    dtype=np.float32)
#: Cephes' rational log1p for |x| < sqrt(2) - 1, highest degree first
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a*b + c`` rounded once (the f32 product is exact in
    float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _log_xla(v: np.ndarray) -> np.ndarray:
    """float32 log as XLA's CPU backend computes it (Eigen's Cephes-style
    ``plog``), for positive finite inputs."""
    v = np.asarray(v, np.float32)
    tiny = _F(1.17549435e-38)
    bits = np.where(v <= tiny, tiny, v).astype(np.float32).view(np.int32)
    e = _F(1) + ((bits >> 23) - 127).astype(np.float32)
    m = ((bits & np.int32(-2139095041)) | np.int32(0x3F000000)).view(np.float32)
    small = m < _F(0.707106781186547524)
    e = (e - np.where(small, _F(1), _F(0))).astype(np.float32)
    x = ((m - _F(1)) + np.where(small, m, _F(0))).astype(np.float32)
    x2 = (x * x).astype(np.float32)
    x3 = (x2 * x).astype(np.float32)
    y = _fma(x, _F(7.0376836292E-2), _F(-1.1514610310E-1))
    y1 = _fma(x, _F(-1.2420140846E-1), _F(1.4249322787E-1))
    y2 = _fma(x, _F(2.0000714765E-1), _F(-2.4999993993E-1))
    y = _fma(y, x, _F(1.1676998740E-1))
    y1 = _fma(y1, x, _F(-1.6668057665E-1))
    y2 = _fma(y2, x, _F(3.3333331174E-1))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    s = _fma(y, x3, (_F(-2.12194440e-4) * e).astype(np.float32))
    t = _fma(_F(-0.5), x2, x)
    return _fma(_F(0.693359375), e, (t + s).astype(np.float32))


def _log1p_xla(x: np.ndarray) -> np.ndarray:
    """float32 log1p as XLA's CPU backend computes it: Cephes' rational
    form below sqrt(2) - 1 in magnitude, ``log(1 + x)`` above."""
    x = np.asarray(x, np.float32)
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    for c in _LOG1P_NUM:
        num = _fma(num, x, _F(c))
    for c in _LOG1P_DEN:
        den = _fma(den, x, _F(c))
    x2 = (x * x).astype(np.float32)
    s = ((x * x2).astype(np.float32) * (num / den).astype(np.float32)
         ).astype(np.float32)
    s = (x + _fma(_F(-0.5), x2, s)).astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        large = _log_xla((x + _F(1)).astype(np.float32))
    return np.where(np.abs(x) < _F(0.41421356237309504880), s, large)


def _erfinv_xla(x: np.ndarray) -> np.ndarray:
    """float32 erfinv as XLA emits it (Giles' single-precision
    polynomial), for |x| < 1."""
    x = np.asarray(x, np.float32)
    w = -_log1p_xla((-x * x).astype(np.float32))
    lt = w < _F(5)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, w - _F(2.5), np.sqrt(w) - _F(3)).astype(np.float32)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
    for i in range(1, 9):
        p = _fma(p, w, np.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]))
    return (p * x).astype(np.float32)


def _normal_of(bits: np.ndarray, scale=None) -> np.ndarray:
    """The standard normal of ``jax.random.normal`` from its random words:
    uniform on [nextafter(-1, 0), 1), then ``sqrt(2) * erfinv``."""
    lo = np.nextafter(_F(-1.0), _F(0.0))
    # (1 - lo) rounds to 2.0 in float32, so the scale is exact
    u = np.maximum(lo, (_uniform_of(bits) * _F(2.0) + lo).astype(np.float32))
    c = _F(np.sqrt(2))
    if scale is not None:
        c = (c * _F(scale)).astype(np.float32)
        return (_erfinv_xla(u) * c).astype(np.float32)
    return (c * _erfinv_xla(u)).astype(np.float32)


def normal(key: np.ndarray, shape, scale=None) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32, bit for bit. ``scale``
    gives ``normal(key, shape) * scale`` as a jitted program computes it:
    XLA folds the two constants, ``erfinv(u) * (sqrt(2) * scale)``."""
    shape = tuple(int(s) for s in np.atleast_1d(shape)) if shape != () else ()
    num = int(np.prod(shape, dtype=np.int64))
    return _normal_of(random_bits(key, num), scale).reshape(shape)


# --------------------------------------------------------------------------
# jax.random.gamma: Marsaglia and Tsang's loop per element (jax's
# ``_gamma_one`` under vmap), each element on its own key, as a jitted
# program with a constant ``a`` computes it on XLA's CPU backend: the
# constants d and c = (1/3) / sqrt(d) folded on the host in exact IEEE
# arithmetic, ``1 + x * c`` and ``1 - 0.0331 * X^2`` fused multiply-adds,
# the boost's ``pow`` the C library's ``powf``, subnormal results flushed
# to zero.
# --------------------------------------------------------------------------
_TINY = np.finfo(np.float32).tiny


def _split_each(keys: np.ndarray, num: int) -> np.ndarray:
    """``jax.random.split(k, num)`` of every key of ``keys`` [n, 2] ->
    [n, num, 2]."""
    hi, lo = _counters(num)
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], hi[None, :], lo[None, :])
    return np.stack([b1, b2], axis=-1)


def _word_each(keys: np.ndarray) -> np.ndarray:
    """The one random word of a scalar draw under every key of ``keys``."""
    b1, b2 = threefry2x32(keys[:, 0], keys[:, 1], np.uint32(0), np.uint32(0))
    return b1 ^ b2


def _flush(x: np.ndarray) -> np.ndarray:
    """Subnormal float32 values to zero, as XLA's CPU backend runs."""
    return np.where(np.abs(x) < _TINY, _F(0), x).astype(np.float32)


def _powf(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """float32 ``pow`` as XLA's CPU backend computes it: ``x * x`` and
    ``x * x * x`` for the exponents 2 and 3 (its algebraic simplifier's
    rewrites), else the C library's ``powf``."""
    import ctypes
    import ctypes.util

    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = (ctypes.c_float, ctypes.c_float)
    out = np.fromiter((lib.powf(float(a), float(b)) for a, b in zip(x, y)),
                      np.float32, len(x))
    sq = (x * x).astype(np.float32)
    out = np.where(y == _F(2), sq, out)
    return np.where(y == _F(3), (sq * x).astype(np.float32), out)


def gamma(key: np.ndarray, a: float, shape) -> np.ndarray:
    """``jax.random.gamma(key, a, shape)`` in float32, bit for bit, as a
    jitted program with the constant ``a`` computes it (a later ``* 0.01``
    in that program is not folded into the draw).

    Called eagerly, jax passes ``a`` into its program as an argument and
    computes ``1 / sqrt(d)`` with the CPU's reciprocal-square-root estimate
    and two Newton steps; those values of ``c`` are not reproduced here."""
    shape = tuple(int(s) for s in np.atleast_1d(shape)) if shape != () else ()
    n = int(np.prod(shape, dtype=np.int64))
    alpha = _F(a)
    boost = alpha >= _F(1)
    alpha_b = alpha if boost else _F(alpha + _F(1))
    d = _F(alpha_b - _F(1 / 3))
    c = _F(_F(1 / 3) / np.sqrt(d, dtype=np.float32))
    keys = split(np.asarray(key, np.uint32), n) if n else np.zeros((0, 2), np.uint32)
    pair = _split_each(keys, 2)
    loop_key, sub = pair[:, 0].copy(), pair[:, 1]
    big_x = np.zeros(n, np.float32)
    big_v = np.ones(n, np.float32)
    big_u = np.full(n, _F(2), np.float32)

    def accept_not(xx, vv, uu):
        # continue while U >= 1 - 0.0331 X^2 and log U >= X/2 + d (1 - V + log V)
        squeeze = _fma(_F(-0.0331), (xx * xx).astype(np.float32), _F(1))
        with np.errstate(all="ignore"):
            log_v = _log_xla(np.where(vv > 0, vv, _F(1)))
            log_u = _log_xla(np.where(uu > 0, uu, _F(1)))
        tail = ((_F(1) - vv).astype(np.float32) + log_v).astype(np.float32)
        rhs = ((xx * _F(0.5)).astype(np.float32)
               + (d * tail).astype(np.float32)).astype(np.float32)
        return (uu >= squeeze) & (log_u >= rhs)

    active = np.ones(n, dtype=bool)
    while active.any():
        idx = np.nonzero(active)[0]
        three = _split_each(loop_key[idx], 3)
        loop_key[idx] = three[:, 0]
        x_key, u_key = three[:, 1].copy(), three[:, 2]
        x = np.zeros(len(idx), np.float32)
        v = np.full(len(idx), _F(-1), np.float32)
        redo = np.ones(len(idx), dtype=bool)
        while redo.any():
            j = np.nonzero(redo)[0]
            two = _split_each(x_key[j], 2)
            x_key[j] = two[:, 0]
            x[j] = _normal_of(_word_each(two[:, 1]))
            v[j] = _fma(x[j], c, _F(1))
            redo = v <= 0
        big_x[idx] = (x * x).astype(np.float32)
        big_v[idx] = ((v * v).astype(np.float32) * v).astype(np.float32)
        big_u[idx] = _uniform_of(_word_each(u_key))
        active = np.zeros(n, dtype=bool)
        active[idx] = accept_not(big_x[idx], big_v[idx], big_u[idx])
    out = (d * big_v).astype(np.float32)
    if not boost:
        samples = (_F(1) - _uniform_of(_word_each(sub))).astype(np.float32)
        expo = np.full(n, _F(_F(1) / alpha), np.float32)
        out = _flush((out * _flush(_powf(samples, expo))).astype(np.float32))
    return _flush(out).reshape(shape)
