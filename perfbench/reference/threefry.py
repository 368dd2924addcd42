"""threefry2x32 with jax's partitionable layout, on the host in NumPy.

A frozen copy of the semantics the program's PRNG follows:

* ``bits(key, shape)[j] = o0 ^ o1`` with ``(o0, o1) = tf(key, (0, j))``
  for the flat position ``j``;
* ``split(key, n)[j] = (o0, o1)`` from the same call;
* ``fold_in(key, d) = tf(key, (0, d))``;
* ``uniform``: ``bits >> 9 | 0x3f800000`` read as a float in [1, 2),
  minus one, scaled by ``maxval - minval`` and shifted by ``minval`` in
  one fused multiply-add, then clamped below at ``minval``;
* ``randint``: the key split into (k1, k2) for the high and low words,
  then ``(hi % span) * (2^32 % span) + lo % span`` modulo ``span`` with
  uint32 wrap-around.

A key is an int64 array or tensor of shape ``(..., 2)`` holding two
uint32 words.  Every function returns NumPy arrays (int64 words, or
float32 for ``uniform``).
"""
from __future__ import annotations

import math

import numpy as np

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _tf(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on wrapping uint32 arrays."""
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + k0
    x1 = x1 + k1
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """The key of a whole-number seed: ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    seed = int(seed)
    if seed < 0:
        seed &= MASK32
    return np.array([(seed >> 32) & MASK32, seed & MASK32], dtype=np.int64)


def _words(k) -> np.ndarray:
    return (np.asarray(k, dtype=np.int64) & MASK32).astype(np.uint32)


def _cipher(k, shape: tuple):
    k = _words(k)
    j = np.arange(math.prod(shape), dtype=np.uint32).reshape(shape)
    lead = k.shape[:-1] + (1,) * len(shape)
    with np.errstate(over="ignore"):
        return _tf(k[..., 0].reshape(lead), k[..., 1].reshape(lead),
                   np.zeros_like(j), j)


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def split(k, num=2) -> np.ndarray:
    o0, o1 = _cipher(k, _shape(num))
    return np.stack([o0, o1], axis=-1).astype(np.int64)


def fold_in(k, data: int) -> np.ndarray:
    w = _words(k)
    d = np.full(w.shape[:-1], int(data) & MASK32, dtype=np.uint32)
    with np.errstate(over="ignore"):
        o0, o1 = _tf(w[..., 0], w[..., 1], np.zeros_like(d), d)
    return np.stack([o0, o1], axis=-1).astype(np.int64)


def bits(k, shape=()) -> np.ndarray:
    o0, o1 = _cipher(k, _shape(shape))
    return (o0 ^ o1).astype(np.int64)


def fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the float32 product is exact in
    float64)."""
    return (np.asarray(a, np.float32).astype(np.float64)
            * np.asarray(b, np.float32).astype(np.float64)
            + np.asarray(c, np.float32).astype(np.float64)).astype(np.float32)


def uniform(k, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    b = bits(k, shape)
    f = (((b >> 9) | 0x3F800000).astype(np.uint32).view(np.float32)
         - np.float32(1.0))
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, fma32(f, np.float32(hi - lo), lo))


def randint(k, shape=(), minval=0, maxval=1) -> np.ndarray:
    """Uniform int32 in [minval, maxval) (int64 array)."""
    k1, k2 = np.moveaxis(split(k), -2, 0)
    shape = _shape(shape)
    hi_bits, lo_bits = bits(k1, shape), bits(k2, shape)
    mn, mx = int(minval), int(maxval)
    span = 1 if mx <= mn else (mx - mn) & MASK32
    mult = (2 ** 16) % span
    mult = (mult * mult & MASK32) % span
    off = ((((hi_bits % span) * mult) & MASK32) + lo_bits % span) & MASK32
    return mn + off % span
