"""Counter-based PRNG, bit-exact with ``jax.random`` (threefry2x32).

Counterpart of ``jax.random`` and of ``repro/kernels/amper_sample.py``'s
in-kernel threefry.  Draws in the port are compared bit for bit with the
JAX reference, so this module reproduces jax's *partitionable* threefry
layout (``jax_threefry_partitionable``, on by default since jax 0.5):

* ``bits(key, shape)[j] = o0 ^ o1`` with ``(o0, o1) = tf(key, (0, j))``
  for the flat position ``j``;
* ``split(key, n)[j] = (o0, o1)`` from the same call;
* ``fold_in(key, d) = tf(key, (0, d))``.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words.
Every function computes on its key's device:

* a key on the CPU runs the cipher in numpy's wrapping uint32 arithmetic
  (torch's ``uint32`` has no ``<<`` and no ``%`` on the CPU), and a draw
  moves where the caller asks with ``device=``;
* a key on the card goes to the ``csrc/prng.cu`` kernel through
  :mod:`repro_torch.kernels.ops` (one launch a call, no copy of the key
  or of the result to the host), so a training step whose keys live on
  the card can be captured in a CUDA graph.

Both give the same bits (the kernel's plain int64 versions are in
:mod:`repro_torch.kernels.prng`).  Keys and draws are handed out as
int64 tensors holding the uint32 values.  No function touches a global
generator.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.xla_float import fma32

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on numpy uint32 arrays (wrapping).

    The same rounds and key schedule as ``jax._src.prng.threefry_2x32``;
    arguments broadcast against each other.
    """
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


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)``'s data: ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    seed = int(seed)
    if seed < 0:
        seed &= MASK32  # jax reads a negative int32 seed as its bit pattern
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64)


def key_data(k) -> torch.Tensor:
    """Raw words of a key (an int64 ``(..., 2)`` tensor) or of jax key
    data; a key on the card stays there."""
    if _on_card(k):
        return k if k.dtype == torch.int64 else k.to(torch.int64) & MASK32
    return torch.as_tensor(np.asarray(k, dtype=np.int64)) & MASK32


def _on_card(k) -> bool:
    return isinstance(k, torch.Tensor) and k.device.type == "cuda"


def _ops():
    # imported late: kernels.ops imports modules that import this one
    from repro_torch.kernels import ops

    return ops


def _moved(x: torch.Tensor, device) -> torch.Tensor:
    return x if device is None else x.to(device)


def _words(k) -> np.ndarray:
    return (np.asarray(k, dtype=np.int64) & MASK32).astype(np.uint32)


def _cipher(k, shape: tuple) -> tuple:
    """``tf(key, (0, j))`` over the flat positions ``j`` of ``shape``,
    broadcast against the key's batch dims (``k.shape[:-1] + shape``)."""
    k = _words(k)
    j = np.arange(math.prod(shape), dtype=np.uint32).reshape(shape)
    lead = k.shape[:-1] + (1,) * len(shape)
    with np.errstate(over="ignore"):
        return threefry2x32(k[..., 0].reshape(lead), k[..., 1].reshape(lead),
                            np.zeros_like(j), j)


def _tensor(x: np.ndarray, device=None) -> torch.Tensor:
    out = torch.from_numpy(np.asarray(x, dtype=np.int64))
    return out if device is None else out.to(device)


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def split(k: torch.Tensor, num=2) -> torch.Tensor:
    """``jax.random.split``: keys of shape ``k.shape[:-1] + num + (2,)``."""
    if _on_card(k):
        return _ops().prng_split(k, _shape(num))
    o0, o1 = _cipher(k, _shape(num))
    return _tensor(np.stack([o0, o1], axis=-1))


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    if _on_card(k):
        return _ops().prng_fold_in(k, data)
    w = _words(k)
    d = np.full(w.shape[:-1], int(data) & MASK32, dtype=np.uint32)
    with np.errstate(over="ignore"):
        o0, o1 = threefry2x32(w[..., 0], w[..., 1], np.zeros_like(d), d)
    return _tensor(np.stack([o0, o1], axis=-1))


def bits(k: torch.Tensor, shape=(), device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 in ``[0, 2^32)``."""
    if _on_card(k):
        return _moved(_ops().prng_bits(k, _shape(shape)), device)
    o0, o1 = _cipher(k, _shape(shape))
    return _tensor(o0 ^ o1, device)


def uniform(k: torch.Tensor, shape=(), minval=0.0, maxval=1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform`` for float32, bit for bit.

    The mantissa trick of ``jax/_src/random.py::_uniform``:
    ``bits >> 9 | 0x3f800000`` bitcast to ``[1, 2)``, minus one, scaled
    by ``maxval - minval`` and shifted by ``minval`` (one fused
    multiply-add), then clamped below at ``minval``.
    """
    if _on_card(k):
        return _moved(_ops().prng_uniform(k, _shape(shape), float(minval),
                                          float(maxval)), device)
    b = bits(k, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    out = torch.maximum(lo, fma32(f, hi - lo, lo))
    return out if device is None else out.to(device)


def bernoulli(k: torch.Tensor, p=0.5, shape=(), device=None) -> torch.Tensor:
    """``jax.random.bernoulli`` for a float32 ``p``: ``uniform(key, shape)
    < p``, bit for bit (batched keys as in :func:`uniform`)."""
    out = uniform(k, shape) < torch.tensor(p, dtype=torch.float32)
    return out if device is None else out.to(device)


def normal(k: torch.Tensor, shape=(), device=None) -> torch.Tensor:
    """``jax.random.normal`` for float32: ``sqrt(2) * erfinv(u)`` with
    ``u ~ U(nextafter(-1, 0), 1)``.  ``erfinv`` is torch's, so values
    agree with jax to float32 rounding, not bit for bit."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(k, shape, lo, 1.0)
    out = torch.erfinv(u) * torch.tensor(math.sqrt(2), dtype=torch.float32)
    return out if device is None else out.to(device)


def randint(k: torch.Tensor, shape=(), minval=0, maxval=1,
            device=None) -> torch.Tensor:
    """``jax.random.randint`` for int32, bit for bit (``_randint``).

    Splits the key into (k1, k2) for the high and low words, then reduces
    ``(hi % span) * (2^32 % span) + lo % span`` modulo ``span`` with
    uint32 wrap-around.  ``minval``/``maxval`` may be tensors on any
    device (a data-dependent bound stays where it is: the bits move to
    it, the bound never moves to the host).  With a key on the card the
    bounds are ints or scalars (on the card, or 0-d on the CPU), and the
    kernel reads a bound on the card there.
    """
    if _on_card(k):
        return _moved(_ops().prng_randint(k, _shape(shape), minval, maxval),
                      device)
    k = key_data(k)
    k1, k2 = split(k).unbind(-2)
    shape = _shape(shape)
    mx = torch.as_tensor(maxval, dtype=torch.int64)
    if device is None:
        device = mx.device
    mx = mx.to(device)
    mn = torch.as_tensor(minval, dtype=torch.int64).to(device)
    higher = bits(k1, shape, device)
    lower = bits(k2, shape, device)
    span = torch.where(mx <= mn, torch.ones_like(mx), (mx - mn) & MASK32)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span
    off = ((((higher % span) * mult) & MASK32) + lower % span) & MASK32
    off = off % span
    return (mn + off).to(torch.int32)
