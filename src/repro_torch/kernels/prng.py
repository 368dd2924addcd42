"""jax.random's threefry on keys that live on the card, as a CUDA kernel.

Not a port of a Pallas kernel: the counterpart of the threefry2x32 that
``jax.random`` runs through XLA on the device, so that the port's keys
can stay on the card and a training step can be captured in a CUDA
graph.  The kernel source is ``csrc/prng.cu`` (its header gives the
bound and the design), sharing ``csrc/threefry.cuh`` with the in-kernel
pick of ``csrc/amper_sample.cu``.  Callers go through
:mod:`repro_torch.prng`, which sends a key on CUDA here through the
wrappers of :mod:`repro_torch.kernels.ops` (``prng_split``,
``prng_fold_in``, ``prng_bits``, ``prng_uniform``, ``prng_randint``).

The ``*_ref`` functions are the plain versions: the same functions in
int64 tensor arithmetic (every uint32 word held in an int64, masked after
each add and shift), on whatever device the key lies.  They are what the
tests and ``chip_smoke.py`` hold the kernel against; on the CPU
:mod:`repro_torch.prng` keeps its numpy path, which the tests hold them
against too.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.xla_float import fma32

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# csrc/prng.cu's operations
CIPHER, BITS, UNIFORM, RANDINT = 0, 1, 2, 3

_VP, _LL, _INT, _UINT, _FLOAT = (ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_uint, ctypes.c_float)
# launch arguments of csrc/prng.cu
_ARGS = (_INT, _VP, _LL, _LL, _LL, _UINT, _FLOAT, _FLOAT, _LL, _LL, _VP,
         _INT, _VP, _INT, _VP)


def threefry2x32_ref(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 words
    (broadcasting); jax._src.prng.threefry_2x32 bit for bit."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) & MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _cipher_ref(key: torch.Tensor, shape: tuple, offset: int = 0):
    """``tf(key, (0, offset + j))`` over the flat positions ``j`` of
    ``shape``, broadcast against the key's batch dims."""
    k = key.to(torch.int64) & MASK32
    j = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=k.device).reshape(shape)
    j = (j + offset) & MASK32
    lead = k.shape[:-1] + (1,) * len(shape)
    return threefry2x32_ref(k[..., 0].reshape(lead), k[..., 1].reshape(lead),
                            torch.zeros_like(j), j)


def split_ref(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.split``: int64 keys of shape ``key.shape[:-1] + shape
    + (2,)``."""
    o0, o1 = _cipher_ref(key, shape)
    return torch.stack([o0, o1], -1)


def fold_in_ref(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    o0, o1 = _cipher_ref(key, (), int(data) & MASK32)
    return torch.stack([o0, o1], -1)


def bits_ref(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 in [0, 2^32)."""
    o0, o1 = _cipher_ref(key, shape)
    return o0 ^ o1


def uniform_ref(key: torch.Tensor, shape: tuple, minval: float,
                maxval: float) -> torch.Tensor:
    """``jax.random.uniform`` for float32: the mantissa trick, one fused
    multiply-add, the clamp at ``minval``."""
    b = bits_ref(key, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    return torch.maximum(lo.to(f.device), fma32(f, hi - lo, lo))


def randint_ref(key: torch.Tensor, shape: tuple, minval, maxval
                ) -> torch.Tensor:
    """``jax.random.randint`` for int32: the inner split, the two bits
    draws, and the span arithmetic in wrapping uint32.  ``minval`` and
    ``maxval`` are ints or integer tensors (on the key's device or 0-d on
    the CPU)."""
    pair = split_ref(key, (2,))
    higher = bits_ref(pair[..., 0, :], shape)
    lower = bits_ref(pair[..., 1, :], shape)
    mx = torch.as_tensor(maxval, dtype=torch.int64).to(higher.device)
    mn = torch.as_tensor(minval, dtype=torch.int64).to(higher.device)
    span = torch.where(mx <= mn, torch.ones_like(mx), (mx - mn) & MASK32)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span
    off = ((((higher % span) * mult) & MASK32) + lower % span) & MASK32
    return (mn + off % span).to(torch.int32)


def _bound(x) -> tuple:
    """A randint bound as (host int, device pointer, is int64)."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        return 0, x.data_ptr(), int(x.dtype == torch.int64)
    return int(x), None, 0


def prng_out(op: int, key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The uninitialized output of ``op`` on ``key``: ``key.shape[:-1] +
    shape`` (``+ (2,)`` for the cipher), on the key's device."""
    dtype = {CIPHER: torch.int64, BITS: torch.int64, UNIFORM: torch.float32,
             RANDINT: torch.int32}[op]
    tail = (2,) if op == CIPHER else ()
    return torch.empty(tuple(key.shape[:-1]) + tuple(shape) + tail,
                       dtype=dtype, device=key.device)


def prng_cuda(op: int, key: torch.Tensor, shape: tuple, *, offset: int = 0,
              minval=0, maxval=1) -> torch.Tensor:
    """Launch ``csrc/prng.cu`` on a key (or batch of keys) on the card,
    checked by the wrapper; returns the output shaped ``key.shape[:-1] +
    shape`` (``+ (2,)`` for the cipher)."""
    dev = key.device
    keys = key.reshape(-1, 2)  # a view where the batch dims allow one
    if keys.stride(1) != 1:
        keys = keys.contiguous()
    n_keys, per_key = keys.shape[0], math.prod(shape)
    out = prng_out(op, key, shape)
    lo_i, lo_p, lo_64 = _bound(minval) if op == RANDINT else (0, None, 0)
    hi_i, hi_p, hi_64 = _bound(maxval) if op == RANDINT else (0, None, 0)
    lo_f, hi_f = ((float(minval), float(maxval)) if op == UNIFORM
                  else (0.0, 0.0))
    build.launch("prng", _ARGS, dev, op, keys.data_ptr(), n_keys,
                 keys.stride(0), per_key, offset, lo_f, hi_f, lo_i, hi_i,
                 lo_p, lo_64, hi_p, hi_64, out.data_ptr())
    return out
