"""The PRNG kernel's plain versions against the numpy path and jax.

``repro_torch.kernels.prng``'s ``*_ref`` functions (int64 tensor
arithmetic, on any device) are what ``chip_smoke.py``'s ``prng`` phase
holds the ``csrc/prng.cu`` kernel against on the card.  Here, on the
CPU, they are held bit for bit against :mod:`repro_torch.prng`'s numpy
path (what a host key runs) and against ``jax.random`` under the
partitionable layout, over the phase's edge cases at small sizes: edge
key words, split counts, fold_in data up to 2^32 - 1, draw shapes,
randint spans of 1, 2, 2^31 and 2^32 - 1 with int, int32 and int64
bounds, batched keys (contiguous and strided).  The ``ops`` wrappers
take the plain versions for keys on the CPU and count no launch.  On a
card (marked ``cuda``, skipped here) the kernel is held against them.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.kernels import ops
from repro_torch.kernels import prng as kp

# key words: (0, 0), (0, 1), (2^32 - 1, 2^32 - 1), (0, 2^32 - 1)
SEEDS = (0, 1, 2 ** 64 - 1, 2 ** 32 - 1)
SPLITS = (2, 3, 4, 500)
SHAPES = ((), (16,), (64,), (1000,))
FOLDS = (0, 1, 12345, 2 ** 32 - 1)
BOUNDS = ((0, 1), (0, 2), (0, 10), (-2 ** 31, 0), (-2 ** 31, 2 ** 31 - 1),
          (7, 7))


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _jkey(k: torch.Tensor):
    return jax.random.wrap_key_data(k.numpy().astype(np.uint32))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_split_fold_in_equal_numpy_and_jax(seed):
    k = prng.key(seed)
    for n in SPLITS:
        got = kp.split_ref(k, (n,))
        _eq(got, prng.split(k, n))  # repro: noqa[PRNG-REUSE] one key, each version
        _eq(got, jax.random.key_data(jax.random.split(_jkey(k), n)))
        _eq(ops.prng_split(k, (n,)), got)
    for d in FOLDS:
        got = kp.fold_in_ref(k, d)
        _eq(got, prng.fold_in(k, d))
        _eq(got, jax.random.key_data(jax.random.fold_in(_jkey(k), d)))
        _eq(ops.prng_fold_in(k, d), got)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_draws_equal_numpy_and_jax(seed, shape):
    k = prng.key(seed)
    got = kp.bits_ref(k, shape)
    _eq(got, prng.bits(k, shape))
    _eq(got, jax.random.bits(_jkey(k), shape))
    _eq(ops.prng_bits(k, shape), got)
    for lo, hi in ((0.0, 1.0), (-0.05, 0.05)):
        got = kp.uniform_ref(k, shape, lo, hi)
        _eq(got, prng.uniform(k, shape, lo, hi))  # repro: noqa[PRNG-REUSE] one key, each version
        _eq(got, jax.random.uniform(_jkey(k), shape, minval=lo, maxval=hi))
        _eq(ops.prng_uniform(k, shape, lo, hi), got)
    for lo, hi in BOUNDS:
        got = kp.randint_ref(k, shape, lo, hi)
        _eq(got, prng.randint(k, shape, lo, hi))  # repro: noqa[PRNG-REUSE] one key, each version
        _eq(got, jax.random.randint(_jkey(k), shape, lo, hi))
        _eq(ops.prng_randint(k, shape, lo, hi), got)
        _eq(kp.randint_ref(k, shape, torch.tensor(lo, dtype=torch.int64),
                           torch.tensor(hi, dtype=torch.int32)), got)


def test_plain_batched_keys_equal_numpy():
    batch = prng.split(prng.key(7), 16)           # contiguous
    strided = prng.split(batch)[:, 1]             # stride 4 between keys
    assert strided.stride() == (4, 1)
    for kb in (batch, strided):
        _eq(kp.split_ref(kb, (3,)), prng.split(kb, 3))
        _eq(kp.fold_in_ref(kb, 9), prng.fold_in(kb, 9))
        _eq(kp.uniform_ref(kb, (4,), -0.05, 0.05),
            prng.uniform(kb, (4,), -0.05, 0.05))  # repro: noqa[PRNG-REUSE] one key, each version
        _eq(kp.randint_ref(kb, (), 0, 10), prng.randint(kb, (), 0, 10))  # repro: noqa[PRNG-REUSE] one key, each version
        _eq(kp.bits_ref(kb, (64,)), prng.bits(kb, (64,)))  # repro: noqa[PRNG-REUSE] one key, each version
        _eq(jax.random.key_data(jax.vmap(lambda x: jax.random.split(x, 3))(
            _jkey(kb))), kp.split_ref(kb, (3,)))


def test_cpu_keys_run_the_plain_versions_and_launch_nothing():
    before = dict(ops.launches)
    k = prng.key(3)
    assert not prng._on_card(k)
    _eq(ops.prng_split(k, (2,)), prng.split(k))
    _eq(ops.prng_randint(k, (5,), 0, torch.tensor(9)),
        prng.randint(k, (5,), 0, 9))  # repro: noqa[PRNG-REUSE] one key, each version
    assert ops.launches == before
    with pytest.raises(TypeError, match="int64"):
        ops.prng_bits(k.to(torch.int32), (2,))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_cuda_prng_kernel_equals_plain(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    k = prng.key(seed).cuda()
    for n in SPLITS + (1_000_000,):
        _eq(ops.prng_split(k, (n,)).cpu(), kp.split_ref(k, (n,)).cpu())
    for d in FOLDS:
        _eq(ops.prng_fold_in(k, d).cpu(), kp.fold_in_ref(k, d).cpu())
    for shape in SHAPES + ((1_000_000,),):
        _eq(ops.prng_bits(k, shape).cpu(), kp.bits_ref(k, shape).cpu())
        _eq(ops.prng_uniform(k, shape, -0.05, 0.05).cpu(),
            kp.uniform_ref(k, shape, -0.05, 0.05).cpu())
        for lo, hi in BOUNDS:
            want = kp.randint_ref(k, shape, lo, hi).cpu()
            _eq(ops.prng_randint(k, shape, lo, hi).cpu(), want)
            _eq(ops.prng_randint(
                k, shape, torch.tensor(lo, device="cuda"),
                torch.tensor(hi, dtype=torch.int32, device="cuda")).cpu(),
                want)
