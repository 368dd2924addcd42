"""The port's PRNG against ``jax.random``, bit for bit.

Every JAX call runs under ``jax.threefry_partitionable(True)`` so the
comparison does not depend on the installed jax's default layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.xla_float import div_const, fma32

SEEDS = (0, 5, 11, 2 ** 31 - 1)
SHAPES = ((), (1,), (7,), (16,), (3, 5), (2, 3, 4))


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _same_bits(a, b) -> bool:
    a = np.asarray(a)
    b = b.numpy()
    if a.dtype == np.float32:
        return a.shape == b.shape and (a.view(np.uint32) == b.view(np.uint32)).all()
    return a.shape == b.shape and (a.astype(np.int64) == b.astype(np.int64)).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    k = jax.random.key(seed)
    kt = prng.key(seed)
    assert _same_bits(jax.random.key_data(k), kt)
    for num in (2, 3, (2, 3)):
        fresh = jax.random.key(seed)  # one split per key object
        assert _same_bits(jax.random.key_data(jax.random.split(fresh, num)),
                          prng.split(kt, num))
    for d in (0, 1, 7, 2 ** 32 - 1):
        assert _same_bits(jax.random.key_data(jax.random.fold_in(k, d)),
                          prng.fold_in(kt, d))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_randint(seed, shape):
    kb, ku, kc, kr = jax.random.split(jax.random.key(seed), 4)
    tb, tu, tc, tr = prng.split(prng.key(seed), 4)
    assert _same_bits(jax.random.bits(kb, shape), prng.bits(tb, shape))
    assert _same_bits(jax.random.uniform(ku, shape, minval=-0.05, maxval=0.05),
                      prng.uniform(tu, shape, -0.05, 0.05))
    assert _same_bits(jax.random.uniform(kc, shape), prng.uniform(tc, shape))
    for lo, hi in ((0, 2), (3, 7), (0, 1_000_000), (0, 2 ** 31 - 1), (5, 5)):
        assert _same_bits(jax.random.randint(jax.random.fold_in(kr, hi),
                                             shape, lo, hi),
                          prng.randint(prng.fold_in(tr, hi), shape, lo, hi))


def test_batched_keys_match_per_key_draws():
    """A batch of keys draws what each key draws alone (the vectorized
    env resets rely on it)."""
    keys = prng.split(prng.key(9), 5)
    batched = prng.uniform(keys, (4,), -0.05, 0.05)
    for i in range(5):
        assert torch.equal(batched[i], prng.uniform(keys[i], (4,), -0.05, 0.05))
    assert torch.equal(prng.split(keys)[2], prng.split(keys[2]))


def test_randint_tensor_bound_stays_put():
    bound = torch.tensor(37, dtype=torch.int32)
    a = prng.randint(prng.key(4), (9,), 0, bound)
    b = prng.randint(prng.key(4), (9,), 0, 37)
    assert torch.equal(a, b) and a.dtype == torch.int32


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_close(seed):
    """``normal`` uses torch's erfinv: equal to float32 rounding."""
    a = np.asarray(jax.random.normal(jax.random.key(seed), (64, 8)))
    b = prng.normal(prng.key(seed), (64, 8)).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_xla_float_helpers_match_jit():
    """fma32/div_const reproduce XLA's CPU rewrites of a*b+c and x/c."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(4096).astype(np.float32) for _ in range(3))
    got = jax.jit(lambda a, b, c: a * b + c)(a, b, c)
    assert _same_bits(got, fma32(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(c)))
    x = rng.standard_normal(4096).astype(np.float32)
    got = jax.jit(lambda x: x / 20)(jnp.asarray(x))
    assert _same_bits(got, div_const(torch.from_numpy(x), 20))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p", [0.5, 0.1, 0.9])
def test_bernoulli_single_and_batched_keys(seed, p):
    """``bernoulli`` is ``jax.random.bernoulli`` bit for bit, for one key
    and for a batch of keys (each drawing what it draws alone, as
    ``jax.vmap`` over the keys does: Breakout's reset)."""
    k, kt = jax.random.key(seed), prng.key(seed)
    for i, shape in enumerate(((), (7,), (3, 5))):
        assert _same_bits(jax.random.bernoulli(jax.random.fold_in(k, i), p,
                                               shape),
                          prng.bernoulli(prng.fold_in(kt, i), p, shape))
    keys = jax.random.split(jax.random.key(seed), 6)
    want = jax.vmap(lambda kk: jax.random.bernoulli(kk, p))(keys)
    got = prng.bernoulli(prng.split(kt, 6), p)
    assert got.dtype == torch.bool and _same_bits(want, got)
    want = jax.vmap(lambda kk: jax.random.bernoulli(kk, p, (4,)))(keys)
    assert _same_bits(want, prng.bernoulli(prng.split(kt, 6), p, (4,)))
