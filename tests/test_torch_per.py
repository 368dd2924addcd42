"""The port's PER samplers against the JAX reference.

``SumTreePER``, ``CumsumPER`` and the sharded ``ShardedPERSampler`` get
the same priorities and keys as the reference.  On dyadic priorities
(multiples of 2^-8, at most 4) every prefix sum and every tree node is
exact whatever the order of summation, so draws must agree bit for bit;
on random floats the two packages sum in different orders (XLA's cumsum
is a parallel scan), so there the port's draws are held to the PER law
P(i) = p_i / sum p by a chi-square test instead.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from scipy import stats

from repro.core import per as jper
from repro.core import samplers as jsamplers
from repro.core.sharded import ShardedPERSampler as JShardedPER
from repro.core.sharded import ShardedPERState as JShardedPERState
from repro_torch import prng
from repro_torch.core import per as tper
from repro_torch.core import samplers as tsamplers
from repro_torch.core.sharded import ShardedPERSampler, sharded_sample_per
from repro_torch.distributed.sharding import Mesh
from test_torch_dqn import thirty_agent_steps

N = 1024
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _dyadic(n, seed, zeros=0.1):
    """Priorities k / 256 with k in [0, 1024]; a share of them zero."""
    rng = np.random.default_rng(seed)
    p = rng.integers(1, 1025, n).astype(np.float32) / 256
    p[rng.random(n) < zeros] = 0.0
    return p


def _jmesh(s):
    if jax.device_count() < s:
        pytest.skip(f"needs {s} host devices (tests/conftest.py forces 8)")
    return JMesh(np.asarray(jax.devices()[:s]), ("data",))


@pytest.mark.parametrize("kind", ["per-sumtree", "per-cumsum", "per"])
def test_per_samplers_bit_identical_on_dyadic_priorities(kind):
    js = jsamplers.make_sampler(kind, N)
    ts = tsamplers.make_sampler(kind, N, device="cpu")
    rng = np.random.default_rng(1)
    p = _dyadic(N, seed=2)
    jst = jax.jit(js.update)(js.init(), np.arange(N, dtype=np.int32), p)
    tst = ts.update(ts.init(), torch.arange(N), torch.from_numpy(p))
    # a second write with duplicated rows: the last value wins
    idx = rng.integers(0, N, 200).astype(np.int32)
    p2 = _dyadic(200, seed=3)
    jst = jax.jit(js.update)(jst, idx, p2)
    tst = ts.update(tst, torch.from_numpy(idx), torch.from_numpy(p2))
    np.testing.assert_array_equal(np.asarray(js.priorities(jst)),
                                  ts.priorities(tst).numpy())
    assert float(js.total(jst)) == float(ts.total(tst))
    for stratified in (True, False):
        draw = jax.jit(lambda s, k: js.sample(s, k, 100, stratified))
        for seed in range(3):
            want = np.asarray(draw(jst, jax.random.key(seed)))
            got = ts.sample(tst, prng.key(seed), 100, stratified)
            np.testing.assert_array_equal(want, got.numpy())
            assert got.dtype == torch.int32


def test_sum_tree_state_matches_reference():
    """The whole tree, interior nodes included: the leaf-to-root delta
    walk, with only the last occurrence of a duplicated row applied."""
    n = 300   # not a power of two: padded leaves stay 0
    js, ts = jper.SumTreePER(n), tper.SumTreePER(n, device="cpu")
    jst, tst = js.init(), ts.init()
    rng = np.random.default_rng(4)
    for step in range(4):
        idx = rng.integers(0, n, 64).astype(np.int32)
        p = _dyadic(64, seed=10 + step)
        jst = jax.jit(js.update)(jst, idx, p)
        tst = ts.update(tst, torch.from_numpy(idx), torch.from_numpy(p))
    np.testing.assert_array_equal(np.asarray(jst.tree), tst.tree.numpy())
    assert int(jst.n_leaves) == int(tst.n_leaves) == n


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_sharded_per_bit_identical_on_dyadic_priorities(shards):
    p = _dyadic(N, seed=5)
    js = JShardedPER(N, _jmesh(shards), axis_names=("data",))
    jst = JShardedPERState(priorities=jax.device_put(p, js.sharding))
    mesh = Mesh([CPU] * shards)
    ts = ShardedPERSampler(N, mesh, axis_names=("data",))
    tst = ts.from_dense(torch.from_numpy(p))
    draw = jax.jit(lambda s, k: js.sample(s, k, 128))
    free = sharded_sample_per(mesh, 128)
    for seed in range(3):
        want = np.asarray(draw(jst, jax.random.key(seed)))
        np.testing.assert_array_equal(
            want, ts.sample(tst, prng.key(seed), 128).numpy())
        np.testing.assert_array_equal(
            want, free(tst.priorities, prng.key(seed)).numpy())
    assert float(js.total(jst)) == float(ts.total(tst))
    # update through global rows, duplicates included
    idx = np.random.default_rng(6).integers(0, N, 100).astype(np.int32)
    p2 = _dyadic(100, seed=7)
    jst = jax.jit(js.update)(jst, idx, p2)
    tst = ts.update(tst, torch.from_numpy(idx), torch.from_numpy(p2))
    np.testing.assert_array_equal(np.asarray(jst.priorities),
                                  ts.priorities(tst).numpy())


@pytest.mark.parametrize("kind", ["per-sumtree", "per-cumsum", "per-sharded"])
def test_per_draw_law_chi_square(kind):
    """On random float priorities the draws follow P(i) = p_i / sum p."""
    n, batch, draws = 48, 256, 80
    p = np.random.default_rng(8).uniform(0.05, 2.0, n).astype(np.float32)
    ts = tsamplers.make_sampler(kind, n, device="cpu",
                                mesh=Mesh([CPU] * 4))
    st = ts.update(ts.init(), torch.arange(n), torch.from_numpy(p))
    keys = prng.split(prng.key(9), draws)
    idx = torch.cat([ts.sample(st, k, batch) for k in keys]).numpy()
    observed = np.bincount(idx, minlength=n)
    expected = p.astype(np.float64) / p.astype(np.float64).sum() * idx.size
    assert stats.chisquare(observed, expected).pvalue > 1e-3


@pytest.mark.parametrize("kind", ["per-sumtree", "per-cumsum", "per",
                                  "per-sharded", "amper-fr-sharded"])
def test_new_kinds_registered_and_satisfy_protocol(kind):
    s = tsamplers.make_sampler(kind, 64, device="cpu", mesh=Mesh([CPU] * 2))
    assert isinstance(s, tsamplers.Sampler)
    assert kind in tsamplers.available_samplers()
    st = s.update(s.init(), torch.arange(64), torch.full((64,), 0.5))
    assert s.priorities(st).shape == (64,)
    assert s.sample(st, prng.key(0), 8).shape == (8,)


def test_sharded_kinds_default_to_cuda():
    """Left without a mesh or device, the sharded kinds ask for every
    visible CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for kind in ("amper-fr-sharded", "per-sharded"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsamplers.make_sampler(kind, 64)


def test_thirty_agent_steps_per_cumsum_match_reference():
    thirty_agent_steps("per-cumsum", "dqn", 1, "broadcast")
