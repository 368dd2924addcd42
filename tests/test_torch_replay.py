"""The port's replay buffer against the JAX reference: ring writes, write
stamps across the int32 rollover, n-step emission, IS weights and
stale-safe priority updates.  Integer state must agree bit for bit,
float state within rtol 1e-6 where one op rounds differently (XLA and
torch each round pow), and within the slice tolerance rtol 1e-5 /
atol 1e-6 where a sum of products is reassociated (the n-step return)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.quantize as jqz
from repro.core import per as jper
from repro.core import replay_buffer as jrb
from repro.core import samplers as jsamplers
from repro_torch import interop, prng
from repro_torch.core import per as tper
from repro_torch.core import quantize as tqz
from repro_torch.core import replay_buffer as trb
from repro_torch.core import samplers as tsamplers

OBS = 3
V_MAX = 4.0


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _example():
    return {"obs": np.zeros(OBS, np.float32), "action": np.int32(0),
            "reward": np.float32(0), "next_obs": np.zeros(OBS, np.float32),
            "done": np.float32(0), "terminated": np.float32(0)}


def _rows(rng, b, done_p=0.3):
    return {"obs": rng.standard_normal((b, OBS)).astype(np.float32),
            "action": rng.integers(0, 2, b).astype(np.int32),
            "reward": rng.standard_normal(b).astype(np.float32),
            "next_obs": rng.standard_normal((b, OBS)).astype(np.float32),
            "done": (rng.random(b) < done_p).astype(np.float32),
            "terminated": (rng.random(b) < done_p / 2).astype(np.float32)}


def _pair(kind, capacity, **kw):
    js = jsamplers.make_sampler(kind, capacity, v_max=V_MAX, min_csp=8)
    ts = tsamplers.make_sampler(kind, capacity, v_max=V_MAX, min_csp=8,
                                device="cpu")
    return (jrb.ReplayBuffer(capacity, js, **kw),
            trb.ReplayBuffer(capacity, ts, **kw))


def _t(rows):
    return {k: torch.from_numpy(np.array(v)) for k, v in rows.items()}


def _assert_same_state(js, ts, trace=None):
    """Integer state equal; float priorities within rtol 1e-6.  Quantized
    priorities may differ by one code only where ``trace`` = (rows, p_jax,
    p_port) shows the two packages' float priorities for that row round to
    the two codes: the pow rounds independently in XLA and torch."""
    js = jax.tree.map(np.asarray, js)
    for k in js.storage:
        np.testing.assert_array_equal(js.storage[k], ts.storage[k].numpy())
    assert int(js.pos) == ts.pos and int(js.size) == ts.size
    assert int(js.total_adds) == ts.total_adds
    assert int(js.add_gen) == ts.add_gen
    np.testing.assert_array_equal(js.write_stamp, ts.write_stamp.numpy())
    np.testing.assert_array_equal(js.write_gen, ts.write_gen.numpy())
    for a, b in zip(js.sampler_state, ts.sampler_state):
        b = b.numpy()
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=1e-6)
        elif a.dtype == np.int32:
            _assert_codes_traced(a, b, trace)
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(js.max_priority, ts.max_priority.numpy(),
                               rtol=1e-6)


def _assert_codes_traced(jpq, tpq, trace):
    diff = np.flatnonzero(jpq != tpq)
    if diff.size == 0:
        return
    assert trace is not None, f"codes differ at rows {diff} with no trace"
    rows, pj, pt = trace
    for r in diff:
        assert abs(int(jpq[r]) - int(tpq[r])) == 1
        last = np.flatnonzero(rows == r)[-1]
        np.testing.assert_allclose(pj[last], pt[last], rtol=1e-6)
        assert jqz.quantize(pj[last], V_MAX) == jpq[r]
        assert tqz.quantize(torch.tensor(pt[last]), V_MAX) == tpq[r]


def _priorities(td):
    """Each package's float priority for ``td`` (alpha 0.6, eps 0.01)."""
    pj = np.asarray(jax.jit(lambda x: (jnp.abs(x) + 0.01) ** 0.6)(td))
    pt = ((torch.from_numpy(td).abs() + 0.01) ** 0.6).numpy()
    return pj, pt


@pytest.mark.parametrize("kind", ["uniform", "amper-fr"])
def test_ring_writes_wrap_and_add_block(kind):
    jb, tb = _pair(kind, 10)
    js, ts = jb.init(_example()), tb.init(_t(_example()))
    rng = np.random.default_rng(0)
    add = jax.jit(jb.add_batch)
    for b in (4, 4, 3, 7, 10):
        rows = _rows(rng, b)
        js, ts = add(js, rows), tb.add_batch(ts, _t(rows))
        _assert_same_state(js, ts)
    block = {k: v.reshape((2, 3) + v.shape[1:]) for k, v in _rows(rng, 6).items()}
    js, ts = jax.jit(jb.add_block)(js, block), tb.add_block(ts, _t(block))
    _assert_same_state(js, ts)
    one = {k: v[0] for k, v in _rows(rng, 1).items()}
    js, ts = jb.add(js, one), tb.add(ts, _t(one))
    _assert_same_state(js, ts)


def test_stamps_across_the_int32_rollover():
    """(stamp, gen) pairs stay unique and equal to the reference's when the
    add counter wraps past 2^31 - 1."""
    jb, tb = _pair("amper-fr", 8)
    js = jb.init(_example())._replace(total_adds=jnp.int32(2 ** 31 - 5),
                                      add_gen=jnp.int32(7))
    ts = interop.replay_state_from_jax(jax.tree.map(np.asarray, js),
                                       device="cpu")
    rng = np.random.default_rng(1)
    add = jax.jit(jb.add_batch)
    for b in (3, 3, 3):
        rows = _rows(rng, b)
        js, ts = add(js, rows), tb.add_batch(ts, _t(rows))
        _assert_same_state(js, ts)
    idx = np.array([0, 3, 7, 5], np.int32)
    np.testing.assert_array_equal(np.asarray(jb.stamps(js, idx)),
                                  tb.stamps(ts, torch.from_numpy(idx)).numpy())


@pytest.mark.parametrize("kind", ["uniform", "amper-fr"])
def test_update_priorities_plain_and_stale_safe(kind):
    jb, tb = _pair(kind, 16)
    js, ts = jb.init(_example()), tb.init(_t(_example()))
    rng = np.random.default_rng(2)
    rows = _rows(rng, 12)
    js, ts = jb.add_batch(js, rows), tb.add_batch(ts, _t(rows))
    idx = np.array([1, 4, 4, 9, 11, 2], np.int32)   # a duplicate row
    td = rng.standard_normal(6).astype(np.float32)
    js = jax.jit(jb.update_priorities)(js, idx, td)
    ts = tb.update_priorities(ts, torch.from_numpy(idx), torch.from_numpy(td))
    _assert_same_state(js, ts, (idx, *_priorities(td)))
    stamp = np.asarray(jb.stamps(js, idx))
    rows = _rows(rng, 8)                              # recycles slots 12..3
    js, ts = jb.add_batch(js, rows), tb.add_batch(ts, _t(rows))
    td2 = (3 * rng.standard_normal(6)).astype(np.float32)
    js = jax.jit(jb.update_priorities)(js, idx, td2, stamp)
    ts = tb.update_priorities(ts, torch.from_numpy(idx), torch.from_numpy(td2),
                              torch.from_numpy(stamp))
    fresh = np.asarray(jb.stamps(js, idx) == stamp).all(-1)
    pj, pt = _priorities(td)
    pj2, pt2 = _priorities(td2)
    _assert_same_state(js, ts, (idx, np.where(fresh, pj2, pj),
                                np.where(fresh, pt2, pt)))


@pytest.mark.parametrize("kind", ["uniform", "amper-fr"])
def test_sample_indices_batch_and_weights(kind):
    jb, tb = _pair(kind, 64, beta=0.5)
    js, ts = jb.init(_example()), tb.init(_t(_example()))
    rng = np.random.default_rng(3)
    rows = _rows(rng, 50)
    js, ts = jb.add_batch(js, rows), tb.add_batch(ts, _t(rows))
    idx = np.arange(0, 50, 2, dtype=np.int32)
    td = rng.standard_normal(25).astype(np.float32)
    js = jax.jit(jb.update_priorities)(js, idx, td)
    ts = tb.update_priorities(ts, torch.from_numpy(idx), torch.from_numpy(td))
    for seed in range(3):
        ji, jbatch, jw = jax.jit(lambda s, k: jb.sample(s, k, 16, beta=0.7))(
            js, jax.random.key(seed))
        ti, tbatch, tw = tb.sample(ts, prng.key(seed), 16, beta=0.7)
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
        for k in jbatch:
            np.testing.assert_array_equal(np.asarray(jbatch[k]), tbatch[k].numpy())
        np.testing.assert_allclose(np.asarray(jw), tw.numpy(), rtol=1e-6)


def test_nstep_emission_matches_reference():
    jb, tb = _pair("uniform", 32, n_step=3, gamma=0.9, num_envs=2)
    js, ts = jb.init(_example()), tb.init(_t(_example()))
    rng = np.random.default_rng(4)
    add = jax.jit(jb.add_batch)
    for _ in range(9):
        rows = _rows(rng, 2, done_p=0.35)
        js, ts = add(js, rows), tb.add_batch(ts, _t(rows))
        jst = jax.tree.map(np.asarray, js)
        assert int(jst.nstep.count) == ts.nstep.count
        assert int(jst.nstep.pos) == ts.nstep.pos
        for k in ("obs", "action", "next_obs", "done", "terminated"):
            np.testing.assert_array_equal(jst.storage[k], ts.storage[k].numpy())
        np.testing.assert_allclose(jst.storage["reward"],
                                   ts.storage["reward"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert int(jst.pos) == ts.pos
    with pytest.raises(ValueError, match="num_envs"):
        tb.add_batch(ts, _t(_rows(rng, 3)))


def test_importance_weights_and_beta_schedule():
    rng = np.random.default_rng(5)
    prios = rng.uniform(0, 2, 100).astype(np.float32)
    prios[::9] = 0
    idx = rng.integers(0, 100, 32).astype(np.int32)
    for beta in (0.4, 1.0):
        want = jax.jit(jper.importance_weights)(prios, idx, jnp.int32(80), beta)
        got = tper.importance_weights(torch.from_numpy(prios),
                                      torch.from_numpy(idx).long(), 80, beta)
        np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-6)
    for step in (0, 50, 100, 500):
        np.testing.assert_allclose(
            float(jper.beta_schedule(0.4, 1.0, jnp.int32(step), 100)),
            float(tper.beta_schedule(0.4, 1.0, step, 100)), rtol=1e-7)


def test_dirty_arcs_and_row_ranges():
    for cap, base, n in ((10, 3, 4), (10, 8, 5), (10, 2, 10), (10, 0, 0), (10, 9, 25)):
        assert trb.dirty_arcs(cap, base, n) == jrb.dirty_arcs(cap, base, n)
    rows = [5, 1, 2, 3, 9, 9, 10, 0]
    assert trb.rows_to_ranges(rows) == jrb.rows_to_ranges(rows)
