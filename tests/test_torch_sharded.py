"""The port's sharded replay and its two new kernels against the JAX reference.

Inputs come from numpy with fixed seeds.  Reference meshes are built as
``jax.sharding.Mesh(devices[:S], ("data",))`` over the 8 forced host
devices (``tests/conftest.py``); the port's are S logical shards on the
CPU.  Integer paths (kernels, membership, draws, updates) must agree bit
for bit.  IS weights agree within rtol 1e-6: the two packages sum the
sharded priorities in different orders.  The
reference's sampling programs run jitted, as its replay buffer and DQN
run them.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import repro.core.quantize as jqz
from repro.core import replay_buffer as jrb
from repro.core import samplers as jsamplers
from repro.core.amper import AmperConfig as JConfig
from repro.core.amper import AmperState as JState
from repro.core.sharded import ShardedAmperSampler as JSharded
from repro.kernels import ops as jops
from repro_torch import prng
from repro_torch.core import replay_buffer as trb
from repro_torch.core import samplers as tsamplers
from repro_torch.core.amper import AmperConfig, fr_intervals, \
    group_representatives
from repro_torch.core.sharded import (ShardedAmperSampler, repartition,
                                      sharded_sample_fr)
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rank_select_ref, tcam_match_ref
from test_torch_dqn import thirty_agent_steps

N = 2048
BATCH = 64
CFG = dict(capacity=N, m=20, lam_fr=2.0, v_max=8.0, csp_capacity=600)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _jmesh(s):
    if jax.device_count() < s:
        pytest.skip(f"needs {s} host devices (tests/conftest.py forces 8)")
    return JMesh(np.asarray(jax.devices()[:s]), ("data",))


def _tmesh(s):
    return Mesh([CPU] * s)


def _table(n, seed, frac_valid=0.9, v_max=8.0):
    rng = np.random.default_rng(seed)
    p = rng.exponential(1.0, n).astype(np.float32)
    valid = rng.random(n) < frac_valid
    pq = np.asarray(jax.jit(lambda x: jqz.quantize(x, v_max))(p))
    return pq, valid


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


# --- (a), (b): the plain versions against the reference's kernels ------------


def _ranks_for(count):
    return np.array([0, 1, count // 2, count - 1, count, count + 5, -1, -9],
                    np.int32)


@pytest.mark.parametrize("n,frac_valid", [(1, 1.0), (777, 0.9), (5000, 0.8),
                                          (3000, 0.0)])
def test_rank_select_ref_equals_reference_kernel(n, frac_valid):
    pq, valid = _table(n, seed=n, frac_valid=frac_valid)
    cfg = AmperConfig(capacity=n, m=20, lam_fr=2.0, v_max=8.0)
    lo, hi = fr_intervals(group_representatives(prng.key(n), cfg), cfg)
    count = int(rank_select_ref(*_t(pq, valid), lo, hi,
                                torch.zeros(1, dtype=torch.int32))[1])
    assert count > 2 or n == 1 or frac_valid == 0.0  # not a degenerate case
    ranks = _ranks_for(count)
    jidx, jcnt = jops.rank_select(pq, valid, lo.numpy(), hi.numpy(), ranks)
    tidx, tcnt = ops.rank_select(*_t(pq, valid), lo, hi, *_t(ranks))
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    assert int(jcnt) == int(tcnt) == count
    assert tidx.dtype == torch.int32 and tcnt.dtype == torch.int32


@pytest.mark.parametrize("n", [1, 1001, 4096])
def test_tcam_match_ref_equals_reference_kernel(n):
    pq, _ = _table(n, seed=n + 1)
    rng = np.random.default_rng(n)
    for width in (0, 7, 18):
        q = np.int32(pq[rng.integers(0, n)] if n else 0)
        mask = np.int32((1 << width) - 1)
        want = np.asarray(jops.tcam_match(pq, q, mask))
        got = ops.tcam_match(*_t(pq), int(q), int(mask))
        np.testing.assert_array_equal(want, got.numpy())
        assert got.dtype == torch.bool


def test_new_wrappers_check_arguments_and_never_fall_back():
    pq = torch.zeros(16, dtype=torch.int32)
    valid = torch.ones(16, dtype=torch.bool)
    lo = hi = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.rank_select(pq, valid, lo, hi, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        ops.rank_select(pq[:0], valid[:0], lo, hi,
                        torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        ops.tcam_match(pq.long(), 0, 0)
    before = dict(ops.launches)
    meta = [torch.empty(16, dtype=torch.int32, device="meta"),
            torch.empty(16, dtype=torch.bool, device="meta"),
            torch.empty(3, dtype=torch.int32, device="meta"),
            torch.empty(3, dtype=torch.int32, device="meta"),
            torch.empty(4, dtype=torch.int32, device="meta")]
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.rank_select(*meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.tcam_match(meta[0], 1, 0)
    assert ops.launches == before


# --- (c): ShardedAmperSampler against repro.core.sharded ---------------------


@pytest.fixture(scope="module")
def jax_membership():
    """The reference's global membership per shard count (its fr_modes are
    bit-identical by its own tests, so one mode serves all)."""
    pq, valid = _table(N, seed=1)
    out = {}

    def get(s):
        if s not in out:
            js = JSharded(JConfig(**CFG), _jmesh(s), axis_names=("data",))
            st = JState(pq=jax.device_put(pq, js.sharding),
                        valid=jax.device_put(valid, js.sharding))
            fn = jax.jit(js.membership)
            out[s] = [np.asarray(fn(st, jax.random.key(k))) for k in (4, 5)]
        return out[s]

    return get


@pytest.mark.parametrize("mode", ["broadcast", "kernel", "fused"])
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_sharded_amper_sampler_bit_identical(shards, mode, jax_membership):
    pq, valid = _table(N, seed=1)
    js = JSharded(JConfig(**CFG, fr_mode=mode), _jmesh(shards),
                  axis_names=("data",))
    ts = ShardedAmperSampler(AmperConfig(**CFG, fr_mode=mode),
                             _tmesh(shards), axis_names=("data",))
    assert ts.local_csp_capacity == js.local_csp_capacity
    jdraw = jax.jit(lambda s, k: js.sample(s, k, BATCH))
    free = sharded_sample_fr(ts.mesh, ts.cfg, BATCH, axis_names=("data",))
    empty = np.zeros_like(valid)
    for v, keys in ((valid, (4, 5)), (empty, (6,))):  # empty: fallback
        jst = JState(pq=jax.device_put(pq, js.sharding),
                     valid=jax.device_put(v, js.sharding))
        tst = ts.from_dense(*_t(pq, v))
        assert len(tst.pq) == shards
        for k in keys:
            want = np.asarray(jdraw(jst, jax.random.key(k)))
            got = ts.sample(tst, prng.key(k), BATCH)
            np.testing.assert_array_equal(want, got.numpy())
            assert got.dtype == torch.int32
            assert torch.equal(got, free(tst.pq, tst.valid, prng.key(k)))
    tst = ts.from_dense(*_t(pq, valid))
    for k, want in zip((4, 5), jax_membership(shards)):
        np.testing.assert_array_equal(want, ts.membership(tst, prng.key(k))
                                      .numpy())


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_update_matches_reference(shards):
    """Global rows map to (shard, local row); a duplicated row takes its
    last value, and a priority of 0 invalidates the row."""
    rng = np.random.default_rng(shards)
    idx = rng.integers(0, N, 300).astype(np.int32)   # with duplicates
    prio = rng.uniform(0, 9, 300).astype(np.float32)
    prio[::11] = 0.0
    js = JSharded(JConfig(**CFG), _jmesh(shards), axis_names=("data",))
    jst = jax.jit(js.update)(js.init(), idx, prio)
    ts = ShardedAmperSampler(AmperConfig(**CFG), _tmesh(shards))
    tst = ts.update(ts.init(), *_t(idx, prio))
    np.testing.assert_array_equal(np.asarray(jst.pq), torch.cat(tst.pq).numpy())
    np.testing.assert_array_equal(np.asarray(jst.valid),
                                  torch.cat(tst.valid).numpy())
    np.testing.assert_array_equal(np.asarray(js.priorities(jst)),
                                  ts.priorities(tst).numpy())
    np.testing.assert_allclose(float(js.total(jst)), float(ts.total(tst)),
                               rtol=1e-6)
    # repartition: 2 or 8 shards -> 4 and back leaves every value in place
    four = ShardedAmperSampler(AmperConfig(**CFG), _tmesh(4))
    back = repartition(ts, repartition(four, tst))
    assert torch.equal(torch.cat(back.pq), torch.cat(tst.pq))
    assert repartition(object(), tst) is tst


def test_sharded_sampler_refuses_uneven_shards_and_unknown_axes():
    with pytest.raises(ValueError, match="divisible"):
        ShardedAmperSampler(AmperConfig(capacity=100), _tmesh(8))
    with pytest.raises(ValueError, match="sharding axes"):
        ShardedAmperSampler(AmperConfig(capacity=64), _tmesh(2),
                            axis_names=("pod",))


def test_mesh_orders_shards_like_the_reference():
    """Shards over several axes are numbered row-major in the order of
    ``axis_names``, as the reference's flat axis index is."""
    d = [[torch.device("cpu", i * 2 + j) for j in range(2)] for i in range(2)]
    mesh = Mesh(d, ("pod", "data"))
    idx = [x.index for x in mesh.shard_devices(("pod", "data"))]
    assert idx == [0, 1, 2, 3]
    assert [x.index for x in mesh.shard_devices(("data", "pod"))] == [0, 2, 1, 3]
    assert [x.index for x in mesh.shard_devices(("data",))] == [0, 1]


# --- (e): the replay buffer over the sharded sampler ---------------------------


@pytest.mark.parametrize("shards", [2, 8])
def test_replay_buffer_sharded_matches_reference(shards):
    cap, obs = 512, 3
    kw = dict(m=20, lam_fr=2.0, v_max=4.0, min_csp=16, axis_names=("data",))
    js = jsamplers.make_sampler("amper-fr-sharded", cap, mesh=_jmesh(shards),
                                fr_mode="kernel", **kw)
    ts = tsamplers.make_sampler("amper-fr-sharded", cap, mesh=_tmesh(shards),
                                fr_mode="fused", device="cpu", **kw)
    # alpha = 1: the priority |td| + eps rounds the same in both packages,
    # so the quantized table can be held exact (a pow rounds independently)
    jb = jrb.ReplayBuffer(cap, js, alpha=1.0)
    tb = trb.ReplayBuffer(cap, ts, alpha=1.0)
    ex = {"obs": np.zeros(obs, np.float32), "reward": np.float32(0)}
    jst = jb.init(ex)
    tst = tb.init({k: torch.from_numpy(np.array(v)) for k, v in ex.items()})
    rng = np.random.default_rng(shards)
    jadd, jsample = jax.jit(jb.add_batch), jax.jit(
        lambda s, k: jb.sample(s, k, 32))
    jupd = jax.jit(jb.update_priorities)
    for step in range(12):   # 12 * 48 rows wraps the 512-row ring
        rows = {"obs": rng.standard_normal((48, obs)).astype(np.float32),
                "reward": rng.standard_normal(48).astype(np.float32)}
        jst = jadd(jst, rows)
        tst = tb.add_batch(tst, {k: torch.from_numpy(v) for k, v in rows.items()})
        jidx, jbatch, jw = jsample(jst, jax.random.key(step))
        tidx, tbatch, tw = tb.sample(tst, prng.key(step), 32)
        np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
        np.testing.assert_array_equal(np.asarray(jbatch["obs"]),
                                      tbatch["obs"].numpy())
        np.testing.assert_allclose(np.asarray(jw), tw.numpy(), rtol=1e-6)
        td = rng.standard_normal(32).astype(np.float32)
        jst = jupd(jst, jidx, td)
        tst = tb.update_priorities(tst, tidx, torch.from_numpy(td))
        np.testing.assert_array_equal(np.asarray(jst.sampler_state.pq),
                                      torch.cat(tst.sampler_state.pq).numpy())


# --- (f): DQN through the sharded sampler ---------------------------------------


def test_thirty_agent_steps_sharded_match_reference(monkeypatch):
    """30 steps of DQN with ``amper-fr-sharded`` on 2 shards, the port
    through its fused kernels' plain versions, the reference through its
    broadcast match; the reference's default mesh is pointed at 2 of the
    forced host devices."""
    jmesh = _jmesh(2)
    monkeypatch.setattr(jsamplers, "_default_mesh", lambda: jmesh)
    thirty_agent_steps("amper-fr-sharded", "dqn", 1, "fused", mesh=_tmesh(2))


# --- (g): what a draw moves between shards -------------------------------------


@pytest.mark.parametrize("shards", [1, 4, 8])
def test_a_draw_moves_shards_plus_batch_scalars(shards):
    """One all-gather of the S shard counts and one psum of the batch:
    S + b scalars a draw, whatever the table size."""
    pq, valid = _table(N, seed=2)
    mesh = _tmesh(shards)
    ts = ShardedAmperSampler(AmperConfig(**CFG, fr_mode="fused"), mesh)
    st = ts.from_dense(*_t(pq, valid))
    mesh.traffic = {"all_gather": 0, "psum": 0}
    ts.sample(st, prng.key(0), BATCH)
    assert mesh.traffic == {"all_gather": shards, "psum": BATCH}
    per = tsamplers.make_sampler("per-sharded", N, mesh=mesh, device="cpu")
    pst = per.update(per.init(), torch.arange(N), torch.ones(N))
    mesh.traffic = {"all_gather": 0, "psum": 0}
    per.sample(pst, prng.key(0), BATCH)
    assert mesh.traffic == {"all_gather": shards, "psum": BATCH}


# --- (h): the kernels on the card ------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("n,frac_valid", [(1, 1.0), (1001, 0.9),
                                          (250_000, 0.9), (4097, 0.0)])
def test_cuda_rank_select_equals_plain(n, frac_valid):
    _need_cuda()
    pq, valid = _table(n, seed=n, frac_valid=frac_valid)
    cfg = AmperConfig(capacity=n, m=20, lam_fr=2.0, v_max=8.0)
    lo, hi = fr_intervals(group_representatives(prng.key(n), cfg), cfg)
    args = [x.cuda() for x in _t(pq, valid)] + [lo.cuda(), hi.cuda()]
    count = int(rank_select_ref(*args, torch.zeros(1, dtype=torch.int32,
                                                   device="cuda"))[1])
    rank = torch.from_numpy(np.concatenate([
        _ranks_for(count),
        np.random.default_rng(n).integers(-3, count + 3, 300)]).astype(
            np.int32)).cuda()
    got = ops.rank_select(*args, rank)
    want = rank_select_ref(*args, rank)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1001, 1_000_000])
def test_cuda_tcam_match_equals_plain(n):
    _need_cuda()
    pq = _t(_table(n, seed=n)[0])[0].cuda()
    for width in (0, 7, 18):
        q, mask = int(pq[n // 2]), (1 << width) - 1
        got = ops.tcam_match(pq, q, mask)
        assert torch.equal(got, tcam_match_ref(pq, q, mask))
