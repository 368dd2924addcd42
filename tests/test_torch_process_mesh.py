"""The process mesh: the reference's ``shard_map`` bodies on
``torch.distributed`` ranks, against the reference and the single-process
mesh.

The reference runs here, in the pytest process, on
``jax.sharding.Mesh(devices[:S], ...)`` of the forced host devices
(``tests/conftest.py``; never ``jax.make_mesh``, ROADMAP C2).  The port's
process mesh runs on 2 and 4 spawned ranks over ``gloo``
(``repro_torch.launch.mesh.run_ranks``), which run only
``tests/torch_mesh_ranks.py``: torch and the port, no jax.  One spawn a
rank count runs every check; the tests read its results.  Inputs come
from numpy with fixed seeds.

Held bit for bit: the sharded AMPER-fr draws in every ``fr_mode``, the
PER draws, ``update``, ``membership``, the partitioned storage, the DQN
steps and the pod sync, against the reference and against the
single-process mesh of the same shard count; the IS weights equal the
single-process mesh's and are within rtol 1e-6 of the reference's (the
two packages sum the priorities in different orders).  The MoE
dispatch equals the single-process mesh's bit for bit and is within
atol = rtol = 1e-5 of the reference's ``moe_apply_shard_map`` (float32
sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import torch_mesh_ranks as ranks
from repro.configs import get_config as jconfig
from repro.core import replay_buffer as jrb
from repro.core import samplers as jsamplers
from repro.core.amper import AmperConfig as JConfig
from repro.core.amper import AmperState as JState
from repro.core.sharded import ShardedAmperSampler as JSharded
from repro.core.sharded import ShardedPERSampler as JShardedPER
from repro.core.sharded import ShardedPERState as JShardedPERState
from repro.distributed import collectives as jcol
from repro.distributed import sharding as jshd
from repro.models import moe as jmoe
from repro.rl import dqn as jd
from repro_torch import interop
from repro_torch.configs import get_config as tconfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch.mesh import _to_host, run_ranks
from test_torch_dqn import _close_trees, _jax_peek
from test_torch_sharded import _table

CPU = torch.device("cpu")
WORLDS = (2, 4)
SPAWN_TIMEOUT = 240.0
MOE_TOL = 1e-5
MOE_KW = dict(d_model=32, n_experts=8, moe_top_k=2, moe_d_ff=16)


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _jmesh(shape, axes):
    n = int(np.prod(shape))
    if jax.device_count() < n:
        pytest.skip(f"needs {n} host devices (tests/conftest.py forces 8)")
    return JMesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


def _tmesh(shape, axes):
    return Mesh(np.full(shape, CPU, dtype=object), axes)


# --- the inputs, from seeds ---------------------------------------------------


def _draw_inputs():
    pq, valid = _table(ranks.N, seed=1)
    rng = np.random.default_rng(7)
    prios = rng.exponential(1.0, ranks.N).astype(np.float32)
    prios[rng.random(ranks.N) < 0.2] = 0.0
    idx = rng.integers(0, ranks.N, 300).astype(np.int32)  # duplicates too
    upd = rng.uniform(0, 9, 300).astype(np.float32)
    upd[::11] = 0.0
    return pq, valid, prios, idx, upd


def _ring_inputs():
    rng = np.random.default_rng(11)
    rows, tds = [], []
    for _ in range(ranks.RING_STEPS):
        r = {"obs": rng.standard_normal((ranks.RING_ADD, 3)).astype(
            np.float32),
             "reward": rng.standard_normal(ranks.RING_ADD).astype(np.float32)}
        r["reward"][::5] = -0.0
        r["obs"][::7, 1] = -0.0
        rows.append(r)
        tds.append(rng.standard_normal(ranks.RING_BATCH).astype(np.float32))
    return rows, tds


def _grads(world):
    rng = np.random.default_rng(world)
    return [{"w": (rng.standard_normal((17, 5)) * 10.0 ** p).astype(
        np.float32), "b": rng.standard_normal(5).astype(np.float32),
        "z": np.zeros(3, np.float32)} for p in range(world)]


def _moe_cases():
    rng = np.random.default_rng(5)
    D, E, F = MOE_KW["d_model"], MOE_KW["n_experts"], MOE_KW["moe_d_ff"]
    params = {
        "router": rng.standard_normal((D, E)).astype(np.float32) * 0.1,
        "w_gate": rng.standard_normal((E, D, F)).astype(np.float32) * 0.2,
        "w_up": rng.standard_normal((E, D, F)).astype(np.float32) * 0.2,
        "w_down": rng.standard_normal((E, F, D)).astype(np.float32) * 0.2,
        "shared": {"w_gate": rng.standard_normal((D, 32)).astype(np.float32),
                   "w_up": rng.standard_normal((D, 32)).astype(np.float32),
                   "w_down": rng.standard_normal((32, D)).astype(np.float32)
                   * 0.2}}
    xs = {"tiled": [rng.standard_normal((4, 8, D)).astype(np.float32)],
          # T = 3 tokens over G = 2 token groups: the reference's scatter
          "fallback": [rng.standard_normal((1, 3, D)).astype(np.float32)]}
    return params, xs


def _configs():
    jc = dataclasses.replace(jconfig("deepseek-moe-16b"), **MOE_KW)
    tc = dataclasses.replace(tconfig("deepseek-moe-16b"), **MOE_KW)
    return jc, tc


def _dqn_reference():
    """The reference's 30 sharded agent steps on 2 shards (its default
    mesh pointed at 2 host devices): the draws of its learn steps, its
    final params, and its initial state as the port's."""
    with pytest.MonkeyPatch.context() as mp:
        jm = _jmesh((2,), ("data",))
        mp.setattr(jsamplers, "_default_mesh", lambda: jm)
        jdq = jd.make_dqn(jd.DQNConfig(**ranks.DQN_KW))
        key = jax.random.key(3)
        js = jdq.init(key)
        single = _tmesh((2,), ("data",))
        cfg = ranks.td.DQNConfig(**ranks.DQN_KW, amper_fr_mode="fused")
        sampler = ranks.td.make_dqn(cfg, device="cpu",
                                    mesh=single).replay.sampler
        start = _to_host(interop.agent_state_from_jax(
            jax.tree.map(np.asarray, js), device="cpu", sampler=sampler))
        keys = jax.random.split(jax.random.fold_in(key, 1),
                                ranks.DQN_STEPS)
        step, peek = jax.jit(jdq.agent_step), _jax_peek(jdq,
                                                        ranks.DQN_KW["batch"])
        idx = []
        for i in range(ranks.DQN_STEPS):
            learns = i >= ranks.DQN_KW["learn_start"]
            idx.append(np.asarray(peek(js, keys[i])[0]) if learns else None)
            js, _ = step(js, keys[i])
    return start, idx, js


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    params, xs = _moe_cases()
    _, tc = _configs()
    start, jidx, js = _dqn_reference()
    return {"table": _draw_inputs(), "ring": _ring_inputs(),
            "dqn_state": start, "grads": {w: _grads(w) for w in WORLDS},
            "moe_params": params,
            "moe": {name: (tc, x) for name, x in xs.items()},
            "dqn_ref": (jidx, js),
            "ckpt_dir": str(tmp_path_factory.mktemp("ranks_ckpt"))}


@pytest.fixture(scope="module")
def spawned(inputs):
    """One spawn a rank count, every check in it (``all_checks``)."""
    cache = {}

    def get(world):
        if world not in cache:
            args = {k: v for k, v in inputs.items() if k != "dqn_ref"}
            args["grads"] = inputs["grads"][world]
            cache[world] = run_ranks(ranks.all_checks, world, (args,),
                                     device="cpu", timeout=SPAWN_TIMEOUT,
                                     threads=1)
        return cache[world]

    return get


@pytest.fixture(scope="module")
def single(inputs):
    """The same checks on the single-process mesh of the same shape."""
    out = {"draws": ranks.draw_checks(_tmesh((ranks.SHARDS,), ("data",)),
                                      *inputs["table"]),
           "storage": _to_host(ranks.storage_checks(
               _tmesh((ranks.SHARDS,), ("data",)), *inputs["ring"])),
           "dqn": _to_host(ranks.dqn_steps(_tmesh((2,), ("data",)),
                                           inputs["dqn_state"])),
           "ckpt": _to_host(ranks.dqn_ckpt(_tmesh((2,), ("data",)),
                                           inputs["ckpt_dir"] + "_one"))}
    out["draws"] = _to_host(out["draws"])
    out["sparse"] = _to_host(ranks.sparse_draws(
        _tmesh((2, 2), ("data", "model")), *inputs["table"][:2]))
    out["moe"] = {name: _to_host(ranks.moe_checks(
        _tmesh((2, 2), ("data", "model")), cfg, inputs["moe_params"], xs))
        for name, (cfg, xs) in inputs["moe"].items()}
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _eq(a, b):
    """Equal dtype, shape and bits (a float -0.0 is not 0.0)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    a, b = a.reshape(-1), b.reshape(-1)
    if a.dtype.kind == "f":
        a, b = a.view(np.uint8), b.view(np.uint8)
    np.testing.assert_array_equal(a, b)


# --- the draws -----------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_draws(inputs):
    pq, valid, prios, idx, upd = inputs["table"]
    jm = _jmesh((ranks.SHARDS,), ("data",))
    out = {}
    for mode in ranks.FR_MODES:
        js = JSharded(JConfig(**ranks.CFG, fr_mode=mode), jm,
                      axis_names=("data",))
        draw = jax.jit(lambda s, k, js=js: js.sample(s, k, ranks.BATCH))
        full = JState(pq=jax.device_put(pq, js.sharding),
                      valid=jax.device_put(valid, js.sharding))
        empty = JState(pq=full.pq, valid=jax.device_put(
            np.zeros_like(valid), js.sharding))
        out[mode] = {
            "draws": [np.asarray(draw(full, jax.random.key(k)))
                      for k in ranks.DRAW_KEYS]
            + [np.asarray(draw(empty, jax.random.key(k)))
               for k in ranks.EMPTY_KEYS],
            "membership": [np.asarray(jax.jit(js.membership)(
                full, jax.random.key(k))) for k in ranks.MEMBER_KEYS]}
    js = JSharded(JConfig(**ranks.CFG), jm, axis_names=("data",))
    jst = jax.jit(js.update)(js.init(), idx, upd)
    out["update"] = {"pq": np.asarray(jst.pq), "valid": np.asarray(jst.valid),
                     "priorities": np.asarray(js.priorities(jst)),
                     "total": float(js.total(jst))}
    per = JShardedPER(ranks.N, jm, axis_names=("data",))
    pst = JShardedPERState(priorities=jax.device_put(prios, per.sharding))
    out["per"] = [np.asarray(jax.jit(lambda s, k: per.sample(s, k, 128))(
        pst, jax.random.key(k))) for k in (0, 1, 2)]
    return out


@pytest.mark.parametrize("mode", ranks.FR_MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fr_draws_bit_identical(world, mode, spawned, single,
                                        reference_draws):
    """Every rank draws the reference's indices (the empty table's
    fallback too), as the single-process mesh does."""
    for r in spawned(world):
        got = r["draws"][mode]
        for g, s, j in zip(got["draws"], single["draws"][mode]["draws"],
                           reference_draws[mode]["draws"]):
            _eq(g, s)
            np.testing.assert_array_equal(g, j)
        assert sum(got["held"]) == ranks.SHARDS // world * (ranks.N
                                                            // ranks.SHARDS)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_membership_bit_identical(world, spawned, reference_draws):
    for r in spawned(world):
        for mode in ranks.FR_MODES:
            for g, j in zip(r["draws"][mode]["membership"],
                            reference_draws[mode]["membership"]):
                np.testing.assert_array_equal(g, j)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_update_bit_identical(world, spawned, single,
                                      reference_draws):
    want = reference_draws["update"]
    for r in spawned(world):
        got = r["draws"]["update"]
        for k in ("pq", "valid", "priorities"):
            np.testing.assert_array_equal(got[k], want[k])
            _eq(got[k], single["draws"]["update"][k])
        _eq(got["total"], single["draws"]["update"]["total"])
        np.testing.assert_allclose(float(got["total"]), want["total"],
                                   rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_per_draws_bit_identical(world, spawned, single,
                                         reference_draws):
    for r in spawned(world):
        for g, s, j in zip(r["draws"]["per"]["draws"],
                           single["draws"]["per"]["draws"],
                           reference_draws["per"]):
            _eq(g, s)
            np.testing.assert_array_equal(g, j)


@pytest.mark.parametrize("world", WORLDS)
def test_traffic_counts_equal_the_single_process_mesh(world, spawned,
                                                      single):
    """S + b scalars a draw (two draws here) on every rank, as on one
    process."""
    for r in spawned(world):
        for mode in ranks.FR_MODES:
            assert r["draws"][mode]["traffic"] == \
                single["draws"][mode]["traffic"] == \
                {"all_gather": 2 * ranks.SHARDS, "psum": 2 * ranks.BATCH}
        assert r["draws"]["per"]["traffic"] == \
            single["draws"]["per"]["traffic"]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_without_a_shard_join_the_draw(world, spawned, single):
    """Shards over "data" of a 2 x 2 mesh: on 4 ranks, two hold none; every
    rank still draws the single-process mesh's batch and table."""
    one = single["sparse"]
    held = []
    for r in spawned(world):
        got = r["sparse"]
        held.append(got["held"])
        for g, s in zip(got["draws"], one["draws"]):
            _eq(g, s)
        _eq(got["dense"], one["dense"])
        assert got["traffic"] == one["traffic"]
    assert held == ([1, 1] if world == 2 else [1, 0, 1, 0])


# --- the partitioned storage ---------------------------------------------------


@pytest.fixture(scope="module")
def reference_ring(inputs):
    rows, tds = inputs["ring"]
    kw = dict(m=20, lam_fr=2.0, v_max=4.0, min_csp=16, axis_names=("data",))
    js = jsamplers.make_sampler("amper-fr-sharded", ranks.RING,
                                mesh=_jmesh((ranks.SHARDS,), ("data",)),
                                fr_mode="kernel", **kw)
    jb = jrb.ReplayBuffer(ranks.RING, js, alpha=1.0)
    st = jb.init({"obs": np.zeros(3, np.float32), "reward": np.float32(0)})
    add, upd = jax.jit(jb.add_batch), jax.jit(jb.update_priorities)
    sample = jax.jit(lambda s, k: jb.sample(s, k, ranks.RING_BATCH))
    samples = []
    for step in range(ranks.RING_STEPS):
        st = add(st, rows[step])
        idx, batch, w = sample(st, jax.random.key(step))
        samples.append({"idx": np.asarray(idx), "w": np.asarray(w),
                        "batch": jax.tree.map(np.asarray, batch)})
        st = upd(st, idx, tds[step])
    return samples, jax.tree.map(np.asarray, st)


@pytest.mark.parametrize("world", WORLDS)
def test_storage_each_rank_holds_its_rows(world, spawned, reference_ring):
    """Rank r holds rows [r * cap / R, (r + 1) * cap / R) of the
    reference's ring after the wrap, and nothing else."""
    _, jst = reference_ring
    n = ranks.RING // world
    for rank, r in enumerate(spawned(world)):
        st = r["storage"]
        assert tuple(st["rows"]) == (rank * n, (rank + 1) * n)
        for k, v in st["held"].items():
            assert v.shape[0] == n
            _eq(v, jst.storage[k][rank * n:(rank + 1) * n])


@pytest.mark.parametrize("world", WORLDS)
def test_storage_dense_view_equals_reference(world, spawned, single,
                                             reference_ring):
    _, jst = reference_ring
    for r in spawned(world):
        for k, v in r["storage"]["dense"].items():
            _eq(v, jst.storage[k])
            _eq(v, single["storage"]["dense"][k])
        np.testing.assert_array_equal(r["storage"]["pq"],
                                      jst.sampler_state.pq)
        _eq(r["storage"]["max_priority"], single["storage"]["max_priority"])


@pytest.mark.parametrize("world", WORLDS)
def test_storage_samples_bit_identical(world, spawned, single, inputs,
                                       reference_ring):
    """Each step's batch holds the rows as stored, bit for bit, a stored
    ``-0.0`` included, as the single-process mesh's does, and equals the
    reference's batch in value; the IS weights equal the single-process
    mesh's.  (The reference's gather from its sharded storage gives
    ``+0.0`` for a stored ``-0.0``: XLA sums the shards' zero-padded
    rows.)"""
    samples, _ = reference_ring
    rows, _ = inputs["ring"]
    negzero = 0
    for r in spawned(world):
        stored = {k: np.zeros((ranks.RING,) + rows[0][k].shape[1:],
                              np.float32) for k in rows[0]}
        for step, (got, one, want) in enumerate(zip(
                r["storage"]["samples"], single["storage"]["samples"],
                samples)):
            np.testing.assert_array_equal(got["idx"], want["idx"])
            at = (step * ranks.RING_ADD + np.arange(ranks.RING_ADD)) \
                % ranks.RING
            for k in ("obs", "reward"):
                stored[k][at] = rows[step][k]
                _eq(got["batch"][k], stored[k][got["idx"]])
                _eq(got["batch"][k], one["batch"][k])
                np.testing.assert_array_equal(got["batch"][k],
                                              want["batch"][k])
                negzero += int(np.signbit(got["batch"][k])[
                    got["batch"][k] == 0].sum())
            _eq(got["w"], one["w"])
            np.testing.assert_allclose(got["w"], want["w"], rtol=1e-6)
    assert negzero > 0  # the draws did carry a stored -0.0


# --- DQN ------------------------------------------------------------------------


def test_thirty_sharded_agent_steps_on_two_ranks(spawned, single, inputs):
    """30 DQN steps with ``amper-fr-sharded`` (fused) on 2 ranks of one
    shard each, from the reference's initial state: every rank's draws
    equal the reference's at each learn step, and its params, moments,
    TD errors, ring and table equal the single-process mesh's bit for
    bit; its params are within the 30-step oracle's tolerance of the
    reference's (``tests/test_torch_dqn.py``)."""
    jidx, js = inputs["dqn_ref"]
    one = single["dqn"]
    for r in spawned(2):
        got = r["dqn"]
        assert got["held_rows"] == ranks.DQN_KW["replay_size"] // 2
        for i, (g, s, j) in enumerate(zip(got["idx"], one["idx"], jidx)):
            if j is None:
                assert g is None and s is None, i
                continue
            _eq(g, s)
            np.testing.assert_array_equal(g, j)
        for a, b in zip(got["td"] + got["loss"], one["td"] + one["loss"]):
            if a is not None:
                _eq(a, b)
        for name in ("params", "opt_m"):
            for a, b in zip(_leaves(got[name]), _leaves(one[name]),
                            strict=True):
                _eq(a, b)
        for k in got["storage"]:
            _eq(got["storage"][k], one["storage"][k])
        _eq(got["pq"], one["pq"])
        _eq(got["returns"], one["returns"])
        _close_trees(js.params, jax.tree.map(torch.from_numpy,
                                             got["params"]))


def test_train_ckpt_on_two_ranks(spawned, single, inputs):
    """``train_ckpt`` on 2 ranks: rank 0 writes the dense view, every rank
    restores its own rows from it, and the run, the files' state and the
    restored state equal the single-process mesh's bit for bit; the
    single-process agent restores the ranks' checkpoint too."""
    one = single["ckpt"]
    for r in spawned(2):
        got = r["ckpt"]
        assert got["done"] == ranks.CKPT_STEPS
        for a, b in zip(_leaves([got["params"], got["restored_params"]]),
                        _leaves([one["params"], one["params"]]),
                        strict=True):
            _eq(a, b)
        for name in ("storage", "restored_storage"):
            for k in got[name]:
                _eq(got[name][k], one["storage"][k])
        _eq(got["pq"], one["pq"])
        _eq(got["restored_pq"], one["pq"])
    cfg = ranks.td.DQNConfig(**ranks.CKPT_KW, amper_fr_mode="fused")
    dq = ranks.td.make_dqn(cfg, device="cpu", mesh=_tmesh((2,), ("data",)))
    back = dq.load_ckpt(inputs["ckpt_dir"], ranks.CKPT_STEPS)
    for a, b in zip(_leaves(_to_host(back.params)), _leaves(one["params"]),
                    strict=True):
        _eq(a, b)


def test_capture_is_refused_on_a_process_mesh(spawned):
    for r in spawned(2):
        assert "CUDA-graph capture is refused" in r["dqn"]["capture_refused"]


# --- the pod sync (C15: the reference's body under a manual shard_map) ----------


def _reference_pod_sync(world, grads, compress):
    jm = _jmesh((world,), ("pod",))
    stacked = {k: np.stack([g[k] for g in grads]) for k in grads[0]}

    def body(g):
        g = jax.tree.map(lambda t: t[0], g)
        if compress:
            return jcol.psum_int8_mean(g, "pod")
        return jax.tree.map(
            lambda t: jax.lax.pmean(t.astype(jnp.float32), "pod"), g)

    fn = shard_map(body, mesh=jm, in_specs=(P("pod"),), out_specs=P(),
                   check_rep=False)
    return jax.tree.map(np.asarray, jax.jit(fn)(stacked))


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("world", WORLDS)
def test_pod_sync_bit_identical(world, compress, spawned, inputs):
    grads = inputs["grads"][world]
    want = _reference_pod_sync(world, grads, compress)
    one_process = col.grad_fn_with_pod_sync(
        lambda params, b: {k: v[0] for k, v in b.items()},
        _tmesh((world,), ("pod",)), compress=compress)(
        None, {k: torch.from_numpy(np.stack([g[k] for g in grads]))
               for k in grads[0]})
    for r in spawned(world):
        got = r["pod"][f"compress={compress}"]
        for k in want:
            _eq(got[k], want[k])
            _eq(got[k], one_process[k].numpy())
        if compress:
            for k in want:
                _eq(r["pod"]["direct"][k], want[k])


def test_pod_sync_without_a_pod_axis_is_the_grad_fn():
    def fn(params, batch):
        return batch

    assert col.grad_fn_with_pod_sync(fn, _tmesh((2,), ("data",))) is fn


# --- the MoE dispatch -------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_moe(inputs):
    jc, _ = _configs()
    jm = _jmesh((2, 2), ("data", "model"))
    out = {}
    for name, (_, xs) in inputs["moe"].items():
        with jm, jshd.use_rules(jshd.ShardingRules(jm, jshd.TRAIN_RULES)):
            fn = jax.jit(lambda p, x: jmoe.moe_apply(jc, p, x))
            out[name] = [jax.tree.map(np.asarray, fn(inputs["moe_params"],
                                                     x)) for x in xs]
    return out


@pytest.mark.parametrize("case", ["tiled", "fallback"])
@pytest.mark.parametrize("world", WORLDS)
def test_moe_shard_map_dispatch(world, case, spawned, single, reference_moe):
    """A 2 x 2 ("data", "model") mesh over the ranks: output and metrics
    equal to the single-process 2 x 2 mesh bit for bit, and within
    ``MOE_TOL`` of the reference's ``moe_apply_shard_map`` (on its 2 x 2
    mesh), which is not its scatter dispatch where the shapes tile."""
    for r in spawned(world):
        for (got, gm), (one, om), (want, wm) in zip(
                r["moe"][case], single["moe"][case], reference_moe[case]):
            _eq(got, one)
            np.testing.assert_allclose(got, want, atol=MOE_TOL, rtol=MOE_TOL)
            for k in wm:
                _eq(gm[k], om[k])
                np.testing.assert_allclose(gm[k], wm[k], atol=MOE_TOL,
                                           rtol=MOE_TOL)


def test_moe_shard_map_is_not_the_scatter(inputs, reference_moe):
    """Where the shapes tile, the reference's shard-map dispatch (and so
    the port's) is not its scatter one: capacity is per token group."""
    jc, _ = _configs()
    x = inputs["moe"]["tiled"][1][0]
    scatter, sm = jmoe.moe_apply_scatter(jc, inputs["moe_params"], x)
    out, metrics = reference_moe["tiled"][0]
    assert np.abs(out - np.asarray(scatter)).max() > 1e-2
    assert float(metrics["moe_drop_frac"]) != float(sm["moe_drop_frac"])


# --- the spawn helper -------------------------------------------------------------


def test_a_rank_that_raises_fails_within_the_timeout():
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(ranks.raises_on_one_rank, 2, device="cpu", timeout=60.0,
                  threads=1)
    assert time.monotonic() - t0 < 60.0


def test_mesh_slots_are_row_major_blocks_over_ranks():
    """The slot helpers a process mesh lays its ranks out by, on a
    single-process mesh (one rank holding every slot)."""
    mesh = _tmesh((2, 2, 2), ("pod", "data", "model"))
    assert list(mesh.local_slots) == list(range(8))
    assert mesh.shard_slots(("pod", "data")) == [0, 2, 4, 6]
    assert mesh.shard_slots(("data", "pod")) == [0, 4, 2, 6]
    assert mesh.group_slots(5, ("model",)) == [4, 5]
    assert mesh.group_slots(5, ("pod", "data")) == [1, 3, 5, 7]
    assert mesh.coords(6) == {"pod": 1, "data": 1, "model": 0}
    assert mesh.local_shards(("pod",)) == [0, 1]
    assert mesh.home == CPU
