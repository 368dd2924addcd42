"""The port's replay checkpoints (``repro_torch.train.replay_checkpoint``)
against the reference's.

Counterpart of ``tests/test_replay_checkpoint.py`` and of the frame
store's checkpoint cases in ``tests/test_frame_store.py``: every
registry sampler's state round-trips bit for bit with the hidden
exact-resume state (stamps, generations, add counter, ``max_priority``,
ring position, the n-step window), delta saves driven by ``replay_dirty``
restore exactly (across a wrapping arc, the int32 counter's rollover and
a whole lap), and a sharded table restores onto fewer shards with equal
priorities, CSP membership and materialized batches.  Cross-package: a
replay checkpoint of either package, dense or from 8 reference shards,
restores in the other equal to the other's state, and a wrong sampler
kind or horizon raises the reference's diff word for word.  Reference
meshes are ``jax.sharding.Mesh`` over the forced host devices, built
directly (ROADMAP C2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.core import replay_buffer as jrb
from repro.core import samplers as jsamplers
from repro.train import checkpoint as jck
from repro.train import replay_checkpoint as jrck
from repro_torch import interop, prng
from repro_torch.core import sharded as tsharded
from repro_torch.core.replay_buffer import FrameStore, ReplayBuffer
from repro_torch.core.samplers import abstract_state, make_sampler
from repro_torch.distributed.sharding import Mesh
from repro_torch.train import checkpoint as ck
from repro_torch.train import replay_checkpoint as rck

CAP = 512
EX = {"obs": torch.zeros(4), "reward": torch.tensor(0.0)}
JEX = {"obs": jnp.zeros(4), "reward": jnp.float32(0)}
KINDS = ["uniform", "per-sumtree", "per-cumsum", "amper-k", "amper-fr"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return torch.equal(a, b)
    return type(a) is type(b) and a == b


def assert_same(a, b):
    na, la = ck._flatten_with_names(a)
    nb, lb = ck._flatten_with_names(b)
    assert na == nb
    for name, x, y in zip(na, la, lb):
        assert same_bits(x, y), name


def _sampler(kind, cap=CAP, **kw):
    return make_sampler(kind, cap, device="cpu", v_max=8.0, min_csp=64, **kw)


def _populated(rb, seed=0, rounds=5, rows=200):
    """add / sample / priority-update cycles, the ring wrapped, so every
    piece of hidden state is non-trivial."""
    st = rb.init(EX)
    rng = np.random.default_rng(seed)
    for i in range(rounds):
        st = rb.add_batch(st, {
            "obs": torch.from_numpy(rng.standard_normal((rows, 4))
                                    .astype(np.float32)),
            "reward": torch.arange(rows, dtype=torch.float32)})
        idx, _, _ = rb.sample(st, prng.key(100 + i), 32)
        st = rb.update_priorities(st, idx, torch.from_numpy(
            rng.standard_normal(32).astype(np.float32)))
    return st


@pytest.mark.parametrize("kind", KINDS)
def test_replay_state_roundtrips_bitwise(kind, tmp_path):
    rb = ReplayBuffer(CAP, _sampler(kind))
    st = _populated(rb)
    rck.save_replay(str(tmp_path), 7, st, meta={"sampler": kind})
    out = rck.restore_replay(str(tmp_path), 7, rb, EX)
    assert_same(st, out)
    assert (out.pos, out.size, out.total_adds) == (st.pos, st.size,
                                                   st.total_adds)
    assert isinstance(out.pos, int) and out.pos == 1000 % CAP
    assert float(out.max_priority) == float(st.max_priority)
    assert ck.load_meta(str(tmp_path), 7)["sampler"] == kind


@pytest.mark.parametrize("kind", KINDS + ["amper-fr-sharded", "per-sharded"])
def test_abstract_state_matches_init_and_the_reference(kind):
    """Names, shapes and dtypes of ``init`` on the meta device (a sharded
    kind's dense view), equal to the reference's ``eval_shape``."""
    mesh = Mesh([CPU] * 4)
    s = make_sampler(kind, 64, device="cpu", v_max=8.0, mesh=mesh)
    abstract = abstract_state(s)
    names, leaves = ck._flatten_with_names(abstract)
    assert all(x.device.type == "meta" for x in leaves)
    init = s.init()
    if hasattr(s, "to_dense"):
        init = s.to_dense(init)
    n_init, l_init = ck._flatten_with_names(init)
    assert names == n_init
    for a, b in zip(leaves, l_init):
        assert a.shape == b.shape and a.dtype == b.dtype
    jmesh = JMesh(np.asarray(jax.devices()[:4]), ("data",))
    js = jsamplers.make_sampler(kind, 64, v_max=8.0, mesh=jmesh,
                                axis_names=("data",))
    jnames = jck._flatten_with_names(jsamplers.abstract_state(js))[0]
    jleaves = jax.tree.leaves(jsamplers.abstract_state(js))
    assert names == jnames
    assert [ck._leaf_dtype_name(x) for x in leaves] == \
        [np.dtype(x.dtype).name for x in jleaves]
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in jleaves]


def test_wrong_sampler_restore_raises_the_reference_diff(tmp_path):
    rb = ReplayBuffer(CAP, _sampler("per-sumtree"))
    rck.save_replay(str(tmp_path), 1, _populated(rb))
    with pytest.raises(ValueError) as mine:
        rck.restore_replay(str(tmp_path), 1,
                           ReplayBuffer(CAP, _sampler("amper-fr")), EX)
    jrb2 = jrb.ReplayBuffer(CAP, jsamplers.make_sampler("amper-fr", CAP,
                                                        v_max=8.0))
    with pytest.raises(ValueError) as theirs:
        jrck.restore_replay(str(tmp_path), 1, jrb2, JEX)
    assert str(mine.value) == str(theirs.value)
    assert "does not match" in str(mine.value)


# --- exact dirty sets / incremental saves ------------------------------------


@pytest.mark.parametrize("kind", ["uniform", "per-cumsum", "amper-fr"])
def test_replay_dirty_delta_roundtrips_bitwise(kind, tmp_path):
    """Delta saves from replay_marks / replay_dirty restore equal to a
    full dump, across a wrapping arc and priority-feedback rows."""
    cap = 16
    rb = ReplayBuffer(cap, _sampler(kind, cap, csp_capacity=4))
    st = rb.init(EX)
    rng = np.random.default_rng(3)
    st = rb.add_batch(st, {"obs": torch.from_numpy(
        rng.standard_normal((12, 4)).astype(np.float32)),
        "reward": torch.arange(12, dtype=torch.float32)})
    rck.save_replay(str(tmp_path), 1, st)  # legacy full base
    marks = rck.replay_marks(st)
    assert marks == {"pos": 12, "total_adds": 12, "add_gen": 0}
    st = rb.add_batch(st, {"obs": torch.from_numpy(
        rng.standard_normal((9, 4)).astype(np.float32)),
        "reward": torch.ones(9)})
    st = rb.update_priorities(st, torch.tensor([6, 7, 10]),
                              torch.tensor([0.5, 2.0, 1.5]))
    dirty = rck.replay_dirty(rb, st, marks, priority_rows=[6, 7, 10])
    ck.save_incremental(str(tmp_path), 2, st, base_step=1, dirty=dirty)
    assert_same(st, rck.restore_replay(str(tmp_path), 2, rb, EX))
    # the reference replays the port's chain to the same table
    jbuf = jrb.ReplayBuffer(cap, jsamplers.make_sampler(
        kind, cap, v_max=8.0, min_csp=64, csp_capacity=4))
    jout = jrck.restore_replay(str(tmp_path), 2, jbuf, JEX)
    for a, b in zip(jax.tree.leaves(jout),
                    jax.tree.leaves(interop.replay_state_to_numpy(st))):
        np.testing.assert_array_equal(np.asarray(a), b)


def _storage_spec(dirty):
    return ck._flatten_with_names(dirty.storage)[1][0]


def test_replay_dirty_full_wrap_is_whole_ring():
    cap = 8
    rb = ReplayBuffer(cap, _sampler("per-cumsum", cap))
    st = rb.init(EX)
    for _ in range(4):
        st = rb.add_batch(st, {"obs": torch.zeros(5, 4),
                               "reward": torch.zeros(5)})
    dirty = rck.replay_dirty(rb, st, {"pos": 4, "total_adds": 4})
    assert _storage_spec(dirty).ranges == [(0, cap)]


def test_replay_dirty_wrap_safe_across_int32_rollover():
    cap = 16
    rb = ReplayBuffer(cap, _sampler("per-cumsum", cap))
    st = rb.init(EX)._replace(pos=5, size=cap, total_adds=-(2 ** 31) + 6,
                              add_gen=1)
    marks = {"pos": 12, "total_adds": (2 ** 31 - 3) & 0xFFFFFFFF,
             "add_gen": 0}
    assert _storage_spec(rck.replay_dirty(rb, st, marks)).ranges == \
        [(12, cap), (0, 5)]


def test_replay_dirty_full_lap_detected_by_generation():
    cap = 16
    rb = ReplayBuffer(cap, _sampler("per-cumsum", cap))
    st = rb.init(EX)._replace(pos=3, size=cap, total_adds=77, add_gen=1)
    marks = {"pos": 3, "total_adds": 77, "add_gen": 0}
    assert _storage_spec(rck.replay_dirty(rb, st, marks)).ranges == \
        [(0, cap)]


def test_replay_dirty_no_writes_skips_storage(tmp_path):
    cap = 16
    rb = ReplayBuffer(cap, _sampler("uniform", cap))
    st = rb.add_batch(rb.init(EX), {"obs": torch.zeros(4, 4),
                                    "reward": torch.zeros(4)})
    rck.save_replay(str(tmp_path), 1, st)
    dirty = rck.replay_dirty(rb, st, rck.replay_marks(st))
    ck.save_incremental(str(tmp_path), 2, st, base_step=1, dirty=dirty)
    man = ck.load_manifest(str(tmp_path), 2)
    assert man["delta"][man["names"].index("storage/obs")] is None
    assert_same(st, rck.restore_replay(str(tmp_path), 2, rb, EX))


# --- n-step accumulator state ------------------------------------------------

NEX = {"obs": torch.zeros(4), "action": torch.tensor(0, dtype=torch.int32),
       "reward": torch.tensor(0.0), "next_obs": torch.zeros(4),
       "done": torch.tensor(0.0)}


@pytest.mark.parametrize("kind", ["per-cumsum", "amper-fr"])
def test_nstep_replay_state_roundtrips_bitwise(kind, tmp_path):
    """The n-step window (ring, saturated count, cursor) round-trips, and
    the restored accumulator keeps emitting the same stream."""
    n_envs = 4
    rb = ReplayBuffer(CAP, _sampler(kind), n_step=3, gamma=0.97,
                      num_envs=n_envs)
    st = rb.init(NEX)
    rng = np.random.default_rng(0)
    for i in range(7):
        st = rb.add_batch(st, {
            "obs": torch.from_numpy(rng.standard_normal((n_envs, 4))
                                    .astype(np.float32)),
            "action": torch.full((n_envs,), i % 2, dtype=torch.int32),
            "reward": torch.arange(n_envs, dtype=torch.float32) + i,
            "next_obs": torch.from_numpy(rng.standard_normal((n_envs, 4))
                                         .astype(np.float32)),
            "done": (torch.arange(n_envs) == i % n_envs).float()})
    assert (st.nstep.count, st.nstep.pos) == (3, 7 % 3)
    rck.save_replay(str(tmp_path), 4, st, meta={"sampler": kind})
    out = rck.restore_replay(str(tmp_path), 4, rb, NEX)
    assert_same(st, out)
    assert (out.nstep.count, out.nstep.pos) == (3, 1)
    nxt = {"obs": torch.ones(n_envs, 4),
           "action": torch.zeros(n_envs, dtype=torch.int32),
           "reward": torch.ones(n_envs), "next_obs": torch.ones(n_envs, 4),
           "done": torch.zeros(n_envs)}
    a = rb.add_batch(rck.restore_replay(str(tmp_path), 4, rb, NEX), nxt)
    assert_same(a, rb.add_batch(out, nxt))


def test_nstep_restore_into_wrong_horizon_raises_the_reference_diff(
        tmp_path):
    rb3 = ReplayBuffer(CAP, _sampler("per-cumsum"), n_step=3, num_envs=2)
    st = rb3.init(NEX)
    for _ in range(4):
        st = rb3.add_batch(st, {k: torch.ones((2,) + tuple(v.shape),
                                              dtype=v.dtype)
                                for k, v in NEX.items()})
    rck.save_replay(str(tmp_path), 1, st)
    with pytest.raises(ValueError) as mine:
        rck.restore_replay(str(tmp_path), 1,
                           ReplayBuffer(CAP, _sampler("per-cumsum")), NEX)
    jex = {"obs": jnp.zeros(4), "action": jnp.int32(0),
           "reward": jnp.float32(0), "next_obs": jnp.zeros(4),
           "done": jnp.float32(0)}
    with pytest.raises(ValueError) as theirs:
        jrck.restore_replay(str(tmp_path), 1, jrb.ReplayBuffer(
            CAP, jsamplers.make_sampler("per-cumsum", CAP)), jex)
    assert str(mine.value) == str(theirs.value)


# --- cross-package replay checkpoints ----------------------------------------


def _jmesh(s):
    return JMesh(np.asarray(jax.devices()[:s]), ("data",))


def _jpopulated(jbuf, seed=0, rounds=3, rows=200):
    st = jbuf.init(JEX)
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        st = jbuf.add_batch(st, {
            "obs": jnp.asarray(rng.standard_normal((rows, 4)), jnp.float32),
            "reward": jnp.asarray(rng.standard_normal(rows), jnp.float32)})
        idx = jnp.asarray(rng.integers(0, CAP, 32), jnp.int32)
        st = jbuf.update_priorities(
            st, idx, jnp.asarray(rng.standard_normal(32), jnp.float32))
    return st


@pytest.mark.parametrize("kind,shards", [("amper-fr", 0), ("per-sumtree", 0),
                                         ("amper-fr-sharded", 8)])
def test_reference_replay_checkpoint_restores_in_the_port(tmp_path, kind,
                                                          shards):
    """A reference buffer (8 shards: its global table) restores into the
    port's buffer (2 shards) equal to ``replay_state_from_jax``."""
    kw = dict(mesh=_jmesh(shards), axis_names=("data",)) if shards else {}
    jbuf = jrb.ReplayBuffer(CAP, jsamplers.make_sampler(kind, CAP, v_max=8.0,
                                                        **kw))
    jst = _jpopulated(jbuf)
    jrck.save_replay(str(tmp_path), 3, jst)
    tkw = dict(mesh=Mesh([CPU] * 2), axis_names=("data",)) if shards else {}
    rb = ReplayBuffer(CAP, _sampler(kind, **tkw))
    out = rck.restore_replay(str(tmp_path), 3, rb, EX)
    want = interop.replay_state_from_jax(jax.tree.map(np.asarray, jst),
                                         device="cpu", sampler=rb.sampler)
    assert_same(want, out)
    assert out.sampler_state.__class__ is want.sampler_state.__class__


def test_port_replay_checkpoint_restores_in_the_reference(tmp_path):
    """A port buffer on 4 shards restores into the reference's dense
    amper-fr buffer, equal to ``replay_state_to_numpy``."""
    rb = ReplayBuffer(CAP, _sampler("amper-fr-sharded",
                                    mesh=Mesh([CPU] * 4)))
    st = _populated(rb, rounds=3)
    rck.save_replay(str(tmp_path), 2, st, rb=rb)
    jbuf = jrb.ReplayBuffer(CAP, jsamplers.make_sampler("amper-fr", CAP,
                                                        v_max=8.0))
    jout = jrck.restore_replay(str(tmp_path), 2, jbuf, JEX)
    want = interop.replay_state_to_numpy(st, rb.sampler)
    got = jax.tree_util.tree_flatten_with_path(jout)[0]
    assert [jck._path_key_str(p[-1]) for p, _ in got][-3:] == \
        ["total_adds", "write_gen", "add_gen"]
    for (_, a), b in zip(got, jax.tree.leaves(want)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="rb="):
        rck.save_replay(str(tmp_path), 3, st)


# --- elastic sharded restore -------------------------------------------------


def _sharded_rb(n_shards, frame_store=None, cap=CAP):
    s = make_sampler("amper-fr-sharded", cap, mesh=Mesh([CPU] * n_shards),
                     axis_names=("data",), device="cpu", v_max=8.0)
    return ReplayBuffer(cap, s, frame_store=frame_store)


@pytest.mark.parametrize("to_shards", [2, 1])
def test_sharded_restore_onto_fewer_shards(tmp_path, to_shards):
    """A table saved on 4 shards restores onto 2 (and 1) with equal
    priorities and CSP membership, and keeps training."""
    rb4 = _sharded_rb(4)
    st4 = _populated(rb4)
    rck.save_replay(str(tmp_path), 3, st4, rb=rb4)
    rb = _sharded_rb(to_shards)
    st = rck.restore_replay(str(tmp_path), 3, rb, EX)
    assert len(st.sampler_state.pq) == to_shards
    assert torch.equal(rb4.sampler.priorities(st4.sampler_state),
                       rb.sampler.priorities(st.sampler_state))
    assert torch.equal(rb4.sampler.membership(st4.sampler_state,
                                              prng.key(42)),
                       rb.sampler.membership(st.sampler_state, prng.key(42)))
    st = rb.add_batch(st, {"obs": torch.ones(32, 4),
                           "reward": torch.zeros(32)})
    idx, _, w = rb.sample(st, prng.key(9), 16)
    st = rb.update_priorities(st, idx, torch.ones(16))
    assert bool(torch.isfinite(w).all())


def test_sharded_to_single_device_restore(tmp_path):
    rb4 = _sharded_rb(4)
    st4 = _populated(rb4)
    rck.save_replay(str(tmp_path), 1, st4, rb=rb4)
    rb1 = ReplayBuffer(CAP, _sampler("amper-fr"))
    st1 = rck.restore_replay(str(tmp_path), 1, rb1, EX)
    assert torch.equal(rb4.sampler.priorities(st4.sampler_state),
                       rb1.sampler.priorities(st1.sampler_state))


def test_to_dense_inverts_from_dense():
    for kind in ("amper-fr-sharded", "per-sharded"):
        s = make_sampler(kind, 64, device="cpu", mesh=Mesh([CPU] * 4),
                         v_max=8.0)
        st = s.update(s.init(), torch.arange(0, 64, 3),
                      torch.linspace(0.1, 7.0, 22))
        dense = s.to_dense(st)
        again = s.from_dense(*dense)
        assert all(torch.equal(torch.cat(a), torch.cat(b))
                   for a, b in zip(st, again))
        assert torch.equal(s.priorities(st), s.priorities(again))


def test_repartition_moves_state_onto_mesh():
    rb2 = _sharded_rb(2)
    dense = _sampler("amper-fr").init()
    moved = tsharded.repartition(rb2.sampler, dense)
    assert len(moved.pq) == 2
    assert torch.equal(dense.pq, torch.cat(moved.pq))


# --- the uint8 frame store ---------------------------------------------------

HW = (5, 5)
PIX_EX = {"frame": torch.zeros(HW, dtype=torch.uint8),
          "action": torch.tensor(0, dtype=torch.int32),
          "reward": torch.tensor(0.0), "done": torch.tensor(0.0)}


def _pixel_rb(sampler):
    return ReplayBuffer(256, sampler, frame_store=FrameStore(
        history_len=4, frame_shape=HW, n_step=2))


def _pixel_fill(rb, seed, n=300):
    rng = np.random.default_rng(seed)
    st = rb.init(PIX_EX)
    for _ in range(n // 50):
        st = rb.add_batch(st, {
            "frame": torch.from_numpy(rng.integers(0, 256, (50,) + HW,
                                                   dtype=np.uint8)),
            "action": torch.from_numpy(rng.integers(0, 3, 50)
                                       .astype(np.int32)),
            "reward": torch.from_numpy(rng.standard_normal(50)
                                       .astype(np.float32)),
            "done": torch.from_numpy((rng.random(50) < 0.15)
                                     .astype(np.float32))})
    return st


def test_uint8_replay_checkpoint_roundtrips_bitwise(tmp_path):
    rb = _pixel_rb(_sampler("amper-fr", 256))
    st = _pixel_fill(rb, 11)
    idx, _, _ = rb.sample(st, prng.key(0), 32)
    st = rb.update_priorities(st, idx, torch.ones(32))
    rck.save_replay(str(tmp_path), 5, st)
    out = rck.restore_replay(str(tmp_path), 5, rb, PIX_EX)
    assert out.storage["frame"].dtype == torch.uint8
    assert_same(st, out)
    anchors = torch.arange(256)
    a, b = rb.materialize(st, anchors), rb.materialize(out, anchors)
    for k in a:
        assert same_bits(a[k], b[k]), k


@pytest.mark.parametrize("to_shards", [2, 1])
def test_uint8_elastic_restore_onto_fewer_shards(tmp_path, to_shards):
    """A pixel buffer saved on 4 shards restores onto 2 (and 1): uint8
    frames, stamps and priorities intact, the same CSP membership, and
    the same materialized batch at the same anchors."""
    fs = FrameStore(history_len=4, frame_shape=HW, n_step=2)
    rb4 = _sharded_rb(4, fs, cap=256)
    st4 = _pixel_fill(rb4, 13)
    rck.save_replay(str(tmp_path), 2, st4, rb=rb4)
    rb = _sharded_rb(to_shards, fs, cap=256)
    st = rck.restore_replay(str(tmp_path), 2, rb, PIX_EX)
    assert st.storage["frame"].dtype == torch.uint8
    assert torch.equal(st4.storage["frame"], st.storage["frame"])
    assert torch.equal(rb4.sampler.priorities(st4.sampler_state),
                       rb.sampler.priorities(st.sampler_state))
    assert torch.equal(rb4.sampler.membership(st4.sampler_state,
                                              prng.key(42)),
                       rb.sampler.membership(st.sampler_state, prng.key(42)))
    anchors = torch.arange(256)
    a, b = rb4.materialize(st4, anchors), rb.materialize(st, anchors)
    for k in ("obs", "next_obs", "reward", "done"):
        assert same_bits(a[k], b[k]), k
    idx, batch, w = rb.sample(st, prng.key(4), 64)
    st = rb.update_priorities(st, idx, torch.ones(64))
    assert bool(torch.isfinite(batch["obs"]).all())
    assert bool(torch.isfinite(w).all())
