"""The port's frame-deduplicated pixel store against the JAX reference.

Both packages take the same add stream (per-env episodes, ring
wraparound, warm-up, several lockstep envs, the int32 add counter across
its rollover).  The ring state (uint8 frames, stamps, generations,
counters) must agree bit for bit, and so must ``materialize`` and
``sample`` (indices, stacked ``obs`` / ``next_obs``, the sample-time
n-step return, ``done`` / ``terminated``) against the jitted reference:
the float work is one uint8 -> float multiply, a 0/1 mask and the n-step
sum in the jitted reference's rounding order.  The IS weights hold within
rtol 1e-6, as in ``test_torch_replay.py``: their pow rounds independently
in XLA and torch (one ulp).  The
reference's fused Pallas draw disagrees with its own jnp draw on this
jax (ROADMAP C1), so the port's five fr_modes, dense and on a port
``Mesh`` of 1, 2 and 4 shards, are held against the reference's
``broadcast`` draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.core import replay_buffer as jrb
from repro.core import samplers as jsamplers
from repro_torch import prng
from repro_torch.core import replay_buffer as trb
from repro_torch.core import samplers as tsamplers
from repro_torch.distributed.sharding import Mesh

HW = (5, 5)
FR_MODES = ("broadcast", "interval", "window", "kernel", "fused")


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _stream(seed, n_envs, n_steps, p_done=0.15):
    """Per-env episode streams in global add order: row ``t`` is env
    ``t % n_envs`` at lockstep step ``t // n_envs``."""
    rng = np.random.default_rng(seed)
    t = n_envs * n_steps
    return {"frame": rng.integers(0, 256, size=(t,) + HW, dtype=np.uint8),
            "action": rng.integers(0, 3, size=t).astype(np.int32),
            "reward": rng.standard_normal(t).astype(np.float32),
            "done": (rng.random(t) < p_done).astype(np.float32)}


EXAMPLE = {"frame": np.zeros(HW, np.uint8), "action": np.int32(0),
           "reward": np.float32(0), "done": np.float32(0)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _buffers(cap, fs_kw, jsampler=None, tsampler=None):
    """The reference's and the port's frame-store buffers (uniform
    samplers unless given)."""
    jb = jrb.ReplayBuffer(
        cap, jsampler or jsamplers.make_sampler("uniform", cap),
        frame_store=jrb.FrameStore(frame_shape=HW, **fs_kw))
    tb = trb.ReplayBuffer(
        cap, tsampler or tsamplers.make_sampler("uniform", cap, device="cpu"),
        frame_store=trb.FrameStore(frame_shape=HW, **fs_kw))
    return jb, tb


def _fill(jb, tb, hist, n_envs, start=0):
    """The same stream through both buffers, one lockstep step an arc;
    ``start`` sets the int32 add counter first."""
    js, ts = jb.init(EXAMPLE), tb.init(_t(EXAMPLE))
    js = js._replace(total_adds=jnp.int32(start))
    ts = ts._replace(total_adds=start)
    add = jax.jit(jb.add_batch)
    for v in range(len(hist["frame"]) // n_envs):
        rows = {k: x[v * n_envs:(v + 1) * n_envs] for k, x in hist.items()}
        js, ts = add(js, rows), tb.add_batch(ts, _t(rows))
    return js, ts


def _bits(a, b, what=""):
    """Equal bit for bit (a float -0.0 differs from 0.0)."""
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_ring(js, ts):
    js = jax.tree.map(np.asarray, js)
    for k in js.storage:
        _bits(js.storage[k], ts.storage[k], k)
    for k in ("write_stamp", "write_gen"):
        _bits(getattr(js, k), getattr(ts, k), k)
    assert (int(js.pos), int(js.size), int(js.total_adds), int(js.add_gen)) \
        == (ts.pos, ts.size, ts.total_adds, ts.add_gen)


CASES = [  # cap, history_len, n_envs, n_step, steps, first add counter
    pytest.param(32, 4, 1, 1, 50, 0, id="wraparound"),
    pytest.param(32, 4, 1, 1, 10, 0, id="warm-up"),
    pytest.param(48, 3, 1, 3, 70, 0, id="nstep3-across-the-wrap"),
    pytest.param(40, 4, 2, 2, 18, 0, id="two-envs-nstep2"),
    pytest.param(64, 2, 4, 1, 40, 0, id="stride4-two-laps"),
    pytest.param(48, 4, 2, 3, 40, 2 ** 31 - 37, id="int32-stamp-wrap"),
]


@pytest.mark.parametrize("cap,hist_len,n_envs,n_step,steps,start", CASES)
def test_materialize_bit_exact_vs_jitted_reference(cap, hist_len, n_envs,
                                                   n_step, steps, start):
    fs_kw = dict(history_len=hist_len, stride=n_envs, n_step=n_step,
                 gamma=0.9)
    jb, tb = _buffers(cap, fs_kw)
    hist = _stream(7 * cap + hist_len, n_envs, steps)
    js, ts = _fill(jb, tb, hist, n_envs, start)
    _same_ring(js, ts)
    if start:
        assert ts.add_gen == 1      # the counter rolled over in the stream
    want = jax.jit(jb.materialize)(js, jnp.arange(cap))
    got = tb.materialize(ts, torch.arange(cap))
    assert sorted(got) == sorted(want)
    for k in want:
        _bits(want[k], got[k], k)
    assert got["obs"].shape == (cap,) + HW + (hist_len,)
    assert bool((got["obs"][:, ..., -1] > 0).any())


@pytest.mark.parametrize("kind,fr_mode", [("uniform", None),
                                          ("amper-fr", "broadcast"),
                                          ("amper-fr", "fused")])
@pytest.mark.parametrize("n_step", [1, 3])
def test_sample_bit_exact_vs_jitted_reference(kind, fr_mode, n_step):
    """Indices, the materialized batch and the IS weights of ``sample``,
    before and after a priority update, with the n-step return."""
    cap = 128
    kw = dict(v_max=8.0, min_csp=16)
    jb, tb = _buffers(
        cap, dict(history_len=4, stride=2, n_step=n_step, gamma=0.99),
        jsamplers.make_sampler(kind, cap, **kw),
        tsamplers.make_sampler(kind, cap, device="cpu",
                               **(kw | ({"fr_mode": fr_mode} if fr_mode
                                        else {}))))
    js, ts = _fill(jb, tb, _stream(5, 2, 90), 2)
    # alpha = 1 keeps the priority of a TD error the same in both
    # packages (a pow rounds independently), so the tables stay equal
    jb.alpha = tb.alpha = 1.0
    jsample = jax.jit(lambda s, k: jb.sample(s, k, 32, beta=0.7))
    jupdate = jax.jit(jb.update_priorities)
    rng = np.random.default_rng(1)
    for seed in range(3):
        jidx, jbatch, jw = jsample(js, jax.random.key(seed))
        tidx, tbatch, tw = tb.sample(ts, prng.key(seed), 32, beta=0.7)
        _bits(jidx, tidx, "idx")
        for k in jbatch:
            _bits(jbatch[k], tbatch[k], k)
        np.testing.assert_allclose(np.asarray(jw), tw.numpy(), rtol=1e-6)
        td = rng.standard_normal(32).astype(np.float32)
        js = jupdate(js, jidx, td)
        ts = tb.update_priorities(ts, tidx, torch.from_numpy(td))


def test_episode_boundary_zero_pads_like_a_flat_buffer():
    """A stack whose chain crosses a ``done`` row zeroes every older
    frame: the padding a float buffer records at an episode start."""
    jb, tb = _buffers(32, dict(history_len=4))
    hist = _stream(3, 1, 12, p_done=0.0)
    hist["done"][5] = 1.0                      # one episode cut at t = 5
    js, ts = _fill(jb, tb, hist, 1)
    got = tb.materialize(ts, torch.arange(32))
    scale = np.float32(1.0 / 255.0)
    expect = np.stack([np.zeros(HW, np.float32), np.zeros(HW, np.float32),
                       hist["frame"][6].astype(np.float32) * scale,
                       hist["frame"][7].astype(np.float32) * scale], -1)
    np.testing.assert_array_equal(got["obs"][7].numpy(), expect)
    assert bool((got["obs"][5] != 0).any(0).any(0).all())  # full history
    # the done row's own window ends the episode: terminal, no next_obs
    assert float(got["terminated"][4]) == 0.0
    assert float(got["terminated"][5]) == 1.0
    assert not bool(got["next_obs"][5].any())
    want = jax.jit(jb.materialize)(js, jnp.arange(32))
    for k in want:
        _bits(want[k], got[k], k)


def test_frame_store_config_and_schema_errors():
    uni = tsamplers.make_sampler("uniform", 64, device="cpu")
    with pytest.raises(ValueError, match="n_step=1"):
        trb.ReplayBuffer(64, uni, n_step=3,
                         frame_store=trb.FrameStore(4, HW))
    with pytest.raises(ValueError, match="capacity"):
        trb.ReplayBuffer(16, tsamplers.make_sampler("uniform", 16,
                                                    device="cpu"),
                         frame_store=trb.FrameStore(8, HW, stride=2))
    for bad in (trb.FrameStore(0, HW), trb.FrameStore(4, HW, n_step=0),
                trb.FrameStore(4, HW, stride=0)):
        with pytest.raises(ValueError, match="invalid FrameStore"):
            trb.ReplayBuffer(64, uni, frame_store=bad)
    tb = trb.ReplayBuffer(64, uni, frame_store=trb.FrameStore(4, HW))
    with pytest.raises(ValueError, match="frame"):
        tb.init(_t({"obs": np.zeros(4, np.float32),
                    "reward": np.float32(0)}))
    with pytest.raises(ValueError, match="uint8"):
        tb.init(_t(EXAMPLE | {"frame": np.zeros(HW, np.float32)}))
    with pytest.raises(ValueError, match="frame_shape"):
        tb.init(_t(EXAMPLE | {"frame": np.zeros((4, 5), np.uint8)}))


def _jmesh(s):
    if jax.device_count() < s:
        pytest.skip(f"needs {s} host devices (tests/conftest.py forces 8)")
    return JMesh(np.asarray(jax.devices()[:s]), ("data",))


@pytest.mark.parametrize("shards", [0, 1, 2, 4], ids=lambda s: (
    "dense" if s == 0 else f"{s}-shard"))
def test_fr_modes_draw_bit_identical_materialized_batches(shards):
    """Every fr_mode of the port draws the reference's broadcast batch
    (indices and the materialized pixel batch bit for bit, IS weights
    within rtol 1e-6), and all five draw the same IS weights bit for
    bit."""
    cap = 512
    hist = _stream(17, 1, 600)
    fs_kw = dict(history_len=4, n_step=2)
    kw = dict(v_max=8.0)
    if shards:
        jsampler = jsamplers.make_sampler(
            "amper-fr-sharded", cap, mesh=_jmesh(shards),
            axis_names=("data",), **kw)
    else:
        jsampler = jsamplers.make_sampler("amper-fr", cap, **kw)
    jb = jrb.ReplayBuffer(cap, jsampler, frame_store=jrb.FrameStore(
        frame_shape=HW, **fs_kw))
    js = jb.init(EXAMPLE)
    add = jax.jit(jb.add_batch)
    for v in range(600):
        js = add(js, {k: x[v:v + 1] for k, x in hist.items()})
    jidx, jbatch, jw = jax.jit(lambda s, k: jb.sample(s, k, 64))(
        js, jax.random.key(23))
    for mode in FR_MODES:
        if shards:
            ts_ = tsamplers.make_sampler(
                "amper-fr-sharded", cap, mesh=Mesh([torch.device("cpu")]
                                                   * shards),
                axis_names=("data",), fr_mode=mode, device="cpu", **kw)
        else:
            ts_ = tsamplers.make_sampler("amper-fr", cap, fr_mode=mode,
                                         device="cpu", **kw)
        _, tb = _buffers(cap, fs_kw, jsampler, ts_)
        ts = tb.init(_t(EXAMPLE))
        for v in range(600):
            ts = tb.add_batch(ts, _t({k: x[v:v + 1] for k, x in hist.items()}))
        tidx, tbatch, tw = tb.sample(ts, prng.key(23), 64)
        _bits(jidx, tidx, f"{mode} idx")
        for k in jbatch:
            _bits(jbatch[k], tbatch[k], f"{mode} {k}")
        np.testing.assert_allclose(np.asarray(jw), tw.numpy(), rtol=1e-6)
        if mode == FR_MODES[0]:
            first_w = tw
        assert torch.equal(tw, first_w), mode
