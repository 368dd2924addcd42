"""The trainer's keys and schedules as tensors, and its captured step.

``train`` derives its step keys once on the agent's device and reads
epsilon, Adam's bias-corrected rate and beta from tables built once
(``DQN.schedules``); on a card its steady AMPER-fr fused step is
captured in a CUDA graph (``DQN.runner``).  On the CPU:

* the tables equal the reference's schedule expressions jitted one step
  at a time: epsilon bit for bit; Adam's rate and an annealed beta
  within one float32 ulp, because the port's expressions, which the
  tables keep as ``agent_step`` evaluates them, round otherwise than
  XLA (its ``pow`` for the rate; for beta, XLA fuses the multiply-add
  the port rounds twice);
* ``train`` (keys and tables as tensors, the fused draw through its
  plain version) equals the reference's jitted ``train`` over 60 steps:
  the ring's actions, flags and stamps, the live rows and the counters
  exactly; float rows, parameters and Adam moments within
  ``test_torch_dqn.py``'s rtol 1e-5 / atol 1e-6 (XLA and torch sum the
  matmuls in different orders), and so the quantized priorities within
  one code, as that module states;
* the runner's captured mode, whose body the graph would hold, run on
  the CPU without a graph, equals the eager runner and ``agent_step``
  on host keys bit for bit, across the ring's wrap and the target syncs.

On a card (marked ``cuda``, skipped here) the captured run is replayed
against the eager one on host keys.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl import dqn as jd
from repro_torch import interop, obs, prng
from repro_torch.kernels import ops
from repro_torch.models.qhead import tree_leaves
from repro_torch.rl import dqn as td
from test_torch_dqn import ATOL, RTOL

CFG = dict(env="cartpole", sampler="amper-fr", num_envs=4,
           replay_size=2000, batch=16, hidden=32, learn_start=20,
           target_sync=25, eps_decay_steps=100, beta_end=1.0)
STEPS = 60


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _bits(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    return (x.view(torch.int32) if x.dtype == torch.float32 else x).numpy()


@pytest.mark.parametrize("kw", [
    {}, {"beta_end": None}, {"beta_anneal_steps": 40, "lr": 3e-4},
    {"eps_decay_steps": 40, "eps_end": 0.05}],
    ids=["annealed", "constant-beta", "horizon-lr", "short-decay"])
def test_schedule_tables_equal_reference_jitted(kw):
    cfg = {**CFG, **kw}
    jcfg = jd.DQNConfig(**cfg)
    jdq = jd.make_dqn(jcfg)
    tab = td.make_dqn(td.DQNConfig(**cfg), device="cpu").schedules(STEPS)

    @jax.jit
    def eps(step):  # the reference's act
        return jnp.clip(jcfg.eps_start + (jcfg.eps_end - jcfg.eps_start)
                        * step / jcfg.eps_decay_steps, jcfg.eps_end,
                        jcfg.eps_start)

    @jax.jit
    def lr(step):  # the reference's adam
        c = step.astype(jnp.float32) + 1
        return jcfg.lr * jnp.sqrt(1 - 0.999 ** c) / (1 - 0.9 ** c)

    beta = jax.jit(lambda step: jnp.float32(jdq.beta_at(step)))
    for name, fn in (("eps", eps), ("lr", lr), ("beta", beta)):
        want = np.stack([np.asarray(fn(jnp.int32(t)), np.float32)
                         for t in range(STEPS)])
        got = getattr(tab, name)
        assert got.dtype == torch.float32 and got.shape == (STEPS,)
        if name == "eps":
            np.testing.assert_array_equal(want.view(np.int32), _bits(got),
                                          err_msg=name)
        else:
            np.testing.assert_array_max_ulp(want, got.numpy(), maxulp=1)
    np.testing.assert_array_equal(np.asarray(tab.beta_host, np.float32),
                                  tab.beta.numpy())


def test_train_with_tensor_keys_and_tables_equals_reference_train():
    jdq = jd.make_dqn(jd.DQNConfig(**CFG))
    tdq = td.make_dqn(td.DQNConfig(**CFG, amper_fr_mode="fused"),
                      device="cpu")
    jst, jm = jdq.train(jax.random.key(3), STEPS)
    tst, tm = tdq.train(prng.key(3), STEPS)
    want = interop.agent_state_from_jax(jax.tree.map(np.asarray, jst),
                                        device="cpu")
    assert tst.step == want.step == STEPS
    for f in ("pos", "size", "total_adds", "add_gen"):
        assert getattr(tst.buffer, f) == getattr(want.buffer, f), f
    for f in want.buffer.storage:
        got, exp = tst.buffer.storage[f], want.buffer.storage[f]
        if got.dtype == torch.float32 and f != "action":
            np.testing.assert_allclose(exp.numpy(), got.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f)
        else:
            np.testing.assert_array_equal(exp.numpy(), got.numpy(), f)
    pq, valid = want.buffer.sampler_state
    tpq, tvalid = tst.buffer.sampler_state
    np.testing.assert_array_equal(valid.numpy(), tvalid.numpy())
    assert int((pq.long() - tpq.long()).abs().max()) <= 1
    for x, y in ((want.buffer.write_stamp, tst.buffer.write_stamp),
                 (want.buffer.write_gen, tst.buffer.write_gen),
                 (want.n_episodes, tst.n_episodes)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    for f in ("params", "target_params", "opt_m", "opt_v"):
        for x, y in zip(tree_leaves(getattr(want, f)),
                        tree_leaves(getattr(tst, f))):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f)
    np.testing.assert_array_max_ulp(np.asarray(jm["beta"], np.float32),
                                    np.asarray(tm["beta"], np.float32), 1)
    np.testing.assert_allclose(np.asarray(jm["return_mean"]),
                               torch.stack(tm["return_mean"]).numpy(),
                               rtol=RTOL, atol=ATOL)


def _same_state(a, b):
    for f in ("params", "target_params", "opt_m", "opt_v"):
        for x, y in zip(tree_leaves(getattr(a, f)),
                        tree_leaves(getattr(b, f))):
            np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=f)
    for f in a.buffer.storage:
        np.testing.assert_array_equal(_bits(a.buffer.storage[f]),
                                      _bits(b.buffer.storage[f]), f)
    for x, y in zip(a.buffer.sampler_state, b.buffer.sampler_state):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    for x, y in ((a.buffer.write_stamp, b.buffer.write_stamp),
                 (a.buffer.write_gen, b.buffer.write_gen),
                 (a.buffer.max_priority, b.buffer.max_priority),
                 (a.env_state.x, b.env_state.x),
                 (a.env_state.t, b.env_state.t),
                 (a.obs, b.obs), (a.episode_return, b.episode_return),
                 (a.last_returns, b.last_returns),
                 (a.n_episodes, b.n_episodes)):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    for f in ("pos", "size", "total_adds", "add_gen"):
        assert getattr(a.buffer, f) == getattr(b.buffer, f), f
        assert isinstance(getattr(a.buffer, f), int), f
    assert a.step == b.step


@pytest.mark.parametrize("replay,steps", [(2000, 90), (150, 120)],
                         ids=["ring", "ring-wraps"])
def test_static_body_equals_eager_runner_and_agent_step(replay, steps):
    """The captured mode's static buffers, card counters and per-step
    tables, run through the graph's body on the CPU, against the eager
    runner and against ``agent_step`` on host keys: every step's rows,
    losses and returns, and the final state, bit for bit."""
    cfg = td.DQNConfig(**{**CFG, "replay_size": replay},
                       amper_fr_mode="fused")
    dqn = td.make_dqn(cfg, device="cpu")
    key = prng.key(9)
    runs = {}
    for capture in (True, False):
        r = dqn.runner(dqn.init(key), key, steps, capture=capture,
                       record_idx=True)
        runs[capture] = (r.advance(steps), r.metrics, r.idx, r.info)
    st, idx, beta = dqn.init(key), [], []
    for k in prng.split(prng.fold_in(key, 1), steps):
        st, m = dqn.agent_step(st, k)
        idx.append(m["idx"])
        beta.append(m["beta"])
    (a, ma, ia, info), (b, mb, ib, _) = runs[True], runs[False]
    assert not info["captured"] and info["graph_replays"] == 0  # no graph
    _same_state(a, b)
    _same_state(a, st)
    for x, y, z in zip(ia, ib, idx):
        assert (x is None) == (y is None) == (z is None)
        if x is not None:
            assert torch.equal(x, y) and torch.equal(x, z)
    assert sum(x is not None for x in ia) == steps - cfg.learn_start
    for f in ("loss", "return_mean"):
        np.testing.assert_array_equal(_bits(torch.stack(ma[f])),
                                      _bits(torch.stack(mb[f])))
    assert ma["beta"] == mb["beta"] == beta


def test_runner_continues_and_refuses_other_paths():
    """A runner advanced in pieces equals one advanced at once; capture
    is refused where no steady step can be captured."""
    cfg = td.DQNConfig(**CFG, amper_fr_mode="fused")
    dqn = td.make_dqn(cfg, device="cpu")
    key = prng.key(4)
    whole = dqn.runner(dqn.init(key), key, 70, capture=True)
    whole.advance(70)
    parts = dqn.runner(dqn.init(key), key, 70, capture=True)
    for stop in (10, 21, 26, 50, 70):
        parts.advance(stop)
    _same_state(whole.state, parts.state)
    assert len(parts.metrics["loss"]) == 70
    for kw in ({"amper_fr_mode": "kernel"}, {"n_step": 3},
               {"env": "breakout", "amper_fr_mode": "fused"}):
        other = td.make_dqn(dataclasses.replace(cfg, **kw), device="cpu")
        with pytest.raises(ValueError, match="capture needs"):
            other.runner(other.init(key), key, 10, capture=True)


@pytest.mark.parametrize("capture", [True, False], ids=["static", "eager"])
def test_runner_spans_count_its_steps(capture):
    """With a registry the runner logs one ``runner_advance`` an advance
    (its ``steps`` attribute), one ``steady_step`` or ``eager_step`` a
    step, a ``priority_write`` of ``num_envs`` rows a step (the ring's
    inserts), and a ``replay_sample`` and a ``priority_write`` of
    ``batch`` rows a learn step on the CPU; and it runs bit for bit as
    it does untraced."""
    cfg = td.DQNConfig(**CFG, amper_fr_mode="fused")
    dqn = td.make_dqn(cfg, device="cpu")
    key, stops = prng.key(6), (10, 21, 26, 50, 70)
    plain = dqn.runner(dqn.init(key), key, 70, capture=capture,
                       record_idx=True)
    traced = dqn.runner(dqn.init(key), key, 70, capture=capture,
                        record_idx=True)
    reg = obs.Registry()
    for stop in stops:
        plain.advance(stop)
        with obs.use_registry(reg):
            traced.advance(stop)
    _same_state(plain.state, traced.state)
    for x, y in zip(plain.idx, traced.idx):
        assert (x is None and y is None) or torch.equal(x, y)
    spans = reg.spans()
    names = [s.name for s in spans]
    adv = [s for s in spans if s.name == "runner_advance"]
    assert [s.attrs["steps"] for s in adv] == [
        b - a for a, b in zip((0,) + stops, stops)]
    steady, eager = names.count("steady_step"), names.count("eager_step")
    assert steady + eager == 70
    learn = 70 - cfg.learn_start
    syncs = sum(1 for t in range(cfg.learn_start, 70)
                if t % cfg.target_sync == 0)
    assert steady == (learn - syncs if capture else 0)
    assert eager == traced.info["eager_steps"]
    assert names.count("replay_sample") == learn
    assert "learn" not in names  # the TD step has no span of its own
    rows = [s.attrs["rows"] for s in spans if s.name == "priority_write"]
    assert (rows.count(cfg.num_envs), rows.count(cfg.batch)) == (70, learn)
    # every step span sits inside an advance, and its draw inside it
    ids = {s.id: s for s in spans}
    for s in spans:
        if s.name in ("steady_step", "eager_step"):
            assert ids[s.parent].name == "runner_advance"
        if s.name in ("replay_sample", "priority_write"):
            assert ids[s.parent].name in ("steady_step", "eager_step")
    for s in adv:
        kids = [c for c in spans if c.parent == s.id]
        assert s.self_ns == (s.host_end_ns - s.host_start_ns) - sum(
            c.host_end_ns - c.host_start_ns for c in kids)


def test_capture_defaults_off_without_a_card():
    cfg = td.DQNConfig(**CFG, amper_fr_mode="fused")
    dqn = td.make_dqn(cfg, device="cpu")
    r = dqn.runner(dqn.init(prng.key(0)), prng.key(0), 5)
    assert not r.capture
    r.advance(5)
    assert r.info["eager_steps"] == 5 and not r.info["captured"]


@pytest.mark.cuda
def test_cuda_captured_step_replays_equal_the_eager_step():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graph and the kernels "
                    "have no CPU mode")
    cfg = td.DQNConfig(**{**CFG, "num_envs": 16, "replay_size": 100_000,
                          "batch": 64, "hidden": 128, "learn_start": 100,
                          "target_sync": 100}, amper_fr_mode="fused")
    dqn = td.make_dqn(cfg, device="cuda")
    key, n = prng.key(5), 300
    r = dqn.runner(dqn.init(key), key, n, record_idx=True)
    ops.reset_launches()
    a = r.advance(n)
    assert r.info["captured"] and r.info["graph_replays"] > 150
    # a replay counts the launches its graph holds: one draw a learn step
    assert r.info["replay_launches"]["amper_sample"] == 1
    assert ops.launches["amper_sample"] == n - cfg.learn_start
    st, idx = dqn.init(key), []
    for k in prng.split(prng.fold_in(key, 1), n):
        st, m = dqn.agent_step(st, k)
        idx.append(m["idx"])
    _same_state(a, st)
    for x, z in zip(r.idx, idx):
        assert (x is None) == (z is None)
        assert x is None or torch.equal(x, z)


def test_launch_counters_count_replays_not_captures():
    """A launch outside a capture counts in ``launches``; a graph's
    replay adds the launches its capture recorded (``ops.replayed``)."""
    saved = dict(ops.launches), dict(ops.recorded)
    try:
        ops.reset_launches()
        ops._launched("prng")
        assert ops.launches["prng"] == 1 and ops.recorded == saved[1]
        ops.replayed({"amper_sample": 1, "prng": 10})
        ops.replayed({"amper_sample": 1, "prng": 10})
        assert (ops.launches["amper_sample"], ops.launches["prng"]) == (2, 21)
    finally:
        ops.launches.update(saved[0])
        ops.recorded.update(saved[1])
