"""The port's envs against the JAX reference.

Acrobot and MountainCar: each step starts both packages from the
reference's state, so a one-ulp difference (XLA's ``sin``/``cos`` are
not torch's) is measured over one step and does not grow: Acrobot is
chaotic.  Observations and states must agree within rtol 1e-5 /
atol 1e-6; ``done``, ``terminated``, the episode clocks, rewards and the
auto-reset states exactly.  Breakout and Freeway compute in small
integers held in float32, so their states, uint8 frames and signals must
agree exactly over whole runs.  The golden trajectories of
``tests/golden/envs.json`` hold all five envs under
``test_env_golden.py``'s tolerances.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.rl import envs as jenvs
from repro_torch import prng
from repro_torch.rl import envs as tenvs

RTOL, ATOL = 1e-5, 1e-6
FLAT = ("cartpole", "acrobot", "mountaincar")
PIXEL = ("breakout", "freeway")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "envs.json")


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=RTOL,
                               atol=ATOL)


def _state(js) -> tenvs.EnvState:
    return tenvs.EnvState(x=torch.from_numpy(np.array(js.x)),
                          t=torch.from_numpy(np.array(js.t)))


@pytest.mark.parametrize("name", ["acrobot", "mountaincar"])
def test_vector_env_matches_reference(name):
    n = 8
    jv = jenvs.VectorEnv(jenvs.make_env(name), n)
    tv = tenvs.VectorEnv(tenvs.make_env(name), n, device="cpu")
    js = jv.reset(jax.random.key(0))
    ts = tv.reset(prng.key(0))
    np.testing.assert_array_equal(np.asarray(js.x), ts.x.numpy())  # exact
    _close(jv.obs(js), tv.obs(ts))
    # a third of the envs start two steps before the time limit, so the
    # run holds auto-resets too
    js = js._replace(t=js.t.at[::3].set(jv.env.max_steps - 2))
    step = jax.jit(jv.step)
    keys = jax.random.split(jax.random.key(1), 60)
    tkeys = prng.split(prng.key(1), 60)
    actions = np.random.default_rng(0).integers(
        0, tv.n_actions, (60, n)).astype(np.int32)
    for i in range(60):
        js_next, jobs, jr, jdone, jterm = step(js, actions[i], keys[i])
        ts, tobs, tr, tdone, tterm = tv.step(
            _state(js), torch.from_numpy(actions[i]), tkeys[i])
        _close(jobs, tobs)
        _close(js_next.x, ts.x)
        np.testing.assert_array_equal(np.asarray(jdone), tdone.numpy())
        np.testing.assert_array_equal(np.asarray(jterm), tterm.numpy())
        np.testing.assert_array_equal(np.asarray(js_next.t), ts.t.numpy())
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        assert tobs.dtype == tr.dtype == torch.float32
        assert tdone.dtype == tterm.dtype == torch.bool
        # an auto-reset state is a fresh draw: bit for bit
        d = np.asarray(jdone)
        np.testing.assert_array_equal(np.asarray(js_next.x)[d],
                                      ts.x.numpy()[d])
        js = js_next


def _golden_start(name, reset_obs):
    """The physics state behind a golden reset observation (the golden
    file was written under jax's older threefry layout, whose reset draw
    the port does not reproduce)."""
    obs = np.asarray(reset_obs, np.float64)
    if name == "acrobot":
        x = [np.arctan2(obs[1], obs[0]), np.arctan2(obs[3], obs[2]),
             obs[4], obs[5]]
    else:
        x = obs
    return tenvs.EnvState(x=torch.tensor(np.asarray(x, np.float32)),
                          t=torch.tensor(0, dtype=torch.int32))


@pytest.mark.parametrize("name", FLAT)
def test_env_matches_golden_trajectory(name):
    with open(GOLDEN) as f:
        fx = json.load(f)[name]
    env = tenvs.make_env(name)
    state = _golden_start(name, fx["reset_obs"])
    np.testing.assert_allclose(env.obs(state).numpy(), fx["reset_obs"],
                               rtol=1e-6, atol=1e-6)
    for t, a in enumerate(fx["actions"]):
        state, obs, r, d, _ = env.step(
            state, torch.tensor(a, dtype=torch.int32),
            prng.fold_in(prng.key(1), t))
        np.testing.assert_allclose(obs.numpy(), fx["obs"][t], rtol=1e-5,
                                   atol=1e-6, err_msg=f"{name} step {t}")
        assert float(r) == pytest.approx(fx["reward"][t], abs=1e-6)
        assert bool(d) == fx["done"][t]


@pytest.mark.parametrize("name", FLAT + PIXEL)
def test_time_limit_truncation_is_not_termination(name):
    env = tenvs.make_env(name)
    state = env.reset(prng.split(prng.key(0), 3), "cpu")
    state = state._replace(t=torch.full_like(state.t, env.max_steps - 1))
    nxt, obs, r, d, term = env.step(state, torch.zeros(3, dtype=torch.int32),
                                    prng.split(prng.key(2), 3))
    assert bool(d.all()) and not bool(term.any())
    assert bool((nxt.t == 0).all())          # a fresh episode started
    assert obs.shape == (3,) + env.obs_shape


def test_mountaincar_goal_and_left_wall():
    env = tenvs.make_env("mountaincar")
    x = torch.tensor([[0.49, 0.07], [-1.19, -0.07], [-0.5, 0.0]])
    state = tenvs.EnvState(x=x, t=torch.zeros(3, dtype=torch.int32))
    _, obs, r, d, term = env.step(state, torch.tensor([2, 0, 1]),
                                  prng.split(prng.key(1), 3))
    assert term.tolist() == [True, False, False] and d.tolist() == term.tolist()
    assert float(obs[1, 0]) == np.float32(env.MIN_POS)
    assert float(obs[1, 1]) == 0.0
    assert r.tolist() == [-1.0, -1.0, -1.0]


def test_registry_has_the_flat_envs():
    assert tenvs.available_envs() == sorted(FLAT + PIXEL)
    for name in FLAT + PIXEL:
        assert tenvs.make_env(name).obs_shape == \
            jenvs.make_env(name).obs_shape
        assert tenvs.make_env(name).max_steps == \
            jenvs.make_env(name).max_steps


# --- the pixel envs ----------------------------------------------------------


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert np.asarray(a).dtype == b.numpy().dtype


@pytest.mark.parametrize("name", PIXEL)
def test_pixel_vector_env_matches_reference(name):
    """A whole run stepped independently in both packages: states, uint8
    frames, rewards, signals and the auto-reset draws bit for bit."""
    n, steps = 8, 120
    jv = jenvs.VectorEnv(jenvs.make_env(name), n)
    tv = tenvs.VectorEnv(tenvs.make_env(name), n, device="cpu")
    js = jv.reset(jax.random.key(0))
    ts = tv.reset(prng.key(0))
    _same(js.x, ts.x)
    _same(jv.obs(js), tv.obs(ts))
    # a third of the envs start a few steps before the time limit
    js = js._replace(t=js.t.at[::3].set(jv.env.max_steps - 5))
    ts = ts._replace(t=torch.from_numpy(np.array(js.t)))
    step = jax.jit(jv.step)
    keys = jax.random.split(jax.random.key(1), steps)
    tkeys = prng.split(prng.key(1), steps)
    # mostly "up", so Freeway's chickens cross
    actions = np.random.default_rng(0).choice(
        3, (steps, n), p=(0.2, 0.6, 0.2)).astype(np.int32)
    dones = rewards = 0
    for i in range(steps):
        js, jobs, jr, jdone, jterm = step(js, actions[i], keys[i])
        ts, tobs, tr, tdone, tterm = tv.step(ts, torch.from_numpy(actions[i]),
                                             tkeys[i])
        for a, b in ((js.x, ts.x), (js.t, ts.t), (jobs, tobs), (jr, tr),
                     (jdone, tdone), (jterm, tterm)):
            _same(a, b)
        _same(jv.obs(js), tv.obs(ts))
        assert tobs.shape == (n, 10, 10) and tobs.dtype == torch.uint8
        dones += int(tdone.sum())
        rewards += float(tr.sum())
    assert dones > n // 3 and rewards > 0      # resets and scores were held


def _random_states(name, n, rng):
    """States of every kind the games reach, and some they rarely do
    (sparse brick walls, a chicken in every lane at every clock)."""
    if name == "breakout":
        head = np.stack([rng.integers(0, 9, n), rng.integers(0, 10, n),
                         rng.choice([-1, 1], n), rng.choice([-1, 1], n),
                         rng.integers(0, 10, n)], -1)
        bricks = rng.random((n, 30)) < rng.choice([0.02, 0.5, 0.95], (n, 1))
        x = np.concatenate([head, bricks], -1)
        t = rng.integers(0, 300, n)
    else:
        x = np.concatenate([rng.integers(0, 10, (n, 1)),
                            rng.integers(0, 10, (n, 8))], -1)
        t = rng.integers(0, 250, n)
    return x.astype(np.float32), t.astype(np.int32)


@pytest.mark.parametrize("name", PIXEL)
def test_pixel_step_matches_reference_on_random_states(name):
    """One step from 512 random states: brick hits and clears, wall and
    ceiling bounces, paddle catches, lost balls and wall respawns
    (Breakout); moves, collisions, crossings and car wraps at every
    clock (Freeway), bit for bit."""
    n = 512
    rng = np.random.default_rng(7)
    x, t = _random_states(name, n, rng)
    actions = rng.integers(0, 3, n).astype(np.int32)
    jv = jenvs.VectorEnv(jenvs.make_env(name), n)
    tv = tenvs.VectorEnv(tenvs.make_env(name), n, device="cpu")
    js = jenvs.EnvState(x=jax.numpy.asarray(x), t=jax.numpy.asarray(t))
    out = jax.jit(jv.step)(js, actions, jax.random.key(3))
    got = tv.step(tenvs.EnvState(x=torch.from_numpy(x), t=torch.from_numpy(t)),
                  torch.from_numpy(actions), prng.key(3))
    for a, b in zip((out[0].x, out[0].t) + tuple(out[1:]),
                    (got[0].x, got[0].t) + tuple(got[1:])):
        _same(a, b)
    _same(jv.obs(js), tv.obs(tenvs.EnvState(x=torch.from_numpy(x),
                                            t=torch.from_numpy(t))))
    reward, done, term = (v.numpy() for v in got[2:])
    if name == "breakout":
        assert reward.sum() > 20 and term.sum() > 5 and (~term & done).any()
        nxt = got[0].x.numpy()
        respawned = (x[:, 5:].sum(-1) <= 1) & (nxt[:, 5:].sum(-1) == 30)
        assert respawned.any()
    else:
        assert reward.sum() > 5 and not term.any() and done.any()
        collided = (x[:, 0] >= 2) & (x[:, 0] <= 7) & (got[0].x.numpy()[:, 0]
                                                       == 9) & ~done
        assert collided.any()


@pytest.mark.parametrize("name", PIXEL)
def test_pixel_env_matches_golden_trajectory(name):
    """The golden file was written under jax's older threefry layout,
    whose reset draws the port does not make; so the episode starts (the
    first and each one after a ``done``) are the reference's resets under
    that layout, carried over, and every step is the port's."""
    with open(GOLDEN) as f:
        fx = json.load(f)[name]
    jenv, env = jenvs.make_env(name), tenvs.make_env(name)

    def reference_reset(key):
        with jax.threefry_partitionable(False):
            return _state(jax.jit(jenv.reset)(key))

    state = reference_reset(jax.random.key(0))
    np.testing.assert_array_equal(env.obs(state).numpy(), fx["reset_obs"])
    for t, a in enumerate(fx["actions"]):
        state, obs, r, d, term = env.step(
            state, torch.tensor(a, dtype=torch.int32),
            prng.fold_in(prng.key(1), t))
        np.testing.assert_array_equal(obs.numpy(), fx["obs"][t],
                                      err_msg=f"{name} step {t}")
        assert float(r) == fx["reward"][t]
        assert bool(d) == fx["done"][t] and bool(term) == fx["terminated"][t]
        if bool(d):
            state = reference_reset(
                jax.random.fold_in(jax.random.key(1), t))
