"""The port's Acrobot and MountainCar against the JAX reference.

Each step starts both packages from the reference's state, so a one-ulp
difference (XLA's ``sin``/``cos`` are not torch's) is measured over one
step and does not grow: Acrobot is chaotic.  Observations and states
must agree within rtol 1e-5 / atol 1e-6; ``done``, ``terminated``, the
episode clocks, rewards and the auto-reset states exactly.  The golden
trajectories of ``tests/golden/envs.json`` hold all three flat envs under
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


@pytest.mark.parametrize("name", FLAT)
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
    assert tenvs.available_envs() == sorted(FLAT)
    for name in FLAT:
        assert tenvs.make_env(name).obs_shape == \
            jenvs.make_env(name).obs_shape
        assert tenvs.make_env(name).max_steps == \
            jenvs.make_env(name).max_steps
