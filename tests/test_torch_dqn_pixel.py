"""The port's pixel DQN path on the CPU: Breakout.

Split out of ``tests/test_torch_dqn.py`` (whose module docstring states
the rules) so that the test runner's per-file workers share the load;
each pixel env's cases of ``test_pixel_train_and_evaluate_run_on_cpu``
and ``test_train_many_pixel_seeds_match_reference`` sit in a file of
their own (Freeway's in ``test_torch_dqn_pixel_freeway.py``, which calls
the bodies defined here).
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.models.qhead import tree_leaves
from repro_torch.rl import dqn as td


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def pixel_train_and_evaluate(env, agent):
    """The pixel path end to end (``tests/test_dqn.py``'s pixel smoke
    test): a uint8 frame stack as the policy input, the frame store and a
    conv head; finite returns, losses and params, and an evaluation."""
    cfg = td.DQNConfig(env=env, agent=agent, sampler="amper-fr",
                       amper_fr_mode="fused", num_envs=2, replay_size=256,
                       batch=16, hidden=32, history_len=4, learn_start=30,
                       eps_decay_steps=100, target_sync=10, v_max=8.0)
    dqn = td.make_dqn(cfg, device="cpu")
    assert dqn.replay.frame_store is not None
    assert dqn.replay.n_step == 1 and "frame" in dqn.example_transition
    state, metrics = dqn.train(prng.key(0), 80)
    assert state.obs.dtype == torch.uint8
    assert tuple(state.obs.shape) == (2, 10, 10, 4)
    assert state.buffer.storage["frame"].dtype == torch.uint8
    assert bool(torch.isfinite(torch.stack(metrics["return_mean"])).all())
    assert bool(torch.isfinite(torch.stack(metrics["loss"])).all())
    assert all(torch.isfinite(t).all() for t in tree_leaves(state.params))
    assert np.isfinite(dqn.evaluate(state, prng.key(1), 2))
    assert torch.equal(dqn.init_obs(state.env_state)[..., -1],
                       dqn.venv.obs(state.env_state))


def train_many_pixel_seeds(env, agent, n_step):
    """``train_many`` and ``evaluate_many`` on 2 pixel seeds, held to the
    multi-seed test's rules (``tests/test_torch_table1.py``) but for the
    parameters' absolute tolerance, 1e-5 here.  Where a conv-head
    gradient element cancels to about 1e-4 of its terms' scale, the two
    packages' sums differ by a few tens of percent of it, and Adam's
    first step, about ``lr * g / (|g| + eps)``, turns that into up to
    4e-6 of a parameter (measured: breakout, seed 1, step 8, a trunk
    weight with ``g`` = -4.9e-7)."""
    from test_torch_table1 import \
        test_train_many_and_evaluate_many_match_reference as check
    check(env, "amper-fr", agent, n_step, param_atol=1e-5)


@pytest.mark.parametrize("env,agent", [("breakout", "dqn")])
def test_pixel_train_and_evaluate_run_on_cpu(env, agent):
    pixel_train_and_evaluate(env, agent)


@pytest.mark.parametrize("env,agent,n_step", [("breakout", "dueling", 3)])
def test_train_many_pixel_seeds_match_reference(env, agent, n_step):
    train_many_pixel_seeds(env, agent, n_step)
