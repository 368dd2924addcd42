"""The port's pixel DQN path on the CPU: Freeway.

Split out of ``tests/test_torch_dqn.py`` (whose module docstring states
the rules) so that the test runner's per-file workers share the load:
Freeway's cases of ``test_pixel_train_and_evaluate_run_on_cpu`` and
``test_train_many_pixel_seeds_match_reference``, on the bodies of
``test_torch_dqn_pixel.py`` (Breakout's).
"""
import jax
import pytest

from test_torch_dqn_pixel import (pixel_train_and_evaluate,
                                  train_many_pixel_seeds)


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.mark.parametrize("env,agent", [("freeway", "double-dueling")])
def test_pixel_train_and_evaluate_run_on_cpu(env, agent):
    pixel_train_and_evaluate(env, agent)


@pytest.mark.parametrize("env,agent,n_step", [("freeway", "dqn", 1)])
def test_train_many_pixel_seeds_match_reference(env, agent, n_step):
    train_many_pixel_seeds(env, agent, n_step)
