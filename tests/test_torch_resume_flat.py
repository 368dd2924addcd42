"""``train_ckpt`` killed and resumed on the flat ring.

Split out of ``tests/test_torch_resume.py`` (whose module docstring
states the rules) so that the test runner's per-file workers share the
load: the uninterrupted ``train_ckpt`` run, the one killed at its first
checkpoint and resumed, and ``train`` end in one state bit for bit, with
AMPER-fr (broadcast and fused), the 3-step window and the sum tree.
"""
import dataclasses

import jax
import pytest
import torch

from repro_torch import prng
from repro_torch.rl.dqn import make_dqn
from repro_torch.train.checkpoint import CheckpointManager
from test_torch_resume import CFG, assert_states_equal, kill_and_resume


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.mark.parametrize("cfg", [
    CFG, dataclasses.replace(CFG, amper_fr_mode="fused"),
    dataclasses.replace(CFG, agent="double", n_step=3),
    dataclasses.replace(CFG, sampler="per-sumtree")],
    ids=["amper-fr", "fused", "double-3step", "per-sumtree"])
def test_train_ckpt_kill_resume_bit_identical(tmp_path, cfg):
    """Uninterrupted, killed-and-resumed and ``train`` end in one state."""
    dqn = make_dqn(cfg, device="cpu")
    key, n = prng.key(1), 70
    st_a, m_a, done = dqn.train_ckpt(
        key, n, CheckpointManager(str(tmp_path / "a"), save_interval=30))
    assert done == n and len(m_a["loss"]) == n
    st_b = kill_and_resume(dqn, key, n, tmp_path / "b", 30)
    st_t, m_t = dqn.train(key, n)
    assert_states_equal(st_a, st_b)
    assert_states_equal(st_a, st_t)
    assert torch.equal(torch.stack(m_a["loss"]), torch.stack(m_t["loss"]))
