"""Kill and resume through the port's ``train_ckpt``.

Counterpart of ``tests/test_resume.py``'s ``train_ckpt`` pins and of its
pixel kill-and-resume pin: a checkpointed, preempted and resumed run
equals the uninterrupted ``train_ckpt`` run and ``train`` bit for bit
(every leaf of the ``AgentState``: params, Adam moments, the replay ring
and sampler state, env state, counters), on the flat ring with AMPER-fr
(broadcast and fused), with the n-step window, on the uint8 frame store,
and on 2 replay shards; a finished run relaunches idempotently; another
``n_steps`` raises.  Cross-package pins: a checkpoint the reference's
``train_ckpt`` wrote mid-run loads into the port equal to
``interop.agent_state_from_jax`` of the reference's state, and one the
port wrote loads through the reference's ``checkpoint.restore`` into
``jax.eval_shape(init, key)`` equal to the port's state as numpy.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.rl import dqn as jd
from repro.train import checkpoint as jck
from repro_torch import interop, obs, prng
from repro_torch.distributed.sharding import Mesh
from repro_torch.rl.dqn import DQNConfig, make_dqn
from repro_torch.train import checkpoint as ck
from repro_torch.train.checkpoint import CheckpointManager

CFG = DQNConfig(num_envs=2, replay_size=256, batch=16, learn_start=30,
                eps_decay_steps=200, target_sync=25, beta_end=1.0,
                sampler="amper-fr", v_max=8.0)
PIX_CFG = DQNConfig(env="breakout", sampler="amper-fr", num_envs=2,
                    replay_size=256, batch=16, learn_start=30,
                    history_len=4, eps_decay_steps=200, target_sync=25,
                    amper_fr_mode="fused")


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


def assert_states_equal(a, b):
    na, la = ck._flatten_with_names(a)
    nb, lb = ck._flatten_with_names(b)
    assert na == nb
    for name, x, y in zip(na, la, lb):
        assert same_bits(x, y), name


def kill_and_resume(dqn, key, n, directory, interval):
    """Preempted at the first checkpoint, then resumed from a fresh
    manager to ``n``; returns the resumed state."""
    mgr = CheckpointManager(str(directory), save_interval=interval)
    mgr.request_preemption()
    _, m1, done1 = dqn.train_ckpt(key, n, mgr)
    assert done1 == interval < n and len(m1["loss"]) == interval
    st, m2, done2 = dqn.train_ckpt(
        key, n, CheckpointManager(str(directory), save_interval=interval))
    assert done2 == n and len(m2["loss"]) == n - interval
    return st


def test_train_ckpt_relaunch_after_completion_is_idempotent(tmp_path):
    dqn = make_dqn(CFG, device="cpu")
    key, n = prng.key(2), 40
    st1, _, done1 = dqn.train_ckpt(
        key, n, CheckpointManager(str(tmp_path), save_interval=20))
    assert done1 == n
    st2, metrics, done2 = dqn.train_ckpt(
        key, n, CheckpointManager(str(tmp_path), save_interval=20))
    assert done2 == n
    assert metrics == {"return_mean": [], "beta": [], "loss": []}
    assert_states_equal(st1, st2)


def test_train_ckpt_resume_with_different_n_steps_raises(tmp_path):
    dqn = make_dqn(CFG, device="cpu")
    mgr = CheckpointManager(str(tmp_path), save_interval=10)
    mgr.request_preemption()
    dqn.train_ckpt(prng.key(0), 40, mgr)
    with pytest.raises(ValueError, match="n_steps"):
        dqn.train_ckpt(prng.key(0), 50, CheckpointManager(str(tmp_path)))


def test_pixel_train_ckpt_kill_resume_bit_identical(tmp_path):
    """Conv head, uint8 frame store, fused AMPER-fr: the resumed pixel run
    equals the uninterrupted one, the uint8 ring included."""
    dqn = make_dqn(PIX_CFG, device="cpu")
    key, n = prng.key(6), 70
    st_a, _, _ = dqn.train_ckpt(
        key, n, CheckpointManager(str(tmp_path / "a"), save_interval=20))
    st_b = kill_and_resume(dqn, key, n, tmp_path / "b", 20)
    assert_states_equal(st_a, st_b)
    assert st_b.buffer.storage["frame"].dtype == torch.uint8
    assert st_b.obs.dtype == torch.uint8


def test_sharded_train_ckpt_resumes_onto_other_shard_counts(tmp_path):
    """On 2 shards the resumed run equals the uninterrupted one; the same
    checkpoint loads onto 4 shards and onto 1 with the same dense table."""
    cfg = dataclasses.replace(CFG, sampler="amper-fr-sharded",
                              amper_fr_mode="fused")
    cpu = torch.device("cpu")
    dqn2 = make_dqn(cfg, device="cpu", mesh=Mesh([cpu] * 2))
    key, n = prng.key(3), 60
    st_a, _, _ = dqn2.train_ckpt(
        key, n, CheckpointManager(str(tmp_path / "a"), save_interval=30))
    st_b = kill_and_resume(dqn2, key, n, tmp_path / "b", 30)
    assert_states_equal(st_a, st_b)
    table = dqn2.replay.sampler.to_dense(st_b.buffer.sampler_state)
    for shards in (4, 1):
        other = make_dqn(cfg, device="cpu", mesh=Mesh([cpu] * shards))
        st = other.load_ckpt(str(tmp_path / "b"), n)
        assert len(st.buffer.sampler_state.pq) == shards
        assert_states_equal(table,
                            other.replay.sampler.to_dense(
                                st.buffer.sampler_state))
        assert_states_equal(st.params, st_b.params)


def test_train_ckpt_telemetry(tmp_path):
    """With a registry: one checkpoint_save span a save, one replay_sample
    span a learn step, the full saves' bytes, and the same final state."""
    dqn = make_dqn(CFG, device="cpu")
    key, n = prng.key(4), 60
    st_off, _, _ = dqn.train_ckpt(
        key, n, CheckpointManager(str(tmp_path / "off"), save_interval=20))
    reg = obs.Registry()
    prev = obs.set_registry(reg)
    try:
        st_on, _, _ = dqn.train_ckpt(
            key, n, CheckpointManager(str(tmp_path / "on"), save_interval=20,
                                      keep=5))
    finally:
        obs.set_registry(prev)
    assert_states_equal(st_off, st_on)
    snap = reg.snapshot().summary()
    assert snap["span_checkpoint_save_ms"]["count"] == 3
    assert snap["span_replay_sample_ms"]["count"] == n - CFG.learn_start
    sizes = sum((tmp_path / "on" / f"step_{s:010d}.ckpt").stat().st_size
                for s in (20, 40, 60))
    assert snap["checkpoint_full_bytes"]["value"] == sizes
    assert snap["checkpoint_chain_len"]["value"] == 0


# --- cross-package checkpoints -----------------------------------------------


@pytest.mark.parametrize("sampler", ["amper-fr", "per-sumtree"])
def test_reference_train_ckpt_loads_into_the_port(tmp_path, sampler):
    cfg = dict(num_envs=2, replay_size=256, batch=16, learn_start=30,
               eps_decay_steps=200, target_sync=25, sampler=sampler,
               v_max=8.0, agent="double", n_step=3)
    jdqn = jd.make_dqn(jd.DQNConfig(**cfg))
    mgr = jck.CheckpointManager(str(tmp_path), save_interval=40)
    mgr.request_preemption()
    jst, _, done = jdqn.train_ckpt(jax.random.key(1), 70, mgr)
    assert done == 40
    tdqn = make_dqn(DQNConfig(**cfg), device="cpu")
    got = tdqn.load_ckpt(str(tmp_path), done)
    want = interop.agent_state_from_jax(jax.tree.map(np.asarray, jst),
                                        device="cpu")
    assert_states_equal(want, got)
    assert isinstance(got.step, int) and got.step == 40
    assert isinstance(got.buffer.nstep.count, int)


@pytest.mark.parametrize("pixel", [False, True])
def test_port_train_ckpt_restores_in_the_reference(tmp_path, pixel):
    cfg = dataclasses.replace(PIX_CFG if pixel else CFG, agent="double",
                              n_step=1 if pixel else 3)
    dqn = make_dqn(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path), save_interval=40)
    mgr.request_preemption()
    st, _, done = dqn.train_ckpt(prng.key(5), 70, mgr)
    assert done == 40
    jcfg = {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(jd.DQNConfig)}
    jdqn = jd.make_dqn(jd.DQNConfig(**jcfg))
    target = jax.eval_shape(jdqn.init, jax.random.key(0))
    out = jck.restore(str(tmp_path), done, target)
    want = interop.agent_state_to_numpy(st)
    got = jax.tree.leaves(out)
    assert len(got) == len(jax.tree.leaves(want))
    for a, b in zip(got, jax.tree.leaves(want)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert int(out.step) == 40 and int(out.buffer.pos) == st.buffer.pos
