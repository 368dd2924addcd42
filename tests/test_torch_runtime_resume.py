"""Kill and resume through the port's ``ReplayService``.

Counterpart of the service half of ``tests/test_resume.py`` and of
``tests/test_frame_store.py``'s pixel service pin: in sync mode a
checkpointed, killed and resumed run equals the uninterrupted one bit
for bit (params, target, and every leaf of the replay state), on the
flat ring, with the n-step window mid-window, and on the uint8 frame
store; in async mode the resumed run finishes the remaining learner
steps with gapless, in-order feedback, its copy-on-write snapshots never
quiesce the pipeline, and a checkpoint of another actor count is
refused.  Cross-package: a sync service checkpoint written by either
package resumes in the other, and the resumed run lands within rtol
1e-4 / atol 1e-5 on params (the sync service's tolerance: XLA and torch
sum the matmuls in different orders) of the writer's uninterrupted run,
with the same actions in the ring.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.rl import dqn as jd
from repro.runtime import ReplayService as JService
from repro.train import checkpoint as jck
from repro_torch import prng
from repro_torch.models.qhead import tree_leaves
from repro_torch.rl.dqn import DQNConfig, make_dqn
from repro_torch.runtime import ReplayService
from repro_torch.train import checkpoint as ck
from repro_torch.train.checkpoint import CheckpointManager
from test_torch_runtime import SERVICE_ATOL, SERVICE_RTOL, run_bounded

CFG = DQNConfig(num_envs=2, replay_size=256, batch=16, learn_start=30,
                eps_decay_steps=200, target_sync=25, beta_end=1.0)
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


def assert_trees_equal(a, b):
    na, la = ck._flatten_with_names(a)
    nb, lb = ck._flatten_with_names(b)
    assert na == nb
    for name, x, y in zip(na, la, lb):
        assert same_bits(x, y), name


def assert_runs_equal(a, b):
    assert_trees_equal(a.params, b.params)
    assert_trees_equal(a.target_params, b.target_params)
    assert_trees_equal(a.buffer, b.buffer)


def sync_service(cfg=CFG):
    return ReplayService(cfg, sync=True, num_actors=1, device="cpu")


# --- sync mode: bit-identical kill / resume ----------------------------------

@pytest.mark.parametrize("cfg,n,interval", [
    (CFG, 80, 25),
    (dataclasses.replace(CFG, sampler="amper-fr", amper_fr_mode="fused",
                         v_max=8.0), 80, 25),
    # a cut that lands mid-window of the 3-step accumulator
    (dataclasses.replace(CFG, agent="double", n_step=3), 80, 26),
    (PIX_CFG, 70, 20)],
    ids=["per-sumtree", "amper-fr-fused", "double-3-step", "pixel"])
def test_sync_service_kill_resume_bit_identical(tmp_path, cfg, n, interval):
    key = prng.key(3)
    svc = sync_service(cfg)
    base = svc.run(key, n)
    mgr = CheckpointManager(str(tmp_path), save_interval=interval)
    mgr.request_preemption()          # "kill" at the first checkpoint
    r1 = svc.run(key, n, manager=mgr)
    cut = r1.metrics["preempted_at"]
    assert cut is not None and cut < n
    r2 = svc.run(key, n, manager=CheckpointManager(
        str(tmp_path), save_interval=interval))
    assert r2.metrics["resumed_from"] == cut
    assert_runs_equal(base, r2)
    if cfg.n_step == 3:
        assert r2.buffer.nstep is not None
    if cfg is PIX_CFG:
        assert base.buffer.storage["frame"].dtype == torch.uint8


def test_sync_resume_kill_at_random_wall_time(tmp_path):
    """The kill point must not matter: preempt from a watchdog thread at
    an arbitrary wall-clock moment, resume, and still match bitwise."""
    n, key = 60, prng.key(5)
    svc = sync_service()
    base = svc.run(key, n)
    mgr = CheckpointManager(str(tmp_path), save_interval=10)
    killer = threading.Timer(0.05, mgr.request_preemption)
    killer.start()
    svc.run(key, n, manager=mgr)
    killer.cancel()
    r2 = svc.run(key, n, manager=CheckpointManager(str(tmp_path),
                                                   save_interval=10))
    assert_runs_equal(base, r2)


def test_sync_resume_with_different_n_steps_raises(tmp_path):
    svc = sync_service()
    mgr = CheckpointManager(str(tmp_path), save_interval=10)
    mgr.request_preemption()
    svc.run(prng.key(0), 40, manager=mgr)
    with pytest.raises(ValueError, match="n_steps"):
        svc.run(prng.key(0), 50, manager=CheckpointManager(str(tmp_path)))


def test_resume_at_target_reports_finite_rates(tmp_path):
    """A run that resumes exactly at its target does zero work in epsilon
    wall time: the throughput metrics come out finite."""
    svc = sync_service()
    svc.run(prng.key(1), 40,
            manager=CheckpointManager(str(tmp_path), save_interval=20))
    r = svc.run(prng.key(1), 40,
                manager=CheckpointManager(str(tmp_path), save_interval=20))
    assert r.metrics["resumed_from"] == 40
    assert np.isfinite(r.metrics["frames_per_sec"])
    assert np.isfinite(r.metrics["learner_steps_per_sec"])


# --- sync checkpoints across the two packages --------------------------------

XCFG = dict(num_envs=2, replay_size=256, batch=16, hidden=32,
            learn_start=10, eps_decay_steps=100, target_sync=10,
            sampler="amper-fr", v_max=8.0)
CUT = 20   # the first save: learning began at step 10


def killed_after_first_save(manager_cls):
    """A manager of ``manager_cls`` that asks for preemption as its first
    save returns, so the run stops right after step ``CUT``."""

    class Killing(manager_cls):
        def save(self, *args, **kwargs):
            out = super().save(*args, **kwargs)
            self.request_preemption()
            return out

    return Killing


def test_reference_sync_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's service is killed at its first save (step 20); the
    port resumes the file to the end, with the run key the file holds,
    and lands within the sync service's tolerance of the reference's
    uninterrupted run: the same actions and ring, params close."""
    n = 60
    jmgr = killed_after_first_save(jck.CheckpointManager)(
        str(tmp_path), save_interval=CUT)
    cut = JService(jd.DQNConfig(**XCFG), sync=True, num_actors=1).run(
        jax.random.key(2), n, manager=jmgr).metrics["preempted_at"]
    assert cut == CUT
    ref = JService(jd.DQNConfig(**XCFG), sync=True, num_actors=1).run(
        jax.random.key(2), n)
    got = sync_service(DQNConfig(**XCFG)).run(
        prng.key(99), n,        # the key comes from the checkpoint
        manager=CheckpointManager(str(tmp_path), save_interval=1000))
    assert got.metrics["resumed_from"] == cut
    for a, b in zip(jax.tree.leaves(ref.params), tree_leaves(got.params)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                   rtol=SERVICE_RTOL, atol=SERVICE_ATOL)
    np.testing.assert_array_equal(np.asarray(ref.buffer.storage["action"]),
                                  got.buffer.storage["action"].numpy())
    assert int(ref.buffer.pos) == got.buffer.pos


def test_port_sync_checkpoint_resumes_in_the_reference(tmp_path):
    """The port's service is killed at its first save (step 20); the
    reference resumes the file to the end and lands within the sync
    service's tolerance of the port's uninterrupted run."""
    n = 60
    mgr = killed_after_first_save(CheckpointManager)(str(tmp_path),
                                                     save_interval=CUT)
    svc = sync_service(DQNConfig(**XCFG))
    assert svc.run(prng.key(2), n, manager=mgr).metrics[
        "preempted_at"] == CUT
    base = svc.run(prng.key(2), n)
    got = JService(jd.DQNConfig(**XCFG), sync=True, num_actors=1).run(
        jax.random.key(99), n,
        manager=jck.CheckpointManager(str(tmp_path), save_interval=1000))
    assert got.metrics["resumed_from"] == CUT
    for a, b in zip(tree_leaves(base.params), jax.tree.leaves(got.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=SERVICE_RTOL, atol=SERVICE_ATOL)
    np.testing.assert_array_equal(base.buffer.storage["action"].numpy(),
                                  np.asarray(got.buffer.storage["action"]))


# --- async mode: snapshot / resume -------------------------------------------

def async_service(n_step: int = 1, num_actors: int = 2, **kw):
    cfg = DQNConfig(sampler="amper-fr", n_step=n_step, num_envs=2,
                    replay_size=256, batch=16, learn_start=8,
                    eps_decay_steps=200, target_sync=50, v_max=8.0,
                    beta_end=1.0)
    return ReplayService(cfg, num_actors=num_actors, chunk_len=4, slab=2,
                         queue_size=4, max_replay_ratio=64, device="cpu",
                         **kw)


@pytest.mark.parametrize("n_step", [1, 3])
def test_async_kill_resume_feedback_stays_exact(tmp_path, n_step):
    """Kill the async service at its first slab, resume from the snapshot:
    the resumed run finishes the remaining learner steps with gapless,
    in-order feedback, carries the pre-kill experience forward, and (for
    n-step) the snapshot holds each actor's own window."""
    n = 40
    mgr = CheckpointManager(str(tmp_path), save_interval=8)
    mgr.request_preemption()
    r1 = run_bounded(async_service(n_step), prng.key(1), n, manager=mgr)
    cut = r1.metrics["preempted_at"]
    assert cut is not None and 0 < cut < n
    names = ck.load_manifest(str(tmp_path), mgr.latest_step())["names"]
    assert any(nm.startswith("actors/1/env_state") for nm in names)
    assert any(nm.startswith("actors/0/nstep") for nm in names) == \
        (n_step > 1)
    svc2 = async_service(n_step, feedback_log=True)
    r2 = run_bounded(svc2, prng.key(1), n, manager=CheckpointManager(
        str(tmp_path), save_interval=100))
    m = r2.metrics
    assert m["resumed_from"] == cut
    assert m["total_learner_steps"] == n
    assert m["feedback_seqs"] == list(range(cut, n)), m["feedback_seqs"]
    assert r2.buffer.total_adds >= r1.buffer.total_adds
    assert r2.buffer.size >= r1.buffer.size
    assert np.isfinite(svc2.dqn.evaluate(r2.params, prng.key(2), 3))
    for leaf in tree_leaves(r2.params):
        assert bool(torch.isfinite(leaf).all())


def test_async_periodic_snapshots_do_not_change_liveness(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_interval=4)
    r = run_bounded(async_service(), prng.key(2), 20, manager=mgr)
    assert r.metrics["total_learner_steps"] == 20
    assert mgr.latest_step() == 20


def test_async_cow_snapshots_never_quiesce(tmp_path):
    """A checkpointed async run records zero quiesce cycles: a snapshot
    costs only the capture (the guarded clone and reference grabs),
    recorded per snapshot; an uncheckpointed run records none."""
    mgr = CheckpointManager(str(tmp_path), save_interval=8)
    r = run_bounded(async_service(), prng.key(6), 32, manager=mgr)
    snap = r.metrics["snapshot"]
    assert snap["drain_cycles"] == 0
    assert snap["count"] >= 1 and snap["saved"] >= 1
    assert 0 < snap["pause_us_max"] < 1e6
    assert 0 < snap["pause_us_mean"] <= snap["pause_us_max"]
    r0 = run_bounded(async_service(), prng.key(6), 16)
    assert r0.metrics["snapshot"]["count"] == 0
    assert r0.metrics["snapshot"]["pause_us_max"] == 0.0


def test_async_feedback_contract_across_midflight_snapshots(tmp_path):
    """The exactly-once / in-order contract holds while snapshots are
    taken mid-flight, deltas included, and the last one restores."""
    n = 40
    svc = async_service(feedback_log=True)
    mgr = CheckpointManager(str(tmp_path), save_interval=8)
    r = run_bounded(svc, prng.key(9), n, manager=mgr)
    m = r.metrics
    assert m["total_learner_steps"] == n
    assert m["snapshot"]["saved"] >= 2
    assert m["checkpoint"]["delta_bytes"] > 0
    assert m["feedback_seqs"] == list(range(n)), m["feedback_seqs"]
    r2 = run_bounded(async_service(), prng.key(9), n,
                     manager=CheckpointManager(str(tmp_path),
                                               save_interval=1000))
    assert r2.metrics["resumed_from"] == mgr.latest_step()
    for leaf in tree_leaves(r2.params):
        assert bool(torch.isfinite(leaf).all())


def test_async_snapshot_restores_the_captured_buffer(tmp_path):
    """What a copy-on-write snapshot restores is a buffer the run really
    held: its stamps are a ring written in order (distinct, the largest
    one less than the add counter) and its counters match its rows."""
    mgr = CheckpointManager(str(tmp_path), save_interval=8)
    run_bounded(async_service(), prng.key(4), 24, manager=mgr)
    svc = async_service()
    state = ck.restore(str(tmp_path), mgr.latest_step(),
                       svc._async_target(), device="cpu")
    buf = state["buffer"]
    stamps = buf.write_stamp.numpy()
    live = stamps[stamps >= 0]
    assert len(live) == buf.size == len(np.unique(live))
    assert live.max() == buf.total_adds - 1
    prios = svc.dqn.replay.sampler.priorities(buf.sampler_state).numpy()
    assert (prios[stamps >= 0] > 0).all() and (prios[stamps < 0] == 0).all()


def test_metrics_surface_annealed_beta(tmp_path):
    """The metrics report the beta the draws used (the annealed schedule),
    in sync mode and in async mode."""
    n = 60
    cfg = dataclasses.replace(CFG, beta_end=1.0, beta_anneal_steps=50,
                              learn_start=10)
    dqn = make_dqn(cfg, device="cpu")
    res = sync_service(cfg).run(prng.key(0), n)
    np.testing.assert_allclose(res.metrics["beta"],
                               float(dqn.beta_at(n - 1)), rtol=1e-6)
    assert res.metrics["beta"] > cfg.beta
    r = run_bounded(async_service(), prng.key(2), 30)
    assert cfg.beta < r.metrics["beta"] <= 1.0
    const = sync_service(dataclasses.replace(CFG, beta_end=None,
                                             learn_start=10))
    np.testing.assert_allclose(const.run(prng.key(1), 30).metrics["beta"],
                               CFG.beta, rtol=1e-6)


def test_async_resume_actor_count_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_interval=8)
    mgr.request_preemption()
    run_bounded(async_service(), prng.key(1), 20, manager=mgr)
    with pytest.raises(ValueError, match="num_actors"):
        run_bounded(async_service(num_actors=3), prng.key(1), 20,
                    manager=CheckpointManager(str(tmp_path)))


def test_async_checkpoint_refuses_sync_mode(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_interval=8)
    mgr.request_preemption()
    run_bounded(async_service(), prng.key(1), 20, manager=mgr)
    with pytest.raises(ValueError, match="async"):
        sync_service(async_service().cfg).run(
            prng.key(1), 20, manager=CheckpointManager(str(tmp_path)))
