"""Sync-mode kill and resume through the port's ``ReplayService``.

Split out of ``tests/test_torch_runtime_resume.py`` (whose module
docstring states the rules) so that the test runner's per-file workers
share the load: a checkpointed, killed and resumed sync run equals the
uninterrupted one bit for bit, on the flat ring, AMPER-fr fused, with
the n-step window cut mid-window, and on the uint8 frame store.
"""
import dataclasses

import jax
import pytest
import torch

from repro_torch import prng
from repro_torch.train.checkpoint import CheckpointManager
from test_torch_runtime_resume import (CFG, PIX_CFG, assert_runs_equal,
                                       sync_service)


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


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
