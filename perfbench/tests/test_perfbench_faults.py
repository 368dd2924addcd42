"""The check catches a broken timed path: each fault a cell can have is
planted under the program, the rest of a run is driven on the CPU
(without the look for a card), and ``correct`` has to come out false.

* a step that returns its state unchanged;
* half of the batch left out (the trainer takes the mean over the rest);
* an answer altered where it is produced (one drawn row; one reward of
  the env step).

The exchange between chips does not exist in these one-chip cells."""
import time

import pytest
import torch
from perfbench_testkit import CELLS, catalog, small  # noqa: F401

from perfbench.harness.main import run_cell
from repro_torch.core import replay_buffer, sharded
from repro_torch.core import amper as amper_mod
from repro_torch.rl import dqn as dqn_mod
from repro_torch.rl import envs


def _unchanged_update(self, state, idx, priority):
    return state


def _half(sample):
    def broken(self, state, key, batch, *a, **kw):
        idx = sample(self, state, key, batch, *a, **kw)
        return torch.cat([idx[: batch // 2], idx[: batch - batch // 2]])
    return broken


def _altered(sample):
    def broken(self, state, key, batch, *a, **kw):
        idx = sample(self, state, key, batch, *a, **kw).clone()
        idx[0] = (idx[0] + 1) % self.cfg.capacity
        return idx
    return broken


def _env_altered(step):
    def broken(self, state, action, keys):
        out = list(step(self, state, action, keys))
        out[2] = out[2].clone()
        out[2][0] += 1.0
        return tuple(out)
    return broken


def _rb_half(sample):
    def broken(self, state, key, batch, beta=None):
        idx, rows, w = sample(self, state, key, batch, beta)
        h = batch // 2
        return idx[:h], {k: v[:h] for k, v in rows.items()}, w[:h]
    return broken


def _frozen_runner(make_dqn):
    def broken(cfg, device="cuda", mesh=None):
        d = make_dqn(cfg, device=device, mesh=mesh)
        real = d.runner

        class Frozen(real):
            def advance(self, stop):
                # the steps return the state they were given
                self.state = self.state._replace(step=stop)
                return self.state
        return d._replace(runner=Frozen)
    return broken


S = sharded.ShardedAmperSampler
A = amper_mod.AmperSampler
FAULTS = {
    (CELLS[0], "unchanged"): (S, "update", _unchanged_update),
    (CELLS[0], "half"): (S, "sample", _half(S.sample)),
    (CELLS[0], "altered"): (S, "sample", _altered(S.sample)),
    (CELLS[1], "unchanged"): (dqn_mod, "make_dqn",
                              _frozen_runner(dqn_mod.make_dqn)),
    (CELLS[1], "half"): (replay_buffer.ReplayBuffer, "sample",
                         _rb_half(replay_buffer.ReplayBuffer.sample)),
    (CELLS[1], "altered"): (A, "sample", _altered(A.sample)),
    (CELLS[1], "env_altered"): (envs.CartPole, "step",
                                _env_altered(envs.CartPole.step)),
}


@pytest.mark.parametrize("cell, fault", list(FAULTS),
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_fault_is_caught(catalog, small, monkeypatch, cell, fault):
    owner, attr, broken = FAULTS[(cell, fault)]
    monkeypatch.setattr(owner, attr, broken)
    config, traffic = small[cell]
    out = run_cell(catalog, cell, 11, 0.2, False, torch.device("cpu"),
                   time.perf_counter(), config=config, cell=traffic)
    assert not out["correct"], out["checks"]
