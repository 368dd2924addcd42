"""The port's multi-seed trainer and the Table 1 twin against the JAX
reference.

``train_many`` runs S seeds in lockstep where the reference vmaps its
scan over them.  Both start from the same keys; each seed's actions and
sampled replay rows must agree exactly with the reference's, and the
final parameters within rtol 1e-5 / atol 1e-6 (XLA and torch sum the
matmuls in different orders).  The port's draws are recorded in the
order the lockstep takes them, which the test checks too.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import benchmarks.table1_learning as jt1
import benchmarks.torch_table1_learning as tt1
from repro.rl import dqn as jd
from repro_torch import interop, prng
from repro_torch.models.qhead import tree_leaves
from repro_torch.rl import dqn as td
from test_torch_dqn import ATOL, RTOL, _close, _close_trees, _jax_peek

SEEDS = (0, 1)
STEPS = 30


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _reference_rows(jdq, key, batch):
    """One seed of the reference run step by step: its sampled rows at
    each learn step."""
    step, peek = jax.jit(jdq.agent_step), _jax_peek(jdq, batch)
    st = jdq.init(key)
    rows = []
    for k in jax.random.split(jax.random.fold_in(key, 1), STEPS):
        if int(st.step) >= jdq.cfg.learn_start:
            rows.append(np.asarray(peek(st, k)[0]))
        st, _ = step(st, k)
    return rows


@pytest.mark.parametrize("env,sampler,agent,n_step", [
    ("cartpole", "per-sumtree", "double", 3),
    ("mountaincar", "amper-fr", "dqn", 1),
])
def test_train_many_and_evaluate_many_match_reference(env, sampler, agent,
                                                      n_step, param_atol=ATOL):
    """``param_atol`` is the absolute tolerance of the parameters and Adam
    moments (the module's 1e-6 unless a caller states another)."""
    kw = dict(env=env, sampler=sampler, agent=agent, n_step=n_step,
              num_envs=4, replay_size=256, batch=16, hidden=32,
              learn_start=8, target_sync=10)
    jdq = jd.make_dqn(jd.DQNConfig(**kw))
    tdq = td.make_dqn(td.DQNConfig(**kw), device="cpu")
    jkeys = jax.vmap(jax.random.key)(np.asarray(SEEDS, np.uint32))
    tkeys = tt1.stack_keys(SEEDS)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jkeys)),
                                  tkeys.numpy())

    draws = []
    sample = tdq.replay.sample

    def recording(*args, **kwargs):
        out = sample(*args, **kwargs)
        draws.append(out[0].numpy())
        return out

    tdq.replay.sample = recording
    tstates, tm = tdq.train_many(tkeys, STEPS)
    jstates, jm = jdq.train_many(jkeys, STEPS)

    # lockstep: learn step t draws for seed 0, then seed 1, then t + 1
    learn_steps = STEPS - kw["learn_start"]
    assert len(draws) == len(SEEDS) * learn_steps
    for s in SEEDS:
        want = _reference_rows(jdq, jkeys[s], kw["batch"])
        for t in range(learn_steps):
            np.testing.assert_array_equal(want[t], draws[2 * t + s])

    carried = interop.agent_states_from_jax(jax.tree.map(np.asarray, jstates),
                                            device="cpu")
    assert len(carried) == len(tstates) == len(SEEDS)
    for c, t in zip(carried, tstates):
        np.testing.assert_array_equal(c.buffer.storage["action"].numpy(),
                                      t.buffer.storage["action"].numpy())
        assert c.buffer.pos == t.buffer.pos and c.step == t.step == STEPS
        assert int(c.n_episodes) == int(t.n_episodes)
        for a, b in ((c.params, t.params), (c.target_params, t.target_params),
                     (c.opt_m, t.opt_m), (c.opt_v, t.opt_v)):
            for x, y in zip(tree_leaves(a), tree_leaves(b)):
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                           atol=param_atol)
        _close(c.obs.numpy(), t.obs)
    for name in ("return_mean", "beta"):
        assert tm[name].shape == (len(SEEDS), STEPS)
        _close(np.asarray(jm[name]), tm[name])
    assert tm["loss"].shape == (len(SEEDS), STEPS)

    ekeys = jax.vmap(jax.random.key)(np.asarray([100, 101], np.uint32))
    want = np.asarray(jdq.evaluate_many(jstates, ekeys, 3))
    got = tdq.evaluate_many(carried, tt1.stack_keys((100, 101)), 3)
    assert got.shape == (len(SEEDS),) and got.dtype == torch.float32
    _close(want, got)
    own = tdq.evaluate_many(tstates, tt1.stack_keys((100, 101)), 3)
    assert bool(torch.isfinite(own).all())


def test_train_is_train_many_of_one_seed():
    cfg = td.DQNConfig(env="acrobot", sampler="amper-k", num_envs=2,
                       replay_size=128, batch=8, hidden=16, learn_start=4)
    dqn = td.make_dqn(cfg, device="cpu")
    st, m = dqn.train(prng.key(1), 12)
    states, mm = dqn.train_many(tt1.stack_keys((0, 1)), 12)
    for a, b in zip(tree_leaves(st.params), tree_leaves(states[1].params)):
        assert torch.equal(a, b)
    assert torch.equal(st.buffer.sampler_state.pq,
                       states[1].buffer.sampler_state.pq)
    assert torch.equal(torch.stack(m["loss"]), mm["loss"][1])
    assert len(m["return_mean"]) == 12 and isinstance(m["beta"][0], float)


def test_dqn_config_defaults_match_reference():
    jf = {f.name: f.default for f in dataclasses.fields(jd.DQNConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(td.DQNConfig)}
    shared = sorted(set(jf) & set(tf))
    assert "sampler" in shared and len(shared) >= 20
    assert {k: tf[k] for k in shared} == {k: jf[k] for k in shared}
    assert td.DQNConfig().sampler == "per-sumtree"


def test_table1_twin_keeps_the_reference_protocol():
    assert tt1.SAMPLERS == jt1.SAMPLERS and tt1.AGENTS == jt1.AGENTS
    assert tt1.ENVS == jt1.ENVS and tt1.PARITY_RATIO == jt1.PARITY_RATIO
    for amper, per in ((150.0, 300.0), (100.0, 300.0), (-150.0, -100.0),
                       (-170.0, -100.0), (0.0, 0.0)):
        assert tt1.within_parity(amper, per) == jt1.within_parity(amper, per)
    np.testing.assert_array_equal(
        tt1.stack_keys((3, 7)).numpy(),
        np.asarray(jax.random.key_data(jt1.jnp_stack_keys((3, 7)))))


def test_table1_twin_runs_and_reports(capsys):
    """A tiny ``--parity`` run on the CPU: the last line is the JSON
    summary, and the exit code says whether the gate held."""
    rc = tt1.main(["--parity", "--steps", "210", "--seeds", "1",
                   "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    summary = json.loads(last)
    assert set(summary["scores"]["cartpole"]) == {"double/per-cumsum",
                                                  "double/amper-fr"}
    assert rc == (0 if all(summary["gates"].values()) else 1)
    assert summary["gpu"] is None and summary["wall_s"] > 0
