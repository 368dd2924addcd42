"""The port's DQN slice against the JAX reference.

Both packages start from one state (the reference's ``init`` carried over
with :func:`repro_torch.interop.agent_state_from_jax`) and take 30
``agent_step``s on the same step keys.  Actions, sampled replay rows,
ring position and write stamps must agree exactly; parameters, Adam
moments and TD errors within rtol 1e-5 / atol 1e-6, because XLA and
torch sum the matmuls in different orders.  A quantized priority may
differ by one code only where the two packages' float priorities (from
those TD errors, or from the running max priority for new rows) round to
the two codes.  Such a row can cross a selection boundary (AMPER-k's
kNN radius) and change a draw; the step is then taken again from the
reference's state, on whose table the port's draw must be exact.  Where
the jitted reference's AMPER-k draw disagrees with its own functions
(ROADMAP C9), the port's draw must equal those functions' draw, and
the loop goes on from the reference's state after the step.

On the pixel envs the uint8 frames, stacks and the frame store's rows
agree exactly.  The conv heads' sums (36 terms a conv output, 1,024 a
dense row) round otherwise in XLA and torch, and Adam's normalised steps
let those differences grow: over 30 free steps the parameters leave
rtol 1e-5.  So each pixel step starts the port from the reference's
state, as the Acrobot env test does, and the rules above hold over the
step, but one: TD errors that agree within the tolerance (about 1e-6
absolute here) can lie up to 3 codes apart at 24 fractional bits, so a
pixel priority may differ by as many codes as lie between the two
packages' float priorities.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.amper as ja
import repro.core.quantize as jqz
from repro.models import qhead as jqh
from repro.rl import dqn as jd
from repro.rl import envs as jenvs
from repro_torch import interop, prng
from repro_torch.core import quantize as tqz
from repro_torch.models import qhead as tqh
from repro_torch.models.qhead import tree_leaves
from repro_torch.rl import dqn as td
from repro_torch.rl import envs as tenvs

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=RTOL,
                               atol=ATOL)


def _close_trees(jtree, ttree):
    jl = jax.tree.leaves(jtree)
    tl = tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(a, b)


def test_cartpole_vector_env_matches_reference():
    n = 8
    jv = jenvs.VectorEnv(jenvs.make_env("cartpole"), n)
    tv = tenvs.VectorEnv(tenvs.make_env("cartpole"), n, device="cpu")
    js = jv.reset(jax.random.key(0))
    ts = tv.reset(prng.key(0))
    np.testing.assert_array_equal(np.asarray(js.x), ts.x.numpy())  # exact
    step = jax.jit(jv.step)
    keys = jax.random.split(jax.random.key(1), 60)
    tkeys = prng.split(prng.key(1), 60)
    actions = np.random.default_rng(0).integers(0, 2, (60, n)).astype(np.int32)
    for i in range(60):
        js, jobs, jr, jdone, jterm = step(js, actions[i], keys[i])
        ts, tobs, tr, tdone, tterm = tv.step(ts, torch.from_numpy(actions[i]),
                                             tkeys[i])
        _close(jobs, tobs)
        _close(js.x, ts.x)
        np.testing.assert_array_equal(np.asarray(jdone), tdone.numpy())
        np.testing.assert_array_equal(np.asarray(jterm), tterm.numpy())
        np.testing.assert_array_equal(np.asarray(js.t), ts.t.numpy())
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


@pytest.mark.parametrize("kind", ["mlp", "dueling"])
def test_qheads_match_reference(kind):
    jh = jqh.make_qhead(kind, (4,), 32, 3)
    th = tqh.make_qhead(kind, (4,), 32, 3, device="cpu")
    jp = jh.init(jax.random.key(2))
    _close_trees(jp, th.init(prng.key(2)))      # He init: normal draws
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(1).standard_normal((16, 4)).astype(np.float32)
    _close(jh.apply(jp, x), th.apply(tp, torch.from_numpy(x)))


@pytest.mark.parametrize("kind", ["conv", "conv-dueling"])
def test_conv_qheads_and_gradients_match_reference(kind):
    """The conv heads on [B, 10, 10, 4] stacks and on one [10, 10, 4]
    stack: He init (normal draws), Q-values, and the gradient of every
    parameter under the learner's loss (the mean squared TD error of the
    taken actions) at the DQN's batch of 64, with the reference's HWIO
    kernel carried over as is."""
    shape, batch = (10, 10, 4), 64
    jh = jqh.make_qhead(kind, shape, 32, 3)
    th = tqh.make_qhead(kind, shape, 32, 3, device="cpu")
    jp = jh.init(jax.random.key(2))
    _close_trees(jp, th.init(prng.key(2)))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert tuple(tp["conv"]["w"].shape) == (3, 3, 4, tqh.CONV_CHANNELS)
    rng = np.random.default_rng(1)
    x = (rng.integers(0, 256, (batch,) + shape).astype(np.float32)
         * np.float32(1 / 255))
    _close(jax.jit(jh.apply)(jp, x), th.apply(tp, torch.from_numpy(x)))
    _close(jh.apply(jp, x[3]), th.apply(tp, torch.from_numpy(x[3])))
    action = rng.integers(0, 3, batch)
    target = rng.standard_normal(batch).astype(np.float32)

    def jloss(p):
        qa = jnp.take_along_axis(jh.apply(p, x), action[:, None], 1)[:, 0]
        return jnp.mean((qa - target) ** 2)

    jg = jax.jit(jax.grad(jloss))(jp)
    tp = tqh.tree_map(lambda t: t.requires_grad_(True), tp)
    qa = th.apply(tp, torch.from_numpy(x)).gather(
        1, torch.from_numpy(action)[:, None])[:, 0]
    loss = ((qa - torch.from_numpy(target)) ** 2).mean()
    tg = torch.autograd.grad(loss, tree_leaves(tp))
    jl = jax.tree.leaves(jg)
    assert len(jl) == len(tg)
    for a, b in zip(jl, tg):
        _close(a, b)


def test_conv_head_refuses_small_or_flat_shapes():
    with pytest.raises(ValueError, match="too small"):
        tqh.make_qhead("conv", (2, 5, 4), device="cpu")
    with pytest.raises(ValueError, match=r"\(H, W, C\)"):
        tqh.make_qhead("conv-dueling", (4,), device="cpu")
    with pytest.raises(ValueError, match="conv head"):
        tqh.make_qhead("mlp", (10, 10, 4), device="cpu")


def _jax_peek(jdq, batch):
    """The reference agent_step's sampled rows and TD errors, recomputed
    from its pieces (pure functions, so the state is untouched)."""

    def peek(state, key):
        k_act, k_sample = jax.random.split(key)
        _, _, tr = jdq.act(state.params, state.env_state, state.obs,
                           state.step, k_act)
        buf = jdq.replay.add_batch(state.buffer, tr)
        idx, b, w = jdq.replay.sample(buf, k_sample, batch,
                                      beta=jdq.beta_at(state.step))
        out = jdq.learn(state.params, state.target_params, state.opt_m,
                        state.opt_v, state.step, b, w)
        return idx, out[3]

    return jax.jit(peek)


def _jax_table(jdq):
    """The reference agent_step's sampler state after this step's ring
    write, and the key of its draw."""

    def table(state, key):
        k_act, k_sample = jax.random.split(key)
        _, _, tr = jdq.act(state.params, state.env_state, state.obs,
                           state.step, k_act)
        return jdq.replay.add_batch(state.buffer, tr).sampler_state, k_sample

    return jax.jit(table)


def _amper_k_draw_one_rep(cfg, st, key, batch):
    """The reference's AMPER-k draw (``AmperSampler.sample``, variant
    "k") composed of its own functions, with each V(g_i) computed once."""
    kcsp, kpick = jax.random.split(key)
    kv, kroll = jax.random.split(kcsp)
    vq, n_i = jax.jit(lambda kv, pq, valid: (
        jqz.quantize(ja.group_representatives(kv, cfg), cfg.v_max,
                     cfg.frac_bits),
        ja.knn_sizes(ja.group_representatives(kv, cfg),
                     ja.group_counts(pq, valid, cfg), cfg)))(
            kv, st.pq, st.valid)
    select = {"sort": ja._knn_select_sort,
              "bisect": functools.partial(ja._knn_select_bisect,
                                          frac_bits=cfg.frac_bits),
              "hist": functools.partial(ja._knn_select_hist,
                                        frac_bits=cfg.frac_bits)}
    sel = jax.jit(select[cfg.knn_mode])(st.pq, st.valid, vq, n_i)
    csp = ja._compact(jnp.any(sel, axis=0) & st.valid, cfg.csp_capacity,
                      kroll)
    return ja.sample_from_csp(csp, kpick, batch,
                              jnp.sum(st.valid.astype(jnp.int32)))


def _trace_codes(jpq, tpq, explained, arc, idx, jtd, ttd, jmax, tmax, v_max,
                 one_code=True):
    """Every row whose quantized priority differs is explained: written
    this step (from the max priority or a TD error of this step, both
    within tolerance and each rounding to its package's code), or
    explained earlier and not written since.  The codes differ by one,
    or with ``one_code=False`` by no more codes than lie between the two
    float priorities."""
    idx = idx.tolist()
    written = set(arc) | set(idx)
    keep = {r: why for r, why in explained.items() if r not in written}
    for r in np.flatnonzero(jpq != tpq).tolist():
        gap = abs(int(jpq[r]) - int(tpq[r]))
        assert gap == 1 or not one_code, r
        if r in idx:
            k = len(idx) - 1 - idx[::-1].index(r)   # last occurrence wins
            pj = np.asarray(jax.jit(lambda t: (jnp.abs(t) + 0.01) ** 0.6)(jtd[k]))
            pt = (ttd[k].abs() + 0.01) ** 0.6
            np.testing.assert_allclose(float(jtd[k]), float(ttd[k]),
                                       rtol=RTOL, atol=ATOL)
        elif r in arc:
            pj, pt = jmax, tmax
            np.testing.assert_allclose(float(pj), float(pt), rtol=RTOL)
        else:
            assert r in keep, f"row {r} differs with no write to explain it"
            continue
        assert int(jqz.quantize(pj, v_max)) == int(jpq[r])
        assert int(tqz.quantize(torch.as_tensor(pt), v_max)) == int(tpq[r])
        codes_between = (abs(float(pj) - float(pt))
                         * ((1 << tqz.DEFAULT_FRAC_BITS) - 1) / v_max)
        assert gap <= codes_between + 1, r
        keep[r] = "traced"
    return keep


SLICES = [  # sampler, agent, n_step, the port's fr_mode, env
    pytest.param("amper-fr", "dqn", 1, "fused", "cartpole",
                 id="amper-fr-dqn-1-fused"),
    pytest.param("uniform", "double-dueling", 3, "broadcast", "cartpole",
                 id="uniform-double-dueling-3-broadcast"),
    pytest.param("amper-k", "double", 3, "broadcast", "acrobot",
                 id="acrobot-amper-k-double-3-broadcast"),
    pytest.param("amper-fr", "dueling", 1, "fused", "mountaincar",
                 id="mountaincar-amper-fr-dueling-1-fused"),
    pytest.param("amper-fr", "double-dueling", 3, "fused", "breakout",
                 id="pixel-breakout-amper-fr-double-dueling-3-fused"),
    pytest.param("amper-fr", "dqn", 1, "kernel", "freeway",
                 id="pixel-freeway-amper-fr-dqn-1-kernel"),
]


def _dense(x):
    """A port state field, per-shard tuples joined into one tensor."""
    return torch.cat(x) if isinstance(x, tuple) else x


def thirty_agent_steps(sampler, agent, n_step, fr_mode, mesh=None,
                       env="cartpole"):
    """Start the reference and the port from one state and hold them
    together over 30 ``agent_step``s on ``env`` (see the module
    docstring).  With a sharded ``sampler``, the caller points the
    reference's default mesh at the same shard count as the port's
    ``mesh``."""
    kw = dict(env=env, sampler=sampler, agent=agent, n_step=n_step,
              num_envs=4, replay_size=256, batch=16, hidden=32,
              learn_start=8, target_sync=10)
    jdq = jd.make_dqn(jd.DQNConfig(**kw))
    tdq = td.make_dqn(td.DQNConfig(**kw, amper_fr_mode=fr_mode), device="cpu",
                      mesh=mesh)
    assert getattr(tdq.replay.sampler, "cfg", None) is None or \
        tdq.replay.sampler.cfg.fr_mode == fr_mode
    key = jax.random.key(3)
    js = jdq.init(key)
    ts = interop.agent_state_from_jax(jax.tree.map(np.asarray, js),
                                      device="cpu", sampler=tdq.replay.sampler)
    jkeys = jax.random.split(jax.random.fold_in(key, 1), 30)
    tkeys = prng.split(prng.fold_in(prng.key(3), 1), 30)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jkeys)),
                                  tkeys.numpy())
    pixel = tdq.replay.frame_store is not None
    step = jax.jit(jdq.agent_step)
    peek = _jax_peek(jdq, kw["batch"])
    table = _jax_table(jdq)
    explained = {}
    learned = resynced = 0
    for i in range(30):
        if pixel:   # one step's difference, not 30 compounded ones
            ts = interop.agent_state_from_jax(
                jax.tree.map(np.asarray, js), device="cpu",
                sampler=tdq.replay.sampler)
            explained = {}
        jidx, jtd = peek(js, jkeys[i]) if i >= kw["learn_start"] else (None, None)
        jmax_before = np.asarray(js.buffer.max_priority)
        tmax_before = ts.buffer.max_priority.clone()
        arc = [(ts.buffer.pos + j) % kw["replay_size"] for j in range(4)]
        js_before = js
        js, _ = step(js, jkeys[i])
        ts, tm = tdq.agent_step(ts, tkeys[i])
        if jidx is not None and not np.array_equal(jidx, tm["idx"].numpy()):
            # The port's draw on the reference's own table and key.
            ts_ref, tm_ref = tdq.agent_step(interop.agent_state_from_jax(
                jax.tree.map(np.asarray, js_before), device="cpu",
                sampler=tdq.replay.sampler), tkeys[i])
            if np.array_equal(jidx, tm_ref["idx"].numpy()):
                # A traced one-code row crossed a selection boundary (a
                # kNN radius); go on from the reference's table.
                assert explained, "a draw differs on identical tables"
                tmax_before = interop.to_tensor(
                    np.asarray(js_before.buffer.max_priority), "cpu")
                ts, tm = ts_ref, tm_ref
                explained = {}
                resynced += 1
            else:
                # The jitted reference recomputes V(g_i) in several fusions
                # with different multiply-add contractions, so its kNN
                # radius and its final selection can disagree (ROADMAP
                # C9).  The port's draw equals the reference's own
                # functions with each V(g_i) computed once, and the step
                # goes on from the reference's state after it.
                st, k_sample = table(js_before, jkeys[i])
                want = _amper_k_draw_one_rep(jdq.replay.sampler.cfg, st,
                                             k_sample, kw["batch"])
                np.testing.assert_array_equal(np.asarray(want),
                                              tm_ref["idx"].numpy())
                assert not np.array_equal(np.asarray(want), jidx)
                ts = interop.agent_state_from_jax(
                    jax.tree.map(np.asarray, js), device="cpu",
                    sampler=tdq.replay.sampler)
                explained = {}
                learned += 1
                resynced += 1
                continue
        jb = jax.tree.map(np.asarray, js.buffer)
        tb = ts.buffer
        # exact: actions, ring position, stamps, episode counters
        np.testing.assert_array_equal(jb.storage["action"],
                                      tb.storage["action"].numpy())
        assert int(jb.pos) == tb.pos and int(jb.size) == tb.size
        np.testing.assert_array_equal(jb.write_stamp, tb.write_stamp.numpy())
        np.testing.assert_array_equal(jb.write_gen, tb.write_gen.numpy())
        assert int(js.n_episodes) == int(ts.n_episodes)
        # within tolerance: params, moments, env, returns
        for jt, tt in ((js.params, ts.params), (js.target_params,
                       ts.target_params), (js.opt_m, ts.opt_m),
                       (js.opt_v, ts.opt_v)):
            _close_trees(jt, tt)
        _close(js.last_returns, ts.last_returns)
        if pixel:   # uint8 frames and stacks, exact
            assert ts.obs.dtype == tb.storage["frame"].dtype == torch.uint8
            np.testing.assert_array_equal(np.asarray(js.obs), ts.obs.numpy())
            for k in ("frame", "reward", "done", "terminated"):
                np.testing.assert_array_equal(jb.storage[k],
                                              tb.storage[k].numpy())
        else:
            _close(js.obs, ts.obs)
            for k in ("obs", "next_obs", "reward"):
                _close(jb.storage[k], tb.storage[k])
        if jidx is None:
            assert tm["idx"] is None
            continue
        learned += 1
        np.testing.assert_array_equal(np.asarray(jidx), tm["idx"].numpy())
        _close(jtd, tm["td"])
        if sampler.startswith("amper"):
            explained = _trace_codes(
                jb.sampler_state.pq, _dense(tb.sampler_state.pq).numpy(),
                explained, arc if n_step == 1 or pixel else [], tm["idx"],
                np.asarray(jtd), tm["td"], jmax_before, tmax_before,
                tdq.cfg.v_max, one_code=not pixel)
        else:
            _close(jdq.replay.sampler.priorities(js.buffer.sampler_state),
                   tdq.replay.sampler.priorities(tb.sampler_state))
    assert learned == 30 - kw["learn_start"]
    return resynced


@pytest.mark.parametrize("sampler,agent,n_step,fr_mode,env", SLICES)
def test_thirty_agent_steps_match_reference(sampler, agent, n_step, fr_mode,
                                            env):
    thirty_agent_steps(sampler, agent, n_step, fr_mode, env=env)


def test_train_and_evaluate_run_on_cpu():
    cfg = td.DQNConfig(sampler="amper-fr", amper_fr_mode="kernel",
                       num_envs=2, replay_size=64, batch=8, hidden=16,
                       learn_start=4)
    dqn = td.make_dqn(cfg, device="cpu")
    assert dqn.replay.sampler.cfg.fr_mode == "kernel"
    st, metrics = dqn.train(prng.key(0), 12)
    assert st.step == 12 and len(metrics["loss"]) == 12
    assert all(torch.isfinite(t).all() for t in tree_leaves(st.params))
    ret = dqn.evaluate(st, prng.key(1), n_episodes=2)
    assert np.isfinite(ret) and ret >= 1.0


@pytest.mark.parametrize("env,agent", [("breakout", "dqn"),
                                       ("freeway", "double-dueling")])
def test_pixel_train_and_evaluate_run_on_cpu(env, agent):
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


@pytest.mark.parametrize("env,agent,n_step", [("breakout", "dueling", 3),
                                              ("freeway", "dqn", 1)])
def test_train_many_pixel_seeds_match_reference(env, agent, n_step):
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


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.make_dqn(td.DQNConfig())


@pytest.mark.parametrize("entry", [
    "vector_env", "make_qhead", "mlp_init", "to_tensor", "params_from_jax",
    "amper_sampler", "uniform_sampler", "make_sampler", "lm_params_from_jax",
    "lm_cache_from_jax", "lm_init_cache", "lm_init_params", "serve_cli",
    "amper_k_sampler", "make_sampler_amper_k", "train_many",
    "vector_env_acrobot", "vector_env_mountaincar", "vector_env_breakout",
    "vector_env_freeway", "conv_init", "make_qhead_conv", "make_dqn_pixel"])
def test_each_entry_point_defaults_to_cuda(entry):
    """Left at its default device, every entry point asks for the card,
    so a state built without ``device=`` never lands on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_reduced_config
    from repro_torch.core import amper as ta
    from repro_torch.core import samplers as tsm
    from repro_torch.launch import serve
    from repro_torch.models.model_api import Model

    calls = {
        "vector_env": lambda: tenvs.VectorEnv(tenvs.make_env("cartpole"), 2),
        "make_qhead": lambda: tqh.make_qhead("mlp", (4,)),
        "mlp_init": lambda: tqh.mlp_init(prng.key(0), [4, 2]),
        "to_tensor": lambda: interop.to_tensor(np.zeros(3, np.float32)),
        "params_from_jax": lambda: interop.params_from_jax(
            [{"w": np.zeros((4, 2), np.float32),
              "b": np.zeros(2, np.float32)}]),
        "amper_sampler": lambda: ta.AmperSampler(ta.AmperConfig(capacity=8)),
        "uniform_sampler": lambda: ta.UniformSampler(8),
        "make_sampler": lambda: tsm.make_sampler("amper-fr", 8),
        "lm_params_from_jax": lambda: interop.lm_params_from_jax(
            {"embed": np.zeros((4, 2), np.float32)}),
        "lm_cache_from_jax": lambda: interop.lm_cache_from_jax(
            {"blocks": {"k": np.zeros((1, 1, 1, 2, 8), np.float32)},
             "len": np.int32(0)}),
        "lm_init_cache": lambda: Model.from_config(
            get_reduced_config("stablelm-1.6b")).init_cache(1, 8),
        "lm_init_params": lambda: Model.from_config(
            get_reduced_config("stablelm-1.6b")).init_params(
                torch.Generator().manual_seed(0)),
        "serve_cli": lambda: serve.main(["--reduced"]),
        "amper_k_sampler": lambda: ta.AmperSampler(
            ta.AmperConfig(capacity=8, knn_mode="bisect"), variant="k"),
        "make_sampler_amper_k": lambda: tsm.make_sampler("amper-k", 8),
        "train_many": lambda: td.make_dqn(td.DQNConfig(
            env="acrobot", sampler="amper-k")).train_many(
                torch.stack([prng.key(0), prng.key(1)]), 2),
        "vector_env_acrobot": lambda: tenvs.VectorEnv(
            tenvs.make_env("acrobot"), 2),
        "vector_env_mountaincar": lambda: tenvs.VectorEnv(
            tenvs.make_env("mountaincar"), 2),
        "vector_env_breakout": lambda: tenvs.VectorEnv(
            tenvs.make_env("breakout"), 2),
        "vector_env_freeway": lambda: tenvs.VectorEnv(
            tenvs.make_env("freeway"), 2),
        "conv_init": lambda: tqh.conv_init(prng.key(0), 4),
        "make_qhead_conv": lambda: tqh.make_qhead("conv", (10, 10, 4)),
        "make_dqn_pixel": lambda: td.make_dqn(td.DQNConfig(env="breakout")),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
