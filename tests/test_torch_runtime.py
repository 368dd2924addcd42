"""The port's async runtime (``repro_torch.runtime``) against the reference's.

Counterpart of ``tests/test_runtime.py``, plus the cross-package pins:
the runtime's PRNG streams equal the reference's key for key; one
rollout chunk, started from the reference's params, env state, n-step
window and key carried across by ``interop``, emits the reference's
actions, flags, ``valid`` rows and finished returns exactly and its
float rows within rtol 1e-5 / atol 1e-6 (XLA fuses the env update
otherwise inside the scan), 1-step and 3-step;
the slab draw on a carried-across buffer gives the reference's rows,
stamps and batch exactly and its IS weights within rtol 1e-6 (XLA and
torch each round the ``pow``), split with the reference's interleaving;
the slab learner's params, moments, TD errors and losses agree with the
reference's scan within rtol 1e-4 / atol 1e-5, the tolerance
``tests/test_runtime.py`` holds the sync service to (XLA and torch sum
the matmuls in different orders); the sync service agrees with the
reference's sync service at that tolerance and equals the port's own
``train`` bit for bit.

The async contracts are the reference's: every learner batch's feedback
applied exactly once and in order, the beta of a failed draw never
published, a checkpoint meta's topology checked, the frame store's
single-actor rule, telemetry in the reference's JSONL and Prometheus
schema (read by both packages), the health probe equal to the draw it
follows, and an acyclic lock-order graph.  Every ``svc.run`` runs in a
daemon thread joined with a timeout (:func:`run_bounded`), so a hang
fails its test instead of hanging the whole test run.
"""
import ast
import dataclasses
import pathlib
import queue
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import replay_buffer as jrb
from repro.core import samplers as jsamplers
from repro.rl import dqn as jd
from repro.runtime import ReplayService as JService
from repro.runtime import actor as jactor
from repro.runtime import learner as jlearner
from repro.runtime import pipeline as jpipeline
from repro.runtime import prng as jrprng
from repro.train import checkpoint as jck
from repro_torch import interop, obs, prng
from repro_torch.analysis import locks
from repro_torch.core import replay_buffer as trb
from repro_torch.core import samplers as tsamplers
from repro_torch.models.qhead import tree_leaves
from repro_torch.rl import dqn as td
from repro_torch.rl.envs import EnvState
from repro_torch.runtime import ReplayService
from repro_torch.runtime import prng as rprng
from repro_torch.runtime import streams
from repro_torch.runtime.actor import make_rollout
from repro_torch.runtime.learner import make_slab_learner
from repro_torch.runtime.pipeline import PrefetchPipeline, make_slab_sampler
from repro_torch.train.checkpoint import CheckpointManager

RUN_TIMEOUT = 120.0   # seconds a service run may take before it fails
SERVICE_RTOL, SERVICE_ATOL = 1e-4, 1e-5   # tests/test_runtime.py's


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def run_bounded(svc, key, n, manager=None, timeout=RUN_TIMEOUT):
    """``svc.run(key, n, manager)`` in a daemon thread joined with a
    timeout; fails if it is still running, re-raises what it raised."""
    out = {}

    def target():
        try:
            out["result"] = svc.run(key, n, manager=manager)
        except BaseException as e:  # re-raised on the test's thread
            out["error"] = e

    th = threading.Thread(target=target, name="bounded-run", daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"svc.run did not finish in {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["result"]


def small_cfg(**kw):
    base = dict(num_envs=2, replay_size=256, batch=16, learn_start=8,
                eps_decay_steps=200, target_sync=50, v_max=8.0)
    base.update(kw)
    return td.DQNConfig(**base)


def assert_finite_params(params):
    for leaf in tree_leaves(params):
        assert bool(torch.isfinite(leaf).all())


# --- PRNG stream discipline --------------------------------------------------

def test_runtime_keys_match_reference_and_never_repeat():
    """actor_keys / chunk_key / sample_key equal the reference's bit for
    bit, and no key is consumed twice across actors, chunks and draws."""
    seen = set()
    for seed in (0, 7, 2 ** 31 + 5):
        jkey, tkey = jax.random.key(seed), prng.key(seed)
        for actor_id in range(3):
            jr, jroll = jrprng.actor_keys(jkey, actor_id)
            tr, troll = rprng.actor_keys(tkey, actor_id)
            for jk, tk in [(jr, tr)] + [
                    (jrprng.chunk_key(jroll, c), rprng.chunk_key(troll, c))
                    for c in range(3)]:
                want = np.asarray(jax.random.key_data(jk))
                np.testing.assert_array_equal(want, tk.numpy())
                fp = (seed,) + tuple(want.tolist())
                assert fp not in seen
                seen.add(fp)
        for draw in range(5):
            want = np.asarray(jax.random.key_data(
                jrprng.sample_key(jkey, draw)))
            np.testing.assert_array_equal(
                want, rprng.sample_key(tkey, draw).numpy())
            fp = (seed,) + tuple(want.tolist())
            assert fp not in seen
            seen.add(fp)


# --- one rollout chunk -------------------------------------------------------

CHUNK = 6
# Inside the reference's scan XLA fuses the cart-pole update (and the
# n-step return) otherwise than in one env step, so the float rows and
# the env's float state may differ in the last place: they are held
# within test_torch_dqn's RTOL 1e-5 / ATOL 1e-6; actions, flags, returns
# and counters exactly.
FLOAT_ROWS = ("obs", "next_obs", "reward")


def _close_float(want, got, err_msg=""):
    np.testing.assert_allclose(want, got, rtol=1e-5, atol=1e-6,
                               err_msg=err_msg)


@pytest.mark.parametrize("agent,n_step", [("dqn", 1), ("double", 3)])
def test_rollout_chunk_matches_reference(agent, n_step):
    """Two chunks of the reference's jitted rollout; each is taken by the
    port from the reference's inputs (params, env state, obs, episode
    returns, the actor's n-step window, the chunk key) carried across,
    and must give the same transitions, valid flags, finished returns
    and carry (floats within ``FLOAT_ROWS``' tolerance).  With 3-step the first chunk spans the warm-up,
    the second starts mid-window."""
    kw = dict(agent=agent, n_step=n_step, num_envs=4, replay_size=256,
              batch=16, hidden=32, eps_decay_steps=20)
    jdq = jd.make_dqn(jd.DQNConfig(**kw))
    tdq = td.make_dqn(td.DQNConfig(**kw), device="cpu")
    jroll = jax.jit(jactor.make_rollout(jdq, CHUNK))
    troll = make_rollout(tdq, CHUNK)
    key = jax.random.key(5)
    params = jax.tree.map(np.asarray, jdq.init(key).params)
    k_reset, k_roll = jrprng.actor_keys(key, 1)
    _, t_roll = rprng.actor_keys(prng.key(5), 1)
    env_state = jdq.venv.reset(k_reset)
    obs_ = jdq.init_obs(env_state)
    ep_ret = jnp.zeros(4)
    nstep = jdq.replay.nstep_init(jdq.example_transition)
    for chunk in range(2):
        step = chunk * CHUNK
        jout = jax.tree.map(np.asarray, jroll(
            params, env_state, obs_, jnp.int32(step), ep_ret, nstep,
            jrprng.chunk_key(k_roll, chunk)))
        j_env, j_obs, j_ret, j_ns, j_tr, j_valid, j_fin = jout
        t_env, t_obs, t_ret, t_ns, t_tr, t_valid, t_fin = troll(
            interop.params_from_jax(params, "cpu"),
            EnvState(x=interop.to_tensor(np.asarray(env_state.x), "cpu"),
                     t=interop.to_tensor(np.asarray(env_state.t), "cpu")),
            interop.to_tensor(np.asarray(obs_), "cpu"), step,
            interop.to_tensor(np.asarray(ep_ret), "cpu"),
            interop.nstep_state_from_jax(
                jax.tree.map(np.asarray, nstep), "cpu"),
            rprng.chunk_key(t_roll, chunk))
        valid = np.broadcast_to(j_valid, (CHUNK,))
        assert t_valid == valid.tolist()
        if n_step == 3 and chunk == 0:
            assert t_valid == [False, False] + [True] * (CHUNK - 2)
        np.testing.assert_array_equal(j_fin, t_fin.numpy())
        np.testing.assert_array_equal(j_ret, t_ret.numpy())
        np.testing.assert_array_equal(j_env.t, t_env.t.numpy())
        assert t_tr is not None and set(t_tr) == set(j_tr)
        for k in j_tr:
            compare = (_close_float if k in FLOAT_ROWS
                       else np.testing.assert_array_equal)
            compare(j_tr[k][valid], t_tr[k].numpy(), err_msg=k)
        _close_float(j_env.x, t_env.x.numpy())
        _close_float(j_obs, t_obs.numpy())
        if n_step > 1:
            assert int(j_ns.count) == t_ns.count
            assert int(j_ns.pos) == t_ns.pos
            for k in j_ns.ring:
                compare = (_close_float if k in FLOAT_ROWS
                           else np.testing.assert_array_equal)
                compare(j_ns.ring[k], t_ns.ring[k].numpy(), err_msg=k)
        env_state, obs_, ep_ret, nstep = (jroll(
            params, env_state, obs_, jnp.int32(step), ep_ret, nstep,
            jrprng.chunk_key(k_roll, chunk))[:4])


# --- the slab draw -----------------------------------------------------------

BATCH, SLAB = 16, 4


def _filled_buffers(kind, fr_mode):
    """A reference buffer with 200 rows and fed-back priorities, and the
    port's buffer holding the same state (carried across)."""
    cap = 256
    js = jsamplers.make_sampler(kind, cap, v_max=8.0, min_csp=BATCH)
    ts = tsamplers.make_sampler(kind, cap, v_max=8.0, min_csp=BATCH,
                                fr_mode=fr_mode, device="cpu")
    jb = jrb.ReplayBuffer(cap, js)
    tb = trb.ReplayBuffer(cap, ts)
    example = {"obs": np.zeros(3, np.float32), "action": np.int32(0),
               "reward": np.float32(0)}
    rng = np.random.default_rng(11)
    st = jb.init(example)
    st = jb.add_batch(st, {
        "obs": rng.standard_normal((200, 3)).astype(np.float32),
        "action": rng.integers(0, 2, 200).astype(np.int32),
        "reward": rng.standard_normal(200).astype(np.float32)})
    idx = rng.integers(0, 200, 120).astype(np.int32)
    st = jb.update_priorities(st, idx, rng.exponential(1.5, 120).astype(
        np.float32))
    carried = interop.replay_state_from_jax(jax.tree.map(np.asarray, st),
                                            "cpu")
    return jb, st, tb, carried


@pytest.mark.parametrize("kind,fr_mode", [
    ("amper-fr", "fused"), ("amper-fr", "kernel"), ("per-sumtree", None),
    ("uniform", None)])
def test_slab_sampler_matches_reference(kind, fr_mode):
    jb, jstate, tb, tstate = _filled_buffers(kind, fr_mode or "broadcast")
    key = jax.random.key(21)
    jout = jax.tree.map(np.asarray, jax.jit(
        jpipeline.make_slab_sampler(jb, BATCH, SLAB))(
            jstate, key, jnp.float32(0.7)))
    tkey = prng.key(21)
    idx, batch, w, stamp = make_slab_sampler(tb, BATCH, SLAB)(tstate, tkey,
                                                              0.7)
    assert idx.shape == (SLAB, BATCH) and stamp.shape == (SLAB, BATCH, 2)
    np.testing.assert_array_equal(jout[0], idx.numpy())
    for k in jout[1]:
        np.testing.assert_array_equal(jout[1][k], batch[k].numpy(),
                                      err_msg=k)
    np.testing.assert_allclose(jout[2], w.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(jout[3], stamp.numpy())
    # the interleaving: slab row j holds flat rows {j, S+j, 2S+j, ...}
    flat = tb.sample(tstate, tkey, BATCH * SLAB, beta=0.7)[0]
    for j in range(SLAB):
        assert torch.equal(idx[j], flat[j::SLAB])


# --- the slab learner --------------------------------------------------------

@pytest.mark.parametrize("agent,n_step", [("dqn", 1), ("double-dueling", 3)])
def test_slab_learner_matches_reference_scan(agent, n_step):
    kw = dict(agent=agent, n_step=n_step, num_envs=2, batch=BATCH,
              hidden=32)
    jdq = jd.make_dqn(jd.DQNConfig(**kw))
    tdq = td.make_dqn(td.DQNConfig(**kw), device="cpu")
    st0, st1 = jdq.init(jax.random.key(0)), jdq.init(jax.random.key(1))
    rng = np.random.default_rng(3)
    shape = (SLAB, BATCH)
    batch = {"obs": rng.standard_normal(shape + (4,)).astype(np.float32),
             "action": rng.integers(0, 2, shape).astype(np.int32),
             "reward": rng.standard_normal(shape).astype(np.float32),
             "next_obs": rng.standard_normal(shape + (4,)).astype(np.float32),
             "done": (rng.random(shape) < 0.2).astype(np.float32),
             "terminated": (rng.random(shape) < 0.1).astype(np.float32)}
    weights = rng.uniform(0.3, 1.0, shape).astype(np.float32)
    moments = jax.tree.map(
        lambda p: np.abs(rng.standard_normal(p.shape)).astype(np.float32)
        * 1e-3, st0.params)
    args = (st0.params, st1.params, moments, moments)
    want = jax.tree.map(np.asarray, jax.jit(jlearner.make_slab_learner(jdq))(
        *args, jnp.int32(40), batch, weights))
    got = make_slab_learner(tdq)(
        *(interop.params_from_jax(jax.tree.map(np.asarray, a), "cpu")
          for a in args), 40,
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(weights))
    for w_, g in zip(want[:3], got[:3]):
        for x, y in zip(jax.tree.leaves(w_), tree_leaves(g)):
            np.testing.assert_allclose(x, y.numpy(), rtol=SERVICE_RTOL,
                                       atol=SERVICE_ATOL)
    for w_, g in zip(want[3:], got[3:]):
        assert g.shape == w_.shape
        np.testing.assert_allclose(w_, g.numpy(), rtol=SERVICE_RTOL,
                                   atol=SERVICE_ATOL)


# --- strict-sync equivalence -------------------------------------------------

SYNC_CASES = [("dqn", 1), ("double", 3), ("dueling", 2)]
SYNC_STEPS = 120


def _sync_kw(agent, n_step):
    return dict(agent=agent, n_step=n_step, num_envs=2, replay_size=256,
                batch=16, hidden=32, learn_start=20, eps_decay_steps=100,
                target_sync=10)


def test_sync_requires_single_actor():
    with pytest.raises(ValueError, match="sync mode"):
        ReplayService(td.DQNConfig(), sync=True, num_actors=2, device="cpu")


def test_service_defaults_to_the_card():
    """The default device is the card: without one, construction raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReplayService(td.DQNConfig(), sync=True, num_actors=1)


@pytest.mark.parametrize("agent,n_step", SYNC_CASES)
def test_sync_service_matches_reference_sync_service(agent, n_step):
    kw = _sync_kw(agent, n_step)
    ref = JService(jd.DQNConfig(**kw), sync=True, num_actors=1).run(
        jax.random.key(0), SYNC_STEPS)
    got = ReplayService(td.DQNConfig(**kw), sync=True, num_actors=1,
                        device="cpu").run(prng.key(0), SYNC_STEPS)
    assert got.metrics["learner_steps"] == ref.metrics["learner_steps"] \
        == SYNC_STEPS - kw["learn_start"]
    np.testing.assert_allclose(ref.metrics["return_curve"],
                               got.metrics["return_curve"], rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(jax.tree.leaves(ref.params), tree_leaves(got.params)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                   rtol=SERVICE_RTOL, atol=SERVICE_ATOL)
    np.testing.assert_array_equal(np.asarray(ref.buffer.storage["action"]),
                                  got.buffer.storage["action"].numpy())
    assert set(got.metrics) == set(ref.metrics)


@pytest.mark.parametrize("agent,n_step", SYNC_CASES)
def test_sync_service_equals_train(agent, n_step):
    """Sync mode is the trainer: the same steps on the same keys, so its
    params, moments and buffer equal ``train``'s bit for bit."""
    cfg = td.DQNConfig(**_sync_kw(agent, n_step))
    state, metrics = td.make_dqn(cfg, device="cpu").train(prng.key(4),
                                                          SYNC_STEPS)
    res = ReplayService(cfg, sync=True, num_actors=1, device="cpu").run(
        prng.key(4), SYNC_STEPS)
    for a, b in ((state.params, res.params),
                 (state.target_params, res.target_params)):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)
    for k in state.buffer.storage:
        assert torch.equal(state.buffer.storage[k], res.buffer.storage[k])
    for x, y in zip(state.buffer.sampler_state, res.buffer.sampler_state):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(
        torch.stack(metrics["return_mean"]).numpy(),
        res.metrics["return_curve"])


# --- async mode: deferred feedback contract ----------------------------------

@pytest.mark.parametrize("sampler,agent,n_step,fr_mode", [
    ("per-sumtree", "dqn", 1, "broadcast"),
    ("amper-fr", "dqn", 1, "broadcast"),
    ("amper-fr", "double", 3, "broadcast"),
    ("amper-fr", "dqn", 1, "fused")])
def test_async_feedback_exactly_once_in_order(sampler, agent, n_step,
                                              fr_mode):
    """Every learner batch's deferred priority update is applied exactly
    once, in learner-step order, with non-negative staleness, with the
    actors' own n-step windows and through the fused draw too."""
    cfg = small_cfg(sampler=sampler, agent=agent, n_step=n_step,
                    amper_fr_mode=fr_mode)
    svc = ReplayService(cfg, num_actors=2, chunk_len=4, slab=2,
                        queue_size=4, max_replay_ratio=64,
                        feedback_log=True, device="cpu")
    res = run_bounded(svc, prng.key(1), 20)
    m = res.metrics
    assert m["learner_steps"] == 20
    assert m["feedback_seqs"] == list(range(20)), m["feedback_seqs"]
    assert m["staleness"]["count"] == 20
    assert 0 <= m["staleness"]["mean"] <= m["staleness"]["max"]
    assert m["frames"] > 0 and res.buffer.size > 0
    assert np.isfinite(svc.dqn.evaluate(res.params, prng.key(2), 2))
    assert_finite_params(res.params)


def test_frame_store_service_requires_single_actor():
    cfg = small_cfg(env="breakout", sampler="amper-fr", history_len=4)
    with pytest.raises(ValueError, match="num_actors"):
        ReplayService(cfg, sync=False, num_actors=2, device="cpu")
    svc = ReplayService(cfg, num_actors=1, chunk_len=4, slab=2,
                        max_replay_ratio=64, feedback_log=True, device="cpu")
    res = run_bounded(svc, prng.key(3), 8)
    assert res.metrics["feedback_seqs"] == list(range(8))
    assert res.buffer.storage["frame"].dtype == torch.uint8


def test_check_meta_missing_key_is_loud():
    ok = {"mode": "async", "num_actors": 2}
    ReplayService._check_meta(ok, "async", num_actors=2)
    with pytest.raises(ValueError, match="mode"):
        ReplayService._check_meta({"mode": "sync"}, "async")
    with pytest.raises(ValueError, match="num_actors"):
        ReplayService._check_meta({"mode": "async"}, "async", num_actors=2)
    with pytest.raises(ValueError, match="num_actors=3"):
        ReplayService._check_meta({"mode": "async", "num_actors": 3},
                                  "async", num_actors=2)


def test_prefetch_beta_not_published_for_a_draw_that_never_happened():
    """``last_beta`` is the beta of the latest *completed* draw: a draw
    that raises leaves it untouched, and the guard is released."""
    state = SimpleNamespace(size=64)

    def failing_sample(st, key, beta):
        raise RuntimeError("sampler exploded")

    stop = threading.Event()
    guard = streams.StateGuard()
    p = PrefetchPipeline(failing_sample, lambda: (state, 0),
                         out_q=queue.Queue(2), stop=stop,
                         base_key=prng.key(0), slab=2, min_size=1,
                         guard=guard, device=torch.device("cpu"),
                         beta_fn=lambda v: 0.7)
    p.start()
    p.join(timeout=10.0)
    assert not p.is_alive()
    assert isinstance(p.error, RuntimeError)
    assert p.last_beta is None
    assert p.draws == 0
    assert stop.is_set() and not guard.lock.locked()


def test_a_failing_stage_fails_the_run():
    """No stage swallows an error: a draw that raises stops the run, and
    ``run`` raises it from the prefetch pipeline."""
    svc = ReplayService(small_cfg(sampler="amper-fr"), num_actors=1,
                        chunk_len=4, slab=2, device="cpu")

    def exploding(state, key, beta):
        raise RuntimeError("draw kernel failed")

    svc._sample = exploding
    with pytest.raises(RuntimeError, match="prefetch pipeline failed") as e:
        run_bounded(svc, prng.key(0), 8)
    assert "draw kernel failed" in str(e.value.__cause__)


def test_pause_gate_parks_and_resumes_workers():
    """The quiesce utility: paused workers park at their next check
    (``wait_parked`` sees them all), run again after ``resume``, and a
    stop releases a parked worker."""
    from repro_torch.runtime.actor import PauseGate

    gate, stop = PauseGate(), threading.Event()
    ticks = [0, 0]

    def worker(i):
        while not stop.is_set():
            gate.wait_if_paused(stop)
            ticks[i] += 1
            stop.wait(0.001)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    gate.pause()
    assert gate.paused and gate.wait_parked(2, stop, timeout=10.0)
    frozen = list(ticks)
    stop.wait(0.05)
    assert ticks == frozen                  # parked workers do nothing
    gate.resume()
    stop.wait(0.05)
    assert all(t > f for t, f in zip(ticks, frozen))
    gate.pause()
    assert gate.wait_parked(2, stop, timeout=10.0)
    stop.set()                              # releases the parked workers
    for t in threads:
        t.join(timeout=10.0)
        assert not t.is_alive()


def test_stream_helpers_on_the_cpu():
    """On the CPU the hand-off helpers are host-only no-ops, ``clone``
    copies every tensor of a NamedTuple tree and keeps host counters."""
    assert streams.stage_stream(torch.device("cpu")) is None
    assert streams.mark(None) is None
    state = trb.ReplayBuffer(8, tsamplers.make_sampler(
        "per-sumtree", 8, device="cpu")).init({"x": torch.zeros(())})
    twin = streams.clone(state)
    assert type(twin) is type(state) and twin.pos == state.pos
    pairs = list(zip(streams.tensors(state), streams.tensors(twin)))
    assert len(pairs) == 6
    for a, b in pairs:
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    streams.accept(None, None, state)
    guard = streams.StateGuard()
    with guard.use(None) as op:
        assert guard.lock.locked()
    assert op.event is None and not guard.lock.locked()


# --- telemetry ---------------------------------------------------------------

def test_service_async_telemetry_jsonl(tmp_path, capsys):
    """The reference's schema: RunResult keys, the JSONL timeline with the
    health gauges, the Prometheus file; both packages read the log and
    the exposition the same."""
    from repro import obs as jobs
    from repro.obs import report as jreport
    from repro_torch.obs import report

    jpath, ppath = str(tmp_path / "run.jsonl"), str(tmp_path / "run.prom")
    tel = obs.Telemetry(metrics_out=jpath, prometheus_out=ppath,
                        probe_every=4, window=50)
    svc = ReplayService(small_cfg(sampler="amper-fr"), num_actors=2,
                        chunk_len=4, slab=2, max_replay_ratio=64,
                        telemetry=tel, device="cpu")
    m = run_bounded(svc, prng.key(0), 40).metrics
    for k in ("staleness", "queue_depth", "snapshot", "checkpoint"):
        assert k in m, k
    assert m["staleness"]["count"] == 40
    assert m["staleness"]["p50"] <= m["staleness"]["p95"] <= \
        m["staleness"]["p99"] <= m["staleness"]["max"]
    assert {"kl_nats", "csp_occupancy", "fallback_draws",
            "probe_draws"} <= set(m["health"])
    assert m["health"]["probe_draws"] >= 1
    for pkg in (obs, jobs):
        snaps = [r for r in pkg.read_jsonl(jpath) if r["kind"] == "snapshot"]
        assert len(snaps) >= 2
        mm = snaps[-1]["metrics"]
        for name in ("frames_total", "blocks_total", "learner_steps_total",
                     "feedback_applied_total", "staleness_steps",
                     "work_queue_depth", "batch_queue_depth",
                     "csp_occupancy", "sampling_kl_nats", "probe_draws",
                     "span_learn_ms", "span_slab_draw_ms",
                     "span_rollout_ms", "span_add_block_ms",
                     "span_apply_feedback_ms"):
            assert name in mm, name
        assert mm["staleness_steps"]["count"] == 40
        assert mm["learner_steps_total"]["value"] == 40
        assert 0.0 <= mm["csp_occupancy"]["value"] <= 1.0
        series = pkg.parse_prometheus(open(ppath).read())
        assert series["repro_learner_steps_total_total"] == 40.0
        assert "repro_staleness_steps_count" in series
    assert report.main([jpath]) == 0
    out = capsys.readouterr().out
    jreport.main([jpath])
    assert capsys.readouterr().out == out and "staleness_steps" in out
    assert not obs.get_registry().enabled


def test_service_sync_uniform_schema(tmp_path):
    """Sync mode gives the async mode's snapshot / checkpoint schema."""
    manager = CheckpointManager(str(tmp_path / "ckpt"), keep=3,
                                save_interval=20)
    tel = obs.Telemetry(metrics_out=str(tmp_path / "sync.jsonl"),
                        probe_every=0)
    svc = ReplayService(small_cfg(num_envs=1), sync=True, num_actors=1,
                        telemetry=tel, device="cpu")
    m = svc.run(prng.key(0), 60, manager=manager).metrics
    assert m["mode"] == "sync"
    assert set(m["snapshot"]) == {"count", "saved", "pause_us_mean",
                                  "pause_us_max", "drain_cycles"}
    assert m["snapshot"]["count"] == 3
    assert m["snapshot"]["pause_us_max"] > 0
    ck = m["checkpoint"]
    assert ck["saves"] == 3
    assert ck["full_bytes"] > 0 and ck["delta_bytes"] > 0
    assert ck["chain_len"] >= 1
    assert m["staleness"] == {"count": 0, "mean": 0.0, "max": 0,
                              "p50": 0, "p95": 0, "p99": 0}
    events = [r for r in obs.read_jsonl(str(tmp_path / "sync.jsonl"))
              if r["kind"] == "event" and r["event"] == "checkpoint"]
    assert [e["step"] for e in events] == [20, 40, 60]
    assert [e["delta"] for e in events] == [False, True, True]


def test_service_without_telemetry_unchanged(tmp_path):
    svc = ReplayService(small_cfg(), num_actors=2, chunk_len=4, slab=2,
                        max_replay_ratio=64, device="cpu")
    res = run_bounded(svc, prng.key(0), 20)
    assert res.metrics["staleness"]["count"] == 20
    assert "health" not in res.metrics
    assert not obs.get_registry().enabled
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("fr_mode", ["fused", "kernel"])
def test_probe_equals_the_draw_it_follows(monkeypatch, fr_mode):
    """Under the running service the health probe re-derives the very
    draw it follows: its sampled priorities are those of the production
    slab's rows (flat order) on the same state and key."""
    from repro_torch.obs import probes

    svc = ReplayService(small_cfg(sampler="amper-fr", amper_fr_mode=fr_mode),
                        num_actors=2, chunk_len=4, slab=2,
                        max_replay_ratio=64, device="cpu",
                        telemetry=obs.Telemetry(probe_every=2))
    last, checked = {}, []
    sample = svc._sample

    def recording(state, key, beta):
        out = sample(state, key, beta)
        last["key"] = key
        last["prio"] = svc.dqn.replay.sampler.priorities(
            state.sampler_state)[out[0].transpose(0, 1).reshape(-1).long()]
        return out

    make_probe = probes.make_replay_probe

    def checking_probe(sampler, batch):
        probe = make_probe(sampler, batch)

        def run(state, key):
            out = probe(state, key)
            assert torch.equal(key, last["key"])
            assert torch.equal(out[4], last["prio"] / sampler.cfg.v_max)
            checked.append(True)
            return out

        return run

    svc._sample = recording
    monkeypatch.setattr(probes, "make_replay_probe", checking_probe)
    m = run_bounded(svc, prng.key(6), 24).metrics
    assert len(checked) == m["health"]["probe_draws"] >= 2


# --- lock order and the port's import rule -----------------------------------

def test_async_service_acquisition_graph_is_acyclic(tmp_path):
    """Lockdep over a tiny, churny async run with a checkpoint manager and
    telemetry: the runtime's locks (the replay-state guard among them),
    the registry's and the exporter's form an acyclic order."""
    rec = locks.enable()
    try:
        svc = ReplayService(
            small_cfg(sampler="amper-fr", replay_size=32, learn_start=4,
                      target_sync=10),
            num_actors=2, chunk_len=2, slab=2, queue_size=2, device="cpu",
            telemetry=obs.Telemetry(metrics_out=str(tmp_path / "m.jsonl"),
                                    probe_every=2))
        res = run_bounded(svc, prng.key(0), 8, manager=CheckpointManager(
            str(tmp_path / "ckpt"), save_interval=4))
        assert res.metrics["learner_steps"] == 8
        counts = rec.counts()
        for name in ("runtime.replay_state", "runtime.work_q",
                     "runtime.batch_q", "runtime.snapshot_q",
                     "obs.registry", "obs.jsonl_exporter"):
            assert counts.get(name, 0) > 0, (name, counts)
        assert rec.cycles() == [], rec.cycles()
    finally:
        locks.disable()


def test_find_cycles_reports_each_cycle_once():
    assert locks.find_cycles([("a", "b"), ("b", "c")]) == []
    assert locks.find_cycles([("b", "a"), ("a", "b"), ("c", "a"),
                              ("b", "c")]) == [["a", "b"], ["a", "b", "c"]]


PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _forbidden_imports(path: pathlib.Path) -> list[str]:
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(PORT)}:{node.lineno} {name}")
    return bad


def test_port_imports_neither_jax_nor_the_reference():
    """The port's first rule, on every module of ``src/repro_torch``:
    no ``import jax...`` and no ``import repro...`` / ``from repro...``."""
    modules = sorted(PORT.rglob("*.py"))
    assert len(modules) > 40
    bad = [b for m in modules for b in _forbidden_imports(m)]
    assert bad == []
    # the guard itself sees what it must refuse
    probe = PORT / "runtime" / "prng.py"
    src = probe.read_text()
    tree = ast.parse(src + "\nimport jax.numpy as jnp\n"
                     "from repro.runtime import prng\n")
    found = [n for n in ast.walk(tree)
             if isinstance(n, (ast.Import, ast.ImportFrom))
             and ((getattr(n, "module", None) or "").startswith("repro.")
                  or any(a.name.startswith("jax") for a in n.names))]
    assert len(found) == 2


# --- a sync checkpoint of the reference's service loads in the port ----------

def test_sync_checkpoint_target_names_match_reference(tmp_path):
    """A sync service checkpoint of the port holds the reference's leaf
    names and dtypes: the two packages' files are one format."""
    kw = _sync_kw("dqn", 1)
    mgr = CheckpointManager(str(tmp_path / "t"), save_interval=10)
    mgr.request_preemption()
    ReplayService(td.DQNConfig(**kw), sync=True, num_actors=1,
                  device="cpu").run(prng.key(0), 30, manager=mgr)
    jmgr = jck.CheckpointManager(str(tmp_path / "j"), save_interval=10)
    jmgr.request_preemption()
    JService(jd.DQNConfig(**kw), sync=True, num_actors=1).run(
        jax.random.key(0), 30, manager=jmgr)
    step = mgr.latest_step()
    assert step == jmgr.latest_step() == 1  # preempted at the first step
    tman = jck.load_manifest(str(tmp_path / "t"), step)
    jman = jck.load_manifest(str(tmp_path / "j"), step)
    assert tman["names"] == jman["names"]
    assert tman["dtypes"] == jman["dtypes"]
    assert tman["meta"] == jman["meta"]

