"""High-churn stress tests for the port's async replay runtime.

Counterpart of ``tests/test_async_stress.py``.  A tiny buffer, many
actor threads and short rollout chunks force rapid slot recycling: most
sampled rows are overwritten between the draw and the deferred priority
apply.  The runtime must keep the stamped ``update_priorities`` contract
(every learner batch's feedback applied exactly once, in learner-step
order, never onto a recycled slot) and stay live.

The recycled-slot half is pinned deterministically at the buffer level,
against the reference's buffer driven through the same sample -> recycle
-> late-feedback rounds from one numpy seed: indices and stamps exact,
priorities within rtol 1e-6 (XLA and torch each round the ``pow``).  The
ordering half runs under real thread contention, with more actor threads
than cores and a shortened switch interval.  One test injects a slow
write under the replay-state lock and checks that no draw ever sees it
half applied.
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import replay_buffer as jrb
from repro.core import samplers as jsamplers
from repro_torch import prng
from repro_torch.core import replay_buffer as trb
from repro_torch.core import samplers as tsamplers
from repro_torch.models.qhead import tree_leaves
from repro_torch.rl.dqn import DQNConfig
from repro_torch.runtime import ReplayService
from test_torch_runtime import run_bounded


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


# --- deterministic recycled-slot contract under churn -------------------------

@pytest.mark.parametrize("kind", ["per-cumsum", "per-sumtree", "amper-fr"])
def test_stamped_updates_never_land_on_recycled_slots_under_churn(kind):
    """20 sample -> recycle -> late-feedback rounds with full wraparound,
    both packages on the same inputs: after each apply every surviving
    slot holds its fed-back priority and every recycled one the
    max-priority write it received, and the port's draws, stamps and
    priorities equal the reference's."""
    cap = 16
    jb = jrb.ReplayBuffer(cap, jsamplers.make_sampler(
        kind, cap, v_max=64.0, csp_capacity=cap))
    tb = trb.ReplayBuffer(cap, tsamplers.make_sampler(
        kind, cap, v_max=64.0, csp_capacity=cap, device="cpu"))
    js = jb.add_batch(jb.init({"x": jnp.float32(0)}), {"x": jnp.zeros(cap)})
    ts = tb.add_batch(tb.init({"x": torch.zeros(())}),
                      {"x": torch.zeros(cap)})
    key = jax.random.key(0)
    rng = np.random.default_rng(1)
    for round_ in range(20):
        jidx, _, _ = jb.sample(js, jax.random.fold_in(key, round_), 8)
        idx, _, _ = tb.sample(ts, prng.fold_in(prng.key(0), round_), 8)
        np.testing.assert_array_equal(np.asarray(jidx), idx.numpy())
        jstamp, stamp = jb.stamps(js, jidx), tb.stamps(ts, idx)
        np.testing.assert_array_equal(np.asarray(jstamp), stamp.numpy())
        before = ts.write_stamp.clone().numpy()
        churn = int(rng.integers(0, cap + 1))
        if churn:
            js = jb.add_batch(js, {"x": jnp.full(churn, float(round_))})
            ts = tb.add_batch(ts, {"x": torch.full((churn,),
                                                   float(round_))})
        mp_at_add = float(ts.max_priority)
        td = np.linspace(1.0, 9.0, 8).astype(np.float32) + round_
        js = jb.update_priorities(js, jidx, jnp.asarray(td), stamp=jstamp)
        ts = tb.update_priorities(ts, idx, torch.from_numpy(td), stamp=stamp)
        prios = tb.sampler.priorities(ts.sampler_state).numpy()
        np.testing.assert_allclose(
            np.asarray(jb.sampler.priorities(js.sampler_state)), prios,
            rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(js.write_stamp),
                                      ts.write_stamp.numpy())
        after = ts.write_stamp.numpy()
        idx_np = idx.numpy()
        expect = {}
        for j, slot in enumerate(idx_np):
            if after[slot] == before[slot]:  # survived: last valid write
                expect[slot] = (abs(td[j]) + tb.eps) ** tb.alpha
        for slot, want in expect.items():
            np.testing.assert_allclose(prios[slot], want, rtol=1e-4,
                                       err_msg=f"round {round_} slot {slot}")
        recycled = set(idx_np[after[idx_np] != before[idx_np]])
        for slot in recycled - set(expect):
            np.testing.assert_allclose(
                prios[slot], mp_at_add, rtol=1e-4,
                err_msg=f"round {round_} stale write on recycled {slot}")


# --- threaded races: tiny buffer, many actors, rapid recycling ----------------

def _stress_service(n_step: int, sampler: str, num_actors: int = 4,
                    **kw) -> ReplayService:
    cfg = DQNConfig(sampler=sampler, n_step=n_step, num_envs=2,
                    replay_size=32, batch=16, learn_start=4,
                    eps_decay_steps=100, target_sync=10, v_max=8.0, **kw)
    return ReplayService(cfg, num_actors=num_actors, chunk_len=2, slab=2,
                         queue_size=2, feedback_log=True, device="cpu")


def _check_churned(svc, res, n):
    m = res.metrics
    assert m["learner_steps"] == n
    assert m["feedback_seqs"] == list(range(n)), m["feedback_seqs"]
    assert m["staleness"]["count"] == n
    assert 0 <= m["staleness"]["mean"] <= m["staleness"]["max"]
    buf = res.buffer
    assert buf.size == 32                            # fully churned
    assert buf.total_adds > 2 * 32                   # many recycles
    stamps = buf.write_stamp.numpy()
    assert stamps.min() >= 0
    assert stamps.max() == buf.total_adds - 1        # ring write ordering
    assert len(np.unique(stamps)) == 32              # stamps stay distinct
    prios = svc.dqn.replay.sampler.priorities(buf.sampler_state).numpy()
    assert np.isfinite(prios).all() and (prios >= 0).all()
    assert float(buf.max_priority) >= 1.0
    for leaf in tree_leaves(res.params):
        assert bool(torch.isfinite(leaf).all())


@pytest.mark.parametrize("n_step,sampler,fr_mode",
                         [(1, "per-sumtree", "broadcast"),
                          (3, "amper-fr", "broadcast"),
                          (1, "amper-fr", "fused")])
def test_async_high_churn_exactly_once_in_order(n_step, sampler, fr_mode):
    """4 actors race into a 32-slot ring (about every 4 blocks recycle the
    whole buffer, so nearly every deferred update targets a dead slot):
    the run completes, applies every slab's feedback exactly once in
    order and keeps the buffer invariants."""
    n = 40
    svc = _stress_service(n_step, sampler, amper_fr_mode=fr_mode)
    _check_churned(svc, run_bounded(svc, prng.key(5), n), n)


def test_async_contention_more_actors_than_cores():
    """More actor threads than cores and a switch interval of 10 us, so
    the threads interleave inside every Python statement: the ordering
    contract and the buffer invariants still hold."""
    n = 24
    actors = min((os.cpu_count() or 1) + 1, 16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        svc = _stress_service(1, "amper-fr", num_actors=actors)
        _check_churned(svc, run_bounded(svc, prng.key(8), n), n)
    finally:
        sys.setswitchinterval(old)


def test_draw_never_sees_a_half_applied_write():
    """A slow write is injected under the replay-state lock: it first
    poisons the stamps of the arc it is about to write, sleeps (so every
    other thread runs), then writes.  Every draw checks, while it holds
    the lock, that no poisoned stamp is visible and that the lock is
    held; writes and draws interleave, and the run ends with no poison
    in the buffer."""
    svc = _stress_service(1, "amper-fr", num_actors=2)
    poison = -7
    add, sample = svc._add_block, svc._sample
    seen = {"writes": 0, "draws": 0, "poisoned": 0, "unlocked": 0}

    def slow_add(state, block):
        if not svc._guard.lock.locked():
            seen["unlocked"] += 1
        n = next(iter(block.values())).shape[:2].numel()
        arc = (state.pos + torch.arange(n)) % svc.dqn.replay.capacity
        state.write_stamp[arc] = poison
        time.sleep(0.003)
        seen["writes"] += 1
        return add(state, block)

    def checked_sample(state, key, beta):
        if not svc._guard.lock.locked():
            seen["unlocked"] += 1
        if bool((state.write_stamp == poison).any()):
            seen["poisoned"] += 1
        seen["draws"] += 1
        return sample(state, key, beta)

    svc._add_block, svc._sample = slow_add, checked_sample
    res = run_bounded(svc, prng.key(2), 30)
    assert res.metrics["feedback_seqs"] == list(range(30))
    assert seen["writes"] > 10 and seen["draws"] >= 15
    assert seen["poisoned"] == 0 and seen["unlocked"] == 0
    assert not bool((res.buffer.write_stamp == poison).any())
