"""The port's epsilon schedule against the reference's, bit for bit.

The reference's actor computes ``clip(start + (end - start) * step /
decay, end, start)`` in float32 under ``jax.jit``.  XLA turns the
division by the constant ``decay`` into a multiplication by its float32
reciprocal, folds ``(end - start) * (1 / decay)`` into one float32
constant and fuses the multiply-add; the port's ``epsilon`` spells that
out (``rl/dqn.py``).  Each setting is swept over every step from 0 to
``decay + 2``, each step jitted alone as the reference's actor sees it,
and compared through the schedule table that ``train`` reads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.rl import dqn as td

# (eps_start, eps_end, eps_decay_steps)
SETTINGS = [(1.0, 0.05, 40), (1.0, 0.05, 100), (1.0, 0.05, 200),
            (1.0, 0.05, 5000), (0.9, 0.1, 7), (0.9, 0.1, 40)]


@pytest.mark.parametrize("start,end,decay", SETTINGS,
                         ids=[f"{s}-{e}-{d}" for s, e, d in SETTINGS])
def test_epsilon_equals_reference_jitted(start, end, decay):
    @jax.jit
    def eps(step):  # the reference's act
        return jnp.clip(start + (end - start) * step / decay, end, start)

    n = decay + 3
    want = np.stack([np.asarray(eps(jnp.int32(t)), np.float32)
                     for t in range(n)])
    dqn = td.make_dqn(td.DQNConfig(eps_start=start, eps_end=end,
                                   eps_decay_steps=decay, num_envs=2,
                                   replay_size=64, batch=8, hidden=8),
                      device="cpu")
    got = dqn.schedules(n).eps
    assert got.dtype == torch.float32 and got.shape == (n,)
    bad = np.nonzero(want.view(np.int32) != got.numpy().view(np.int32))[0]
    assert bad.size == 0, (f"{bad.size} of {n} steps differ, first at "
                           f"{bad[:5].tolist()}: {want[bad[:5]]} against "
                           f"{got.numpy()[bad[:5]]}")
    assert float(got[0]) == np.float32(start)
    assert float(got[-1]) == np.float32(end)
