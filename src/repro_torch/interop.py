"""Carry weights and agent state between the JAX reference and the port.

The port imports nothing of the reference package.  The ``*_from_jax``
functions take the reference's objects as plain numpy pytrees
(``jax.tree.map(np.asarray, state)``) and read them by field name, so a
test can start both packages from one state and step them side by side.
The reverse direction, :func:`agent_state_to_numpy`,
:func:`replay_state_to_numpy` and :func:`lm_train_state_to_numpy`, gives
the port's states in the reference's numpy layout: the same NamedTuple
fields in the same order (so ``jax.tree.leaves`` of either lists the
same leaves), a sharded sampler's table dense, and the port's host
counters as 0-d int32 arrays.  The LM trainer's states (``TrainState``
with its ``AdamWState``, and the sequence replay's ``ReplayDataState``)
go both ways too.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.amper import AmperState, UniformState
from repro_torch.core.per import CumsumState, SumTreeState
from repro_torch.core.replay_buffer import NStepState, ReplayState
from repro_torch.models.qhead import tree_map
from repro_torch.rl.dqn import AgentState
from repro_torch.rl.envs import EnvState
from repro_torch.train import checkpoint as ck
from repro_torch.train.data import ReplayDataState
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.train_step import TrainState


def to_tensor(x, device="cuda") -> torch.Tensor:
    """numpy array (or scalar) -> tensor of the same dtype on ``device``."""
    return torch.from_numpy(np.array(x, copy=True)).to(resolve_device(device))


def params_from_jax(params, device="cuda"):
    """A Q-head's params (nested lists/dicts of ``{"w", "b"}`` numpy
    arrays, in the reference's ``(in, out)`` layout) as the port's head
    params.  The layout is kept, so no weight is transposed."""
    return tree_map(lambda x: to_tensor(x, device).to(torch.float32), params)


def _sampler_state(s, device, sampler=None):
    """A reference sampler state as the port's.  A sharded sampler
    (``sampler.from_dense``) splits the reference's global arrays into
    its per-shard layout; the rest of the state goes to ``device``."""
    if sampler is not None and hasattr(sampler, "from_dense"):
        return sampler.from_dense(*(to_tensor(x, device) for x in s))
    if hasattr(s, "tree"):
        return SumTreeState(tree=to_tensor(s.tree, device),
                            n_leaves=to_tensor(s.n_leaves, device))
    if hasattr(s, "pq"):
        return AmperState(pq=to_tensor(s.pq, device),
                          valid=to_tensor(s.valid, device))
    if hasattr(s, "priorities") and hasattr(s, "valid"):
        return UniformState(priorities=to_tensor(s.priorities, device),
                            valid=to_tensor(s.valid, device))
    if type(s).__name__ == "CumsumState":
        return CumsumState(priorities=to_tensor(s.priorities, device))
    raise TypeError(f"no port of sampler state {type(s).__name__}")


def nstep_state_from_jax(ns, device="cuda") -> NStepState | None:
    """A reference n-step window (``NStepState``, numpy leaves; the
    buffer's or an actor's own) as the port's, or None for None."""
    if ns is None:
        return None
    return NStepState(
        ring={k: to_tensor(v, device) for k, v in ns.ring.items()},
        count=int(ns.count), pos=int(ns.pos))


def replay_state_from_jax(rs, device="cuda", sampler=None) -> ReplayState:
    """A reference ``ReplayState`` (numpy leaves) as the port's; pass the
    port's ``sampler`` for a sharded sampler state."""
    nstep = nstep_state_from_jax(rs.nstep, device)
    return ReplayState(
        storage={k: to_tensor(v, device) for k, v in rs.storage.items()},
        sampler_state=_sampler_state(rs.sampler_state, device, sampler),
        pos=int(rs.pos), size=int(rs.size),
        max_priority=to_tensor(rs.max_priority, device),
        write_stamp=to_tensor(rs.write_stamp, device),
        total_adds=int(rs.total_adds),
        write_gen=to_tensor(rs.write_gen, device),
        add_gen=int(rs.add_gen), nstep=nstep)


def agent_state_from_jax(st, device="cuda", sampler=None) -> AgentState:
    """A reference DQN ``AgentState`` (numpy leaves) as the port's:
    params, target, Adam moments, replay buffer with sampler state, env
    state, observations and counters.  Pass the port agent's sampler
    (``dqn.replay.sampler``) when it is a sharded one.  A pixel agent's
    uint8 frame stack and its frame store's uint8 frames keep their
    dtype, and its conv kernels their HWIO layout."""
    return AgentState(
        params=params_from_jax(st.params, device),
        target_params=params_from_jax(st.target_params, device),
        opt_m=params_from_jax(st.opt_m, device),
        opt_v=params_from_jax(st.opt_v, device),
        buffer=replay_state_from_jax(st.buffer, device, sampler),
        env_state=EnvState(x=to_tensor(st.env_state.x, device),
                           t=to_tensor(st.env_state.t, device)),
        obs=to_tensor(st.obs, device),
        step=int(st.step),
        episode_return=to_tensor(st.episode_return, device),
        last_returns=to_tensor(st.last_returns, device),
        n_episodes=to_tensor(st.n_episodes, device))


def _numpy_leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:  # numpy has no bfloat16: widen, exact
            x = x.to(torch.float32)
        return x.detach().cpu().numpy()
    return np.asarray(x, dtype=ck._scalar_dtype(x))  # a host counter


def _to_numpy(tree):
    return ck._unflatten(tree, [_numpy_leaf(x)
                                for x in ck._flatten_with_names(tree)[1]])


def _dense(rs: ReplayState, sampler) -> ReplayState:
    if sampler is not None and hasattr(sampler, "to_dense"):
        return rs._replace(sampler_state=sampler.to_dense(rs.sampler_state))
    return rs


def replay_state_to_numpy(rs: ReplayState, sampler=None) -> ReplayState:
    """The port's ``ReplayState`` in the reference's numpy layout; pass
    the buffer's ``sampler`` when it is a sharded one, whose per-shard
    table becomes the reference's one global table."""
    return _to_numpy(_dense(rs, sampler))


def agent_state_to_numpy(st: AgentState, sampler=None) -> AgentState:
    """The port's DQN ``AgentState`` in the reference's numpy layout (see
    :func:`replay_state_to_numpy` for ``sampler``)."""
    return _to_numpy(st._replace(buffer=_dense(st.buffer, sampler)))


def _take(tree, s: int):
    """Entry ``s`` of every leaf of a numpy pytree whose leaves lead with
    a seed axis (NamedTuples, tuples, lists and dicts are walked; None
    stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _take(v, s) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_take(v, s) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take(v, s) for v in tree)
    return np.asarray(tree)[s]


def agent_states_from_jax(st, device="cuda", sampler=None) -> list:
    """A batch of reference ``AgentState``s (numpy leaves with a leading
    seed axis S, as the reference's ``train_many`` returns them) as a
    list of S port states, in the layout the port's ``train_many``
    returns."""
    n_seeds = np.asarray(st.step).shape[0]
    return [agent_state_from_jax(_take(st, s), device, sampler)
            for s in range(n_seeds)]


def _lm_leaf(x, device) -> torch.Tensor:
    """A numpy leaf of the reference's LM (float32, int32 or bfloat16,
    whose numpy type torch cannot read) as a tensor of the same dtype."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return to_tensor(x.astype(np.float32), device).to(torch.bfloat16)
    return to_tensor(x, device)


def lm_params_from_jax(params, device="cuda") -> dict:
    """The reference LM's param tree (nested dicts of numpy leaves, layers
    stacked on the leading dim, weights ``(in, out)``) as the port's:
    the same tree and layout, nothing transposed."""
    return tree_map(lambda x: _lm_leaf(x, device), params)


def lm_cache_from_jax(cache, device="cuda") -> dict:
    """The reference LM's cache as the port's, ``len`` an int32 scalar on
    ``device``: a decoder's ``{"blocks": {...}, "len"}`` (k and v, MLA's
    latent, the rwkv ``state`` / ``x_prev`` / ``cx_prev``, or the hybrid
    block's k, v, ``mamba_h`` and ``mamba_conv``; ``"dense_blocks"``
    alike for deepseek's leading dense layers) or the encoder-decoder's
    ``{"self_k", "self_v", "cross_k", "cross_v", "len"}``; numpy
    leaves, each kept in its dtype."""
    out = {name: ({k: _lm_leaf(v, device) for k, v in val.items()}
                  if isinstance(val, dict) else _lm_leaf(val, device))
           for name, val in cache.items() if name != "len"}
    out["len"] = _lm_leaf(np.asarray(cache["len"], np.int32), device)
    return out


def lm_train_state_from_jax(st, device="cuda") -> TrainState:
    """The reference LM trainer's ``TrainState`` (numpy leaves: step,
    params, ``AdamWState`` m, v, count and the optional master) as the
    port's; the counters become int32 scalars on ``device``."""
    o = st.opt_state
    return TrainState(
        step=_lm_leaf(np.asarray(st.step, np.int32), device),
        params=lm_params_from_jax(st.params, device),
        opt_state=AdamWState(
            m=lm_params_from_jax(o.m, device),
            v=lm_params_from_jax(o.v, device),
            count=_lm_leaf(np.asarray(o.count, np.int32), device),
            master=(None if o.master is None
                    else lm_params_from_jax(o.master, device))))


def replay_data_state_from_jax(ds, device="cuda") -> ReplayDataState:
    """The reference's ``ReplayDataState`` (numpy leaves) as the port's:
    sampler state, loss EMA and the seen counts."""
    return ReplayDataState(
        sampler_state=_sampler_state(ds.sampler_state, device),
        loss_ema=to_tensor(ds.loss_ema, device),
        seen=to_tensor(ds.seen, device))


def lm_train_state_to_numpy(tree):
    """A port ``TrainState``, ``ReplayDataState`` or a tuple of them in the
    reference's numpy layout (bfloat16 leaves widened to float32)."""
    return _to_numpy(tree)
