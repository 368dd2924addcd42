"""DQN agent family with pluggable experience replay, on tensors.

Counterpart of ``repro/rl/dqn.py``: epsilon-greedy actors over a
:class:`~repro_torch.rl.envs.VectorEnv`, a ring replay buffer with any
registered sampler (uniform, PER, AMPER-k, AMPER-fr), the MLP or dueling
Q-head, vanilla or Double-DQN targets, n-step returns, hard target sync
and the reference's hand-written Adam.

Pixel envs (``len(obs_shape) > 1``) promote the head to its conv
counterpart and switch the buffer to the frame store
(:class:`~repro_torch.core.replay_buffer.FrameStore`): each step stores
the one uint8 frame the policy just acted on, and the buffer
materializes ``history_len``-stacked float batches (and the n-step
return) at sample time.  The actor keeps the same uint8 stack as its
``obs`` and converts it with the buffer's ``frame.float() * scale``, so
the materialized batches equal what the policy saw bit for bit.  The
frame store keeps no pre-reset observation, so there ``terminated``
collapses to ``done``.

The reference runs the whole loop as one ``lax.scan``; here ``train`` is
a Python loop over :func:`agent_step`, and the reference's ``lax.cond``
on the step counter is a host-side ``if`` (the counter is a host int).
The reference's ``train_many`` vmaps that scan over S seeds; here the S
seeds run in lockstep (step t of every seed before step t + 1 of any),
each with its own state, and ``train`` is ``train_many`` of one seed.
``train_ckpt`` is ``train`` in ``save_interval`` segments with a
checkpoint of the whole :class:`AgentState` between them, in the
reference's on-disk format (:mod:`repro_torch.train.checkpoint`): it
runs the very steps ``train`` runs, so a killed and resumed run ends in
``train``'s state bit for bit.
PRNG keys are host tensors (:mod:`repro_torch.prng`) consumed exactly as
the reference consumes its keys, so the two packages take the same
actions and draw the same replay indices from the same state.

``DQNConfig.amper_fr_mode`` forwards to the AMPER-fr samplers' existing
``fr_mode`` ("broadcast", "kernel" or "fused"): it is how the training
path reaches the CUDA kernels.  The default, "broadcast", is what the
reference's DQN always uses.  The ``per-*`` kinds (``per-sharded``
included) weight the TD loss by their importance weights.

Scheduling counts loop iterations, not frames: ``learn_start``,
``train_every``, ``target_sync`` and ``eps_decay_steps`` are iterations,
each of which collects ``num_envs`` transitions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import prng, resolve_device
from repro_torch.core.per import beta_schedule
from repro_torch.core.replay_buffer import FrameStore, ReplayBuffer
from repro_torch.core.samplers import make_sampler
from repro_torch.models.qhead import make_qhead, tree_leaves, tree_map
from repro_torch.rl import envs as envs_mod
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import replay_checkpoint as rck
from repro_torch.xla_float import fma32

RETURN_RING = 64  # completed-episode returns kept for the train metric

# agent name -> (Q-head kind, use Double-DQN targets); pixel envs promote
# the head kind to its conv counterpart.
AGENTS = {
    "dqn": ("mlp", False),
    "double": ("mlp", True),
    "dueling": ("dueling", False),
    "double-dueling": ("dueling", True),
}

_CONV_PROMOTION = {"mlp": "conv", "dueling": "conv-dueling"}


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    env: str = "cartpole"
    sampler: str = "per-sumtree"   # a repro_torch.core.samplers registry name
    agent: str = "dqn"             # dqn | double | dueling | double-dueling
    n_step: int = 1
    num_envs: int = 1
    replay_size: int = 2000
    batch: int = 64
    hidden: int = 128
    history_len: int = 4           # frames per stacked pixel observation
    gamma: float = 0.99
    lr: float = 1e-3
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 5000
    target_sync: int = 100
    learn_start: int = 200
    train_every: int = 1
    alpha: float = 0.6
    beta: float = 0.4
    beta_end: float | None = None
    beta_anneal_steps: int | None = None
    amper_m: int = 20
    amper_lam_fr: float = 2.0
    amper_csp_ratio: float = 0.15
    amper_fr_mode: str = "broadcast"  # the AMPER-fr sampler's fr_mode
    v_max: float = 8.0


class AgentState(NamedTuple):
    params: Any
    target_params: Any
    opt_m: Any
    opt_v: Any
    buffer: Any                  # ReplayState
    env_state: Any               # EnvState, leaves lead with [num_envs]
    obs: torch.Tensor            # policy input: float32[num_envs, obs_dim],
    #                              or uint8[num_envs, H, W, history_len]
    #                              (the actor's frame stack) for pixels
    step: int
    episode_return: torch.Tensor  # float32[num_envs]
    last_returns: torch.Tensor   # ring of completed episode returns
    n_episodes: torch.Tensor     # int32 scalar


class DQN(NamedTuple):
    """Everything :func:`make_dqn` builds, by name."""

    init: Callable           # key -> AgentState
    agent_step: Callable     # (AgentState, key) -> (AgentState, metrics)
    train: Callable          # (key, n_steps) -> (AgentState, metrics)
    train_many: Callable     # (keys [S, 2], n_steps) -> ([S] states,
    #                          metrics [S, n_steps])
    evaluate: Callable       # (params | AgentState, key, n_episodes) -> return
    evaluate_many: Callable  # ([S] states, keys [S, 2], n_episodes) -> [S]
    train_ckpt: Callable     # (key, n_steps, CheckpointManager)
    #                          -> (AgentState, metrics, done_steps)
    load_ckpt: Callable      # (directory, step) -> AgentState
    ckpt_target: Callable    # () -> AgentState restore target (buffer on
    #                          the meta device, in its saved form)
    act: Callable            # (params, env_state, obs, step, key)
    #                          -> (env_state, next_obs, transitions)
    learn: Callable          # (params, target, m, v, step, batch, weights)
    #                          -> (params, m, v, td, loss)
    cfg: DQNConfig
    env: Any
    venv: Any
    replay: Any              # the ReplayBuffer (sampler attached)
    beta_at: Callable
    q_apply: Callable
    example_transition: dict
    init_obs: Callable       # (venv env_state) -> initial policy input


def make_dqn(cfg: DQNConfig, device="cuda", mesh=None) -> DQN:
    """Build the agent on ``device``.  ``mesh`` (a
    :class:`~repro_torch.distributed.sharding.Mesh`) goes to the sharded
    sampler kinds, e.g. S shards of the replay on one card; its lead
    device must be ``device``."""
    dev = resolve_device(device)
    env = envs_mod.make_env(cfg.env)
    venv = envs_mod.VectorEnv(env, cfg.num_envs, dev)
    obs_shape = venv.obs_shape
    pixel = len(obs_shape) > 1
    try:
        head_kind, double = AGENTS[cfg.agent]
    except KeyError:
        raise ValueError(f"unknown agent: {cfg.agent!r} "
                         f"(available: {sorted(AGENTS)})") from None
    if cfg.n_step < 1:
        raise ValueError(f"n_step must be >= 1, got {cfg.n_step}")
    if pixel:
        head_kind = _CONV_PROMOTION[head_kind]
        net_shape = obs_shape + (cfg.history_len,)
    else:
        net_shape = obs_shape
    qhead = make_qhead(head_kind, net_shape, cfg.hidden, env.n_actions,
                       device=dev)
    q_apply = qhead.apply
    gamma_n = cfg.gamma ** cfg.n_step
    ring = max(RETURN_RING, cfg.num_envs)
    sampler = make_sampler(
        cfg.sampler, cfg.replay_size, device=dev, m=cfg.amper_m,
        lam_fr=cfg.amper_lam_fr, csp_ratio=cfg.amper_csp_ratio,
        v_max=cfg.v_max, min_csp=cfg.batch, knn_mode="bisect",
        fr_mode=cfg.amper_fr_mode, mesh=mesh)
    # Compare concrete devices ("cuda" and "cuda:0" are one card).
    if (torch.empty(0, device=sampler.device).device
            != torch.empty(0, device=dev).device):
        raise ValueError(f"the sampler's (lead) device {sampler.device} is "
                         f"not the agent's device {dev}")
    is_per = cfg.sampler.startswith("per")
    frame_store = (FrameStore(history_len=cfg.history_len,
                              frame_shape=obs_shape, stride=cfg.num_envs,
                              n_step=cfg.n_step, gamma=cfg.gamma)
                   if pixel else None)
    rb = ReplayBuffer(cfg.replay_size, sampler, alpha=cfg.alpha,
                      beta=cfg.beta, n_step=1 if pixel else cfg.n_step,
                      gamma=cfg.gamma, num_envs=cfg.num_envs,
                      frame_store=frame_store)
    action0, zero = torch.tensor(0, dtype=torch.int32), torch.tensor(0.0)
    if pixel:
        # One uint8 frame a transition; the buffer stacks obs / next_obs.
        example_transition = {
            "frame": torch.zeros(obs_shape, dtype=torch.uint8),
            "action": action0, "reward": zero, "done": zero,
            "terminated": zero}
    else:
        obs0 = torch.zeros(obs_shape)
        example_transition = {
            "obs": obs0, "action": action0, "reward": zero,
            "next_obs": obs0, "done": zero, "terminated": zero}

    def stack_init(frames: torch.Tensor) -> torch.Tensor:
        """A history stack from one uint8 frame batch: zeros but the
        newest plane, the padding the frame store materializes for an
        episode's first observation."""
        z = torch.zeros(frames.shape + (cfg.history_len,), dtype=torch.uint8,
                        device=frames.device)
        z[..., -1] = frames
        return z

    def stack_push(stack: torch.Tensor, frames: torch.Tensor,
                   done: torch.Tensor) -> torch.Tensor:
        """Shift one frame in; restart from zero padding where ``done``."""
        shifted = torch.cat([stack[..., 1:], frames[..., None]], -1)
        d = done.reshape(done.shape + (1,) * (shifted.ndim - done.ndim))
        return torch.where(d, stack_init(frames), shifted)

    if pixel:
        def q_in(obs: torch.Tensor) -> torch.Tensor:
            # The one uint8 -> float expression the frame store uses too.
            return obs.to(torch.float32) * frame_store.scale

        def init_obs(env_state):
            return stack_init(venv.obs(env_state))
    else:
        def q_in(obs: torch.Tensor) -> torch.Tensor:
            return obs

        def init_obs(env_state):
            return venv.obs(env_state)

    def fresh(key: torch.Tensor, buffer) -> AgentState:
        k1, k2 = prng.split(key)
        params = qhead.init(k1)
        env_state = venv.reset(k2)
        return AgentState(
            params=params, target_params=params,
            opt_m=tree_map(torch.zeros_like, params),
            opt_v=tree_map(torch.zeros_like, params),
            buffer=buffer, env_state=env_state,
            obs=init_obs(env_state), step=0,
            episode_return=torch.zeros(cfg.num_envs, device=dev),
            last_returns=torch.zeros(ring, device=dev),
            n_episodes=torch.tensor(0, dtype=torch.int32, device=dev))

    def init(key: torch.Tensor) -> AgentState:
        return fresh(key, rb.init(example_transition))

    def td_loss(params, target_params, batch, weights):
        q = q_apply(params, batch["obs"])
        action = batch["action"].to(torch.int64)[:, None]
        qa = q.gather(1, action)[:, 0]
        with torch.no_grad():
            qn = q_apply(target_params, batch["next_obs"])
            if double:
                a_star = q_apply(params, batch["next_obs"]).argmax(-1)
                boot = qn.gather(1, a_star[:, None])[:, 0]
            else:
                boot = qn.max(-1).values
            target = (batch["reward"]
                      + gamma_n * (1 - batch["terminated"]) * boot)
        td = qa - target
        return (weights * td * td).mean(), td

    def adam(params, grads, m, v, step: int):
        b1, b2, eps = 0.9, 0.999, 1e-8
        m = tree_map(lambda a, g: b1 * a + (1 - b1) * g, m, grads)
        v = tree_map(lambda a, g: b2 * a + (1 - b2) * g * g, v, grads)
        c = torch.tensor(step + 1, dtype=torch.float32)
        lr = (cfg.lr * torch.sqrt(1 - torch.pow(torch.tensor(0.999), c))
              / (1 - torch.pow(torch.tensor(0.9), c))).to(dev)
        params = tree_map(lambda p, mm, vv: p - lr * mm / (vv.sqrt() + eps),
                          params, m, v)
        return params, m, v

    def beta_at(step: int):
        """IS exponent at ``step``: constant unless ``beta_end`` is set."""
        if cfg.beta_end is None:
            return cfg.beta
        horizon = (cfg.beta_anneal_steps if cfg.beta_anneal_steps is not None
                   else cfg.eps_decay_steps)
        return beta_schedule(cfg.beta, cfg.beta_end, step, horizon)

    def epsilon(step: int) -> torch.Tensor:
        """The reference's float32 schedule as XLA compiles it: the
        constants fold into one float32 rate and the add fuses."""
        rate = (torch.tensor(cfg.eps_end - cfg.eps_start, dtype=torch.float32)
                / cfg.eps_decay_steps)
        e = fma32(torch.tensor(float(step)), rate, cfg.eps_start)
        return torch.clamp(e, cfg.eps_end, cfg.eps_start)

    def act(params, env_state, obs, step: int, key: torch.Tensor):
        """One vectorized epsilon-greedy env step (the actor piece).
        Returns the post-reset policy input of the next step and the rows
        to store: flat envs keep the pre-reset ``next_obs``, pixel envs
        only the frame the action was taken on."""
        k_coin, k_rand, k_env = prng.split(key, 3)
        with torch.no_grad():
            greedy = q_apply(params, q_in(obs)).argmax(-1)
        explore = prng.uniform(k_coin, (cfg.num_envs,)) < epsilon(step)
        randa = prng.randint(k_rand, (cfg.num_envs,), 0, env.n_actions)
        action = torch.where(explore.to(dev), randa.to(dev),
                             greedy).to(torch.int32)
        env_state, next_obs, reward, done, terminated = venv.step(
            env_state, action, k_env)
        if pixel:
            transitions = {
                "frame": obs[..., -1], "action": action, "reward": reward,
                "done": done.to(torch.float32),
                "terminated": terminated.to(torch.float32)}
            return (env_state, stack_push(obs, venv.obs(env_state), done),
                    transitions)
        transitions = {
            "obs": obs, "action": action, "reward": reward,
            "next_obs": next_obs, "done": done.to(torch.float32),
            "terminated": terminated.to(torch.float32)}
        return env_state, venv.obs(env_state), transitions

    def learn(params, target_params, opt_m, opt_v, step: int, batch,
              weights):
        """One TD gradient step on a sampled batch (the learner piece)."""
        w = weights if is_per else torch.ones_like(weights)
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, td = td_loss(params, target_params, batch, w)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        grads_tree = _unflatten(params, grads)
        params = tree_map(lambda p: p.detach(), params)
        params, m, v = adam(params, grads_tree, opt_m, opt_v, step)
        return params, m, v, td.detach(), loss.detach()

    def agent_step(state: AgentState, key: torch.Tensor):
        k_act, k_sample = prng.split(key)
        env_state, obs_next, transitions = act(
            state.params, state.env_state, state.obs, state.step, k_act)
        reward = transitions["reward"]
        done = transitions["done"] > 0.5
        buffer = rb.add_batch(state.buffer, transitions)

        # Each env that finished claims the next slot of the completed-
        # return ring (exclusive cumsum orders simultaneous finishes);
        # unfinished envs aim at a discard slot past the ring.
        ep_ret = state.episode_return + reward
        d = done.to(torch.int32)
        slot = (state.n_episodes + torch.cumsum(d, 0) - d) % ring
        ring_ext = torch.cat([state.last_returns,
                              torch.zeros(1, device=dev)])
        ring_ext[torch.where(done, slot, ring).to(torch.int64)] = ep_ret
        last_returns = ring_ext[:ring]
        n_episodes = state.n_episodes + d.sum(dtype=torch.int32)
        episode_return = torch.where(done, torch.zeros_like(ep_ret), ep_ret)

        params, m, v = state.params, state.opt_m, state.opt_v
        loss = torch.zeros((), device=dev)
        idx = td = None
        if state.step >= cfg.learn_start and state.step % cfg.train_every == 0:
            idx, batch, w = rb.sample(buffer, k_sample, cfg.batch,
                                      beta=beta_at(state.step))
            params, m, v, td, loss = learn(
                params, state.target_params, m, v, state.step, batch, w)
            buffer = rb.update_priorities(buffer, idx, td)
        target_params = (params if state.step % cfg.target_sync == 0
                         else state.target_params)

        new = AgentState(params=params, target_params=target_params,
                         opt_m=m, opt_v=v, buffer=buffer,
                         env_state=env_state, obs=obs_next,
                         step=state.step + 1, episode_return=episode_return,
                         last_returns=last_returns, n_episodes=n_episodes)
        ret_mean = torch.where(
            n_episodes > 0,
            last_returns.sum() / torch.clamp(n_episodes, max=ring),
            torch.zeros((), device=dev))
        # idx/td: the learn step's sampled rows and TD errors (None when
        # the step did not learn).
        metrics = {"return_mean": ret_mean,
                   "beta": float(beta_at(state.step)), "loss": loss,
                   "idx": idx, "td": td}
        return new, metrics

    def lockstep(keys: torch.Tensor, n_steps: int):
        """``init`` on each key, then ``n_steps`` agent steps of every
        seed, step t of all seeds before step t + 1 of any; seed s steps
        on the reference's keys ``split(fold_in(keys[s], 1), n_steps)``.
        Returns the S final states and each seed's metrics as lists."""
        states = [init(k) for k in keys]
        step_keys = [prng.split(prng.fold_in(k, 1), n_steps) for k in keys]
        metrics = [{"return_mean": [], "beta": [], "loss": []}
                   for _ in states]
        for t in range(n_steps):
            for s, (st, ks, mts) in enumerate(zip(states, step_keys,
                                                  metrics)):
                states[s], mt = agent_step(st, ks[t])
                for name, seq in mts.items():
                    seq.append(mt[name])
        return states, metrics

    def train(key: torch.Tensor, n_steps: int):
        """``init`` then ``n_steps`` agent steps on the reference's step
        keys (``split(fold_in(key, 1), n_steps)``).  Returns the final
        state and per-step metrics as lists."""
        states, metrics = lockstep(prng.key_data(key)[None], n_steps)
        return states[0], metrics[0]

    def train_many(keys: torch.Tensor, n_steps: int):
        """S seeds (``keys`` [S, 2]) trained in lockstep, each as
        ``train`` trains it.  Returns the list of S final states and the
        metrics stacked float32 [S, n_steps] on the agent's device."""
        states, metrics = lockstep(prng.key_data(keys).reshape(-1, 2),
                                   n_steps)

        def stack(seq):  # 0-d tensors on the device, or host floats
            return torch.stack([torch.as_tensor(v, dtype=torch.float32)
                                .to(dev) for v in seq]) if seq else \
                torch.zeros(0, device=dev)

        return states, {name: torch.stack([stack(m[name]) for m in metrics])
                        for name in metrics[0]}

    def ckpt_target() -> AgentState:
        """The restore target of a checkpointed :class:`AgentState`:
        ``init``'s small leaves (params, moments, env state, counters) on
        the device, and the buffer's saved form on the meta device (no
        replay memory allocated)."""
        return fresh(prng.key(0), rck.replay_target(rb, example_transition))

    def load_ckpt(directory: str, step: int) -> AgentState:
        """The :class:`AgentState` checkpointed at ``step``, on this
        agent's device and replay shards (a checkpoint holds a sharded
        table dense, so it restores onto any shard count)."""
        state = ckpt_mod.restore(directory, step, ckpt_target(), device=dev)
        return state._replace(buffer=rck.from_dense_view(rb, state.buffer))

    def train_ckpt(key: torch.Tensor, n_steps: int,
                   manager: ckpt_mod.CheckpointManager):
        """``train`` with periodic checkpoints and exact resume.

        The step keys are derived once for the whole run
        (``split(fold_in(key, 1), n_steps)``, as ``train``), and the
        steps run in ``manager.save_interval`` segments with a full
        checkpoint of the :class:`AgentState` (params, Adam moments,
        replay buffer and sampler state, env state, episode accounting
        and the host counters) after each.  A run resumed from the latest
        checkpoint runs the same steps on the same state as ``train``,
        so it ends in ``train``'s final state bit for bit.

        The manifest records ``n_steps``: resuming with another one
        would change every step key, and raises.  Relaunching a finished
        run returns its final state and empty metrics.

        Returns ``(state, metrics, done_steps)``: ``metrics`` as
        ``train``'s, over the steps THIS call ran, and ``done_steps <
        n_steps`` iff the manager was preempted (after a checkpoint).
        """
        key = prng.key_data(key)
        keys = prng.split(prng.fold_in(key, 1), n_steps)
        state, start = None, 0
        latest = manager.latest_step()
        if latest is not None:
            saved = ckpt_mod.load_meta(manager.directory, latest)
            if saved.get("n_steps", n_steps) != n_steps:
                raise ValueError(
                    f"resume with n_steps={n_steps} but checkpoint was "
                    f"written by an n_steps={saved['n_steps']} run; the "
                    f"step-key derivation depends on n_steps, so this "
                    f"would not be an exact resume")
            state, start = load_ckpt(manager.directory, latest), latest
        if state is None:  # no checkpoint: only now pay for a fresh init
            state = init(key)
        metrics = {"return_mean": [], "beta": [], "loss": []}
        t = start
        while t < n_steps:
            for k in keys[t:t + min(n_steps - t, manager.save_interval)]:
                state, mt = agent_step(state, k)
                t += 1
                for name, seq in metrics.items():
                    seq.append(mt[name])
            if manager.should_save(t) or t == n_steps:
                manager.save(t, state._replace(
                    buffer=rck.dense_view(rb, state.buffer)),
                    meta={"n_steps": n_steps, "step": t})
            if manager.preempted and t < n_steps:
                break
        return state, metrics, t

    def evaluate(state, key: torch.Tensor, n_episodes: int = 10) -> float:
        """Greedy-policy average return over ``n_episodes`` episodes run
        in lockstep, each on its own key as the reference's ``vmap``."""
        params = state.params if hasattr(state, "params") else state
        keys = prng.split(key, n_episodes)
        pair = prng.split(keys)                      # [E, 2, 2]
        env_state = env.reset(pair[:, 0], dev)
        keys = pair[:, 1]
        obs = (stack_init(env.obs(env_state)) if pixel
               else env.obs(env_state))
        ret = torch.zeros(n_episodes, device=dev)
        over = torch.zeros(n_episodes, device=dev)
        with torch.no_grad():
            for t in range(env.max_steps):
                pair = prng.split(keys)
                keys, k = pair[:, 0], pair[:, 1]
                action = q_apply(params, q_in(obs)).argmax(-1).to(
                    torch.int32)
                env_state, _, r, d, _ = env.step(env_state, action, k)
                obs = (stack_push(obs, env.obs(env_state), d) if pixel
                       else env.obs(env_state))
                ret = ret + r * (1 - over)
                over = torch.maximum(over, d.to(torch.float32))
                if t % 50 == 49 and bool(over.min() > 0):
                    break
        return float(ret.mean())

    def evaluate_many(states, keys: torch.Tensor, n_episodes: int = 10
                      ) -> torch.Tensor:
        """Per-seed ``evaluate`` scores of ``train_many``'s states, one
        key each: float32 [S] on the agent's device."""
        keys = prng.key_data(keys).reshape(-1, 2)
        return torch.tensor([evaluate(st, k, n_episodes)
                             for st, k in zip(states, keys)],
                            dtype=torch.float32, device=dev)

    return DQN(init=init, agent_step=agent_step, train=train,
               train_many=train_many, evaluate=evaluate,
               evaluate_many=evaluate_many, train_ckpt=train_ckpt,
               load_ckpt=load_ckpt, ckpt_target=ckpt_target, act=act,
               learn=learn, cfg=cfg, env=env, venv=venv, replay=rb,
               beta_at=beta_at,
               q_apply=q_apply, example_transition=example_transition,
               init_obs=init_obs)


def _unflatten(tree, leaves):
    """Rebuild ``tree``'s structure from ``tree_leaves`` order."""
    it = iter(leaves)

    def take(node):
        if isinstance(node, dict):
            return {k: take(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(take(t) for t in node)
        return next(it)

    return take(tree)
