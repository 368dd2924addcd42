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
a Python loop of agent steps (:class:`Runner`), and the reference's
``lax.cond`` on the step counter is a host-side ``if`` (the counter is a
host int).  ``train`` derives its step keys once on the agent's device
and reads its schedules (epsilon, Adam's bias-corrected rate, beta) from
tables built once with :func:`agent_step`'s own host expressions, so on
a card no step sends a key, a rate or a bound back to the host.  With
the fused AMPER-fr draw on a flat 1-step ring, the steady learn step is
captured once in a CUDA graph and replayed; the other steps, and the
other paths, run eagerly on the same keys.
The reference's ``train_many`` vmaps that scan over S seeds; here the S
seeds run in lockstep (step t of every seed before step t + 1 of any),
each with its own state and host schedules (:func:`agent_step`), and
each seed ends in ``train``'s state for its key bit for bit.
``train_ckpt`` is ``train`` in ``save_interval`` segments with a
checkpoint of the whole :class:`AgentState` between them, in the
reference's on-disk format (:mod:`repro_torch.train.checkpoint`): it
runs the very steps ``train`` runs, so a killed and resumed run ends in
``train``'s state bit for bit.
PRNG keys (:mod:`repro_torch.prng`, on the host or on the card) are
consumed exactly as the reference consumes its keys, so the two packages
take the same actions and draw the same replay indices from the same
state.

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
import time
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import prng, resolve_device
from repro_torch.core.per import beta_schedule
from repro_torch.core.replay_buffer import FrameStore, ReplayBuffer
from repro_torch.core.samplers import make_sampler
from repro_torch.kernels import ops
from repro_torch.models.qhead import make_qhead, tree_leaves, tree_map
from repro_torch.obs.tracing import get_registry
from repro_torch.rl import envs as envs_mod
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import replay_checkpoint as rck
from repro_torch.xla_float import fma32

RETURN_RING = 64  # completed-episode returns kept for the train metric
# the telemetry counter of draws run by graph replays (a replayed draw
# records no ``replay_sample`` span: spans plus this count every draw)
REPLAYED_DRAWS = "replay_sample_replayed_total"
REPLAYED_DRAWS_HELP = "replay draws run inside a CUDA graph replay"

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


class StepTables(NamedTuple):
    """A run's per-step schedules, float32 [n_steps] on the agent's
    device, and the betas the metrics report (host floats)."""

    eps: torch.Tensor    # exploration rate
    lr: torch.Tensor     # Adam's bias-corrected learning rate
    beta: torch.Tensor   # IS exponent
    beta_host: list


class DQN(NamedTuple):
    """Everything :func:`make_dqn` builds, by name."""

    init: Callable           # key -> AgentState
    agent_step: Callable     # (AgentState, key) -> (AgentState, metrics)
    train: Callable          # (key, n_steps) -> (AgentState, metrics)
    runner: Callable         # (AgentState, key, n_steps, capture=,
    #                          record_idx=) -> Runner (.advance(stop))
    schedules: Callable      # n_steps -> StepTables
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

    def adam_lr(step: int) -> torch.Tensor:
        """Adam's bias-corrected learning rate at ``step`` (float32, on
        the host)."""
        c = torch.tensor(step + 1, dtype=torch.float32)
        return (cfg.lr * torch.sqrt(1 - torch.pow(torch.tensor(0.999), c))
                / (1 - torch.pow(torch.tensor(0.9), c)))

    def adam(params, grads, m, v, lr: torch.Tensor):
        b1, b2, eps = 0.9, 0.999, 1e-8
        m = tree_map(lambda a, g: b1 * a + (1 - b1) * g, m, grads)
        v = tree_map(lambda a, g: b2 * a + (1 - b2) * g * g, v, grads)
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
        division by the decay becomes a multiplication by its float32
        reciprocal, the constants fold into one float32 rate
        ``f32(f32(end - start) * f32(1 / decay))``, and the add fuses."""
        rate = (torch.tensor(cfg.eps_end - cfg.eps_start, dtype=torch.float32)
                * torch.tensor(1.0 / cfg.eps_decay_steps, dtype=torch.float32))
        e = fma32(torch.tensor(float(step)), rate, cfg.eps_start)
        return torch.clamp(e, cfg.eps_end, cfg.eps_start)

    def act(params, env_state, obs, step: int, key: torch.Tensor,
            eps: torch.Tensor | None = None):
        """One vectorized epsilon-greedy env step (the actor piece).
        Returns the post-reset policy input of the next step and the rows
        to store: flat envs keep the pre-reset ``next_obs``, pixel envs
        only the frame the action was taken on.  ``eps`` (a schedule
        table's entry) stands for ``epsilon(step)``."""
        k_coin, k_rand, k_env = prng.split(key, 3)
        with torch.no_grad():
            greedy = q_apply(params, q_in(obs)).argmax(-1)
        eps = epsilon(step) if eps is None else eps
        explore = prng.uniform(k_coin, (cfg.num_envs,)) < eps
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
              weights, lr: torch.Tensor | None = None):
        """One TD gradient step on a sampled batch (the learner piece).
        ``lr`` (a schedule table's entry) stands for Adam's
        bias-corrected rate at ``step``."""
        w = weights if is_per else torch.ones_like(weights)
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, td = td_loss(params, target_params, batch, w)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        grads_tree = _unflatten(params, grads)
        params = tree_map(lambda p: p.detach(), params)
        lr = adam_lr(step).to(dev) if lr is None else lr
        params, m, v = adam(params, grads_tree, opt_m, opt_v, lr)
        return params, m, v, td.detach(), loss.detach()

    def learns(step: int) -> bool:
        return step >= cfg.learn_start and step % cfg.train_every == 0

    def schedules(n_steps: int) -> StepTables:
        """The schedules of steps ``0 .. n_steps - 1`` as float32 tables
        on the agent's device, built once with the very host expressions
        :func:`agent_step` evaluates step by step (``epsilon``,
        ``adam_lr``, ``beta_at``), so a step that reads its entry gets the
        same bits; ``beta_host`` keeps the betas the metrics report."""
        eps = torch.stack([epsilon(t) for t in range(n_steps)])
        lr = torch.stack([adam_lr(t) for t in range(n_steps)])
        beta_host = [float(beta_at(t)) for t in range(n_steps)]
        return StepTables(eps=eps.to(dev), lr=lr.to(dev),
                          beta=torch.tensor(beta_host,
                                            dtype=torch.float32).to(dev),
                          beta_host=beta_host)

    def step_core(state: AgentState, key: torch.Tensor, eps, lr, beta,
                  learn_now: bool, sync: bool):
        """One agent step with its schedule values given and its host
        decisions (learn, target sync) made by the caller.  Returns the
        new state and the step's return mean, loss, sampled rows and TD
        errors (``None`` when it did not learn)."""
        k_act, k_sample = prng.split(key)
        env_state, obs_next, transitions = act(
            state.params, state.env_state, state.obs, state.step, k_act,
            eps)
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
        if learn_now:
            idx, batch, w = rb.sample(buffer, k_sample, cfg.batch, beta=beta)
            params, m, v, td, loss = learn(
                params, state.target_params, m, v, state.step, batch, w, lr)
            buffer = rb.update_priorities(buffer, idx, td)
        target_params = params if sync else state.target_params

        new = AgentState(params=params, target_params=target_params,
                         opt_m=m, opt_v=v, buffer=buffer,
                         env_state=env_state, obs=obs_next,
                         step=state.step + 1, episode_return=episode_return,
                         last_returns=last_returns, n_episodes=n_episodes)
        ret_mean = torch.where(
            n_episodes > 0,
            last_returns.sum() / torch.clamp(n_episodes, max=ring),
            torch.zeros((), device=dev))
        return new, ret_mean, loss, idx, td

    def agent_step(state: AgentState, key: torch.Tensor):
        """One step on the host's schedules (the reference's
        ``agent_step``); ``train`` runs the same step on tables."""
        t = state.step
        learn_now = learns(t)
        new, ret_mean, loss, idx, td = step_core(
            state, key, epsilon(t), None, beta_at(t) if learn_now else None,
            learn_now, t % cfg.target_sync == 0)
        # idx/td: the learn step's sampled rows and TD errors (None when
        # the step did not learn).
        metrics = {"return_mean": ret_mean, "beta": float(beta_at(t)),
                   "loss": loss, "idx": idx, "td": td}
        return new, metrics

    # The fused AMPER-fr draw on a flat 1-step ring is the path whose
    # steady learn step is captured in a CUDA graph (module docstring).
    static_path = (not pixel and cfg.n_step == 1
                   and getattr(sampler, "variant", None) == "fr"
                   and getattr(getattr(sampler, "cfg", None), "fr_mode",
                               None) == "fused")
    capturable = static_path and dev.type == "cuda"

    class Runner:
        """The step loop of one run of ``n_steps`` from ``key`` (what
        ``train`` and ``train_ckpt`` run, from ``state``): the step keys
        ``split(fold_in(key, 1), n_steps)`` and the schedule tables
        derived once on the agent's device, then steps
        :meth:`advance`-d one by one.  ``capture`` defaults to whether
        this agent's steady step can be captured (a CUDA agent with the
        fused AMPER-fr draw on a flat 1-step ring); ``capture=False``
        runs every step eagerly.  With ``capture`` the run's state
        lives in static buffers: the ring, priorities and stamps adopted
        from the state given, the small leaves cloned, and the ring's
        counters and the step counter mirrored as int64 scalars on the
        card.  The first steady learn step (a learn step that does not
        sync the target) runs on a side stream as the warm-up, the next
        is captured once in a ``torch.cuda.CUDAGraph``, and every steady
        step after that replays it; the other steps run eagerly on the
        same keys, tables and buffers.  The host keeps the step number
        and the ring's counters as ints beside the card's (they depend on
        no data), and makes the learn / sync choice from them, as the
        reference's ``lax.cond`` on ``step``.  On the CPU (the tests)
        ``capture`` keeps the static buffers and runs the graph's body
        itself at every steady step: there is no graph there."""

        def __init__(self, state: AgentState, key: torch.Tensor,
                     n_steps: int, capture: bool | None = None,
                     record_idx: bool = False):
            capture = capturable if capture is None else capture
            if capture and not static_path:
                raise ValueError(
                    "capture needs sampler 'amper-fr' with amper_fr_mode "
                    "'fused', a flat env and n_step 1")
            self.n_steps, self.capture = n_steps, capture
            self.keys = prng.split(prng.fold_in(
                prng.key_data(key).to(dev), 1), n_steps)
            self.tab = schedules(n_steps)
            # per step: metrics as train's; with record_idx the sampled
            # rows (None where a step did not learn)
            self.metrics = {"return_mean": [], "beta": [], "loss": []}
            self.idx = [] if record_idx else None
            # captured: a graph exists; capture_s: the warm-up step and the
            # capture, synchronized; replay_launches: the kernel launches
            # the graph holds, which each replay adds to ops.launches
            self.graph, self.info = None, {
                "captured": False, "graph_replays": 0, "eager_steps": 0,
                "capture_s": 0.0, "replay_launches": {}}
            self.state = state
            if capture:
                self._load(state)

        def _load(self, state: AgentState) -> None:
            buf = state.buffer
            small = {f: tree_map(torch.clone, getattr(state, f)) for f in (
                "params", "target_params", "opt_m", "opt_v", "obs",
                "episode_return", "last_returns", "n_episodes")}
            self.state = state._replace(
                env_state=state.env_state._make(
                    x.clone() for x in state.env_state),
                buffer=buf._replace(max_priority=buf.max_priority.clone()),
                **small)

            def card(x: int) -> torch.Tensor:
                return torch.tensor(x, dtype=torch.int64, device=dev)

            self.ctr = card(state.step)
            self.card = self.state._replace(buffer=self.state.buffer._replace(
                pos=card(buf.pos), size=card(buf.size),
                total_adds=card(buf.total_adds), add_gen=card(buf.add_gen)))
            self.card_stale = False
            n = self.n_steps
            self.ret_tab = torch.zeros(n, device=dev)
            self.loss_tab = torch.zeros(n, device=dev)
            self.idx_tab = torch.zeros(n if self.idx is not None else 1,
                                       cfg.batch, dtype=torch.int32,
                                       device=dev)

        def _record(self, t: int, ret_mean, loss, idx) -> None:
            self.metrics["return_mean"].append(ret_mean)
            self.metrics["beta"].append(self.tab.beta_host[t])
            self.metrics["loss"].append(loss)
            if self.idx is not None:
                self.idx.append(idx)

        def _eager(self, t: int) -> None:
            learn_now = learns(t)
            new, ret_mean, loss, idx, _ = step_core(
                self.state, self.keys[t], self.tab.eps[t], self.tab.lr[t],
                self.tab.beta[t], learn_now, t % cfg.target_sync == 0)
            if self.capture:  # into the static buffers
                _assign(self.state, new)
                self.state = self.state._replace(
                    step=new.step, buffer=self.state.buffer._replace(
                        pos=new.buffer.pos, size=new.buffer.size,
                        total_adds=new.buffer.total_adds,
                        add_gen=new.buffer.add_gen))
                self.card_stale = True
            else:
                self.state = new
            self.info["eager_steps"] += 1
            self._record(t, ret_mean, loss, idx)

        def _body(self) -> None:
            """The steady learn step on the static buffers, at the card's
            step counter: what the graph captures."""
            i = self.ctr.view(1)
            new, ret_mean, loss, idx, _ = step_core(
                self.card, self.keys.index_select(0, i)[0],
                self.tab.eps.index_select(0, i)[0],
                self.tab.lr.index_select(0, i)[0],
                self.tab.beta.index_select(0, i)[0], True, False)
            _assign(self.card, new)
            self.ret_tab.index_copy_(0, i, ret_mean.view(1))
            self.loss_tab.index_copy_(0, i, loss.view(1))
            if self.idx is not None:
                self.idx_tab.index_copy_(0, i, idx.view(1, -1))
            self.ctr.add_(1)

        def _steady(self, t: int) -> None:
            if self.card_stale:  # eager steps ran: the card's counters
                b = self.card.buffer
                for x, v in ((self.ctr, t), (b.pos, self.state.buffer.pos),
                             (b.size, self.state.buffer.size),
                             (b.total_adds, self.state.buffer.total_adds),
                             (b.add_gen, self.state.buffer.add_gen)):
                    x.fill_(v)
                self.card_stale = False
            if dev.type != "cuda":
                self._body()
            elif self.graph is None:
                self._warm_up_and_capture()
            else:
                self.graph.replay()
                ops.replayed(self.info["replay_launches"])
                self.info["graph_replays"] += 1
                # the replayed draw records no span (nothing runs on the
                # host): telemetry counts it here
                reg = get_registry()
                if reg.enabled:
                    reg.counter(REPLAYED_DRAWS, help=REPLAYED_DRAWS_HELP
                                ).add()
            self.state = self.state._replace(
                step=t + 1, buffer=rb.advance(self.state.buffer,
                                              cfg.num_envs))
            self._record(t, self.ret_tab[t], self.loss_tab[t],
                         self.idx_tab[t] if self.idx is not None else None)

        def _warm_up_and_capture(self) -> None:
            """Step t on a side stream (the kernels' scratch for it is made
            there), then the capture of step t + 1's body on that stream."""
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._body()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.info["eager_steps"] += 1
            before = dict(ops.recorded)
            # keep_graph: the graph's nodes stay readable (the launch
            # budget counts them, repro_torch.analysis.launches)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(self.graph, stream=side):
                self._body()
            self.graph.instantiate()
            torch.cuda.synchronize(dev)
            self.info.update(
                captured=True, capture_s=time.perf_counter() - t0,
                replay_launches={k: v - before[k]
                                 for k, v in ops.recorded.items()
                                 if v != before[k]})

        def advance(self, stop: int) -> AgentState:
            """Run steps ``state.step .. stop - 1``; returns the state."""
            for t in range(self.state.step, stop):
                if (self.capture and learns(t)
                        and t % cfg.target_sync != 0):
                    self._steady(t)
                else:
                    self._eager(t)
            return self.state

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
        keys (``split(fold_in(key, 1), n_steps)``, derived once on the
        agent's device) and schedule tables (:class:`Runner`; the steady
        step is captured where it can be).  Returns the final state and
        per-step metrics as lists."""
        r = Runner(init(prng.key_data(key)), key, n_steps)
        return r.advance(n_steps), r.metrics

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
        r = Runner(state, key, n_steps, capturable and start < n_steps)
        t = start
        while t < n_steps:
            t = min(n_steps, t + manager.save_interval)
            state = r.advance(t)
            if manager.should_save(t) or t == n_steps:
                manager.save(t, state._replace(
                    buffer=rck.dense_view(rb, state.buffer)),
                    meta={"n_steps": n_steps, "step": t})
            if manager.preempted and t < n_steps:
                break
        return state, r.metrics, t

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
               runner=Runner, schedules=schedules,
               train_many=train_many, evaluate=evaluate,
               evaluate_many=evaluate_many, train_ckpt=train_ckpt,
               load_ckpt=load_ckpt, ckpt_target=ckpt_target, act=act,
               learn=learn, cfg=cfg, env=env, venv=venv, replay=rb,
               beta_at=beta_at,
               q_apply=q_apply, example_transition=example_transition,
               init_obs=init_obs)


def _assign(dst, src) -> None:
    """Copy every tensor leaf of ``src`` into the tensor at the same place
    of ``dst`` (same structure), in place; a leaf that is already the
    destination is skipped and non-tensor leaves are left alone."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _assign(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s_ in zip(dst, src):
            _assign(d, s_)


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
