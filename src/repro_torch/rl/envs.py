"""Environments on tensors: gym's CartPole-v1, batched.

Counterpart of ``repro/rl/envs.py`` for the env this slice of the port
needs; Acrobot, MountainCar and the pixel envs wait for later slices.

An env works on a batch of states (leading dims of its tensors) and
exposes::

    obs_shape, n_actions
    reset(keys, device) -> state         (one key per env: keys [..., 2])
    obs(state) -> observation
    step(state, action, keys) -> (next_state, obs, reward, done, terminated)

``step`` auto-resets on ``done``: the returned ``obs`` is the PRE-reset
observation the TD target consumes, ``next_state`` already the fresh
episode.  ``done`` ends the episode (termination or the time limit);
``terminated`` only when the MDP itself ended, so a time-limit cut
still bootstraps.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import prng, resolve_device

_ENV_REGISTRY: dict[str, Callable[[], Any]] = {}


def register_env(name: str, *aliases: str):
    """Decorator: register an env class under ``name`` (plus aliases)."""

    def deco(cls):
        for n in (name, *aliases):
            _ENV_REGISTRY[n] = cls
        return cls

    return deco


def available_envs() -> list[str]:
    return sorted(_ENV_REGISTRY)


def make_env(name: str):
    """Build an environment instance by registry name."""
    try:
        cls = _ENV_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown env: {name!r} "
                         f"(available: {available_envs()})") from None
    return cls()


class EnvState(NamedTuple):
    x: torch.Tensor  # float32[..., state_dim] physics state
    t: torch.Tensor  # int32[...] steps in the current episode


@register_env("cartpole")
class CartPole:
    """CartPole-v1: keep the pole upright; +1 per step; 500-step cap.

    The reference's float32 expressions are kept term for term, so the
    two packages agree to float32 rounding.
    """

    obs_dim = 4
    obs_shape = (4,)
    n_actions = 2
    max_steps = 500

    GRAV, MC, MP, LEN, F, TAU = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02

    def reset(self, keys: torch.Tensor, device=None) -> EnvState:
        x = prng.uniform(keys, (4,), -0.05, 0.05, device=device)
        return EnvState(x=x, t=torch.zeros(x.shape[:-1], dtype=torch.int32,
                                           device=x.device))

    def obs(self, state: EnvState) -> torch.Tensor:
        return state.x

    def step(self, state: EnvState, action: torch.Tensor, keys: torch.Tensor):
        x, x_dot, th, th_dot = state.x.unbind(-1)
        force = torch.where(action == 1, self.F, -self.F)
        costh, sinth = torch.cos(th), torch.sin(th)
        total_m = self.MC + self.MP
        pm_l = self.MP * self.LEN
        temp = (force + pm_l * (th_dot * th_dot) * sinth) / total_m
        th_acc = (self.GRAV * sinth - costh * temp) / (
            self.LEN * (4.0 / 3.0 - self.MP * (costh * costh) / total_m))
        x_acc = temp - pm_l * th_acc * costh / total_m
        new = torch.stack([x + self.TAU * x_dot, x_dot + self.TAU * x_acc,
                           th + self.TAU * th_dot, th_dot + self.TAU * th_acc],
                          -1)
        t = state.t + 1
        terminated = (new[..., 0].abs() > 2.4) | (new[..., 2].abs() > 0.2095)
        done = terminated | (t >= self.max_steps)
        reward = torch.ones_like(t, dtype=torch.float32)
        fresh = self.reset(keys, device=new.device)
        next_state = EnvState(x=torch.where(done[..., None], fresh.x, new),
                              t=torch.where(done, fresh.t, t))
        return next_state, new, reward, done, terminated


class VectorEnv:
    """``num_envs`` independent copies of an env, stepped in lockstep.

    ``step`` takes one key and splits it into per-env auto-reset keys,
    as the reference's vmapped ``VectorEnv`` does, so the two packages
    draw the same resets.
    """

    def __init__(self, env, num_envs: int, device="cuda"):
        if num_envs < 1:
            raise ValueError(f"num_envs must be >= 1, got {num_envs}")
        self.env = env
        self.num_envs = num_envs
        self.device = resolve_device(device)
        self.obs_shape = tuple(env.obs_shape)
        self.obs_dim = getattr(env, "obs_dim", None)
        self.n_actions = env.n_actions

    def reset(self, key: torch.Tensor) -> EnvState:
        return self.env.reset(prng.split(key, self.num_envs), self.device)

    def obs(self, state: EnvState) -> torch.Tensor:
        return self.env.obs(state)

    def step(self, state: EnvState, actions: torch.Tensor, key: torch.Tensor):
        """-> (state, next_obs [B, *obs_shape], reward [B], done [B],
        terminated [B])."""
        return self.env.step(state, actions,
                             prng.split(key, self.num_envs))
