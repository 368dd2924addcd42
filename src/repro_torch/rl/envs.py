"""Environments on tensors: classic control and two pixel games, batched.

Counterpart of ``repro/rl/envs.py``: CartPole-v1 (Euler), Acrobot-v1
(RK4, wrapped angles) and MountainCar-v0 (Euler, clipped, with the
left-wall stop), and the two MinAtar-style 10x10 pixel games, Breakout
and Freeway, whose observations are ``uint8[..., 10, 10]`` frames.

An env works on a batch of states (leading dims of its tensors) and
exposes::

    obs_shape, n_actions   ((obs_dim,) for the flat envs, (H, W) for pixels)
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

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import prng, resolve_device
from repro_torch.xla_float import fma32

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


def _f32(c: float) -> torch.Tensor:
    """A Python constant as the float32 scalar XLA folds it to."""
    return torch.tensor(c, dtype=torch.float32)


class EnvState(NamedTuple):
    x: torch.Tensor  # float32[..., state_dim] physics state
    t: torch.Tensor  # int32[...] steps in the current episode


def _auto_reset(env, new: EnvState, done: torch.Tensor, keys) -> EnvState:
    """``new`` where not ``done``, else a fresh episode from ``keys`` (one
    reset drawn for every env, as the reference's ``jnp.where``)."""
    fresh = env.reset(keys, device=new.x.device)
    return EnvState(x=torch.where(done[..., None], fresh.x, new.x),
                    t=torch.where(done, fresh.t, new.t))


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
        return (_auto_reset(self, EnvState(x=new, t=t), done, keys), new,
                reward, done, terminated)


@register_env("acrobot")
class Acrobot:
    """Acrobot-v1: swing the tip above the bar; -1 per step until solved.

    RK4 over ``_dsdt`` on ``[0, DT]``, then the angles wrapped (floor
    mod, as ``jnp``'s ``%``) and the velocities clipped.  The float32
    arithmetic is the jitted reference's (see ``_dsdt``; each RK4 stage
    is one multiply-add), so within one step the two packages differ
    only where XLA's ``sin`` or ``cos`` rounds otherwise than torch's.
    """

    obs_dim = 6
    obs_shape = (6,)
    n_actions = 3
    max_steps = 500

    M1 = M2 = 1.0
    L1 = 1.0
    LC1 = LC2 = 0.5
    I1 = I2 = 1.0
    G = 9.8
    DT = 0.2

    def reset(self, keys: torch.Tensor, device=None) -> EnvState:
        x = prng.uniform(keys, (4,), -0.1, 0.1, device=device)
        return EnvState(x=x, t=torch.zeros(x.shape[:-1], dtype=torch.int32,
                                           device=x.device))

    def obs(self, state: EnvState) -> torch.Tensor:
        th1, th2, d1, d2 = state.x.unbind(-1)
        return torch.stack([torch.cos(th1), torch.sin(th1), torch.cos(th2),
                            torch.sin(th2), d1, d2], -1)

    def _dsdt(self, s: torch.Tensor, torque: torch.Tensor) -> torch.Tensor:
        """The reference's ``_dsdt`` as XLA compiles it: the constant
        terms of ``d1`` and ``d2`` fold into one, and each multiply feeding
        an add or subtract rounds once (:func:`fma32`)."""
        th1, th2, dth1, dth2 = s.unbind(-1)
        m1, m2, l1, lc1, lc2, i1, i2, g = (self.M1, self.M2, self.L1,
                                           self.LC1, self.LC2, self.I1,
                                           self.I2, self.G)
        half_pi = math.pi / 2
        cos2, sin2 = torch.cos(th2), torch.sin(th2)
        cos_a = torch.cos(th1 + th2 - half_pi)
        cos_b = torch.cos(th1 - half_pi)
        c_phi2 = _f32(m2 * lc2 * g)
        c_phi1 = _f32((m1 * lc1 + m2 * l1) * g)
        # m1 lc1^2 + m2 (l1^2 + lc2^2 + 2 l1 lc2 cos th2) + i1 + i2
        d1 = (2 * l1 * lc2 * m2 * cos2
              + (m1 * lc1 ** 2 + m2 * (l1 ** 2 + lc2 ** 2) + i1 + i2))
        d2 = m2 * l1 * lc2 * cos2 + (m2 * lc2 ** 2 + i2)
        # -m2 l1 lc2 dth2^2 sin th2 - 2 m2 l1 lc2 dth2 dth1 sin th2
        #   + (m1 lc1 + m2 l1) g cos(th1 - pi/2) + phi2
        phi1 = fma32(-m2 * l1 * lc2 * (dth2 * dth2), sin2,
                     -(2 * m2 * l1 * lc2 * (dth2 * dth1) * sin2))
        phi1 = fma32(cos_b, c_phi1, phi1)
        phi1 = fma32(cos_a, c_phi2, phi1)        # + phi2, phi2 = c_phi2 cos_a
        # (torque + d2 / d1 phi1 - m2 l1 lc2 dth1^2 sin th2 - phi2)
        #   / (m2 lc2^2 + i2 - d2^2 / d1)
        num = fma32(d2 / d1, phi1, torque)
        num = fma32(-m2 * l1 * lc2 * (dth1 * dth1), sin2, num)
        num = fma32(cos_a, -c_phi2, num)
        ddth2 = num / (m2 * lc2 ** 2 + i2 - d2 * d2 / d1)
        ddth1 = -fma32(d2, ddth2, phi1) / d1
        return torch.stack([dth1, dth2, ddth1, ddth2], -1)

    def step(self, state: EnvState, action: torch.Tensor, keys: torch.Tensor):
        torque = action.to(torch.float32) - 1.0  # {-1, 0, +1}
        s = state.x
        h = self.DT
        k1 = self._dsdt(s, torque)
        k2 = self._dsdt(fma32(k1, _f32(h / 2), s), torque)
        k3 = self._dsdt(fma32(k2, _f32(h / 2), s), torque)
        k4 = self._dsdt(fma32(k3, _f32(h), s), torque)
        new = fma32(k1 + 2 * k2 + 2 * k3 + k4, _f32(h / 6), s)
        th1, th2, d1, d2 = new.unbind(-1)
        pi = math.pi
        new = torch.stack([(th1 + pi) % (2 * pi) - pi,   # floor-mod wrap
                           (th2 + pi) % (2 * pi) - pi,
                           d1.clamp(-4 * pi, 4 * pi),
                           d2.clamp(-9 * pi, 9 * pi)], -1)
        t = state.t + 1
        terminated = (-torch.cos(new[..., 0])
                      - torch.cos(new[..., 1] + new[..., 0])) > 1.0
        done = terminated | (t >= self.max_steps)
        reward = torch.where(terminated, 0.0, -1.0)
        pre = EnvState(x=new, t=t)
        return (_auto_reset(self, pre, done, keys), self.obs(pre), reward,
                done, terminated)


@register_env("mountaincar")
class MountainCar:
    """MountainCar-v0: drive up the right hill; -1 per step; 200-step cap.

    Euler steps with the reference's clip, left-wall stop and goal test.
    The velocity update's multiply-add is rounded once, as XLA compiles
    the reference.
    """

    obs_dim = 2
    obs_shape = (2,)
    n_actions = 3
    max_steps = 200

    MIN_POS, MAX_POS = -1.2, 0.6
    MAX_SPEED = 0.07
    GOAL_POS, GOAL_VEL = 0.5, 0.0
    FORCE, GRAVITY = 0.001, 0.0025

    def reset(self, keys: torch.Tensor, device=None) -> EnvState:
        pos = prng.uniform(keys, (), -0.6, -0.4, device=device)
        return EnvState(x=torch.stack([pos, torch.zeros_like(pos)], -1),
                        t=torch.zeros(pos.shape, dtype=torch.int32,
                                      device=pos.device))

    def obs(self, state: EnvState) -> torch.Tensor:
        return state.x

    def step(self, state: EnvState, action: torch.Tensor, keys: torch.Tensor):
        pos, vel = state.x.unbind(-1)
        vel = vel + (action.to(torch.float32) - 1.0) * self.FORCE
        vel = fma32(torch.cos(3.0 * pos), _f32(-self.GRAVITY), vel)
        vel = vel.clamp(-self.MAX_SPEED, self.MAX_SPEED)
        pos = (pos + vel).clamp(self.MIN_POS, self.MAX_POS)
        vel = torch.where((pos <= self.MIN_POS) & (vel < 0), 0.0, vel)
        t = state.t + 1
        terminated = (pos >= self.GOAL_POS) & (vel >= self.GOAL_VEL)
        done = terminated | (t >= self.max_steps)
        reward = torch.full_like(pos, -1.0)
        new = torch.stack([pos, vel], -1)
        return (_auto_reset(self, EnvState(x=new, t=t), done, keys), new,
                reward, done, terminated)


# --- MinAtar-style pixel environments ----------------------------------------
#
# One uint8 plane of 10x10 cells; object classes are intensities.  A state
# of any leading shape is flattened to [N, ...] for the gathers and
# scatters, and the results take that shape back.

BRICK, CAR = 90, 128          # background object intensities
PADDLE, CHICKEN = 180, 255    # player intensities (drawn over background)
BALL = 255


def _flat(state: EnvState) -> tuple:
    """(x [N, D], t [N], leading shape) of a state of any leading dims."""
    lead = tuple(state.t.shape)
    return state.x.reshape(-1, state.x.shape[-1]), state.t.reshape(-1), lead


@register_env("breakout")
class Breakout:
    """MinAtar-style Breakout: 10x10 grid, 3 brick rows, diagonal ball.

    State ``x`` (float32[..., 35]): ``[ball_y, ball_x, dy, dx, paddle_x,
    bricks(3x10 flattened)]``.  Actions: 0 = noop, 1 = left, 2 = right.
    The ball reflects off the side walls and ceiling, clears a brick it
    would enter (+1, bouncing back without entering), bounces off the
    paddle on the bottom row or is lost (terminated).  A cleared wall
    respawns; ``max_steps`` truncates.
    """

    obs_shape = (10, 10)
    n_actions = 3
    max_steps = 300

    def reset(self, keys: torch.Tensor, device=None) -> EnvState:
        pair = prng.split(keys)                           # [..., 2, 2]
        k_x, k_d = pair[..., 0, :], pair[..., 1, :]
        ball_x = prng.randint(k_x, (), 0, 10).to(torch.float32)
        dx = torch.where(prng.bernoulli(k_d), 1.0, -1.0)
        four = torch.full_like(ball_x, 4.0)
        head = torch.stack([four, ball_x, torch.ones_like(ball_x), dx, four],
                           -1)
        x = torch.cat([head, torch.ones(head.shape[:-1] + (30,),
                                        device=head.device)], -1)
        x = x if device is None else x.to(device)
        return EnvState(x=x, t=torch.zeros(x.shape[:-1], dtype=torch.int32,
                                           device=x.device))

    def obs(self, state: EnvState) -> torch.Tensor:
        x, _, lead = _flat(state)
        n = x.shape[0]
        rows = torch.arange(n, device=x.device)
        by, bx, px = (x[:, i].to(torch.int32).long() for i in (0, 1, 4))
        bricks = x[:, 5:].reshape(n, 3, 10) > 0.5
        g = torch.zeros((n, 10, 10), dtype=torch.uint8, device=x.device)
        # Drawn in the reference's order: bricks, paddle, then the ball
        # over either.
        g[:, 1:4] = torch.where(bricks, BRICK, 0).to(torch.uint8)
        g[rows, 9, px] = PADDLE
        g[rows, by, bx] = BALL
        return g.reshape(lead + self.obs_shape)

    def step(self, state: EnvState, action: torch.Tensor, keys: torch.Tensor):
        x, t, lead = _flat(state)
        action = action.reshape(-1)
        by, bx, dy, dx, px = x[:, :5].unbind(-1)
        bricks = x[:, 5:]
        px = (px + (action == 2).to(torch.float32)
              - (action == 1).to(torch.float32)).clamp(0.0, 9.0)
        ny, nx = by + dy, bx + dx
        # side walls / ceiling: reflect position and flip direction
        dx = torch.where((nx < 0) | (nx > 9), -dx, dx)
        nx = torch.where(nx < 0, -nx, torch.where(nx > 9, 18.0 - nx, nx))
        dy = torch.where(ny < 0, -dy, dy)
        ny = torch.where(ny < 0, -ny, ny)
        # brick hit: clear it, +1, bounce back without entering the cell
        in_wall = (ny >= 1) & (ny <= 3)
        bidx = ((ny - 1) * 10 + nx).clamp(0, 29).to(torch.int32).long()
        bidx = bidx[:, None]
        brick = bricks.gather(1, bidx)[:, 0]
        hit = in_wall & (brick > 0.5)
        reward = hit.to(torch.float32)
        bricks = bricks.scatter(
            1, bidx, torch.where(hit, torch.zeros_like(brick), brick)[:, None])
        dy = torch.where(hit, -dy, dy)
        ny = torch.where(hit, by, ny)
        nx = torch.where(hit, bx, nx)
        # bottom row: paddle bounce or ball lost
        at_bottom = ny >= 9
        caught = at_bottom & (nx == px)
        dy = torch.where(caught, -1.0, dy)
        terminated = at_bottom & ~caught
        # cleared wall respawns
        bricks = torch.where(bricks.sum(-1, keepdim=True) < 0.5,
                             torch.ones_like(bricks), bricks)
        t = t + 1
        done = terminated | (t >= self.max_steps)
        new = EnvState(x=torch.cat([torch.stack([ny, nx, dy, dx, px], -1),
                                    bricks], -1).reshape(lead + (35,)),
                       t=t.reshape(lead))
        done, terminated = done.reshape(lead), terminated.reshape(lead)
        return (_auto_reset(self, new, done, keys), self.obs(new),
                reward.reshape(lead), done, terminated)


@register_env("freeway")
class Freeway:
    """MinAtar-style Freeway: cross 8 lanes of traffic, +1 per crossing.

    State ``x`` (float32[..., 9]): ``[chicken_y, car_x(8 lanes)]``.  The
    chicken lives in column 4 and moves with 0 = noop, 1 = up, 2 = down.
    Lane ``l`` (grid row ``l + 1``) carries one car advancing one cell
    every ``PERIOD[l]`` steps in direction ``DIRECTION[l]`` (wrapping).
    A collision sends the chicken back to the bottom row; the top row
    scores and restarts the crossing.  Freeway never terminates:
    episodes end only by truncation at ``max_steps``.
    """

    obs_shape = (10, 10)
    n_actions = 3
    max_steps = 250

    PERIOD = (1, 2, 3, 4, 4, 3, 2, 1)
    DIRECTION = (1, -1, 1, -1, 1, -1, 1, -1)
    COL = 4  # the chicken's fixed column

    def reset(self, keys: torch.Tensor, device=None) -> EnvState:
        cars = prng.randint(keys, (8,), 0, 10).to(torch.float32)
        x = torch.cat([torch.full(cars.shape[:-1] + (1,), 9.0,
                                  device=cars.device), cars], -1)
        x = x if device is None else x.to(device)
        return EnvState(x=x, t=torch.zeros(x.shape[:-1], dtype=torch.int32,
                                           device=x.device))

    def obs(self, state: EnvState) -> torch.Tensor:
        x, _, lead = _flat(state)
        n = x.shape[0]
        y = x[:, 0].to(torch.int32).long()
        cars = x[:, 1:].to(torch.int32).long()
        g = torch.zeros((n, 10, 10), dtype=torch.uint8, device=x.device)
        lanes = torch.arange(1, 9, device=x.device)
        g[torch.arange(n, device=x.device)[:, None], lanes, cars] = CAR
        g[torch.arange(n, device=x.device), y, self.COL] = CHICKEN
        return g.reshape(lead + self.obs_shape)

    def step(self, state: EnvState, action: torch.Tensor, keys: torch.Tensor):
        x, t, lead = _flat(state)
        action = action.reshape(-1)
        y, cars = x[:, 0], x[:, 1:]
        t = t + 1
        y = (y - (action == 1).to(torch.float32)
             + (action == 2).to(torch.float32)).clamp(0.0, 9.0)
        period = torch.tensor(self.PERIOD, dtype=torch.int32, device=x.device)
        direction = torch.tensor(self.DIRECTION, dtype=torch.float32,
                                 device=x.device)
        moves = (t[:, None] % period == 0).to(torch.float32)
        cars = (cars + moves * direction) % 10.0        # floor mod, as jnp
        # collision: the chicken's row holds a car in its column
        lane = (y.to(torch.int32) - 1).clamp(0, 7).long()[:, None]
        in_traffic = (y >= 1) & (y <= 8)
        hit = in_traffic & (cars.gather(1, lane)[:, 0] == float(self.COL))
        y = torch.where(hit, 9.0, y)
        scored = y <= 0
        reward = scored.to(torch.float32)
        y = torch.where(scored, 9.0, y)
        done = (t >= self.max_steps).reshape(lead)
        new = EnvState(
            x=torch.cat([y[:, None], cars], -1).reshape(lead + (9,)),
            t=t.reshape(lead))
        return (_auto_reset(self, new, done, keys), self.obs(new),
                reward.reshape(lead), done, torch.zeros_like(done))


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
