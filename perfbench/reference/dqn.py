"""The DQN step on CartPole with AMPER-fr replay, written out plainly.

One iteration of the paper's DQN test vehicle (arXiv:2207.07791) as the
configuration states it: an epsilon-greedy step of every env (CartPole,
auto-reset), the new transitions written to the ring at the running
maximum priority, then, from ``learn_start`` on, a draw of a batch from
the AMPER-fr candidate set, a TD step of the MLP Q-head (1-step,
vanilla target, unweighted squared error), Adam, the drawn rows'
priorities rewritten as ``(|td| + eps)^alpha``, and the target synced
every ``target_sync`` iterations.  The keys are derived from the seed as
the configuration's PRNG states (``threefry``).

``precision="tf32"`` rounds every matrix product's operands to TF32
(10 mantissa bits, nearest even), forward and backward: the control a
float32 configuration is held against.  ``fault`` plants one of the
faults the check has to catch: ``"half"`` learns from the first half of
each batch only, ``"altered"`` changes the first drawn row of each draw,
``"env_altered"`` the reward of the first env's transition of iteration
``watch``.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import amper
from perfbench.reference import threefry as tf

GRAV, MC, MP, LEN, FORCE, TAU = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
MAX_STEPS = 500


def cartpole_step(x: torch.Tensor, t: torch.Tensor, action: torch.Tensor,
                  keys) -> tuple:
    """CartPole-v1 in float32, every env at once; ``keys`` [E, 2] draw the
    fresh episode of each env that ends.  Returns ``(x, t)`` after the
    reset, the pre-reset state, reward, done, terminated."""
    xp, x_dot, th, th_dot = x.unbind(-1)
    force = torch.where(action == 1, FORCE, -FORCE)
    costh, sinth = torch.cos(th), torch.sin(th)
    total_m = MC + MP
    pm_l = MP * LEN
    temp = (force + pm_l * (th_dot * th_dot) * sinth) / total_m
    th_acc = (GRAV * sinth - costh * temp) / (
        LEN * (4.0 / 3.0 - MP * (costh * costh) / total_m))
    x_acc = temp - pm_l * th_acc * costh / total_m
    new = torch.stack([xp + TAU * x_dot, x_dot + TAU * x_acc,
                       th + TAU * th_dot, th_dot + TAU * th_acc], -1)
    t = t + 1
    terminated = (new[..., 0].abs() > 2.4) | (new[..., 2].abs() > 0.2095)
    done = terminated | (t >= MAX_STEPS)
    fresh = torch.from_numpy(tf.uniform(keys, (4,), -0.05, 0.05)).to(x.device)
    x_next = torch.where(done[..., None], fresh, new)
    t_next = torch.where(done, torch.zeros_like(t), t)
    reward = torch.ones_like(t, dtype=torch.float32)
    return x_next, t_next, new, reward, done, terminated


def _tf32(x: torch.Tensor) -> torch.Tensor:
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class _MatmulTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32(a) @ _tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return g @ _tf32(b).T, _tf32(a).T @ g


def mlp(params: list, x: torch.Tensor, precision: str) -> torch.Tensor:
    for i, layer in enumerate(params):
        xw = (_MatmulTF32.apply(x, layer["w"]) if precision == "tf32"
              else x @ layer["w"])
        x = xw + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def epsilon(step: int, cfg: dict) -> torch.Tensor:
    """The float32 schedule: ``start + step * f32(f32(end - start) *
    f32(1 / decay))`` in one fused multiply-add, clamped."""
    rate = (torch.tensor(cfg["eps_end"] - cfg["eps_start"],
                         dtype=torch.float32)
            * torch.tensor(1.0 / cfg["eps_decay_steps"], dtype=torch.float32))
    e = torch.from_numpy(np.asarray(tf.fma32(np.float32(step), rate.numpy(),
                                             cfg["eps_start"])))
    return torch.clamp(e, cfg["eps_end"], cfg["eps_start"])


def adam_rate(step: int, cfg: dict) -> torch.Tensor:
    """Adam's bias-corrected rate at ``step``, in float32."""
    c = torch.tensor(step + 1, dtype=torch.float32)
    return (cfg["lr"] * torch.sqrt(1 - torch.pow(torch.tensor(0.999), c))
            / (1 - torch.pow(torch.tensor(0.9), c)))


def _leaves(params: list) -> list[torch.Tensor]:
    return [layer[k] for layer in params for k in ("b", "w")]


def run(inputs: dict, cfg: dict, seed_key, steps: int, watch: int,
        precision: str = "float32", fault: str | None = None) -> dict:
    """Iterations ``0 .. steps - 1`` from the inputs the harness made.

    Returns what the check compares: the parameters and Adam's first
    moment before iteration ``watch``, the first moment after it, the
    loss of iterations ``watch .. steps - 1``, and after the last one
    the parameters, the ring and the priority table.
    """
    dev = inputs["env_x"].device
    n_envs, cap, batch = cfg["num_envs"], cfg["replay_size"], cfg["batch"]
    rcfg = {"m": cfg["amper_m"], "lam_fr": cfg["amper_lam_fr"],
            "v_max": cfg["v_max"], "frac_bits": cfg["frac_bits"]}
    csp_capacity = max(int(cap * cfg["amper_csp_ratio"]), batch)
    params = [{k: v.clone() for k, v in layer.items()}
              for layer in inputs["params"]]
    target = [dict(layer) for layer in params]
    m = [{k: torch.zeros_like(v) for k, v in layer.items()}
         for layer in params]
    v2 = [{k: torch.zeros_like(v) for k, v in layer.items()}
          for layer in params]
    ring = {k: x.clone() for k, x in inputs["ring"].items()}
    p0 = inputs["priorities"]
    pq = amper.quantize(p0, cfg["v_max"], cfg["frac_bits"])
    valid = p0 > 0
    max_p = torch.maximum(torch.tensor(1.0, device=dev), p0.max())
    pos = inputs["fill"] % cap
    x, t_ep = inputs["env_x"].clone(), torch.zeros(n_envs, dtype=torch.int32,
                                                   device=dev)
    keys = tf.split(tf.fold_in(seed_key, 1), steps)
    out: dict = {"loss": []}
    for t in range(steps):
        if t == watch:
            out["params_before"] = [dict(layer) for layer in params]
            out["m_before"] = [dict(layer) for layer in m]
        k_act, k_sample = tf.split(keys[t])
        k_coin, k_rand, k_env = tf.split(k_act, 3)
        with torch.no_grad():
            greedy = mlp(params, x, precision).argmax(-1)
        eps = epsilon(t, cfg).to(dev)
        explore = torch.from_numpy(tf.uniform(k_coin, (n_envs,))).to(dev) < eps
        randa = torch.from_numpy(tf.randint(k_rand, (n_envs,), 0, 2)).to(dev)
        action = torch.where(explore, randa, greedy).to(torch.int32)
        obs = x
        x, t_ep, new, reward, done, term = cartpole_step(
            x, t_ep, action, tf.split(k_env, n_envs))
        if fault == "env_altered" and t == watch:
            reward = reward.clone()
            reward[0] += 1.0
        rows = (pos + torch.arange(n_envs, device=dev)) % cap
        for name, val in (("obs", obs), ("action", action),
                          ("reward", reward), ("next_obs", new),
                          ("done", done.to(torch.float32)),
                          ("terminated", term.to(torch.float32))):
            ring[name][rows] = val.to(ring[name].dtype)
        amper.write_priorities(pq, valid, rows, max_p.expand(n_envs), rcfg)
        pos = (pos + n_envs) % cap
        if t >= cfg["learn_start"] and t % cfg["train_every"] == 0:
            idx = amper.table_draw(pq, valid, k_sample, batch, rcfg,
                                   csp_capacity)
            if fault == "altered":
                idx = idx.clone()
                idx[0] = (idx[0] + 1) % cap
            if fault == "half":
                idx = idx[: batch // 2]
            b = {k: ring[k][idx] for k in ring}
            live = [{k: val.detach().requires_grad_(True)
                     for k, val in layer.items()} for layer in params]
            q = mlp(live, b["obs"], precision)
            qa = q.gather(1, b["action"].to(torch.int64)[:, None])[:, 0]
            with torch.no_grad():
                boot = mlp(target, b["next_obs"], precision).max(-1).values
                goal = (b["reward"] + cfg["gamma"] * (1 - b["terminated"])
                        * boot)
            td = qa - goal
            loss = (torch.ones_like(td) * td * td).mean()
            grads = torch.autograd.grad(loss, _leaves(live))
            lr = adam_rate(t, cfg).to(dev)
            gi = iter(grads)
            new_params, new_m, new_v = [], [], []
            for layer, lm, lv in zip(live, m, v2):
                np_, nm, nv = {}, {}, {}
                for k in ("b", "w"):
                    g = next(gi)
                    nm[k] = 0.9 * lm[k] + (1 - 0.9) * g
                    nv[k] = 0.999 * lv[k] + (1 - 0.999) * g * g
                    np_[k] = layer[k].detach() - lr * nm[k] / (
                        nv[k].sqrt() + 1e-8)
                new_params.append(np_)
                new_m.append(nm)
                new_v.append(nv)
            params, m, v2 = new_params, new_m, new_v
            td = td.detach()
            p = (td.abs() + cfg["per_eps"]) ** cfg["alpha"]
            amper.write_priorities(pq, valid, idx, p, rcfg)
            max_p = torch.maximum(max_p, p.max())
            if t >= watch:
                out["loss"].append(loss.detach())
        if t % cfg["target_sync"] == 0:
            target = [dict(layer) for layer in params]
        if t == watch:
            out["m_after"] = [dict(layer) for layer in m]
    out.update(params_after=params, ring=ring, pq=pq, valid=valid)
    return out
