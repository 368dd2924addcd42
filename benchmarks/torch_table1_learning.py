"""Table 1 / Fig. 8 on the PyTorch port: DQN-family test scores across
an agents x samplers x envs grid, and the AMPER-vs-PER parity gate.

The twin of ``benchmarks/table1_learning.py`` (the same protocol, cells,
flags and gates), run on ``repro_torch``:

    PYTHONPATH=src:. python -m benchmarks.torch_table1_learning --parity
    PYTHONPATH=src:. python -m benchmarks.torch_table1_learning \\
        --env acrobot --agents dqn --steps 1200 --seeds 2

Each cell trains one agent variant with one replay sampler on one env
over the seeds, which run in lockstep through ``train_many``; its test
score is the greedy-policy return averaged over 10 episodes (the
paper's metric), from evaluation keys ``seed + 100``.  ``--device``
defaults to ``cuda``.  The last line of the output is one JSON summary:
the scores, whether each gate held, the wall seconds and the card's
``nvidia-smi`` name and power limit.  A gate that fails exits non-zero
after that line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from repro_torch import prng
from repro_torch.rl.dqn import DQNConfig, make_dqn
from repro_torch.rl.envs import available_envs

SAMPLERS = ("per-sumtree", "amper-k", "amper-fr", "uniform")
AGENTS = ("dqn", "double", "dueling")
ENVS = ("cartpole", "acrobot", "mountaincar")

# Parity gate band: the AMPER score must stay within (1 - PARITY_RATIO) *
# |PER score| of the PER score, which keeps the gate meaningful on the
# negative-return envs (Acrobot, MountainCar) where a plain ratio
# inverts.
PARITY_RATIO = 0.4


def within_parity(amper_score: float, per_score: float,
                  ratio: float = PARITY_RATIO) -> bool:
    return amper_score >= per_score - (1.0 - ratio) * abs(per_score)


def stack_keys(seeds) -> torch.Tensor:
    return torch.stack([prng.key(s) for s in seeds])


def _cell(env, sampler, agent, n_step, steps, seeds, replay, num_envs,
          device):
    cfg = DQNConfig(env=env, sampler=sampler, agent=agent, n_step=n_step,
                    replay_size=replay, num_envs=num_envs,
                    eps_decay_steps=steps // 2, learn_start=200)
    dqn = make_dqn(cfg, device=device)
    states, _ = dqn.train_many(stack_keys(seeds), steps)
    scores = dqn.evaluate_many(states, stack_keys(s + 100 for s in seeds),
                               10).cpu()
    return float(scores.mean()), float(scores.std(correction=0))


def run(env: str = "cartpole", steps: int = 6000, seeds=(0, 1, 2),
        replay: int = 2000, num_envs: int = 1, verbose: bool = True,
        agents=("dqn",), n_step: int = 1, samplers=SAMPLERS,
        device="cuda"):
    """One env's agents x samplers grid, rows keyed ``"agent/sampler"``."""
    rows = {}
    for agent in agents:
        for sampler in samplers:
            mean, std = _cell(env, sampler, agent, n_step, steps, seeds,
                              replay, num_envs, device)
            rows[f"{agent}/{sampler}"] = (mean, std)
            if verbose:
                print(f"table1 {env} {agent:8s} {sampler:12s} "
                      f"test={mean:7.1f} +- {std:.1f}  "
                      f"(n_step={n_step}, seeds={list(seeds)})", flush=True)
    return rows


def run_grid(envs=ENVS, agents=AGENTS, steps: int = 6000, seeds=(0, 1),
             replay: int = 2000, num_envs: int = 1, n_step: int = 1,
             verbose: bool = True, device="cuda"):
    """The full Table-1-style grid: every env x agent x sampler cell."""
    return {env: run(env=env, steps=steps, seeds=seeds, replay=replay,
                     num_envs=num_envs, verbose=verbose, agents=agents,
                     n_step=n_step, device=device)
            for env in envs}


def run_parity(steps: int = 6000, seeds=(0, 1), replay: int = 2000,
               verbose: bool = True, device="cuda"):
    """The acceptance gate: Double DQN + 3-step returns on CartPole under
    AMPER-fr reaches the reward regime of the exact ``per-cumsum`` law.
    Returns the scores; ``within_parity`` of them is the gate."""
    out = {}
    for sampler in ("per-cumsum", "amper-fr"):
        out[sampler] = _cell("cartpole", sampler, "double", 3, steps, seeds,
                             replay, 1, device)
        if verbose:
            print(f"parity cartpole double/n3 {sampler:10s} "
                  f"test={out[sampler][0]:7.1f} +- {out[sampler][1]:.1f}",
                  flush=True)
    return out


def gpu_line(device) -> str | None:
    """``nvidia-smi``'s name and power limit of the card, or None off it."""
    if torch.device(device).type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="cartpole", choices=available_envs())
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--num-envs", type=int, default=1)
    ap.add_argument("--agents", default="dqn,double,dueling",
                    help="comma list of agent variants")
    ap.add_argument("--n-step", type=int, default=1)
    ap.add_argument("--grid", action="store_true",
                    help="full envs x agents x samplers grid")
    ap.add_argument("--parity", action="store_true",
                    help="run only the double/n-step AMPER-vs-PER gate")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = tuple(range(args.seeds))
    agents = tuple(args.agents.split(","))
    t0 = time.perf_counter()
    if args.parity:
        out = run_parity(steps=args.steps, seeds=seeds, device=args.device)
        scores = {"cartpole": {f"double/{k}": v for k, v in out.items()}}
        gates = {"cartpole/double/amper-fr": within_parity(
            out["amper-fr"][0], out["per-cumsum"][0])}
    else:
        envs = ENVS if args.grid else (args.env,)
        scores = run_grid(envs=envs, agents=agents, steps=args.steps,
                          seeds=seeds, num_envs=args.num_envs,
                          n_step=args.n_step, device=args.device)
        for env, rows in scores.items():
            for k, (mean, std) in rows.items():
                print(f"table1/{env}/{k},0.00,"
                      f"test_score={mean:.1f}+-{std:.1f}")
        # Table 1 claim: AMPER within the family of PER for every agent.
        gates = {f"{env}/{agent}/{kind}": within_parity(
                     rows[f"{agent}/{kind}"][0], rows[f"{agent}/per-sumtree"][0])
                 for env, rows in scores.items() if not args.grid
                 for agent in agents for kind in ("amper-fr", "amper-k")}
    summary = {"benchmark": "torch_table1_learning", "parity": args.parity,
               "steps": args.steps, "seeds": list(seeds),
               "device": str(args.device), "scores": scores, "gates": gates,
               "wall_s": time.perf_counter() - t0,
               "gpu": gpu_line(args.device)}
    print(json.dumps(summary), flush=True)
    failed = sorted(k for k, ok in gates.items() if not ok)
    if failed:
        print(f"torch_table1_learning: gate failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
