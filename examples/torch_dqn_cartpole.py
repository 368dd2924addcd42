"""Paper reproduction example on the PyTorch port: DQN with every sampler.

The port's twin of ``examples/dqn_cartpole.py``, with its flags and
``--device`` (the card by default).  AMPER-fr draws through the fused
kernel (``amper_fr_mode="fused"``; on the card its steady learn step is
captured in a CUDA graph), whose draws equal the reference's broadcast
draw bit for bit.  Trains four agents
(uniform / PER / AMPER-k / AMPER-fr) for ``--steps`` iterations through
the steps ``make_dqn(...).train`` runs (its runner) and prints
train/test scores.  With ``--num-envs N`` each iteration steps N
environments in lockstep and writes N transitions into the replay ring,
so frames = steps * num_envs.

Where the reference compiles ahead of time to keep compilation out of
the frames/s column, this twin first runs ``learn_start + 2`` steps of a
throwaway agent (the kernels load, cuBLAS starts, the fused step is
captured once), and subtracts the timed run's own warm-up-and-capture
seconds (``Runner.info["capture_s"]``) from its wall time.

Run:  PYTHONPATH=src python examples/torch_dqn_cartpole.py --steps 6000
      PYTHONPATH=src python examples/torch_dqn_cartpole.py --num-envs 16
      PYTHONPATH=src python examples/torch_dqn_cartpole.py --device cpu --steps 300
"""
import argparse
import time

import torch

from repro_torch import prng, resolve_device
from repro_torch.rl.dqn import DQNConfig, make_dqn
from repro_torch.rl.envs import available_envs

SAMPLERS = ("uniform", "per-sumtree", "amper-k", "amper-fr")
LEARN_START = 200


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> list:
    """Print the table; returns one dict a sampler (``sampler``,
    ``train``, ``test``, ``sec``, ``frames_per_s``, ``warmup_s``,
    ``capture_s``, ``captured``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--env", default="cartpole", choices=available_envs())
    ap.add_argument("--agent", default="dqn",
                    choices=("dqn", "double", "dueling", "double-dueling"),
                    help="agent variant (Q-head x target rule)")
    ap.add_argument("--n-step", type=int, default=1,
                    help="n-step return horizon")
    ap.add_argument("--num-envs", type=int, default=1,
                    help="parallel environments per iteration")
    ap.add_argument("--replay", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the agents and their replay run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    frames = args.steps * args.num_envs
    print(f"agent={args.agent} n_step={args.n_step} device={dev}")
    print(f"{'sampler':14s} {'train(last64)':>14s} {'test(10ep)':>11s} "
          f"{'sec':>6s} {'frames/s':>9s}")
    rows = []
    for sampler in SAMPLERS:
        cfg = DQNConfig(env=args.env, sampler=sampler, agent=args.agent,
                        n_step=args.n_step, replay_size=args.replay,
                        num_envs=args.num_envs,
                        eps_decay_steps=args.steps // 2,
                        learn_start=LEARN_START,
                        amper_fr_mode="fused")
        dqn = make_dqn(cfg, device=dev)
        key = prng.key(args.seed)
        t0 = time.perf_counter()
        warm = min(args.steps, LEARN_START + 2)
        dqn.runner(dqn.init(key), key, warm).advance(warm)
        _sync(dev)
        warmup_s = time.perf_counter() - t0
        runner = dqn.runner(dqn.init(key), key, args.steps)
        t0 = time.perf_counter()
        state = runner.advance(args.steps)
        _sync(dev)
        dt = time.perf_counter() - t0 - runner.info["capture_s"]
        test = dqn.evaluate(state, prng.key(args.seed + 100), 10)
        train = float(runner.metrics["return_mean"][-1])
        print(f"{sampler:14s} {train:14.1f} {test:11.1f} {dt:6.1f} "
              f"{frames / dt:9.0f}")
        rows.append({"sampler": sampler, "train": train, "test": test,
                     "sec": dt, "frames_per_s": frames / dt,
                     "warmup_s": warmup_s,
                     "capture_s": runner.info["capture_s"],
                     "captured": runner.info["captured"]})
    return rows


if __name__ == "__main__":
    main()
