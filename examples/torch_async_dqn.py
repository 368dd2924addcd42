"""Async actor-learner DQN through the port's pipelined `ReplayService`.

The PyTorch port's twin of ``examples/async_dqn.py``, with the same
flags and ``--device`` (the card by default).  Actors, the priority
sampler (prefetching slab N+1 while the learner consumes slab N) and the
learner run as overlapped stages on host threads, each under its own
CUDA stream; TD-error priority feedback flows back out of band with
write-stamp staleness guards.  ``--sync`` degrades to the strict
synchronous mode (the trainer's iteration, step by step) for an
apples-to-apples learner-steps/s comparison.

With ``--ckpt-dir`` the service checkpoints the whole replay stack
(params, optimizer, buffer and sampler state, per-actor env states and
PRNG stream positions) with copy-on-write snapshots, flushes a final
snapshot on SIGTERM (or a ``PREEMPT`` sentinel file in the directory),
and AUTO-RESUMES from the latest checkpoint on relaunch.

Run:  PYTHONPATH=src python examples/torch_async_dqn.py --steps 2000
      PYTHONPATH=src python examples/torch_async_dqn.py --sampler per-sumtree --sync
      PYTHONPATH=src python examples/torch_async_dqn.py --device cpu --steps 200
      PYTHONPATH=src python examples/torch_async_dqn.py --ckpt-dir run1
      PYTHONPATH=src python examples/torch_async_dqn.py --metrics-out run1.jsonl
"""
import argparse

from repro_torch import prng
from repro_torch.obs import Telemetry
from repro_torch.rl.dqn import DQNConfig
from repro_torch.rl.envs import available_envs
from repro_torch.runtime import ReplayService
from repro_torch.train.checkpoint import CheckpointManager

REPLAY_RATIO = 4  # frames per learner step, in units of num_envs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="cartpole", choices=available_envs())
    ap.add_argument("--sampler", default="amper-fr",
                    help="any repro_torch.core.samplers registry name")
    ap.add_argument("--fr-mode", default="fused",
                    help="the AMPER-fr sampler's fr_mode (fused and kernel "
                         "run the CUDA kernels)")
    ap.add_argument("--agent", default="dqn",
                    choices=("dqn", "double", "dueling", "double-dueling"),
                    help="agent variant (Q-head x target rule)")
    ap.add_argument("--n-step", type=int, default=1,
                    help="n-step return horizon (each actor aggregates its "
                         "own stream)")
    ap.add_argument("--steps", type=int, default=2000,
                    help="learner steps (trainer iterations with --sync)")
    ap.add_argument("--num-envs", type=int, default=16,
                    help="environments per actor")
    ap.add_argument("--actors", type=int, default=1, help="actor threads")
    ap.add_argument("--chunk", type=int, default=32,
                    help="env steps per actor rollout chunk")
    ap.add_argument("--slab", type=int, default=8,
                    help="batches per prefetch draw / learner call")
    ap.add_argument("--replay", type=int, default=4000)
    ap.add_argument("--sync", action="store_true",
                    help="strict synchronous mode (baseline)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the agent, the replay and every stage run")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (enables snapshots and "
                         "auto-resume)")
    ap.add_argument("--ckpt-every", type=int, default=500,
                    help="learner steps between snapshots")
    ap.add_argument("--beta-end", type=float, default=None,
                    help="anneal the PER IS exponent to this value")
    ap.add_argument("--metrics-out", default=None,
                    help="write telemetry (JSONL event log + replay-health "
                         "probes) to this path; Prometheus text lands next "
                         "to it as <path>.prom")
    args = ap.parse_args(argv)

    # eps decays per actor ITERATION: in async mode actors run about
    # REPLAY_RATIO iterations per learner step, so scale the horizon to
    # keep exploration comparable with the --sync baseline.  beta anneals
    # in learner steps, so its horizon is --steps.
    decay = max(args.steps // 2, 1) * (1 if args.sync else REPLAY_RATIO)
    cfg = DQNConfig(env=args.env, sampler=args.sampler, agent=args.agent,
                    n_step=args.n_step, num_envs=args.num_envs,
                    replay_size=args.replay, learn_start=50,
                    eps_decay_steps=decay, target_sync=100, v_max=8.0,
                    amper_fr_mode=args.fr_mode, beta_end=args.beta_end,
                    beta_anneal_steps=args.steps if args.beta_end else None)
    tel = (Telemetry(metrics_out=args.metrics_out,
                     prometheus_out=args.metrics_out + ".prom")
           if args.metrics_out else None)
    svc = ReplayService(cfg, sync=args.sync,
                        num_actors=1 if args.sync else args.actors,
                        chunk_len=args.chunk, slab=args.slab,
                        max_replay_ratio=REPLAY_RATIO * args.num_envs,
                        device=args.device, telemetry=tel)
    key = prng.key(args.seed)
    manager = (CheckpointManager(args.ckpt_dir, keep=3,
                                 save_interval=args.ckpt_every)
               if args.ckpt_dir else None)
    if manager is None:
        svc.run(key, 60 if args.sync else 2 * args.slab)   # warm-up
    res = svc.run(key, args.steps, manager=manager)
    if manager is not None and res.metrics.get("preempted_at") is not None:
        print(f"preempted: snapshot flushed at step "
              f"{res.metrics['preempted_at']}; rerun to resume")
    m = res.metrics
    print(f"mode={m['mode']} sampler={args.sampler} env={args.env} "
          f"device={svc.device}")
    print(f"learner steps/s = {m['learner_steps_per_sec']:8.1f}   "
          f"({m['learner_steps']} steps, wall {m['wall_time']:.1f}s)")
    print(f"env frames/s    = {m['frames_per_sec']:8.0f}   "
          f"({m['frames']} frames)")
    if m["mode"] == "async":
        st, qd = m["staleness"], m["queue_depth"]
        print(f"priority staleness: mean={st['mean']:.1f} max={st['max']} "
              f"learner steps behind")
        print(f"queue depth (mean): blocks+feedback={qd['work_mean']:.2f} "
              f"batch slabs={qd['batch_mean']:.2f}")
    print(f"train return_mean = {m['return_mean']:.1f}")
    test = svc.dqn.evaluate(res.params, prng.key(args.seed + 100), 10)
    print(f"test(10ep)        = {test:.1f}")
    if args.metrics_out:
        print(f"telemetry: {args.metrics_out} (+ .prom); inspect with "
              f"`python -m repro_torch.obs.report {args.metrics_out}`")


if __name__ == "__main__":
    main()
