"""Quickstart on the PyTorch port: AMPER in 60 seconds.

The port's twin of ``examples/quickstart.py``, with ``--device`` (the
card by default):

1. Build a priority table, sample with PER and both AMPER variants,
   compare the sampled distributions (the Fig. 7 experiment in miniature).
2. Plug AMPER-fr into a replay buffer and run the store/sample/update
   cycle of Fig. 1.

The reference's ``jax.jit`` calls are eager calls here, and its keys are
``repro_torch.prng`` keys: ``prng.key(0)`` draws the reference's
priorities and indices bit for bit.  The means are taken in float64: the
priorities are multiples of 2^-23, so their float64 sum is exact in any
order and the AMPER means equal the reference's sums' exactly.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch import prng, resolve_device
from repro_torch.core.amper import AmperConfig, AmperSampler
from repro_torch.core.per import CumsumPER
from repro_torch.core.replay_buffer import ReplayBuffer

N, BATCH, DRAW = 10_000, 64, 4096


def mean(x: torch.Tensor) -> float:
    return float(x.double().mean())


def main(argv=None) -> dict:
    """Print the two parts' tables; returns the sampled means (``buffer``,
    ``PER``, ``AMPER-fr``, ``AMPER-k``) and the replay cycle's
    ``replay_reward`` and ``max_priority``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the tables, samplers and buffer live")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    key = prng.key(0).to(dev)
    priorities = prng.uniform(key, (N,))  # the paper's U[0,1] table
    out = {"buffer": mean(priorities)}

    # --- 1. sampling comparison ---------------------------------------------
    per = CumsumPER(N, device=dev)
    per_state = per.update(per.init(), torch.arange(N, device=dev), priorities)
    cfg = AmperConfig(capacity=N, m=20, lam_fr=2.0, v_max=1.0,
                      csp_capacity=1500, knn_mode="bisect")
    print(f"{'sampler':12s} {'mean sampled priority':>22s}   (buffer mean "
          f"{out['buffer']:.3f}, ideal PER {2/3:.3f})")
    idx = per.sample(per_state, key, DRAW)
    out["PER"] = mean(priorities[idx.long()])
    print(f"{'PER':12s} {out['PER']:22.3f}")
    for variant in ("fr", "k"):
        amp = AmperSampler(cfg, variant, device=dev)
        st = amp.update(amp.init(), torch.arange(N, device=dev), priorities)
        idx = amp.sample(st, key, DRAW)
        name = "AMPER-" + variant
        out[name] = mean(priorities[idx.long()])
        print(f"{name:12s} {out[name]:22.3f}")

    # --- 2. replay buffer cycle ----------------------------------------------
    rb = ReplayBuffer(1024, AmperSampler(
        cfg._replace(capacity=1024, csp_capacity=256), "fr", device=dev))
    tr = {"obs": torch.zeros(4), "action": torch.tensor(0, dtype=torch.int32),
          "reward": torch.tensor(0.0)}
    state = rb.init(tr)
    for i in range(256):
        state = rb.add(state, {"obs": torch.full((4,), float(i)),
                               "action": torch.tensor(i % 2,
                                                      dtype=torch.int32),
                               "reward": torch.tensor(float(i))})
    idx, batch, w = rb.sample(state, key, BATCH)
    state = rb.update_priorities(state, idx, batch["reward"] / 256.0)
    out["replay_reward"] = mean(batch["reward"])
    out["max_priority"] = float(state.max_priority)
    print(f"\nreplay cycle ok: sampled {BATCH} transitions, "
          f"mean reward {out['replay_reward']:.1f}, "
          f"priorities updated (max_p={out['max_priority']:.3f})")
    return out


if __name__ == "__main__":
    main()
