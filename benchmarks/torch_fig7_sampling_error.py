"""Fig. 7 on the PyTorch port: AMPER vs PER sampling error.

The twin of ``benchmarks/fig7_sampling_error.py`` (the same protocol,
sweeps and closing assertion), run on ``repro_torch``:

    PYTHONPATH=src:. python -m benchmarks.torch_fig7_sampling_error

n = 10,000 priorities ~ U[0, 1) (``uniform(fold_in(key, 99))``); batches
of 64 drawn 100 times with PER, AMPER-k, AMPER-fr and uniform; the
sampled-priority histograms compared by Laplace-smoothed KL in total
nats over the sample (:mod:`repro_torch.obs.probes`).  ``--device``
defaults to ``cuda``.  The last line of the output is one JSON summary
with the noise floor, the uniform KL, the best AMPER-k and AMPER-fr KL
and the card's ``nvidia-smi`` name and power limit; the script exits
non-zero after it if uniform is not more than 5x worse than the best
AMPER KL.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmarks.torch_table1_learning import gpu_line
from repro_torch import prng
from repro_torch.core.amper import AmperConfig, AmperSampler
from repro_torch.core.per import CumsumPER
from repro_torch.obs.probes import BINS, kl_nats, priority_bin_counts

BATCH, RUNS = 64, 100


def sample_counts(sampler, state, key, prio: np.ndarray) -> np.ndarray:
    """Binned sampled priorities of RUNS draws on keys fold_in(key, r)."""
    counts = np.zeros(BINS)
    for r in range(RUNS):
        idx = sampler.sample(state, prng.fold_in(key, r), BATCH)
        counts += priority_bin_counts(prio[idx.cpu().numpy()])
    return counts


def _table(n: int, seed: int, device):
    """The priorities, as a tensor on ``device`` and on the host."""
    key = prng.key(seed)
    prio = prng.uniform(prng.fold_in(key, 99), (n,), device=device)
    return key, prio, prio.cpu().numpy()


def _filled(sampler, prio: torch.Tensor):
    idx = torch.arange(prio.shape[0], device=prio.device)
    return sampler.update(sampler.init(), idx, prio)


def amper_sampler(n: int, m: int, lam: float, variant: str, csp_ratio: float,
                  device) -> AmperSampler:
    cfg = AmperConfig(capacity=n, m=m, lam=lam / 10.0, lam_fr=lam, v_max=1.0,
                      csp_capacity=max(int(csp_ratio * n), BATCH),
                      knn_mode="bisect")
    return AmperSampler(cfg, variant, device=device)


def run(n: int = 10_000, m_values=(2, 4, 8, 12), lam_values=(0.05, 0.5, 2.0),
        seed: int = 0, verbose: bool = True, device="cuda"):
    key, prio, prio_np = _table(n, seed, device)
    per = CumsumPER(n, device=device)
    per_state = _filled(per, prio)
    q_ref = sample_counts(per, per_state, prng.fold_in(key, 1), prio_np)
    q_ref2 = sample_counts(per, per_state, prng.fold_in(key, 2), prio_np)
    noise_floor = kl_nats(q_ref2, q_ref)

    uni = np.random.default_rng(seed).integers(0, n, BATCH * RUNS)
    kl_uniform = kl_nats(priority_bin_counts(prio_np[uni]).astype(float),
                         q_ref)

    rows = []
    for variant in ("fr", "k"):
        for m in m_values:
            for lam in lam_values:
                s = amper_sampler(n, m, lam, variant, 0.2, device)
                c = sample_counts(s, _filled(s, prio), prng.fold_in(key, 7),
                                  prio_np)
                kl = kl_nats(c, q_ref)
                rows.append({"variant": variant, "m": m, "lam": lam,
                             "kl_nats": kl})
                if verbose:
                    print(f"fig7 amper-{variant} m={m:3d} lam={lam:5.2f} "
                          f"KL={kl:9.1f} nats", flush=True)
    if verbose:
        print(f"fig7 reference: PER-vs-PER noise={noise_floor:.1f} nats, "
              f"uniform-vs-PER={kl_uniform:.1f} nats")
    return {"noise_floor": noise_floor, "kl_uniform": kl_uniform,
            "rows": rows}


def run_sizes(sizes=(5000, 10_000, 20_000), m: int = 8, lam: float = 2.0,
              seed: int = 0, verbose: bool = True, device="cuda"):
    """Fig. 7(d): AMPER-k's sampling error across ER sizes at fixed m
    and CSP ratio 0.15."""
    rows = []
    for n in sizes:
        key, prio, prio_np = _table(n, seed, device)
        per = CumsumPER(n, device=device)
        q_ref = sample_counts(per, _filled(per, prio), prng.fold_in(key, 1),
                              prio_np)
        s = amper_sampler(n, m, lam, "k", 0.15, device)
        c = sample_counts(s, _filled(s, prio), prng.fold_in(key, 7), prio_np)
        kl = kl_nats(c, q_ref)
        rows.append({"n": n, "kl_nats": kl})
        if verbose:
            print(f"fig7d amper-k n={n:6d} m={m} CSP=0.15 KL={kl:9.1f} nats",
                  flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    sizes = run_sizes(device=args.device)
    best = min(r["kl_nats"] for r in out["rows"])
    best_of = {v: min(r["kl_nats"] for r in out["rows"] if r["variant"] == v)
               for v in ("k", "fr")}
    print(f"fig7 summary: best AMPER KL {best:.1f} vs uniform "
          f"{out['kl_uniform']:.1f} (noise {out['noise_floor']:.1f})")
    ok = out["kl_uniform"] > 5 * best
    print(json.dumps({"benchmark": "torch_fig7_sampling_error",
                      "device": str(args.device),
                      "noise_floor": out["noise_floor"],
                      "kl_uniform": out["kl_uniform"],
                      "best_amper_k": best_of["k"],
                      "best_amper_fr": best_of["fr"],
                      "sizes": sizes, "uniform_far_worse": ok,
                      "gpu": gpu_line(args.device)}), flush=True)
    if not ok:
        print("torch_fig7_sampling_error: uniform should be far worse",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
