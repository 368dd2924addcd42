#!/usr/bin/env python3
"""Time the port's three replay kernels of one source tree on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/replay_kernel_times.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(this tree's by default).  To compare with an earlier revision, unpack
it into a ``.gitignore``d directory and run the two in turns on one card:

    mkdir -p build/parent && git archive REV | tar -x -C build/parent
    for s in build/parent/src src src build/parent/src; do
      python3 tools/replay_kernel_times.py --src $s
    done

Each run builds that tree's kernels at first use and calls them through
its public wrappers, ``ops.multi_query_match``, ``ops.rank_select`` and
``ops.amper_sample``.  At n = 1,000,000 and at one 250,000-row shard
(``chip_smoke.py``'s tables, its m = 20 ranges, 64 ranks; the draw's
batch 64 with CSP capacities 150,000 and 37,500, the fused sampler's
0.15 of the rows) it holds each result exactly against the plain
version, then prints one JSON line per kernel and shape: the device time of a call (``chip_smoke.device_time_ms``, CUDA
events) and the call's device operations with their times
(``chip_smoke.device_ops``, torch.profiler).  The last line is the
card's name and power limit.  Exits 2 without a CUDA device, 1 when a
result differs from the plain version.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("replay_kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import chip_smoke as cs
    import repro_torch
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels.amper_sample import amper_sample_ref
    from repro_torch.kernels.ref import multi_query_match_ref, rank_select_ref

    dev = torch.device("cuda")
    lo, hi = cs.ranges(dev)
    tables = {"n1e6": cs.table(cs.N_ROWS, 1000, dev),
              "shard_250k": cs.table(cs.N_ROWS // cs.SHARDS, 0, dev)}
    for shape, (pq, valid) in tables.items():
        count = int(rank_select_ref(pq, valid, lo, hi, torch.zeros(
            1, dtype=torch.int32, device=dev))[1])
        rank = cs.rank_cases(count, 64, seed=3)
        key, cap = prng.key(7), int(0.15 * pq.shape[0])
        calls = {"multi_query_match": (
            lambda: ops.multi_query_match(pq, valid, lo, hi),
            multi_query_match_ref(pq, valid, lo, hi)),
            "rank_select": (lambda: ops.rank_select(pq, valid, lo, hi, rank),
                            rank_select_ref(pq, valid, lo, hi, rank)),
            "amper_sample": (lambda: ops.amper_sample(
                pq, valid, lo, hi, 4242, key, batch=64, csp_capacity=cap),
                amper_sample_ref(pq, valid, lo, hi, 4242, key, batch=64,
                                 csp_capacity=cap))}
        for name, (fn, want) in calls.items():
            got = fn()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                print(f"replay_kernel_times: {name} != plain at {shape}",
                      file=sys.stderr)
                return 1
            print(json.dumps({
                "src": os.path.dirname(repro_torch.__file__), "kernel": name,
                "shape": shape, "n": pq.shape[0], "m": lo.shape[0],
                "batch": rank.shape[0],
                "ms": cs.device_time_ms(fn, calls=100, reps=7),
                "ops_per_call_and_us": cs.device_ops(fn)}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
