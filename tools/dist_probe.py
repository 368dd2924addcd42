#!/usr/bin/env python3
"""What ``torch.distributed`` does with several ranks on the GPUs here.

Run from the repository root on a machine with a CUDA device:

    python3 tools/dist_probe.py

It starts ``gloo`` with 2 ranks, ``nccl`` with 1 and ``nccl`` with 2
through ``repro_torch.launch.mesh.run_ranks`` (rank r on card ``r %
count``, so every rank on card 0 of a one-card machine), and has each
rank call ``all_reduce`` (sum and max) and ``all_gather`` (a list of
int32 and of uint8, and ``all_gather_into_tensor``) on CUDA tensors.  It
prints one JSON line a backend: each rank's results, with the error a
call raised in place of its result (NCCL refuses two ranks on one card),
or the error of the run as a whole.  A rank that hangs is stopped after
90 s.
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from repro_torch.launch.mesh import run_ranks  # noqa: E402


def probe_rank(rank: int, world: int, dev) -> dict:
    """Each call's result on this rank, or the error it raised."""
    import torch.distributed as dist

    def all_reduce(op):
        t = torch.full((4,), rank + 1.0, device=dev)
        dist.all_reduce(t, op=op)
        return t.tolist()

    def all_gather_list(dtype):
        out = [torch.zeros(3, device=dev, dtype=dtype) for _ in range(world)]
        dist.all_gather(out, torch.full((3,), rank, device=dev, dtype=dtype))
        return [t.tolist() for t in out]

    def all_gather_into_tensor():
        out = torch.zeros(3 * world, device=dev, dtype=torch.int32)
        dist.all_gather_into_tensor(out, torch.full(
            (3,), rank, device=dev, dtype=torch.int32))
        return out.tolist()

    calls = {"all_reduce": lambda: all_reduce(dist.ReduceOp.SUM),
             "all_reduce_max": lambda: all_reduce(dist.ReduceOp.MAX),
             "all_gather_int32": lambda: all_gather_list(torch.int32),
             "all_gather_uint8": lambda: all_gather_list(torch.uint8),
             "all_gather_into_tensor": all_gather_into_tensor}
    res = {"rank": rank}
    for name, fn in calls.items():
        try:
            res[name] = fn()
        except Exception as e:  # the finding: what a backend refuses
            res[name] = "ERR " + repr(e)[:300]
    return res


def probe(backend: str, world: int) -> dict:
    try:
        ranks = run_ranks(probe_rank, world, backend=backend, device="cuda",
                          timeout=90.0)
    except Exception as e:  # a rank that raised or hung: also a finding
        return {"backend": backend, "world": world,
                "error": repr(e)[-600:]}
    return {"backend": backend, "world": world, "ranks": ranks}


def main() -> int:
    if not torch.cuda.is_available():
        print("dist_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    for backend, world in (("gloo", 2), ("nccl", 1), ("nccl", 2)):
        print(json.dumps(probe(backend, world)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
