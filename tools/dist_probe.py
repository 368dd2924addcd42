#!/usr/bin/env python3
"""What ``torch.distributed`` does with several ranks on the GPUs here.

Run from the repository root on a machine with a CUDA device:

    python3 tools/dist_probe.py

It starts ``gloo`` with 2 ranks, ``nccl`` with 1 and ``nccl`` with 2
through ``repro_torch.launch.mesh.run_ranks`` (rank r on card ``r %
count``, so every rank on card 0 of a one-card machine), and has each
rank call ``all_reduce`` (sum and max), ``all_gather`` (a list of
int32 and of uint8, and ``all_gather_into_tensor``),
``reduce_scatter_tensor`` and ``all_to_all_single`` on CUDA tensors, the
last three also in their ``torch.distributed._functional_collectives``
forms, and two DTensor redistributions on a ``cuda`` DeviceMesh over the
group (``Partial -> Shard``, a reduce-scatter, and ``Shard(0) ->
Shard(1)``, an all-to-all: what the sharding rules' programs issue).  It
prints one JSON line a backend: each rank's results, with the error a
call raised in place of its result (NCCL refuses two ranks on one card),
or the error of the run as a whole.  Gloo runs each call in a spawn of
its own, so that a call that kills a rank (a segfault) loses only its
own result.  A rank that hangs is stopped after 90 s.  A first line
says whether torch's fake process group (the dry run's) is importable.
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from repro_torch.launch.mesh import run_ranks  # noqa: E402


CALLS = ("all_reduce", "all_reduce_max", "all_gather_int32",
         "all_gather_uint8", "all_gather_into_tensor",
         "reduce_scatter_tensor", "all_to_all_single",
         "funcol_all_gather_tensor", "funcol_reduce_scatter_tensor",
         "funcol_all_to_all_single", "dtensor_partial_to_shard",
         "dtensor_shard_to_shard")


def probe_rank(rank: int, world: int, dev, only=None) -> dict:
    """Each call's result on this rank (only ``only``'s, when given), or
    the error it raised."""
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

    def reduce_scatter_tensor():
        out = torch.zeros(2, device=dev)
        dist.reduce_scatter_tensor(out, torch.arange(
            2.0 * world, device=dev) + rank)
        return out.tolist()

    def all_to_all_single():
        out = torch.zeros(world, device=dev)
        dist.all_to_all_single(out, torch.arange(
            float(world), device=dev) + 10 * rank)
        return out.tolist()

    def funcol(name):
        from torch.distributed import _functional_collectives as fc

        group = dist.group.WORLD
        if name == "all_gather_tensor":
            t = fc.all_gather_tensor(torch.full((2,), float(rank),
                                                device=dev), 0, group)
        elif name == "reduce_scatter_tensor":
            t = fc.reduce_scatter_tensor(torch.arange(
                2.0 * world, device=dev) + rank, "sum", 0, group)
        else:
            t = fc.all_to_all_single(torch.arange(
                float(world), device=dev) + 10 * rank, None, None, group)
        return fc.wait_tensor(t).tolist()

    def dtensor(kind):
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Partial, Shard

        mesh = DeviceMesh("cuda", list(range(world)))
        if kind == "partial_to_shard":
            t = DTensor.from_local(torch.full((world, 2), rank + 1.0,
                                              device=dev), mesh, [Partial()])
            return t.redistribute(mesh, [Shard(0)]).to_local().tolist()
        t = DTensor.from_local(torch.arange(
            2.0 * world, device=dev).reshape(2, world) + 100 * rank, mesh,
            [Shard(0)])
        return t.redistribute(mesh, [Shard(1)]).to_local().tolist()

    calls = {"all_reduce": lambda: all_reduce(dist.ReduceOp.SUM),
             "all_reduce_max": lambda: all_reduce(dist.ReduceOp.MAX),
             "all_gather_int32": lambda: all_gather_list(torch.int32),
             "all_gather_uint8": lambda: all_gather_list(torch.uint8),
             "all_gather_into_tensor": all_gather_into_tensor,
             "reduce_scatter_tensor": reduce_scatter_tensor,
             "all_to_all_single": all_to_all_single,
             "funcol_all_gather_tensor": lambda: funcol("all_gather_tensor"),
             "funcol_reduce_scatter_tensor":
                 lambda: funcol("reduce_scatter_tensor"),
             "funcol_all_to_all_single": lambda: funcol("all_to_all_single"),
             "dtensor_partial_to_shard": lambda: dtensor("partial_to_shard"),
             "dtensor_shard_to_shard": lambda: dtensor("shard_to_shard")}
    res = {"rank": rank}
    for name, fn in calls.items():
        if only is not None and name not in only:
            continue
        try:
            res[name] = fn()
        except Exception as e:  # the finding: what a backend refuses
            res[name] = "ERR " + repr(e)[:300]
    return res


def probe(backend: str, world: int, one_by_one: bool = False) -> dict:
    """Every call in one run of ``world`` ranks, or with ``one_by_one``
    each call in a run of its own (a call that kills a rank, a signal
    rather than an error, then loses only its own result)."""
    groups = [(name,) for name in CALLS] if one_by_one else [None]
    ranks = [{"rank": r} for r in range(world)]
    errors = {}
    for only in groups:
        try:
            got = run_ranks(probe_rank, world, (only,), backend=backend,
                            device="cuda", timeout=90.0)
        except Exception as e:  # a rank that died or hung: also a finding
            errors[",".join(only or CALLS)] = repr(e)[-300:]
            continue
        for mine, g in zip(ranks, got):
            mine.update(g)
    out = {"backend": backend, "world": world, "ranks": ranks}
    if errors:
        out["errors"] = errors
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("dist_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        fake = f"fake_pg: {FakeStore.__module__}.FakeStore importable"
    except Exception as e:  # the dry run needs it
        fake = "fake_pg: ERR " + repr(e)[:300]
    print(fake, flush=True)
    print(json.dumps(probe("gloo", 2, one_by_one=True)), flush=True)
    for backend, world in (("nccl", 1), ("nccl", 2)):
        print(json.dumps(probe(backend, world)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
