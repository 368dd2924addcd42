"""The production, debug and replay meshes, and the process mesh.

Counterpart of ``repro/launch/mesh.py``.  Each ``make_*_mesh`` returns
the port's single-process :class:`~repro_torch.distributed.sharding.Mesh`,
whose slots may repeat one device: the production mesh has the
reference's axes and shape (16 x 16 chips a pod, 2 pods), with every
slot on the given device, so the dry run reads its shard counts and the
sharded replay runs its 256 or 512 logical shards on one card.

:func:`make_process_mesh` lays any of these layouts over the initialized
default ``torch.distributed`` group instead: rank r holds a row-major
block of the slots, on its own device.  :func:`run_ranks` starts R such ranks
(``spawn``, a ``file://`` rendezvous in a fresh directory, a timeout on
the group and on the join) and hands back each rank's return value, or
raises with the traceback of a rank that raised.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16x16 = 256 slots per pod; 2 pods = 512 slots multi-pod, every
    slot on ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = resolve_device(device)
    return Mesh(np.full(shape, dev, dtype=object), axes)


def _visible(device) -> list[torch.device]:
    """Every card for a CUDA ``device``, else ``device`` alone."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_debug_mesh(n_devices: int | None = None, model: int = 1,
                    device="cuda") -> Mesh:
    """Small ``("data", "model")`` mesh over whatever devices exist."""
    devices = _visible(device)
    n = n_devices or len(devices)
    if n > len(devices) or n % model:
        raise ValueError(f"cannot lay {n} devices out as ({n // model}, "
                         f"{model}): {len(devices)} exist")
    return Mesh(np.asarray(devices[:n], dtype=object).reshape(
        n // model, model), ("data", "model"))


def make_replay_mesh(n_shards: int | None = None, device="cuda") -> Mesh:
    """1-D ``("data",)`` mesh for the sharded replay subsystem.

    ``n_shards`` defaults to every visible device; a smaller value builds
    the mesh over a device prefix.  More shards than devices raise, as in
    the reference (S logical shards on one device are ``Mesh([dev] *
    S)``).
    """
    devices = _visible(device)
    n = n_shards or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} shards but only "
                         f"{len(devices)} devices exist")
    return Mesh(devices[:n], ("data",))


def make_process_mesh(shape: Sequence[int], axes: Sequence[str], *,
                      backend: str, device) -> Mesh:
    """A ``shape`` mesh with axis names ``axes`` laid over the ranks of
    the default group, which must be initialized with ``backend``: rank
    r holds the row-major slots ``r * k .. (r + 1) * k - 1`` (``k =
    prod(shape) / R``) on ``device``, its own.  The devices of the other ranks' slots come from an object all-gather.
    For the replay layout pass ``(S,), ("data",)``; the debug and
    production layouts are ``(n // model, model), ("data", "model")``
    and ``(16, 16)`` / ``(2, 16, 16)`` with ``("pod",)`` first."""
    import torch.distributed as dist

    group = dist.group.WORLD
    got = dist.get_backend(group)
    if got != backend:
        raise ValueError(f"the group runs {got!r}, not {backend!r}")
    dev = torch.empty(0, device=resolve_device(device)).device
    world = dist.get_world_size(group)
    size = int(np.prod(shape))
    if size % world:
        raise ValueError(f"{size} slots do not split over {world} ranks")
    every = [None] * world
    dist.all_gather_object(every, str(dev), group=group)
    k = size // world
    grid = np.array([torch.device(every[i // k]) for i in range(size)],
                    dtype=object).reshape(tuple(shape))
    return Mesh(grid, axes, group=group)


def rank_device(device, rank: int) -> torch.device:
    """The device of rank ``rank``: card ``rank % count`` for a CUDA
    ``device`` (several ranks share one card), else ``device``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _to_host(x: Any) -> Any:
    """Tensors in a returned tree -> numpy arrays (they leave the rank by
    value, not through shared memory that dies with it)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(fn: Callable, rank: int, world: int, backend: str,
               init: str, device, timeout: float, threads: int | None,
               args: tuple, out) -> None:
    import torch.distributed as dist

    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, _to_host(result)))
    except Exception:  # the parent raises it
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, args: tuple = (), *,
              backend: str = "gloo", device="cuda", timeout: float = 120.0,
              threads: int | None = None) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``world`` spawned ranks
    joined in one ``backend`` group, and return their results in rank
    order (tensors as numpy arrays).

    ``fn`` must be importable by name in a fresh process (a module-level
    function of a module that imports only what the rank needs).  The
    rendezvous is a ``file://`` in a fresh temporary directory, so runs
    started side by side never share a port.  ``timeout`` seconds bound
    the group's collectives and the whole run: a rank that raises, dies
    or hangs makes this raise (with the rank's traceback where there is
    one) after every rank is stopped.  ``threads`` sets each rank's
    intra-op threads.  Rank r runs on ``rank_device(device, r)``.
    """
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")  # CUDA cannot be forked
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_ranks_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world, backend, init, device, timeout, threads, args, out))
        for r in range(world)]
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results and r not in errors]
                if dead:  # died without a word (a signal, os._exit)
                    errors.update({r: f"rank {r} exited with code "
                                      f"{procs[r].exitcode}" for r in dead})
                    break
                continue
            (results if ok else errors)[rank] = value
            if not ok:
                break
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            p.join(timeout=max(0.0, min(5.0, deadline - time.monotonic())))
        for p in started:
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        rank = min(errors)
        raise RuntimeError(f"rank {rank} of {world} failed:\n{errors[rank]}")
    if len(results) < world:
        missing = sorted(set(range(world)) - set(results))
        raise TimeoutError(f"ranks {missing} of {world} gave no result "
                           f"within {timeout} s")
    return [results[r] for r in range(world)]
