"""The production, debug and replay meshes, and the process mesh.

Counterpart of ``repro/launch/mesh.py``.  Each ``make_*_mesh`` returns
the port's single-process :class:`~repro_torch.distributed.sharding.Mesh`,
whose slots may repeat one device: the production mesh has the
reference's axes and shape (16 x 16 chips a pod, 2 pods), with every
slot on the given device, so the dry run reads its shard counts and the
sharded replay runs its 256 or 512 logical shards on one card.

:func:`fake_group` opens a fake default group of 256 or 512 ranks, and
``make_production_mesh(group=...)`` lays the production mesh over it,
one slot a rank, for one device's DTensor program (``launch/dryrun.py``).
:func:`make_process_mesh` lays any of these layouts over the initialized
default ``torch.distributed`` group instead: rank r holds a row-major
block of the slots, on its own device.  :func:`run_ranks` starts R such ranks
(``spawn``, a ``file://`` rendezvous in a fresh directory, a timeout on
the group and on the join) and hands back each rank's return value, or
raises with the traceback of a rank that raised.
"""
from __future__ import annotations

import contextlib
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


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         group=None) -> Mesh:
    """16x16 = 256 slots per pod; 2 pods = 512 slots multi-pod, every
    slot on ``device``.  With ``group`` (a process group of 256 or 512
    ranks, such as :func:`fake_group`'s), a process mesh with one slot
    a rank, whose :meth:`~Mesh.device_mesh` the sharding rules place
    DTensors on."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = resolve_device(device)
    return Mesh(np.full(shape, dev, dtype=object), axes, group=group)


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """Open a default process group of ``world`` ranks in which this
    process is rank ``rank`` and every collective is fake: it returns
    at once and writes nothing, so one process runs one device's program
    of a production mesh (the dry run's).  Yields ``dist.group.WORLD``.

    The group is torch's test-suite fake backend (backend ``"fake"``,
    registered by the private module
    ``torch.testing._internal.distributed.fake_pg`` with its
    ``FakeStore``).  A default group this process already holds is set
    aside while the block runs and put back after, and the fake one is
    destroyed on leaving, so it never reaches :func:`run_ranks` or
    another caller."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    held = _set_aside_groups() if dist.is_initialized() else None
    try:
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()
    finally:
        if held is not None:
            _put_back_groups(held)


@contextlib.contextmanager
def c10d_gathers():
    """Route DTensor's all-gathers (``torch.distributed.
    _functional_collectives.all_gather_single`` and, in older torch,
    ``all_gather_tensor``) through c10d's ``all_gather_into_tensor`` for
    the block.  On ``gloo`` with CUDA tensors the functional op kills
    its rank (a segfault in torch 2.11, ``tools/dist_probe.py``) where
    c10d's call works; the result is the same tensor, made eagerly (not
    traceable, and counted by no dispatch mode as a collective)."""
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d
    from torch.distributed import _functional_collectives as fc

    def gather(self, gather_dim: int, group, tag: str = ""):
        pg = c10d._resolve_process_group(fc._resolve_group_name(group, tag))
        n = dist.get_world_size(pg)
        x = self.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=pg)
        return out if gather_dim == 0 else torch.cat(out.chunk(n), gather_dim)

    names = [n for n in ("all_gather_single", "all_gather_tensor")
             if hasattr(fc, n)]
    held = {n: getattr(fc, n) for n in names}
    try:
        for n in names:
            setattr(fc, n, gather)
        yield names
    finally:
        for n, fn in held.items():
            setattr(fc, n, fn)


# c10d's module-level group tables (a default group's destruction clears
# them, and the registry of group names)
_C10D_TABLES = ("_pg_map", "_pg_names", "_pg_group_ranks",
                "_pg_backend_config", "_tags_to_pg", "_pg_to_tag")


def _set_aside_groups() -> dict:
    """Take this process's groups out of c10d's tables (fresh empty ones
    in their place) and return them for :func:`_put_back_groups`."""
    import torch.distributed.distributed_c10d as c10d

    held = {name: getattr(c10d, name) for name in _C10D_TABLES}
    held["default"] = c10d._world.default_pg
    held["count"] = c10d._world.group_count  # the fake group's names follow
    for name in _C10D_TABLES:
        setattr(c10d, name, type(held[name])())
    c10d._world.default_pg = None
    return held


def _put_back_groups(held: dict) -> None:
    """Restore the tables :func:`_set_aside_groups` took, and the group
    names' registry the fake group's destruction cleared."""
    import torch.distributed.distributed_c10d as c10d
    from torch._C import _distributed_c10d as cc

    for name in _C10D_TABLES:
        setattr(c10d, name, held[name])
    c10d._world.default_pg = held["default"]
    c10d._world.group_count = held["count"]
    for pg, name in held["_pg_names"].items():
        with contextlib.suppress(RuntimeError):  # absent already
            cc._unregister_process_group(name)
        cc._register_process_group(name, pg)


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
