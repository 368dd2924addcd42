"""The collectives of the sharded programs, on a :class:`Mesh`.

Counterpart of ``jax.lax.all_gather``, ``psum``, ``pmax`` and ``pmean``
as the reference's ``shard_map`` bodies call them
(``repro/core/sharded.py``, ``repro/models/moe.py``), and of
``repro/distributed/collectives.py``'s compressed cross-pod gradient
sync (``psum_int8_mean``, ``grad_fn_with_pod_sync``).

A collective over the shards of some mesh axes takes the values of the
shards this process holds (all of them on a single-process mesh, this
rank's on a process mesh; ``Mesh.local_shards``), in shard order, with
their shape and dtype (which a rank that holds no shard cannot read off
its values), and returns the result on ``mesh.home``, the same on every
rank.  On a process mesh the values cross ranks in one
``torch.distributed`` call: an all-gather of their bytes, so every value
arrives bit for bit, which a float reduction then folds in shard order,
as the single-process mesh does, so both give the same bits; or an
all-reduce for an integer sum or max, which is exact in any order.  The
buffers stay on each rank's device: ``gloo`` takes CUDA tensors too (it
stages them through host memory itself), ``nccl`` needs them there.

Each collective adds the number of scalars it produced to
``mesh.traffic`` (the same count on every rank and on the single-process
mesh), so a test can hold a draw to the O(shards + batch) traffic the
sharded law promises (``sharded.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.distributed.sharding import Mesh, axis_size
from repro_torch.models.qhead import tree_map
from repro_torch.train.optimizer import quantize_int8


def _check(values: Sequence[torch.Tensor], shape, dtype) -> None:
    for j, v in enumerate(values):
        if tuple(v.shape) != tuple(shape) or v.dtype != dtype:
            raise ValueError(f"value {j} is {tuple(v.shape)} {v.dtype}, "
                             f"want {tuple(shape)} {dtype}")


def exchange(mesh: Mesh, local: Sequence[torch.Tensor],
             owners: Sequence[int], shape, dtype) -> list[torch.Tensor]:
    """Every position's value on every rank, bit for bit, on ``mesh.home``.

    ``owners[i]`` is the rank that holds position ``i``; ``local`` holds
    this rank's positions' values in position order, each of ``shape``
    and ``dtype`` (a rank may hold none).  On a single-process mesh
    ``local`` is every position's value already.
    """
    _check(local, shape, dtype)
    if mesh.group is None:
        return [v.to(mesh.home) for v in local]
    import torch.distributed as dist

    held = [sum(1 for o in owners if o == r) for r in range(mesh.world)]
    if len(local) != held[mesh.rank]:
        raise ValueError(f"rank {mesh.rank} holds {held[mesh.rank]} "
                         f"positions, got {len(local)} values")
    width = max(held)
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = int(torch.Size(tuple(shape)).numel()) * item
    send = torch.zeros((width, nbytes), dtype=torch.uint8, device=mesh.home)
    for j, v in enumerate(local):
        send[j] = v.detach().contiguous().reshape(-1).view(torch.uint8)
    recv = torch.empty((mesh.world * width, nbytes), dtype=torch.uint8,
                       device=mesh.home)
    dist.all_gather(list(recv.chunk(mesh.world)), send, group=mesh.group)
    seen = [0] * mesh.world
    out = []
    for o in owners:
        row = recv[o * width + seen[o]]
        seen[o] += 1
        out.append(row.view(dtype).reshape(shape))
    return out


def _shard_owners(mesh: Mesh, axes: Sequence[str]) -> list[int]:
    return [mesh.owner(s) for s in mesh.shard_slots(axes)]


def all_gather(mesh: Mesh, values: Sequence[torch.Tensor],
               axes: Sequence[str], dtype: torch.dtype) -> torch.Tensor:
    """One ``dtype`` scalar per shard of ``axes`` -> ``tensor[S]`` on
    ``mesh.home``; ``values`` are this process's shards'
    (``Mesh.local_shards(axes)``)."""
    out = torch.stack(exchange(mesh, [v.reshape(()) for v in values],
                               _shard_owners(mesh, axes), (), dtype))
    mesh.traffic["all_gather"] += out.numel()
    return out


def _reduce(mesh: Mesh, values: Sequence[torch.Tensor], axes: Sequence[str],
            shape, dtype: torch.dtype, op: str) -> torch.Tensor:
    """Every shard's value gathered, then folded in shard order: the same
    bits on every rank and on the single-process mesh.  Across ranks an
    integer reduction instead folds this rank's values and all-reduces
    the partial: exact in any order, and half the draw time of the
    gather on the 2^28-row cell's batch (``PERF.md``, phase ``mesh``)."""
    fold = torch.add if op == "sum" else torch.maximum
    if (mesh.group is not None and not dtype.is_floating_point
            and dtype != torch.bool):
        import torch.distributed as dist

        _check(values, shape, dtype)
        part = torch.full(tuple(shape), 0 if op == "sum" else
                          torch.iinfo(dtype).min, dtype=dtype,
                          device=mesh.home)
        for v in values:
            part = fold(part, v.to(part.device))
        dist.all_reduce(part, op=(dist.ReduceOp.SUM if op == "sum"
                                  else dist.ReduceOp.MAX), group=mesh.group)
        mesh.traffic["psum"] += part.numel()
        return part
    parts = exchange(mesh, values, _shard_owners(mesh, axes), shape, dtype)
    out = parts[0]
    for v in parts[1:]:
        out = fold(out, v)
    mesh.traffic["psum"] += out.numel()
    return out


def psum(mesh: Mesh, values: Sequence[torch.Tensor], axes: Sequence[str],
         shape, dtype: torch.dtype) -> torch.Tensor:
    """Elementwise sum of one ``shape`` ``dtype`` tensor per shard of
    ``axes``, in shard order, on ``mesh.home``."""
    return _reduce(mesh, values, axes, shape, dtype, "sum")


def pmax(mesh: Mesh, values: Sequence[torch.Tensor], axes: Sequence[str],
         shape, dtype: torch.dtype) -> torch.Tensor:
    """Elementwise max of one tensor per shard of ``axes``."""
    return _reduce(mesh, values, axes, shape, dtype, "max")


def pmean(mesh: Mesh, values: Sequence[torch.Tensor], axes: Sequence[str],
          shape, dtype: torch.dtype) -> torch.Tensor:
    """``psum / S`` over the S shards of ``axes``."""
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return psum(mesh, values, axes, shape, dtype) / n


def all_gather_groups(mesh: Mesh, values: Sequence[torch.Tensor],
                      axes: Sequence[str], dim: int = 0
                      ) -> list[torch.Tensor]:
    """A tiled all-gather over ``axes`` within each group of slots that
    agree off ``axes``: ``values`` holds one tensor per slot this process
    holds (``Mesh.local_slots``, all of one shape), and each slot gets the
    concatenation along ``dim`` of its group's values, row-major over
    ``axes`` (``jax.lax.all_gather(..., axes, axis=dim, tiled=True)``)."""
    local = list(mesh.local_slots)
    if mesh.group is None:
        every = [v.to(mesh.home) for v in values]
    else:
        every = exchange(mesh, values,
                         [mesh.owner(s) for s in range(mesh.size)],
                         values[0].shape, values[0].dtype)
    out = []
    for slot, v in zip(local, values):
        members = mesh.group_slots(slot, axes)
        out.append(torch.cat([every[m].to(v.device) for m in members], dim))
    mesh.traffic["all_gather"] += mesh.size * out[0].numel()
    return out


def psum_int8_mean(grads: Sequence[Any], mesh: Mesh, axis: str) -> Any:
    """Quantize -> int32 psum of the int8 payload -> dequantize with the
    largest scale -> mean over the shards of ``axis``.

    ``grads`` holds one gradient tree per shard of ``axis`` this process
    holds; the result is one tree, the same on every shard.  No error
    feedback: each shard quantizes its own gradient alone, as the
    reference does (``repro/distributed/collectives.py:29-45``).
    """
    n = axis_size(mesh, axis)
    axes = (axis,)

    def one(*gs):
        qs = [quantize_int8(g.to(torch.float32)) for g in gs]
        shape = gs[0].shape
        q_sum = psum(mesh, [q.to(torch.int32) for q, _ in qs], axes, shape,
                     torch.int32)
        s_max = pmax(mesh, [s for _, s in qs], axes, qs[0][1].shape,
                     torch.float32)
        return (q_sum.to(torch.float32) * s_max) / n

    return tree_map(one, *grads)


def grad_fn_with_pod_sync(grad_fn: Callable, mesh: Mesh,
                          compress: bool = True) -> Callable:
    """Wrap ``grad_fn(params, batch) -> grads`` with a sync over "pod".

    Without a ``"pod"`` axis ``grad_fn`` comes back unchanged.  Otherwise
    the wrapper runs ``grad_fn`` once per pod this process holds, on the
    pod's slice of the leading dim of every ``batch`` leaf (the
    reference's batch spec, "pod" first), and returns the pods' mean:
    the int8 one of :func:`psum_int8_mean`, or with ``compress=False``
    the float32 ``pmean``.  ``params`` are whole on every pod (the
    reference's spec strip of "pod"); the data and model axes place
    nothing yet (ROADMAP A14b).
    """
    if "pod" not in mesh.axis_names:
        return grad_fn
    axes = ("pod",)
    n_pod = axis_size(mesh, "pod")

    def wrapped(params, batch):
        grads = []
        for p in mesh.local_shards(axes):
            def piece(x, p=p):
                size = x.shape[0] // n_pod
                return x[p * size:(p + 1) * size]
            grads.append(grad_fn(params, tree_map(piece, batch)))
        if compress:
            return psum_int8_mean(grads, mesh, "pod")
        return tree_map(lambda *gs: pmean(
            mesh, [g.to(torch.float32) for g in gs], axes, gs[0].shape,
            torch.float32), *grads)

    return wrapped
