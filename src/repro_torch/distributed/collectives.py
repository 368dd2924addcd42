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
sharded law promises (``sharded.py``).  Inside :func:`record`, each also
notes the reference's collective it stands for (``all-gather``,
``all-reduce``, ``reduce-scatter``) and its result's bytes on one slot,
which ``launch/hlo_analysis.py::record_collectives`` reads.

The collectives of the shard-map MoE dispatch differentiate
(``torch.autograd.Function``s; the reference differentiates through its
``shard_map`` with ``jax.grad``).  Each backward is the transpose
collective, and folds float sums in shard order, so a process mesh's
gradients equal the single-process mesh's bit for bit:

* :func:`all_gather_groups`: a reduce-scatter, each slot's gradient the
  sum of its piece of its group's output gradients, in group order;
* :func:`exchange`: the inverse exchange.  Its result is the same on
  every rank, so each copy's gradient is the whole gradient, and each
  position takes its owner's own copy's (no traffic; the single-process
  mesh holds one copy);
* :func:`pmean`: a pmean of the shards' gradients, over the n shards
  (with equal copies, ``g / n``);
* :func:`gather_shards`: each shard's slot takes its block of the
  gradient from its own rank's copy, its twins zeros (no traffic);
* :func:`slot_inputs`: the transpose of handing each slot its block of
  an input that every rank holds whole: the blocks' gradients gathered
  from every slot and added into a zero gradient in slot order.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.distributed.sharding import Mesh, axis_size
from repro_torch.models.qhead import tree_map
from repro_torch.train.optimizer import quantize_int8


class _Record:
    notes: Optional[list] = None  # the list record() opened


_RECORD = _Record()


@contextlib.contextmanager
def record():
    """Collect, in a list it yields, one ``(kind, bytes)`` for each
    collective called inside the block, on any thread (autograd runs a
    backward on its own): the reference's name of it and its result's
    bytes on one slot."""
    notes: list = []
    prev = getattr(_RECORD, "notes", None)
    _RECORD.notes = notes
    try:
        yield notes
    finally:
        _RECORD.notes = prev


def _note(kind: str, t: torch.Tensor) -> None:
    notes = getattr(_RECORD, "notes", None)
    if notes is not None:
        notes.append((kind, t.numel() * t.element_size()))


def _grad_on(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    ``local`` is every position's value already.  Differentiable (the
    module docstring's inverse exchange).
    """
    _check(local, shape, dtype)
    if mesh.group is None:
        return [v.to(mesh.home) for v in local]
    if _grad_on(*local):
        return list(_Exchange.apply(mesh, tuple(owners), tuple(shape), dtype,
                                    *local))
    return _exchange(mesh, local, owners, shape, dtype)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, owners, shape, dtype, *local):
        ctx.mesh, ctx.owners = mesh, owners
        ctx.devices = [v.device for v in local]
        return tuple(_exchange(mesh, local, owners, shape, dtype))

    @staticmethod
    def backward(ctx, *grads):
        mine = [i for i, o in enumerate(ctx.owners) if o == ctx.mesh.rank]
        return (None, None, None, None) + tuple(
            None if grads[i] is None else grads[i].to(d)
            for i, d in zip(mine, ctx.devices))


def _exchange(mesh: Mesh, local: Sequence[torch.Tensor],
              owners: Sequence[int], shape, dtype) -> list[torch.Tensor]:
    """:func:`exchange` on a process mesh: one all-gather of bytes."""
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
    _note("all-gather", out)
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
        _note("all-reduce", part)
        return part
    _check(values, shape, dtype)
    parts = ([v.to(mesh.home) for v in values] if mesh.group is None else
             _exchange(mesh, values, _shard_owners(mesh, axes), shape, dtype))
    out = parts[0]
    for v in parts[1:]:
        out = fold(out, v)
    mesh.traffic["psum"] += out.numel()
    _note("all-reduce", out)
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
    """``psum / S`` over the S shards of ``axes``; differentiable (the
    module docstring's transpose)."""
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    if _grad_on(*values):
        return _PMean.apply(mesh, tuple(axes), tuple(shape), dtype, n,
                            *values)
    return psum(mesh, values, axes, shape, dtype) / n


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, shape, dtype, n, *values):
        ctx.mesh, ctx.axes, ctx.shape, ctx.dtype, ctx.n = (mesh, axes, shape,
                                                           dtype, n)
        ctx.devices = [v.device for v in values]
        return psum(mesh, values, axes, shape, dtype) / n

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = psum(mesh, [g] * len(ctx.devices), ctx.axes, ctx.shape,
                 ctx.dtype) / ctx.n
        g = g / ctx.n
        return (None,) * 5 + tuple(g.to(d) for d in ctx.devices)


def all_gather_groups(mesh: Mesh, values: Sequence[torch.Tensor],
                      axes: Sequence[str], dim: int = 0
                      ) -> list[torch.Tensor]:
    """A tiled all-gather over ``axes`` within each group of slots that
    agree off ``axes``: ``values`` holds one tensor per slot this process
    holds (``Mesh.local_slots``, all of one shape), and each slot gets the
    concatenation along ``dim`` of its group's values, row-major over
    ``axes`` (``jax.lax.all_gather(..., axes, axis=dim, tiled=True)``).
    Differentiable (the module docstring's reduce-scatter)."""
    if _grad_on(*values):
        return list(_GatherGroups.apply(mesh, tuple(axes), dim, *values))
    return _gather_groups(mesh, values, axes, dim)


def _every_slot(mesh: Mesh, values: Sequence[torch.Tensor]
                ) -> list[torch.Tensor]:
    """One value per slot of the mesh (``values``: this process's slots'),
    on ``mesh.home``, bit for bit."""
    if mesh.group is None:
        return [v.to(mesh.home) for v in values]
    return _exchange(mesh, values, [mesh.owner(s) for s in range(mesh.size)],
                     values[0].shape, values[0].dtype)


def _one_slot_a_rank(mesh: Mesh) -> bool:
    return mesh.group is not None and mesh.slots_per_rank == 1


def _members_gather(mesh: Mesh, value: torch.Tensor, axes, dim: int):
    """On a mesh with one slot a rank: this slot's group's values over
    ``axes`` concatenated along ``dim`` in group order, gathered only
    from the group's ranks (the DeviceMesh's group of each axis, the
    minor axis first; c10d's ``all_gather_into_tensor``, exact)."""
    import torch.distributed as dist

    dm = mesh.device_mesh()
    out = value.contiguous()
    for a in reversed(tuple(axes)):
        pg = dm.get_group(mesh.axis_names.index(a))
        n = dist.get_world_size(pg)
        flat = out.movedim(dim, 0).contiguous()
        got = flat.new_empty((n * flat.shape[0],) + tuple(flat.shape[1:]))
        dist.all_gather_into_tensor(got, flat, group=pg)
        out = got.movedim(0, dim)
    return out


def _gather_groups(mesh: Mesh, values, axes, dim: int) -> list[torch.Tensor]:
    if _one_slot_a_rank(mesh):
        out = [_members_gather(mesh, values[0], axes, dim)]
    else:
        every = _every_slot(mesh, values)
        out = []
        for slot, v in zip(mesh.local_slots, values):
            members = mesh.group_slots(slot, axes)
            out.append(torch.cat([every[m].to(v.device) for m in members],
                                 dim))
    mesh.traffic["all_gather"] += mesh.size * out[0].numel()
    _note("all-gather", out[0])
    return out


class _GatherGroups(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dim, *values):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        ctx.like = [torch.empty_like(v, device="meta") for v in values]
        ctx.devices = [v.device for v in values]
        return tuple(_gather_groups(mesh, values, axes, dim))

    @staticmethod
    def backward(ctx, *grads):
        mesh, dim = ctx.mesh, ctx.dim
        size = ctx.like[0].shape[dim]
        grads = [torch.zeros(tuple(like.shape[:dim]) + (
            size * len(mesh.group_slots(0, ctx.axes)),)
            + tuple(like.shape[dim + 1:]), dtype=like.dtype, device=d)
            if g is None else g
            for g, like, d in zip(grads, ctx.like, ctx.devices)]
        if _one_slot_a_rank(mesh):
            slot = mesh.local_slots[0]
            members = mesh.group_slots(slot, ctx.axes)
            stacked = _members_gather(mesh, grads[0][None], ctx.axes, 0)
            every = dict(zip(members, stacked.unbind(0)))
        else:
            every = _every_slot(mesh, grads)
        out = []
        for slot, d in zip(mesh.local_slots, ctx.devices):
            members = mesh.group_slots(slot, ctx.axes)
            at = members.index(slot) * size
            acc = None
            for m in members:  # shard order
                piece = every[m].narrow(dim, at, size)
                acc = piece if acc is None else acc + piece
            out.append(acc.to(d))
        mesh.traffic["psum"] += mesh.size * out[0].numel()
        _note("reduce-scatter", out[0])
        return (None, None, None) + tuple(out)


def gather_shards(mesh: Mesh, values: Sequence[torch.Tensor],
                  axes: Sequence[str], dim: int = 0) -> torch.Tensor:
    """The shards of ``axes``' values concatenated along ``dim`` in shard
    order, whole on ``mesh.home`` of every rank: ``values`` holds one
    tensor per slot this process holds, and each shard's value is its
    slot's (``Mesh.shard_slots``: the other axes at index 0, whose twins
    hold the same).  Differentiable: each shard's slot gets its block of
    the gradient from this rank's copy, every other slot zeros, so every
    rank's backward reaches every slot and joins each collective before
    it (a rank whose slots are all twins would otherwise have no
    gradient path and miss them)."""
    if _grad_on(*values):
        return _GatherShards.apply(mesh, tuple(axes), dim, *values)
    return _gather_shards(mesh, values, axes, dim)


def _gather_shards(mesh: Mesh, values, axes, dim: int) -> torch.Tensor:
    shards = mesh.shard_slots(axes) if axes else [0]
    mine = [v for s, v in zip(mesh.local_slots, values) if s in shards]
    like = values[0]
    parts = ([v.to(mesh.home) for v in mine] if mesh.group is None else
             _exchange(mesh, mine, [mesh.owner(s) for s in shards],
                       like.shape, like.dtype))
    out = torch.cat([v.to(mesh.home) for v in parts], dim)
    _note("all-gather", out)
    return out


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dim, *values):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        ctx.devices = [v.device for v in values]
        return _gather_shards(mesh, values, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        shards = mesh.shard_slots(ctx.axes) if ctx.axes else [0]
        pieces = g.chunk(len(shards), ctx.dim)
        out = []
        for s, d in zip(mesh.local_slots, ctx.devices):
            piece = pieces[shards.index(s) if s in shards else 0]
            out.append(piece.to(d) if s in shards
                       else torch.zeros_like(piece, device=d))
        return (None, None, None) + tuple(out)


def slot_inputs(mesh: Mesh, t: torch.Tensor,
                block: Optional[Callable[[int], tuple]] = None
                ) -> list[torch.Tensor]:
    """Each slot's block of ``t``, a tensor every rank holds whole: one
    tensor per slot this process holds, ``t.narrow(*block(slot))`` (``t``
    itself without ``block``).  Differentiable: ``t``'s gradient is the
    whole one on every rank, each slot's block gradient added into a
    zero gradient in slot order (gathered from every rank on a process
    mesh), the transpose of a ``shard_map``'s input split."""
    if _grad_on(t):
        return list(_SlotInputs.apply(mesh, block, t))
    return [t if block is None else t.narrow(*block(s))
            for s in mesh.local_slots]


class _SlotInputs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, block, t):
        ctx.mesh, ctx.block = mesh, block
        ctx.like = torch.empty_like(t, device="meta")
        ctx.device = t.device
        return tuple(t if block is None else t.narrow(*block(s))
                     for s in mesh.local_slots)

    @staticmethod
    def backward(ctx, *grads):
        mesh, block = ctx.mesh, ctx.block
        shape = ctx.like.shape if block is None else ctx.like.narrow(
            *block(mesh.local_slots[0])).shape
        grads = [torch.zeros(shape, dtype=ctx.like.dtype, device=ctx.device)
                 if g is None else g.contiguous() for g in grads]
        every = _every_slot(mesh, grads)
        out = torch.zeros(ctx.like.shape, dtype=ctx.like.dtype,
                          device=mesh.home)
        for s, g in enumerate(every):  # slot order
            target = out if block is None else out.narrow(*block(s))
            target.add_(g)
        mesh.traffic["psum"] += out.numel()
        _note("all-reduce", out)
        return None, None, out.to(ctx.device)


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
    nothing here (a DTensor program places them by the sharding rules,
    ``distributed/sharding.py``).
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
