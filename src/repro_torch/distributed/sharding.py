"""The device mesh of the sharded programs, and the logical-axis sharding
rules of the LM zoo.

Counterpart of ``jax.sharding.Mesh`` as the reference's ``shard_map``
bodies use it (``repro/core/sharded.py``, ``repro/models/moe.py``,
``repro/distributed/collectives.py``), and of
``repro/distributed/sharding.py``.  A :class:`Mesh` is a named grid of
slots, one ``torch.device`` each; one device may hold several slots, so
S logical shards can live on one card.  A program runs its per-slot body
once for each slot it holds, in a host loop; the only traffic between
slots goes through :mod:`repro_torch.distributed.collectives`, which
counts it.

A mesh is either one process's (every slot local), or a process mesh
over a ``torch.distributed`` group (``group=``): the slots are laid over
the group's R ranks in row-major blocks of ``size / R``, each rank runs
the same program (SPMD) for its own slots, and the collectives combine
the slots across ranks.  To every caller the process mesh of R ranks
with k slots each behaves as the single-process mesh of R * k slots: the
same shard order, the same results, the same ``traffic`` counts.

The rules (``TRAIN_RULES``, ``SERVE_RULES``, ``TRAIN_RULES_FSDP``) map
the models' logical axes to mesh axes, MaxText-style, and
:class:`ShardingRules` turns a leaf's logical axes into a partition spec
(a tuple in ``jax.sharding.PartitionSpec``'s layout) for a mesh, and
into DTensor placements (``torch.distributed.tensor``), the port's
counterpart of a ``NamedSharding``: on a process mesh with one slot a
rank, :meth:`Mesh.device_mesh` is a ``DeviceMesh`` of the same shape
and axis names, and :meth:`ShardingRules.sharding` gives a leaf's
``(device_mesh, placements)``, one ``Shard(dim)`` or ``Replicate()`` a
mesh dim.  :func:`logical_constraint` (``with_sharding_constraint``) is
``DTensor.redistribute``, and :func:`distribute` places a tensor the way
the reference's ``in_shardings`` do; DTensor's sharding propagation then
inserts the collectives XLA's partitioner would.  An active rule set
also sends ``moe_apply`` to the explicit-collective dispatch, as in the
reference.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device


class Mesh:
    """Slots on a grid with one named axis per grid dimension.

    Args:
      devices: a list of ``torch.device``s (or nested lists, one level
        per axis), in row-major order: the device of every slot of the
        whole mesh.
      axis_names: one name per grid dimension.
      group: a ``torch.distributed`` process group (``dist.group.WORLD``
        for the default one) for a process mesh; ``None`` (the default)
        keeps every slot in this process.  Rank r of the group holds the
        slots ``r * k .. (r + 1) * k - 1`` in row-major order, with
        ``k = size / R``, and its slots' devices are its own.

    ``traffic`` counts the scalars each collective has produced on this
    mesh (``{"all_gather": n, "psum": n}``; ``pmax`` and ``pmean`` count
    as ``psum``); reset it by assigning zeros.
    """

    def __init__(self, devices, axis_names: Sequence[str] = ("data",),
                 group=None):
        grid = np.array(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names) or grid.size == 0:
            raise ValueError(f"devices of shape {grid.shape} do not match "
                             f"axis names {self.axis_names}")
        self.devices = np.vectorize(torch.device, otypes=[object])(grid)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.size = int(grid.size)
        self.traffic = {"all_gather": 0, "psum": 0}
        self.group = group
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        if self.size % self.world:
            raise ValueError(f"{self.size} slots do not split evenly over "
                             f"{self.world} ranks")
        self.slots_per_rank = self.size // self.world
        self._device_mesh = None

    @property
    def home(self) -> torch.device:
        """Where this process's results land: the device of its first
        slot (of the mesh's first slot on a single-process mesh)."""
        return self.devices.flat[self.rank * self.slots_per_rank]

    @property
    def local_slots(self) -> range:
        """The flat (row-major) indices of the slots this process holds."""
        k = self.slots_per_rank
        return range(self.rank * k, (self.rank + 1) * k)

    def device_mesh(self):
        """The ``DeviceMesh`` of this process mesh: one rank a slot, the
        same shape and axis names, rank r at flat slot r (as the group
        orders its ranks).  Built once.  A mesh whose slots share a
        process has no DeviceMesh: DTensor places one shard a rank."""
        if self._device_mesh is None:
            if self.group is None or self.slots_per_rank != 1:
                where = ("all in this process" if self.group is None else
                         f"{self.slots_per_rank} a rank")
                raise ValueError(
                    f"a DeviceMesh needs one slot a rank; this mesh holds "
                    f"its {self.size} slots {where}")
            import torch.distributed as dist
            from torch.distributed.device_mesh import DeviceMesh

            ranks = torch.tensor(dist.get_process_group_ranks(self.group))
            kind = self.home.type
            # a meta program (the dry run's) takes the card's collectives:
            # DTensor swaps a "cpu" mesh's all-to-all for an all-gather
            self._device_mesh = DeviceMesh(
                "cuda" if kind == "meta" else kind,
                ranks.reshape(self.devices.shape),
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    def owner(self, slot: int) -> int:
        """The rank that holds flat slot ``slot``."""
        return slot // self.slots_per_rank

    def coords(self, slot: int) -> dict:
        """Flat slot index -> ``{axis: index}``."""
        idx = np.unravel_index(slot, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def shard_slots(self, axes: Sequence[str]) -> list[int]:
        """The flat slots of the shards laid over ``axes``, in the
        row-major order of ``axes`` (the order of ``jax.lax.axis_index``
        over them); every other axis is held at index 0."""
        flat = np.arange(self.size).reshape(self.devices.shape)
        pick = tuple(slice(None) if a in axes else 0 for a in self.axis_names)
        kept = [a for a in self.axis_names if a in axes]
        grid = flat[pick].transpose([kept.index(a) for a in axes])
        return [int(s) for s in grid.reshape(-1)]

    def shard_devices(self, axes: Sequence[str]) -> list[torch.device]:
        """The devices of the shards laid over ``axes`` (``shard_slots``)."""
        return [self.devices.flat[s] for s in self.shard_slots(axes)]

    def local_shards(self, axes: Sequence[str]) -> list[int]:
        """The positions in ``shard_slots(axes)`` of the shards this
        process holds (all of them on a single-process mesh)."""
        return [i for i, s in enumerate(self.shard_slots(axes))
                if self.owner(s) == self.rank]

    def group_slots(self, slot: int, axes: Sequence[str]) -> list[int]:
        """The slots that share every coordinate of ``slot`` off ``axes``,
        row-major over ``axes``: the members of a collective over
        ``axes``, in the order of its result."""
        base = self.coords(slot)
        members = []
        for pos in np.ndindex(*(self.shape[a] for a in axes)):
            c = dict(base, **dict(zip(axes, pos)))
            members.append(int(np.ravel_multi_index(
                [c[a] for a in self.axis_names], self.devices.shape)))
        return members


def axis_size(mesh: Mesh, name: str) -> int:
    """Number of devices along mesh axis ``name``."""
    return mesh.shape[name]


def default_mesh(device="cuda") -> Mesh:
    """A 1-D ``("data",)`` mesh: every visible CUDA device for a CUDA
    ``device``, else ``device`` alone."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return Mesh([torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])
    return Mesh([dev])


# logical axis -> mesh axis (or tuple of mesh axes)
TRAIN_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "embed": ("pod", "data"),     # FSDP: params sharded over the data axes
    "embed_out": None,
    "qkv": "model",               # TP over fused head*head_dim features
    "kv": "model",
    "heads": "model",
    "mlp": "model",
    "experts": "model",           # EP
    "expert_mlp": None,           # per-expert hidden: EP already covers it
    "vocab": "model",
    # Sequence parallelism: saved layer activations shard over "model" as
    # well as batch over "data".
    "seq": "model",
    "seq_out": None,            # logits seq dim (vocab already takes "model")
    "tokens": ("pod", "data"),  # flat (B*S) token dim in MoE dispatch
    "kv_seq": None,
    "layers": None,               # stacked layer dim: never sharded
}

SERVE_RULES: dict[str, Any] = {
    **TRAIN_RULES,
    "embed": None,                # no FSDP at serving time: TP only
    "kv_seq": "model",            # split-KV decode: cache seq over model
}

# Pure-FSDP (ZeRO-3) training: no tensor parallelism; params sharded over
# every mesh axis, batch over (data, model).
TRAIN_RULES_FSDP: dict[str, Any] = {
    **TRAIN_RULES,
    "batch": ("data", "model"),
    "embed": ("pod", "data", "model"),
    "qkv": None, "kv": None, "heads": None, "mlp": None, "vocab": None,
    "experts": "model",           # EP stays: expert weights shard by expert
    "seq": None,
}

RULE_PRESETS = {"tp": TRAIN_RULES, "fsdp": TRAIN_RULES_FSDP,
                "serve": SERVE_RULES}


class ShardingRules:
    """Logical axis names -> the axes of ``mesh`` (a :class:`Mesh`)."""

    def __init__(self, mesh: Mesh, rules: dict[str, Any]):
        self.mesh = mesh
        self.rules = dict(rules)

    def spec(self, axes: Sequence[Optional[str]]) -> tuple:
        """The partition spec of a logical-axes tuple, one entry a dim
        (None, a mesh axis name, or a tuple of them), dropping mesh axes
        the mesh does not have (no "pod" on the single-pod mesh)."""
        parts = []
        for ax in axes:
            m = self.rules.get(ax) if ax else None
            if m is None:
                parts.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(a for a in ms if a in self.mesh.axis_names)
            parts.append(ms if len(ms) > 1 else (ms[0] if ms else None))
        return tuple(parts)

    def divisible_spec(self, axes: Sequence[Optional[str]], shape) -> tuple:
        """``spec(axes)`` with each dim's mesh axes dropped where their
        product does not divide the dim of ``shape`` (the reference's
        ``launch/dryrun.py::_divisible_sharding``).  A spec that lays one
        mesh axis over two dims raises, as ``NamedSharding`` refuses it."""
        parts, used = [], []
        for i, entry in enumerate(self.spec(axes)):
            if entry is None:
                parts.append(None)
                continue
            ms = (entry,) if isinstance(entry, str) else entry
            total = 1
            for a in ms:
                total *= self.mesh.shape[a]
            parts.append(entry if shape[i] % total == 0 else None)
            used += ms if parts[-1] is not None else ()
        if len(used) != len(set(used)):
            raise ValueError(f"spec {tuple(parts)} of logical axes "
                             f"{tuple(axes)} lays a mesh axis over two dims")
        return tuple(parts)

    def placements(self, spec: Sequence) -> tuple:
        """A partition spec -> one DTensor placement a mesh dim: ``Shard(d)``
        on each mesh dim that entry d names, ``Replicate()`` elsewhere.
        The mesh axes of one entry must come in the mesh's order (DTensor
        splits a dim over its mesh dims left to right, as a
        ``PartitionSpec`` entry splits it major to minor)."""
        from torch.distributed.tensor import Replicate, Shard

        names = self.mesh.axis_names
        out: list = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            idx = [names.index(a) for a in
                   ((entry,) if isinstance(entry, str) else entry)]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry} is not in the mesh's "
                                 f"axis order {names}")
            for i in idx:
                if out[i] != Replicate():
                    raise ValueError(f"mesh axis {names[i]!r} shards two "
                                     f"dims of spec {tuple(spec)}")
                out[i] = Shard(d)
        return tuple(out)

    def sharding(self, axes: Sequence[Optional[str]], shape=None) -> tuple:
        """``(device_mesh, placements)`` of a logical-axes tuple: the
        counterpart of the reference's ``NamedSharding(mesh, spec(axes))``.
        With ``shape``, the placements of ``divisible_spec``."""
        spec = (self.spec(axes) if shape is None
                else self.divisible_spec(axes, tuple(shape)))
        return self.mesh.device_mesh(), self.placements(spec)


def _contiguous(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (no tensor made)."""
    out, step = [], 1
    for d in reversed(tuple(shape)):
        out.append(step)
        step *= d
    return tuple(reversed(out))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)



def reshape(x, shape: Sequence[int]):
    """``x.reshape(shape)``; a DTensor whose splits DTensor cannot carry
    through the reshape (a split of rows that the new leading dims do
    not divide) is first made whole along every split dim."""
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard

    try:
        return _Reshape.apply(x, tuple(shape))
    except RuntimeError:
        whole = x.redistribute(x.device_mesh, tuple(
            Replicate() if isinstance(p, Shard) else p for p in x.placements))
        return _Reshape.apply(whole, tuple(shape))


def gather_fsdp(tree):
    """Params (a norm's, a bias) made whole over the mesh axes the
    active rules map "embed" to (FSDP's all-gather before use): each
    DTensor leaf's split over those axes replicated, its other splits
    kept, so that an elementwise op meets them as its activations allow
    (torch 2.11's DTensor fails to gather a norm's weight that the
    batch's mesh axis splits).  As it is without rules."""
    rules = active_rules()
    if rules is None:
        return tree
    from torch.distributed.tensor import Replicate, Shard

    m = rules.rules.get("embed")
    fsdp = set((m,) if isinstance(m, str) else (m or ()))
    names = rules.mesh.axis_names

    def whole(_, t):
        if not is_dtensor(t):
            return t
        pl = tuple(Replicate() if names[i] in fsdp and isinstance(p, Shard)
                   else p for i, p in enumerate(t.placements))
        return t if pl == tuple(t.placements) else t.redistribute(
            t.device_mesh, pl)

    return _tree_zip(whole, tree, tree)


def settle(x):
    """A DTensor's partial sums reduced (``Partial`` -> ``Replicate``), so
    that an elementwise op with a split operand takes it as it is (torch
    2.11's DTensor cannot turn a ``Shard`` into a ``Partial``); other
    tensors as they are."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate

    pl = tuple(x.placements)
    if not any(isinstance(p, Partial) for p in pl):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if isinstance(p, Partial) else p for p in pl))


def split_dim(x, dim: int, sizes: Sequence[int]):
    """``x`` with dim ``dim`` reshaped into ``sizes``.  A DTensor split
    along ``dim`` by mesh dims whose product does not divide ``sizes[0]``
    (40 heads over a 16-way "model" axis) is first replicated along
    those mesh dims: DTensor can only unflatten whole blocks."""
    dim = dim % x.ndim
    shape = tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:])
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        mesh, pl = x.device_mesh, tuple(x.placements)
        parts = 1
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim == dim:
                parts *= mesh.size(i)
        if sizes[0] % parts:
            x = x.redistribute(mesh, tuple(
                Replicate() if isinstance(p, Shard) and p.dim == dim else p
                for p in pl))
        return _Reshape.apply(x, shape)
    return x.reshape(shape)


def merge_dims(x, shape: Sequence[int]):
    """``x.reshape(shape)``, the heads of an attention output merged into
    its features.  On a DTensor the backward splits the gradient back
    through :func:`split_dim`, which replicates a split that the heads
    do not take evenly (DTensor's own view backward refuses it)."""
    if not is_dtensor(x):
        return x.reshape(shape)
    return _MergeDims.apply(x, tuple(shape))


class _MergeDims(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        # the merged dims are the trailing ones of the input's shape that
        # the output's last dim covers
        n = len(ctx.shape) - g.ndim + 1
        return split_dim(g, g.ndim - 1, ctx.shape[-n:]), None


def region(fn: Callable, mesh, args: Sequence, in_placements: Sequence,
           out_placements: Sequence):
    """``fn`` on each rank's blocks: torch's ``local_map`` over ``mesh``
    with ``args`` redistributed to ``in_placements`` (None for a
    non-tensor) and the outputs wrapped in ``out_placements``.  An
    argument replicated over a mesh dim that another argument splits
    enters each rank's different work, so its gradient comes back
    ``Partial`` over that dim (the transpose of a ``shard_map``'s
    unmapped input)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    split = {i for pl in in_placements if pl is not None
             for i, p in enumerate(pl) if isinstance(p, Shard)}
    grads = [None if pl is None else tuple(
        Partial() if i in split and p == Replicate() else p
        for i, p in enumerate(pl)) for pl in in_placements]
    # a partial gradient is summed where it leaves the region (the
    # transpose's psum), not handed to the ops before it: torch 2.11's
    # DTensor cannot meet it with a split operand
    args = [_SettleGrad.apply(a) if g is not None and any(
        isinstance(p, Partial) for p in g) and is_dtensor(a) else a
        for a, g in zip(args, grads)]
    return local_map(fn, out_placements=tuple(out_placements),
                     in_placements=tuple(in_placements),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def settle_grad(x):
    """``x``, whose gradient is summed (:func:`settle`) before autograd
    adds it to the gradient of ``x``'s other uses: a residual stream's
    two branches may hand back one partial and one split gradient, which
    torch 2.11's DTensor cannot add.  ``x`` itself off DTensors."""
    if not is_dtensor(x) or not (torch.is_grad_enabled() and
                                 x.requires_grad):
        return x
    return _SettleGrad.apply(x)


class _SettleGrad(torch.autograd.Function):
    """Identity forward; backward sums a partial gradient (:func:`settle`)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return settle(g)


def by_axes(fn: Callable, args: Sequence, axes: Sequence,
            out_like: Sequence[int]):
    """``fn(*args)``, or, when ``args[0]`` is a DTensor, ``fn`` in a
    :func:`region` with each argument placed by its logical axes under
    the active rules (``axes[i]``, mesh axes that do not divide dropped)
    and output j placed as argument ``out_like[j]``: a loop of small
    steps (a selective scan, the WKV chunks) runs on each rank's blocks
    as plain tensors, not one DTensor dispatch a step."""
    if not is_dtensor(args[0]):
        return fn(*args)
    rules = active_rules()
    pls = [rules.sharding(ax, a.shape)[1] for a, ax in zip(args, axes)]
    out = region(fn, args[0].device_mesh, args, pls,
                 [pls[i] for i in out_like])
    return out


def local_block(mesh, placements, dim: int, size: int) -> tuple[int, int]:
    """``(offset, length)`` of this rank's block of a dim of ``size`` that
    ``placements`` split evenly over ``mesh`` (its mesh dims left to
    right, major to minor)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    index, parts = 0, 1
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            index = index * mesh.size(i) + coord[i]
            parts *= mesh.size(i)
    return index * (size // parts), size // parts


def logical_constraint(x, axes: Sequence[Optional[str]]):
    """``with_sharding_constraint`` by logical axes: ``x.redistribute`` to
    the placements of ``axes`` (mesh axes that do not divide a dim
    dropped, ``ShardingRules.divisible_spec``, and a split of a dim under
    a whole leading dim longer than 1, which DTensor cannot flatten); a
    no-op without active rules or on a plain tensor."""
    rules = active_rules()
    if rules is None or not is_dtensor(x):
        return x
    spec = list(rules.divisible_spec(axes, tuple(x.shape)))
    for d in range(1, x.ndim - 1):
        # DTensor cannot flatten a split dim under a whole leading dim
        # longer than 1 (a matmul's [B, S] -> [B * S]): keep it whole
        if spec[d] is not None and any(spec[j] is None and x.shape[j] > 1
                                       for j in range(d)):
            spec[d] = None
    mesh, placements = rules.mesh.device_mesh(), rules.placements(spec)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def distribute(x: torch.Tensor, axes: Sequence[Optional[str]],
               rules: Optional["ShardingRules"] = None):
    """Place a whole tensor by logical axes (the reference's
    ``in_shardings``): a DTensor whose local tensor is this rank's block
    of ``x`` under ``rules.sharding(axes, x.shape)``, sliced here, with no
    traffic (every rank holds the whole ``x``; a ``meta`` ``x`` gives a
    ``meta`` block).  ``x`` itself without rules (``active_rules()`` by
    default) or when it is a DTensor already."""
    from torch.distributed.tensor import DTensor, Shard

    rules = rules if rules is not None else active_rules()
    if rules is None or is_dtensor(x):
        return x
    mesh, placements = rules.sharding(axes, x.shape)
    coord = mesh.get_coordinate()
    local = x.detach()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            size = local.shape[pl.dim] // mesh.size(i)
            local = local.narrow(pl.dim, coord[i] * size, size)
    out = DTensor.from_local(local.contiguous(), mesh, placements,
                             run_check=False, shape=x.shape,
                             stride=_contiguous(x.shape))
    return out.requires_grad_(x.requires_grad)


def zeros(shape, dtype: torch.dtype, axes: Sequence[Optional[str]], device,
          rules: Optional["ShardingRules"] = None):
    """``torch.zeros(shape)`` placed by logical axes: each rank allocates
    only its block (a cache of a production cell never exists whole).
    A plain tensor without rules."""
    from torch.distributed.tensor import DTensor, Shard

    if rules is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    mesh, placements = rules.sharding(axes, shape)
    local = list(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local[pl.dim] //= mesh.size(i)
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), mesh, placements,
        run_check=False, shape=torch.Size(shape), stride=_contiguous(shape))


def copy_into(dst, src) -> None:
    """``dst.copy_(src)``, a DTensor ``src`` redistributed to ``dst``'s
    placements first."""
    if is_dtensor(dst) and is_dtensor(src):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def _flattenable(x):
    """``x`` with the splits of its leading dims other than the first (all
    but the last dim) replicated, so that DTensor flattens the leading
    dims to rows and unflattens them back (it cannot take back a
    strided split).  A sequence split over "model" is gathered before
    the matmul, as sequence parallelism gathers it before a
    column-parallel layer."""
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(x.placements)
    bad = {p.dim for p in pl if isinstance(p, Shard)
           and 0 < p.dim < x.ndim - 1}
    if not bad:
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if isinstance(p, Shard) and p.dim in bad else p
        for p in pl))


def _matmul(a, b):
    """``a @ b`` for a DTensor ``a`` [..., K] and a 2-D ``b``: the leading
    dims flattened to rows and back, the product's rows redistributed to
    the flattened input's split first (DTensor's own decomposition may
    split the rows where the leading dims cannot take it back)."""
    from torch.distributed.tensor import Replicate, Shard

    def rows_split(p) -> bool:
        return isinstance(p, Shard) and p.dim == 0

    a = _flattenable(a)
    a2 = _Reshape.apply(a, (-1, a.shape[-1]))
    out = torch.mm(a2, b)
    rows = tuple(p if rows_split(p) else
                 (Replicate() if rows_split(q) else q)
                 for p, q in zip(a2.placements, out.placements))
    if tuple(out.placements) != rows:
        out = out.redistribute(out.device_mesh, rows)
    return _Reshape.apply(out, (*a.shape[:-1], b.shape[-1]))


class _Reshape(torch.autograd.Function):
    """A DTensor's reshape whose backward first redistributes the
    gradient to the placements the output had (DTensor's own backward
    may be handed a gradient split where the input's shape cannot take
    it back)."""

    @staticmethod
    def forward(ctx, x, shape):
        from torch.distributed.tensor import Replicate, Shard

        out = x.reshape(shape)
        ctx.shape = tuple(x.shape)
        # a partial output's gradient is whole on each rank
        ctx.placements = tuple(p if isinstance(p, Shard) else Replicate()
                               for p in out.placements)
        return out

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g.reshape(ctx.shape), None


class _DTensorMatmul(torch.overrides.TorchFunctionMode):
    """Routes ``a @ b`` with a DTensor ``a`` of 3 or more dims and a 2-D
    ``b`` through :func:`_matmul`; everything else passes."""

    _OPS = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if _DTensorMatmul._OPS is None:
            _DTensorMatmul._OPS = {torch.matmul, torch.Tensor.matmul,
                                   torch.Tensor.__matmul__}
        kwargs = kwargs or {}
        if (func in _DTensorMatmul._OPS and not kwargs and len(args) == 2
                and is_dtensor(args[0]) and args[0].ndim > 2
                and isinstance(args[1], torch.Tensor) and args[1].ndim == 2):
            return _matmul(*args)
        return func(*args, **kwargs)


class _Active:
    rules: Optional[ShardingRules] = None


# process-wide, not per thread: autograd runs a backward (and a
# checkpoint's recompute) on a thread of its own
_ACTIVE = _Active()


@contextlib.contextmanager
def use_rules(rules: ShardingRules):
    """Make ``rules`` the active rules for the block; a DTensor matmul of
    3 or more dims goes through :func:`_matmul` meanwhile."""
    prev = _ACTIVE.rules
    _ACTIVE.rules = rules
    try:
        with _DTensorMatmul():
            yield rules
    finally:
        _ACTIVE.rules = prev


def active_rules() -> Optional[ShardingRules]:
    return _ACTIVE.rules


def recompute_context():
    """``torch.utils.checkpoint``'s ``context_fn``: a recompute under
    active rules re-enters their matmul mode (a checkpoint recomputes
    with no function mode active)."""
    return contextlib.nullcontext(), (
        _DTensorMatmul() if active_rules() is not None
        else contextlib.nullcontext())


def tree_pspecs(axes_tree: Any, rules: ShardingRules) -> Any:
    """Map a logical-axes tree (nested dicts, lists and named tuples with
    axes tuples as leaves, None for an absent subtree) to specs."""
    if axes_tree is None:
        return None
    if isinstance(axes_tree, dict):
        return {k: tree_pspecs(v, rules) for k, v in axes_tree.items()}
    if hasattr(axes_tree, "_fields"):  # TrainState, AdamWState
        return type(axes_tree)(*(tree_pspecs(v, rules) for v in axes_tree))
    if isinstance(axes_tree, list):
        return [tree_pspecs(v, rules) for v in axes_tree]
    return rules.spec(axes_tree)


def _tree_zip(fn, axes_tree: Any, tree: Any) -> Any:
    """``fn(axes, leaf)`` over two parallel trees (dicts, lists, named
    tuples; None for an absent subtree)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_zip(fn, axes_tree[k], v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_zip(fn, a, v)
                            for a, v in zip(axes_tree, tree)))
    if isinstance(tree, list):
        return [_tree_zip(fn, a, v) for a, v in zip(axes_tree, tree)]
    return fn(axes_tree, tree)


def tree_shardings(axes_tree: Any, rules: ShardingRules) -> Any:
    """A logical-axes tree -> the ``(device_mesh, placements)`` of each
    leaf."""
    return _tree_zip(lambda axes, _: rules.sharding(axes), axes_tree,
                     axes_tree)


def distribute_tree(tree: Any, axes_tree: Any,
                    rules: Optional[ShardingRules] = None) -> Any:
    """:func:`distribute` over a tree of tensors and its axes tree."""
    return _tree_zip(lambda axes, t: distribute(t, axes, rules), axes_tree,
                     tree)


def full_tree(tree: Any) -> Any:
    """Each DTensor leaf of a tree -> the whole tensor (``full_tensor``,
    a gather); other leaves as they are."""
    return _tree_zip(lambda _, t: t.full_tensor() if is_dtensor(t) else t,
                     tree, tree)
