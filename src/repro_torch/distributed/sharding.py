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
(a tuple in ``jax.sharding.PartitionSpec``'s layout) for a mesh.  The
dry run reads them (``launch/dryrun.py``: each leaf's shard shape on the
production mesh), and an active rule set sends ``moe_apply`` to the
explicit-collective dispatch as in the reference.  The reference's
``logical_constraint``, ``ShardingRules.sharding`` and
``tree_shardings`` place tensors for XLA's partitioner, which the port
has not yet (ROADMAP A14b).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence

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


_ACTIVE = threading.local()


@contextlib.contextmanager
def use_rules(rules: ShardingRules):
    prev = getattr(_ACTIVE, "rules", None)
    _ACTIVE.rules = rules
    try:
        yield rules
    finally:
        _ACTIVE.rules = prev


def active_rules() -> Optional[ShardingRules]:
    return getattr(_ACTIVE, "rules", None)


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
