"""A single-process device mesh for the sharded replay, and the
logical-axis sharding rules of the LM zoo.

Counterpart of ``jax.sharding.Mesh`` as ``repro/core/sharded.py`` uses it
under ``shard_map``, and of ``repro/distributed/sharding.py``.
A :class:`Mesh` is a named grid of ``torch.device``s; one device may
appear several times, so S logical shards can live on one card.  The
sharded samplers keep one tensor per shard on its device and run the
per-shard program in a host loop; the only traffic between shards goes
through :mod:`repro_torch.distributed.collectives`, which counts it.

The rules (``TRAIN_RULES``, ``SERVE_RULES``, ``TRAIN_RULES_FSDP``) map
the models' logical axes to mesh axes, MaxText-style, and
:class:`ShardingRules` turns a leaf's logical axes into a partition spec
(a tuple in ``jax.sharding.PartitionSpec``'s layout) for a mesh.  Today
only the dry run reads them (``launch/dryrun.py``: each leaf's shard
shape on the production mesh).  The reference's ``logical_constraint``,
``ShardingRules.sharding`` and ``tree_shardings`` place tensors in a
sharded program, which the port has not: a multi-process mesh over
several cards (``torch.distributed`` with NCCL) is not ported yet
(ROADMAP A14), and they come with it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device


class Mesh:
    """Devices on a grid with one named axis per grid dimension.

    Args:
      devices: a list of ``torch.device``s (or nested lists, one level
        per axis), in row-major order.
      axis_names: one name per grid dimension.

    ``traffic`` counts the scalars each collective has produced on this
    mesh (``{"all_gather": n, "psum": n}``); reset it by assigning zeros.
    """

    def __init__(self, devices, axis_names: Sequence[str] = ("data",)):
        grid = np.array(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names) or grid.size == 0:
            raise ValueError(f"devices of shape {grid.shape} do not match "
                             f"axis names {self.axis_names}")
        self.devices = np.vectorize(torch.device, otypes=[object])(grid)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.traffic = {"all_gather": 0, "psum": 0}

    @property
    def lead(self) -> torch.device:
        """The device that collectives gather onto (the first one)."""
        return self.devices.flat[0]

    def shard_devices(self, axes: Sequence[str]) -> list[torch.device]:
        """The devices of the shards laid over ``axes``, in the row-major
        order of ``axes`` (the order of ``jax.lax.axis_index`` over them);
        every other axis is held at index 0."""
        pick = tuple(slice(None) if a in axes else 0 for a in self.axis_names)
        kept = [a for a in self.axis_names if a in axes]
        grid = self.devices[pick].transpose([kept.index(a) for a in axes])
        return list(grid.reshape(-1))


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
