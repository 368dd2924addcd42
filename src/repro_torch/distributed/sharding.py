"""A single-process device mesh for the sharded replay.

Counterpart of ``jax.sharding.Mesh`` as ``repro/core/sharded.py`` uses it
under ``shard_map``, and of ``repro/distributed/sharding.py::axis_size``.
A :class:`Mesh` is a named grid of ``torch.device``s; one device may
appear several times, so S logical shards can live on one card.  The
sharded samplers keep one tensor per shard on its device and run the
per-shard program in a host loop; the only traffic between shards goes
through :mod:`repro_torch.distributed.collectives`, which counts it.

A multi-process mesh over several cards (``torch.distributed`` with
NCCL) is not ported yet.  The logical-axis rules of the reference module
serve the LM zoo and come with it.
"""
from __future__ import annotations

from typing import Sequence

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
