"""The production, debug and replay meshes.

Counterpart of ``repro/launch/mesh.py``.  Each returns the port's
single-process :class:`~repro_torch.distributed.sharding.Mesh`, whose
slots may repeat one device: the production mesh has the reference's
axes and shape (16 x 16 chips a pod, 2 pods), with every slot on the
given device, so the dry run reads its shard counts and the sharded
replay runs its 256 or 512 logical shards on one card.  A mesh of
processes over several cards is ROADMAP A14.
"""
from __future__ import annotations

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
