"""The two collectives of the sharded replay draw, on a :class:`Mesh`.

Counterpart of ``jax.lax.all_gather`` and ``jax.lax.psum`` as
``repro/core/sharded.py`` calls them inside ``shard_map``.  Each takes
one value per shard, in shard order, and returns the result on the
mesh's lead device.  Each adds the number of scalars it produced to
``mesh.traffic``, so a test can hold a draw to the O(shards + batch)
traffic the sharded law promises (``sharded.py:18-21``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.distributed.sharding import Mesh


def all_gather(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """One scalar per shard -> ``tensor[S]`` on the lead device."""
    out = torch.stack([v.reshape(()).to(mesh.lead) for v in values])
    mesh.traffic["all_gather"] += out.numel()
    return out


def psum(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise sum of one tensor per shard, on the lead device."""
    out = values[0].to(mesh.lead)
    for v in values[1:]:
        out = out + v.to(mesh.lead)
    mesh.traffic["psum"] += out.numel()
    return out
