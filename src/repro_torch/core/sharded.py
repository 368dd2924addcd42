"""Sharded replay: AMPER-fr and PER priority sampling over a device mesh.

Counterpart of ``repro/core/sharded.py``.  The priority table is split
into S equal shards along a :class:`~repro_torch.distributed.sharding.Mesh`
(one tensor per shard, on its device), and a draw runs the reference's
per-shard program once per shard in a host loop, where the reference
runs it under ``shard_map``.  AMPER needs little communication:

  * the m range matches and the compaction are local to a shard;
  * the only global state is each shard's CSP count: one all-gather of S
    scalars;
  * each of the ``batch`` draws is owned by exactly one shard, which
    turns it into a global index; one psum of ``batch`` scalars collects
    them.

So a draw moves O(S + batch) scalars between shards
(:mod:`repro_torch.distributed.collectives` counts them).  The
hierarchical-cumsum PER baseline needs each shard's total instead: one
all-gather of S floats and one psum of the batch.

``fr_mode`` picks the per-shard match as on one device: ``"broadcast"``,
``"interval"`` and ``"window"`` test the ranges in PyTorch, ``"kernel"``
runs the ``multi_query_match`` kernel on each shard, and ``"fused"`` adds
the ``rank_select`` kernel, which turns each shard's owned draws into
local indices in one pass without a compacted CSP.  All five give
bit-identical draws.

Two things differ from the single-device sampler, exactly as in the
reference: the key tree (``kq, kpick = split(key)``, then ``kpick, kfb =
split(kpick)``; the representatives come from ``kq``), and the empty-CSP
fallback, which is uniform over the whole global table, not over the
live rows.  Each shard keeps at most ``csp_capacity // S`` members, its
lowest-index ones (no rotation).

Samplers update their per-shard tensors in place and return the state
they were given.
"""
from __future__ import annotations

import functools
import operator
from typing import NamedTuple, Sequence

import torch

from repro_torch import prng
from repro_torch.core import quantize as qz
from repro_torch.core.amper import (FR_MODES, AmperConfig, AmperState,
                                    fr_intervals, fr_match,
                                    group_representatives, last_writer)
from repro_torch.distributed.collectives import all_gather, psum
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels import ops
from repro_torch.kernels.ref import nonzero_static
from repro_torch.obs.tracing import span


def resolve_axes(mesh: Mesh, axis_names: Sequence[str]) -> tuple[str, ...]:
    """The subset of ``axis_names`` present on ``mesh`` (order preserved)."""
    axes = tuple(a for a in axis_names if a in mesh.axis_names)
    if not axes:
        raise ValueError(
            f"none of the sharding axes {tuple(axis_names)} exist on mesh "
            f"axes {mesh.axis_names}")
    return axes


def _mesh_shards(mesh: Mesh, axes: Sequence[str]) -> int:
    return int(functools.reduce(operator.mul,
                                (mesh.shape[a] for a in axes), 1))


def _local_csp_capacity(mesh: Mesh, axes: Sequence[str], cfg: AmperConfig,
                        override: int | None) -> int:
    if override is not None:
        return override
    return max(cfg.csp_capacity // max(_mesh_shards(mesh, axes), 1), 1)


def _ranges_on(v_rep: torch.Tensor, cfg: AmperConfig, devices) -> dict:
    """The m inclusive ranges, moved once to each distinct shard device."""
    lo, hi = fr_intervals(v_rep, cfg)
    return {d: (lo.to(d), hi.to(d)) for d in set(devices)}


def _local_match_fr(pq_local: torch.Tensor, valid_local: torch.Tensor,
                    v_rep: torch.Tensor, lo_hi, cfg: AmperConfig
                    ) -> torch.Tensor:
    """m-query ternary match on one shard (no communication); the
    kernel modes take the shard device's ranges ``lo_hi``, the others
    (``broadcast``, ``interval``, ``window``) go through
    :func:`~repro_torch.core.amper.fr_match` as on one device."""
    if cfg.fr_mode in ("kernel", "fused"):
        sel, _counts = ops.multi_query_match(pq_local, valid_local, *lo_hi)
        return sel
    return fr_match(pq_local, valid_local, v_rep, cfg)


def _fr_sample_body(cfg: AmperConfig, batch: int, mesh: Mesh,
                    devices: Sequence[torch.device], local_cap: int):
    """The sharded AMPER-fr draw: ``body(pq_shards, valid_shards, key) ->
    int32[batch]`` global indices on the mesh's lead device."""
    n_shards = len(devices)

    def body(pq_shards, valid_shards, key):
        n_local = pq_shards[0].shape[0]
        kq, kpick = prng.split(key)
        kpick, kfb = prng.split(kpick)  # the fallback gets its own key
        v_rep = group_representatives(kq, cfg)  # identical on all shards
        ranges = _ranges_on(v_rep, cfg, devices)
        selected = [_local_match_fr(pq, valid, v_rep, ranges[d], cfg)
                    for pq, valid, d in zip(pq_shards, valid_shards, devices)]
        counts = all_gather(mesh, [
            torch.clamp(sel.sum(dtype=torch.int32), max=local_cap)
            for sel in selected])
        cum = torch.cumsum(counts, 0, dtype=torch.int32)
        total = cum[-1]

        # The same draws for every shard: u in [0, total), with the bound
        # left on the device.
        u = prng.randint(kpick, (batch,), 0, torch.clamp(total, min=1))
        owner = torch.searchsorted(cum, u, right=True).to(torch.int32)
        start = cum - counts  # exclusive prefix
        offset = u - start[owner.clamp(0, n_shards - 1).to(torch.int64)]

        contribs = []
        for me, d in enumerate(devices):
            off = offset.to(d)
            if cfg.fr_mode == "fused":
                # rank r in index order IS nonzero(selected)[r]
                local_pick, _cnt = ops.rank_select(
                    pq_shards[me], valid_shards[me], *ranges[d], off)
            else:
                loc_idx = nonzero_static(selected[me], local_cap, fill=0)
                local_pick = loc_idx[off.clamp(0, local_cap - 1)
                                     .to(torch.int64)]
            mine = owner.to(d) == me
            contribs.append(torch.where(
                mine, local_pick.to(torch.int32) + me * n_local,
                torch.zeros_like(off)))
        picked = psum(mesh, contribs)

        # Empty CSP: uniform over the whole global table.
        fb = prng.randint(kfb, (batch,), 0, n_local * n_shards,
                          device=mesh.lead)
        return torch.where(total > 0, picked, fb).to(torch.int32)

    return body


def sharded_sample_fr(mesh: Mesh, cfg: AmperConfig, batch: int,
                      axis_names: Sequence[str] = ("pod", "data"),
                      local_csp_capacity: int | None = None):
    """The sharded AMPER-fr sampler over ``mesh``.

    Returns ``fn(pq_shards, valid_shards, key) -> int32[batch]`` global
    indices, where ``pq_shards``/``valid_shards`` hold one equal-length
    tensor per shard of ``axis_names``, in shard order, on its device.
    """
    axes = resolve_axes(mesh, axis_names)
    devices = mesh.shard_devices(axes)
    return _fr_sample_body(cfg, batch, mesh, devices,
                           _local_csp_capacity(mesh, axes, cfg,
                                               local_csp_capacity))


def _per_sample_body(batch: int, mesh: Mesh,
                     devices: Sequence[torch.device]):
    """The sharded hierarchical-cumsum PER draw: ``body(p_shards, key) ->
    int32[batch]`` on the lead device."""
    n_shards = len(devices)

    def body(p_shards, key):
        n_local = p_shards[0].shape[0]
        local_cum = [torch.cumsum(p, 0) for p in p_shards]
        totals = all_gather(mesh, [c[-1] for c in local_cum])
        cum_tot = torch.cumsum(totals, 0)
        grand = torch.clamp(cum_tot[-1], min=1e-12)

        u = prng.uniform(key, (batch,), device=mesh.lead) * grand
        owner = torch.searchsorted(cum_tot, u, right=True)
        start = cum_tot - totals
        local_u = u - start[owner.clamp(0, n_shards - 1)]
        contribs = []
        for me, d in enumerate(devices):
            loc = torch.searchsorted(local_cum[me], local_u.to(d), right=True)
            loc = loc.clamp(0, n_local - 1).to(torch.int32)
            contribs.append(torch.where(owner.to(d) == me, loc + me * n_local,
                                        torch.zeros_like(loc)))
        return psum(mesh, contribs).to(torch.int32)

    return body


def sharded_sample_per(mesh: Mesh, batch: int,
                       axis_names: Sequence[str] = ("pod", "data")):
    """Contrast baseline: hierarchical cumsum PER on the same sharded
    table.  Returns ``fn(p_shards, key) -> int32[batch]``."""
    axes = resolve_axes(mesh, axis_names)
    return _per_sample_body(batch, mesh, mesh.shard_devices(axes))


def repartition(sampler, state):
    """Move a sampler state onto ``sampler``'s shard layout.

    A per-shard state (any shard count) or a dense one is gathered field
    by field and split again over ``sampler``'s shards: values, and so
    the CSP membership and the sampling law, are unchanged.  For an
    unsharded sampler it is the identity.
    """
    if not hasattr(sampler, "from_dense"):
        return state
    fields = [torch.cat([t.to(sampler.device) for t in f])
              if isinstance(f, tuple) else f for f in state]
    return sampler.from_dense(*fields)


# --- mesh-native Sampler implementations -------------------------------------


def _write_rows(buf: torch.Tensor, local: torch.Tensor, keep: torch.Tensor,
                values: torch.Tensor) -> None:
    """``buf[local[j]] = values[j]`` for the rows with ``keep[j]``, the last
    one winning, in place and with static shapes.  Every other row
    rewrites its slot with the value a kept row writes there, or with
    what it holds, so all writes to one slot agree (a scatter's winner
    among duplicates is undefined on CUDA)."""
    w = last_writer(local, keep)
    buf[local] = torch.where(w >= 0, values[w.clamp(min=0)], buf[local])


class _Shards:
    """What both sharded samplers share: the mesh, the shard devices, and
    the split of a global row index into (shard, local row)."""

    def _setup(self, capacity: int, mesh: Mesh, axis_names: Sequence[str]):
        self.capacity = capacity
        self.mesh = mesh
        self.axis_names = resolve_axes(mesh, axis_names)
        self.devices = mesh.shard_devices(self.axis_names)
        self.n_shards = len(self.devices)
        if capacity % self.n_shards:
            raise ValueError(
                f"capacity {capacity} not divisible by the "
                f"{self.n_shards} shards of mesh axes {self.axis_names}")
        self.n_local = capacity // self.n_shards
        self.device = mesh.lead

    def _zeros(self, dtype) -> tuple[torch.Tensor, ...]:
        return tuple(torch.zeros(self.n_local, dtype=dtype, device=d)
                     for d in self.devices)

    def _split(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """A global ``[capacity]`` tensor as fresh per-shard tensors."""
        return tuple(x[s * self.n_local:(s + 1) * self.n_local]
                     .to(d, copy=True) for s, d in enumerate(self.devices))

    def _write(self, bufs, idx: torch.Tensor, values: torch.Tensor) -> None:
        """Write ``values`` at global rows ``idx`` across the shards."""
        idx = idx.to(torch.int64)
        shard, local = idx // self.n_local, idx % self.n_local
        for s, (buf, d) in enumerate(zip(bufs, self.devices)):
            _write_rows(buf, local.to(d), (shard == s).to(d), values.to(d))

    def _gather(self, parts) -> torch.Tensor:
        return torch.cat([p.to(self.device) for p in parts])

    def _sum(self, parts) -> torch.Tensor:
        return all_gather(self.mesh, [p.sum() for p in parts]).sum()


class ShardedAmperState(NamedTuple):
    """AMPER-fr state, one tensor per shard in shard order."""

    pq: tuple     # int32[capacity / S] per shard
    valid: tuple  # bool[capacity / S] per shard


class ShardedAmperSampler(_Shards):
    """AMPER-fr with the priority table sharded over a mesh.

    The five-method sampler protocol; sampling runs the O(shards + batch)
    law of :func:`sharded_sample_fr`, and :meth:`priorities` /
    :meth:`total` are the dense views the replay buffer's importance
    weights need.  Registry name: ``"amper-fr-sharded"``.
    """

    def __init__(self, cfg: AmperConfig, mesh: Mesh,
                 axis_names: Sequence[str] = ("pod", "data"),
                 local_csp_capacity: int | None = None):
        if cfg.fr_mode not in FR_MODES:
            raise ValueError(f"unknown fr_mode {cfg.fr_mode!r} "
                             f"(available: {FR_MODES})")
        self.cfg = cfg
        self._setup(cfg.capacity, mesh, axis_names)
        self.local_csp_capacity = _local_csp_capacity(
            mesh, self.axis_names, cfg, local_csp_capacity)

    def init(self) -> ShardedAmperState:
        return ShardedAmperState(pq=self._zeros(torch.int32),
                                 valid=self._zeros(torch.bool))

    def from_dense(self, pq: torch.Tensor,
                   valid: torch.Tensor) -> ShardedAmperState:
        """A global (pq, valid) table split over this sampler's shards."""
        return ShardedAmperState(pq=self._split(pq), valid=self._split(valid))

    def to_dense(self, state: ShardedAmperState) -> AmperState:
        """The global (pq, valid) table on the lead device: the inverse of
        :meth:`from_dense`, and the form a checkpoint stores (the
        reference's sharded state is one global ``AmperState``)."""
        return AmperState(pq=self._gather(state.pq),
                          valid=self._gather(state.valid))

    def priorities(self, state: ShardedAmperState) -> torch.Tensor:
        return self._gather(
            qz.dequantize(pq, self.cfg.v_max, self.cfg.frac_bits) * valid
            for pq, valid in zip(state.pq, state.valid))

    def total(self, state: ShardedAmperState) -> torch.Tensor:
        return self._sum(
            qz.dequantize(pq, self.cfg.v_max, self.cfg.frac_bits) * valid
            for pq, valid in zip(state.pq, state.valid))

    def update(self, state: ShardedAmperState, idx: torch.Tensor,
               priority: torch.Tensor) -> ShardedAmperState:
        """Priority write at global rows ``idx`` (a TCAM row write), in
        place; a duplicated row takes its last value."""
        p = priority.to(torch.float32)
        self._write(state.pq, idx,
                    qz.quantize(p, self.cfg.v_max, self.cfg.frac_bits))
        self._write(state.valid, idx, p > 0)
        return state

    def sample(self, state: ShardedAmperState, key: torch.Tensor, batch: int,
               stratified: bool = True) -> torch.Tensor:
        del stratified  # CSP sampling is uniform by construction
        body = _fr_sample_body(self.cfg, batch, self.mesh, self.devices,
                               self.local_csp_capacity)
        with span("sharded_sample"):
            return body(state.pq, state.valid, key)

    def membership(self, state: ShardedAmperState,
                   key: torch.Tensor) -> torch.Tensor:
        """Global bool[capacity] CSP membership for ``key``, equal to the
        single-device ``build_csp_fr(...).selected``."""
        kq, _ = prng.split(key)
        v_rep = group_representatives(kq, self.cfg)
        ranges = _ranges_on(v_rep, self.cfg, self.devices)
        return self._gather(
            _local_match_fr(pq, valid, v_rep, ranges[d], self.cfg)
            for pq, valid, d in zip(state.pq, state.valid, self.devices))


class ShardedPERState(NamedTuple):
    priorities: tuple  # float32[capacity / S] per shard


class ShardedPERSampler(_Shards):
    """Hierarchical-cumsum PER with the priority table sharded over a
    mesh: local cumsum + all-gather of the shard totals.  Draws are not
    stratified (every shard reads the same global uniforms).  Registry
    name: ``"per-sharded"``.
    """

    def __init__(self, capacity: int, mesh: Mesh,
                 axis_names: Sequence[str] = ("pod", "data")):
        self._setup(capacity, mesh, axis_names)

    def init(self) -> ShardedPERState:
        return ShardedPERState(priorities=self._zeros(torch.float32))

    def from_dense(self, priorities: torch.Tensor) -> ShardedPERState:
        return ShardedPERState(priorities=self._split(priorities))

    def to_dense(self, state: ShardedPERState) -> ShardedPERState:
        """The global priority table on the lead device (the inverse of
        :meth:`from_dense`), as the reference's ``ShardedPERState``."""
        return ShardedPERState(priorities=self._gather(state.priorities))

    def total(self, state: ShardedPERState) -> torch.Tensor:
        return self._sum(state.priorities)

    def priorities(self, state: ShardedPERState) -> torch.Tensor:
        return self._gather(state.priorities)

    def update(self, state: ShardedPERState, idx: torch.Tensor,
               priority: torch.Tensor) -> ShardedPERState:
        self._write(state.priorities, idx, priority.to(torch.float32))
        return state

    def sample(self, state: ShardedPERState, key: torch.Tensor, batch: int,
               stratified: bool = True) -> torch.Tensor:
        del stratified  # the sharded law draws global uniforms
        return _per_sample_body(batch, self.mesh, self.devices)(
            state.priorities, key)
