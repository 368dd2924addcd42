"""AMPER-fr: associative-memory-based prioritized experience replay.

Counterpart of ``repro/core/amper.py`` for the AMPER-fr variant
(Algorithm 1 with the prefix or exact-radius query of Fig. 6(b2)) and
the uniform baseline.  AMPER-k waits for a later slice of the port.

The m group representatives, their queries and the compaction rotation
depend only on PRNG keys, never on the table, so they are computed on
the host (:mod:`repro_torch.prng` keys live there) and only the m
ranges travel to the table's device.  Everything that reads the table
stays on its device with static shapes: ``jnp.nonzero(size=...)``
becomes a cumsum plus scatter, so a draw never waits on the device.

``fr_mode`` picks the implementation, and all three give bit-identical
CSPs, indices and weights:

* ``"broadcast"`` -- the (m, n) ternary compare, written in PyTorch;
* ``"kernel"``    -- the m-range match as one CUDA kernel
  (:func:`repro_torch.kernels.ops.multi_query_match`), compaction in
  PyTorch;
* ``"fused"``     -- the whole draw as the CUDA ``amper_sample`` kernel
  (:func:`repro_torch.kernels.ops.amper_sample`).

Samplers update their state tensors in place and return the same state
object: the priority table is the size of the replay memory, and a
functional copy per write would double the memory traffic of a step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import prng, resolve_device
from repro_torch.core import quantize as qz
from repro_torch.kernels import ops
from repro_torch.kernels.ref import nonzero_static
from repro_torch.obs.tracing import span
from repro_torch.xla_float import div_const, fma32

FR_MODES = ("broadcast", "kernel", "fused")


class AmperConfig(NamedTuple):
    """Hyper-parameters of Algorithm 1 (AMPER-fr).

    Attributes:
      capacity: replay size n (number of priority rows).
      m: number of groups (Fig. 9 uses 20).
      lam_fr: scaling factor lambda' of Eqn. 4.
      v_max: static maximum priority value V_max.
      csp_capacity: static CSP buffer size (CSP ratio * capacity).
      frac_bits: fixed-point fraction bits of the int32 quantization.
      exact_radius: compare ``|p - V| <= Delta`` exactly instead of the
        power-of-2 prefix approximation (beyond-paper mode).
      fr_mode: "broadcast", "kernel" or "fused" (see module docstring).
    """

    capacity: int
    m: int = 20
    lam_fr: float = 1.0
    v_max: float = 1.0
    csp_capacity: int = 1500
    frac_bits: int = qz.DEFAULT_FRAC_BITS
    exact_radius: bool = False
    fr_mode: str = "broadcast"


class CspResult(NamedTuple):
    """Stream-compacted candidate set of priorities."""

    indices: torch.Tensor   # int32[csp_capacity], -1 padded
    count: torch.Tensor     # int32 scalar, number of valid entries
    selected: torch.Tensor  # bool[capacity] membership mask


def group_representatives(key: torch.Tensor, cfg: AmperConfig) -> torch.Tensor:
    """Line 3 of Algorithm 1: V(g_i) ~ U[V_max*i/m, V_max*(i+1)/m).

    Float arithmetic as XLA compiles the reference (see
    :mod:`repro_torch.xla_float`).  Returns float32[m] on the host.
    """
    i = torch.arange(cfg.m, dtype=torch.float32)
    lo = div_const(cfg.v_max * i, cfg.m)
    width = torch.full((cfg.m,), cfg.v_max / cfg.m, dtype=torch.float32)
    return fma32(width, prng.uniform(key, (cfg.m,)), lo)


def fr_queries(v_rep: torch.Tensor, cfg: AmperConfig
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(query, don't-care mask) per group: Delta_i = round(lambda'/m * V)."""
    vq = qz.quantize(v_rep, cfg.v_max, cfg.frac_bits)
    return vq, qz.prefix_mask(fr_radii(v_rep, cfg))


def fr_radii(v_rep: torch.Tensor, cfg: AmperConfig) -> torch.Tensor:
    """Exact (non-power-of-2) radii in quantized units."""
    vq = qz.quantize(v_rep, cfg.v_max, cfg.frac_bits)
    return torch.round((cfg.lam_fr / cfg.m) * vq.to(torch.float32)
                       ).to(torch.int32)


def fr_intervals(v_rep: torch.Tensor, cfg: AmperConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The m accepted inclusive ranges [lo_i, hi_i] (prefix or exact)."""
    vq = qz.quantize(v_rep, cfg.v_max, cfg.frac_bits)
    if cfg.exact_radius:
        r = fr_radii(v_rep, cfg)
        return vq - r, vq + r
    _, mask = fr_queries(v_rep, cfg)
    return qz.prefix_range(vq, mask)


def _compact(selected: torch.Tensor, csp_capacity: int,
             key: torch.Tensor | None = None) -> CspResult:
    """Compact a membership mask into a fixed-size index buffer.

    With ``key`` the scan starts at a random rotation, so truncation
    drops a uniformly random arc instead of always the highest rows.
    """
    n = selected.shape[0]
    if key is not None:
        shift = int(prng.randint(key, (), 0, n))
        idx = nonzero_static(torch.roll(selected, -shift), csp_capacity)
        idx = torch.where(idx >= 0, (idx + shift) % n, idx)
    else:
        idx = nonzero_static(selected, csp_capacity)
    count = torch.clamp(selected.sum(dtype=torch.int32), max=csp_capacity)
    return CspResult(indices=idx.to(torch.int32), count=count,
                     selected=selected)


def _ranges(pq: torch.Tensor, key: torch.Tensor, cfg: AmperConfig):
    """(lo, hi) on ``pq``'s device, and the roll key, for one draw."""
    kv, kroll = prng.split(key)
    lo, hi = fr_intervals(group_representatives(kv, cfg), cfg)
    return lo.to(pq.device), hi.to(pq.device), kroll


def fr_match(pq: torch.Tensor, valid: torch.Tensor, v_rep: torch.Tensor,
             cfg: AmperConfig) -> torch.Tensor:
    """The m-query AMPER-fr match of one table: bool[n] membership.

    ``"broadcast"`` compares in PyTorch; ``"kernel"`` and ``"fused"`` run
    the m-range match kernel (a prefix query with don't-care mask M is
    the inclusive range [q & ~M, (q & ~M) | M], so all modes agree).
    """
    if cfg.fr_mode in ("kernel", "fused"):
        lo, hi = (t.to(pq.device) for t in fr_intervals(v_rep, cfg))
        sel, _counts = ops.multi_query_match(pq, valid, lo, hi)
        return sel
    if cfg.exact_radius:
        vq = qz.quantize(v_rep, cfg.v_max, cfg.frac_bits).to(pq.device)
        radius = fr_radii(v_rep, cfg).to(pq.device)
        match = (pq[None, :] - vq[:, None]).abs() <= radius[:, None]
    else:
        vq, mask = (t.to(pq.device) for t in fr_queries(v_rep, cfg))
        match = qz.ternary_match(pq[None, :], vq[:, None], mask[:, None])
    return match.any(0) & valid


def build_csp_fr(pq: torch.Tensor, valid: torch.Tensor, key: torch.Tensor,
                 cfg: AmperConfig) -> CspResult:
    """AMPER-fr CSP construction (Algorithm 1, lines 2-3, 9-12).  The
    ``"fused"`` mode differs only on the sampling path; an explicit CSP
    build shares the match kernel."""
    kv, kroll = prng.split(key)
    selected = fr_match(pq, valid, group_representatives(kv, cfg), cfg)
    return _compact(selected, cfg.csp_capacity, kroll)


def pick_uniform(bits: torch.Tensor, bound) -> torch.Tensor:
    """Uniform int32 in [0, max(bound, 1)) from raw uint32 bits (int64).

    The one reduction law shared by the reference draw and the fused
    kernel's in-kernel threefry: plain modulo.
    """
    b = torch.as_tensor(bound, device=bits.device).to(torch.int64)
    return (bits % b.clamp(min=1)).to(torch.int32)


def sample_from_csp(csp: CspResult, key: torch.Tensor, batch: int,
                    fallback_size: torch.Tensor) -> torch.Tensor:
    """Algorithm 1 lines 14-17: uniform sample of the CSP, falling back
    to uniform over the live rows when the CSP is empty."""
    dev = csp.indices.device
    k_pick, k_fb = prng.split(key)
    u = pick_uniform(prng.bits(k_pick, (batch,), dev), csp.count)
    picked = csp.indices[u]
    fallback = pick_uniform(prng.bits(k_fb, (batch,), dev), fallback_size)
    return torch.where(csp.count > 0, picked, fallback).to(torch.int32)


def last_writer(idx: torch.Tensor, keep: torch.Tensor | None = None
                ) -> torch.Tensor:
    """For each position of ``idx``, the position of the last occurrence
    of its row (among positions where ``keep`` holds; -1 if none).

    A scatter with duplicate indices has no defined winner on CUDA;
    writing every duplicate with its row's last value makes the winner
    irrelevant, which is the reference's sequential last-write-wins.
    """
    pos = torch.arange(idx.shape[0], device=idx.device)
    same = idx[:, None] == idx[None, :]
    if keep is not None:
        same = same & keep[None, :]
    return torch.where(same, pos[None, :], -1).amax(1)


class AmperState(NamedTuple):
    """Sampler state: quantized priorities + validity mask."""

    pq: torch.Tensor     # int32[capacity]
    valid: torch.Tensor  # bool[capacity]


class AmperSampler:
    """AMPER-fr sampler with the PER-like API (init/update/sample/
    priorities/total).  Priorities given to :meth:`update` are the
    already-exponentiated ``|td|^alpha`` values."""

    def __init__(self, cfg: AmperConfig, variant: str = "fr",
                 device="cuda"):
        if variant != "fr":
            raise NotImplementedError(
                f"AMPER variant {variant!r} is not ported yet (only 'fr')")
        if cfg.fr_mode not in FR_MODES:
            raise ValueError(f"unknown fr_mode {cfg.fr_mode!r} "
                             f"(available: {FR_MODES})")
        self.cfg = cfg
        self.variant = variant
        self.device = resolve_device(device)

    def init(self) -> AmperState:
        n = self.cfg.capacity
        return AmperState(
            pq=torch.zeros(n, dtype=torch.int32, device=self.device),
            valid=torch.zeros(n, dtype=torch.bool, device=self.device))

    def priorities(self, state: AmperState) -> torch.Tensor:
        return (qz.dequantize(state.pq, self.cfg.v_max, self.cfg.frac_bits)
                * state.valid)

    def total(self, state: AmperState) -> torch.Tensor:
        return self.priorities(state).sum()

    def update(self, state: AmperState, idx: torch.Tensor,
               priority: torch.Tensor) -> AmperState:
        """Priority write (a TCAM row write in hardware), in place."""
        w = last_writer(idx)
        p = priority[w]
        state.pq[idx] = qz.quantize(p, self.cfg.v_max, self.cfg.frac_bits)
        state.valid[idx] = p > 0
        return state

    def build_csp(self, state: AmperState, key: torch.Tensor) -> CspResult:
        with span("csp_rebuild"):
            return build_csp_fr(state.pq, state.valid, key, self.cfg)

    def sample(self, state: AmperState, key: torch.Tensor, batch: int,
               stratified: bool = True) -> torch.Tensor:
        del stratified  # CSP sampling is uniform by construction
        kcsp, kpick = prng.split(key)
        if self.cfg.fr_mode == "fused":
            return self._sample_fused(state, kcsp, kpick, batch)
        csp = self.build_csp(state, kcsp)
        live = state.valid.sum(dtype=torch.int32)
        return sample_from_csp(csp, kpick, batch, live)

    def _sample_fused(self, state: AmperState, kcsp: torch.Tensor,
                      kpick: torch.Tensor, batch: int) -> torch.Tensor:
        """The whole draw in the ``amper_sample`` kernel, consuming the
        same key tree as the reference: kcsp -> (kv, kroll) for the
        representatives and the rotation, kpick whole to the kernel."""
        from repro_torch.kernels import ops

        cfg = self.cfg
        if cfg.frac_bits > 24:
            raise ValueError(
                f"fr_mode='fused' needs frac_bits <= 24 (as the reference "
                f"kernel), got {cfg.frac_bits}")
        lo, hi, kroll = _ranges(state.pq, kcsp, cfg)
        shift = int(prng.randint(kroll, (), 0, cfg.capacity))
        idx, _stats = ops.amper_sample(
            state.pq, state.valid, lo, hi, shift, kpick,
            batch=batch, csp_capacity=cfg.csp_capacity)
        return idx


class UniformState(NamedTuple):
    priorities: torch.Tensor  # kept so the API is uniform; not sampled on
    valid: torch.Tensor


class UniformSampler:
    """Uniform ER, the paper's weak baseline."""

    def __init__(self, capacity: int, device="cuda"):
        self.capacity = capacity
        self.device = resolve_device(device)

    def init(self) -> UniformState:
        return UniformState(
            priorities=torch.zeros(self.capacity, dtype=torch.float32,
                                   device=self.device),
            valid=torch.zeros(self.capacity, dtype=torch.bool,
                              device=self.device))

    def priorities(self, state: UniformState) -> torch.Tensor:
        return state.priorities * state.valid

    def total(self, state: UniformState) -> torch.Tensor:
        return self.priorities(state).sum()

    def update(self, state: UniformState, idx: torch.Tensor,
               priority: torch.Tensor) -> UniformState:
        p = priority.to(torch.float32)[last_writer(idx)]
        state.priorities[idx] = p
        state.valid[idx] = p > 0
        return state

    def sample(self, state: UniformState, key: torch.Tensor, batch: int,
               stratified: bool = True) -> torch.Tensor:
        del stratified
        live = state.valid.sum(dtype=torch.int32).clamp(min=1)
        return prng.randint(key, (batch,), 0, live)
