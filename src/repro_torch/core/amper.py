"""AMPER: associative-memory-based prioritized experience replay.

Counterpart of ``repro/core/amper.py``: both paper variants of
Algorithm 1 and the uniform baseline.

* AMPER-fr (:func:`build_csp_fr`): one prefix or exact-radius range
  query per group (Fig. 6(b2)).
* AMPER-k (:func:`build_csp_k`): the N_i nearest stored priorities per
  group representative (Eqn. 1).  ``knn_mode`` picks how: ``"sort"``
  ranks every row by distance (the oracle; ties by index), ``"bisect"``
  bisects a per-group radius on match counts over the (m, n) distance
  table, and ``"hist"`` bisects on a shared 4096-bin cumulative
  histogram.  Bisect and hist trim a tie at the final radius by index
  order, so the three modes need not select the same rows.  The
  reference has no Pallas kernel for AMPER-k; it is plain PyTorch on
  the table's device, with static shapes and no host sync.

The m group representatives, their queries and the compaction rotation
depend only on PRNG keys, never on the table, so they are computed on
the host (:mod:`repro_torch.prng` keys live there) and only the m
ranges travel to the table's device.  Everything that reads the table
stays on its device with static shapes: ``jnp.nonzero(size=...)``
becomes a cumsum plus scatter, so a draw never waits on the device.

``fr_mode`` picks the AMPER-fr implementation, and all five give
bit-identical CSPs, indices and weights:

* ``"broadcast"`` -- the (m, n) ternary compare, written in PyTorch;
* ``"interval"``  -- one sorted pass of the 2m range boundaries and a
  binary search per row (interval stabbing);
* ``"window"``    -- per row, only the ranges of the ceil(2 lambda')
  neighbouring value groups;
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

FR_MODES = ("broadcast", "interval", "window", "kernel", "fused")
KNN_MODES = ("sort", "bisect", "hist")
_FAR = 2 ** 30   # distance of a row that is not live: beyond every radius


class AmperConfig(NamedTuple):
    """Hyper-parameters of Algorithm 1.

    Attributes:
      capacity: replay size n (number of priority rows).
      m: number of groups (Fig. 9 uses 20).
      lam: scaling factor lambda of Eqn. 1 (AMPER-k).
      lam_fr: scaling factor lambda' of Eqn. 4 (AMPER-fr).
      v_max: static maximum priority value V_max.
      csp_capacity: static CSP buffer size (CSP ratio * capacity).
      frac_bits: fixed-point fraction bits of the int32 quantization.
      exact_radius: compare ``|p - V| <= Delta`` exactly instead of the
        power-of-2 prefix approximation (beyond-paper mode, AMPER-fr).
      knn_mode: "sort", "bisect" or "hist" (AMPER-k; module docstring).
      fr_mode: one of ``FR_MODES`` (AMPER-fr; module docstring).
    """

    capacity: int
    m: int = 20
    lam: float = 0.05
    lam_fr: float = 1.0
    v_max: float = 1.0
    csp_capacity: int = 1500
    frac_bits: int = qz.DEFAULT_FRAC_BITS
    exact_radius: bool = False
    knn_mode: str = "sort"
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

    ``"broadcast"`` compares in PyTorch; ``"interval"`` and ``"window"``
    test the m inclusive ranges another way; ``"kernel"`` and ``"fused"``
    run the m-range match kernel (a prefix query with don't-care mask M is
    the inclusive range [q & ~M, (q & ~M) | M], so all modes agree).
    """
    if cfg.fr_mode in ("interval", "window", "kernel", "fused"):
        lo, hi = (t.to(pq.device) for t in fr_intervals(v_rep, cfg))
        if cfg.fr_mode == "interval":
            return _interval_membership(pq, lo, hi) & valid
        if cfg.fr_mode == "window":
            return _window_membership(pq, lo, hi, cfg) & valid
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


def _interval_membership(pq: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor) -> torch.Tensor:
    """Is each row inside the union of the ranges [lo_i, hi_i]?

    Interval stabbing: sort the 2m boundary events (+1 at lo, -1 at
    hi + 1), prefix-sum them into the coverage depth after each event,
    and read each row's depth off one binary search.
    """
    m = lo.shape[0]
    pts = torch.cat([lo, hi + 1])
    wts = torch.cat([torch.ones(m, dtype=torch.int32, device=lo.device),
                     -torch.ones(m, dtype=torch.int32, device=lo.device)])
    order = torch.argsort(pts, stable=True)
    pts, depth = pts[order], torch.cumsum(wts[order], 0)
    idx = torch.searchsorted(pts, pq, right=True) - 1
    return (idx >= 0) & (depth[idx.clamp(0, 2 * m - 1)] > 0)


def _window_membership(pq: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                       cfg: AmperConfig) -> torch.Tensor:
    """Range membership from the neighbouring groups only.

    Group i's range holds V(g_i), which lies in value group i, and is at
    most 2 lambda' group widths wide, so a row of value group g can only
    be matched by the groups within ceil(2 lambda') of g.
    """
    g = _value_group(pq, cfg)
    c = int(-(-2 * cfg.lam_fr // 1))   # ceil(2 lambda')
    sel = torch.zeros(pq.shape, dtype=torch.bool, device=pq.device)
    for j in range(-c, c + 1):
        gi = (g + j).clamp(0, cfg.m - 1)
        sel |= (pq >= lo[gi]) & (pq <= hi[gi])
    return sel


def _value_group(pq: torch.Tensor, cfg: AmperConfig) -> torch.Tensor:
    """The value group (of m equal slices of the code range) of each row."""
    width_q = max((1 << cfg.frac_bits) // cfg.m, 1)
    return (pq // width_q).clamp(0, cfg.m - 1)


def build_csp_fr(pq: torch.Tensor, valid: torch.Tensor, key: torch.Tensor,
                 cfg: AmperConfig) -> CspResult:
    """AMPER-fr CSP construction (Algorithm 1, lines 2-3, 9-12).  The
    ``"fused"`` mode differs only on the sampling path; an explicit CSP
    build shares the match kernel."""
    kv, kroll = prng.split(key)
    selected = fr_match(pq, valid, group_representatives(kv, cfg), cfg)
    return _compact(selected, cfg.csp_capacity, kroll)


def group_counts(pq: torch.Tensor, valid: torch.Tensor, cfg: AmperConfig
                 ) -> torch.Tensor:
    """Line 5 of Algorithm 1: C(g_i), the live rows per value group, as
    int32[m] (an integer scatter-add, exact on any device)."""
    return torch.zeros(cfg.m, dtype=torch.int32, device=pq.device
                       ).index_add_(0, _value_group(pq, cfg),
                                    valid.to(torch.int32))


def knn_sizes(v_rep: torch.Tensor, counts: torch.Tensor, cfg: AmperConfig
              ) -> torch.Tensor:
    """Eqn. 1: N_i = round(lambda V(g_i) C(g_i)), in float32, half to
    even, as int32[m] on ``counts``' device."""
    lam_v = torch.tensor(cfg.lam, dtype=torch.float32) * v_rep
    return torch.round(_to_device(lam_v, counts.device)
                       * counts.to(torch.float32)).to(torch.int32)


def _to_device(x: torch.Tensor, device) -> torch.Tensor:
    """A small host tensor copied to ``device`` without waiting for the
    work queued there (a pageable copy is staged before the call returns,
    so the host tensor may be freed at once)."""
    return x.to(device, non_blocking=True)


def _distances(pq: torch.Tensor, valid: torch.Tensor, vq: torch.Tensor
               ) -> torch.Tensor:
    """int32[m, n] |p - V_i| per group, ``_FAR`` at rows that are not live."""
    return torch.where(valid[None, :], (pq[None, :] - vq[:, None]).abs(),
                       _FAR)


def _trim_in_index_order(within: torch.Tensor, n_i: torch.Tensor
                         ) -> torch.Tensor:
    """Keep the first N_i selected rows of each group, in index order."""
    order = torch.cumsum(within, 1, dtype=torch.int32)
    return within & (order <= n_i[:, None])


def _bisect(count_within, n_i: torch.Tensor, frac_bits: int) -> torch.Tensor:
    """The least radius r in [0, 2^frac_bits] with count_within(r) >= N_i,
    per group: ``frac_bits + 1`` rounds on int32 device tensors (the
    reference's ``lax.scan``), with no host sync."""
    lo = torch.zeros_like(n_i)
    hi = torch.full_like(n_i, 1 << frac_bits)
    for _ in range(frac_bits + 1):
        mid = (lo + hi) // 2
        enough = count_within(mid) >= n_i
        lo = torch.where(enough, lo, mid + 1)
        hi = torch.where(enough, mid, hi)
    return lo


def _knn_select_sort(pq: torch.Tensor, valid: torch.Tensor, vq: torch.Tensor,
                     n_i: torch.Tensor) -> torch.Tensor:
    """Oracle kNN: per group, the N_i nearest live rows, bool[m, n].  A
    stable sort breaks distance ties by index."""
    order = torch.argsort(_distances(pq, valid, vq), dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(pq.shape[0], device=pq.device
                               ).expand_as(order))
    return (rank < n_i[:, None]) & valid[None, :]


def _knn_select_bisect(pq: torch.Tensor, valid: torch.Tensor,
                       vq: torch.Tensor, n_i: torch.Tensor,
                       frac_bits: int) -> torch.Tensor:
    """kNN by radius bisection on match counts over the distance table
    (built once a draw); a tie at the final radius is trimmed by index
    order, so each group keeps exactly min(N_i, live) rows."""
    dist = _distances(pq, valid, vq)
    radius = _bisect(lambda r: (dist <= r[:, None]).sum(1, dtype=torch.int32),
                     n_i, frac_bits)
    return _trim_in_index_order(dist <= radius[:, None], n_i)


def _knn_select_hist(pq: torch.Tensor, valid: torch.Tensor, vq: torch.Tensor,
                     n_i: torch.Tensor, frac_bits: int,
                     hist_bins: int = 4096) -> torch.Tensor:
    """kNN by bisection on a shared cumulative histogram of the values.

    The count of a radius is a lower bound (only bins wholly inside
    [V - r, V + r] count), so the radius found can only over-select; the
    trim in index order then cuts each group back to N_i.
    """
    shift = frac_bits - (hist_bins.bit_length() - 1)
    bucket = (pq >> shift).clamp(0, hist_bins - 1)
    cum = torch.cumsum(torch.zeros(hist_bins, dtype=torch.int32,
                                   device=pq.device)
                       .index_add_(0, bucket, valid.to(torch.int32)),
                       0, dtype=torch.int32)
    binsz = 1 << shift

    def count_within(r):
        lo_b = ((vq - r + binsz - 1) >> shift).clamp(0, hist_bins)
        hi_b = (((vq + r + 1) >> shift) - 1).clamp(-1, hist_bins - 1)
        below = torch.where(lo_b > 0, cum[(lo_b - 1).clamp(0, hist_bins - 1)],
                            0)
        inside = cum[hi_b.clamp(0, hist_bins - 1)] - below
        return torch.where(hi_b >= lo_b, inside, 0)

    radius = _bisect(count_within, n_i, frac_bits)
    return _trim_in_index_order(
        _distances(pq, valid, vq) <= radius[:, None], n_i)


def build_csp_k(pq: torch.Tensor, valid: torch.Tensor, key: torch.Tensor,
                cfg: AmperConfig) -> CspResult:
    """AMPER-k CSP construction (Algorithm 1, lines 2-8)."""
    kv, kroll = prng.split(key)
    v_rep = group_representatives(kv, cfg)
    vq = _to_device(qz.quantize(v_rep, cfg.v_max, cfg.frac_bits), pq.device)
    n_i = knn_sizes(v_rep, group_counts(pq, valid, cfg), cfg)
    if cfg.knn_mode == "bisect":
        sel = _knn_select_bisect(pq, valid, vq, n_i, cfg.frac_bits)
    elif cfg.knn_mode == "hist":
        sel = _knn_select_hist(pq, valid, vq, n_i, cfg.frac_bits)
    else:
        sel = _knn_select_sort(pq, valid, vq, n_i)
    return _compact(sel.any(0) & valid, cfg.csp_capacity, kroll)


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
    """AMPER sampler (``variant`` "fr" or "k") with the PER-like API
    (init/update/sample/priorities/total).  Priorities given to
    :meth:`update` are the already-exponentiated ``|td|^alpha`` values.
    ``fr_mode`` applies to AMPER-fr only, ``knn_mode`` to AMPER-k."""

    def __init__(self, cfg: AmperConfig, variant: str = "fr",
                 device="cuda"):
        if variant not in ("fr", "k"):
            raise ValueError(f"unknown AMPER variant: {variant!r}")
        if cfg.fr_mode not in FR_MODES:
            raise ValueError(f"unknown fr_mode {cfg.fr_mode!r} "
                             f"(available: {FR_MODES})")
        if cfg.knn_mode not in KNN_MODES:
            raise ValueError(f"unknown knn_mode {cfg.knn_mode!r} "
                             f"(available: {KNN_MODES})")
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
        fn = build_csp_fr if self.variant == "fr" else build_csp_k
        with span("csp_rebuild"):
            return fn(state.pq, state.valid, key, self.cfg)

    def sample(self, state: AmperState, key: torch.Tensor, batch: int,
               stratified: bool = True) -> torch.Tensor:
        del stratified  # CSP sampling is uniform by construction
        kcsp, kpick = prng.split(key)
        if self.variant == "fr" and self.cfg.fr_mode == "fused":
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
