"""Prioritized Experience Replay baselines and importance-sampling weights.

Counterpart of ``repro/core/per.py``: the two PER samplers the paper
compares AMPER with (Sec. 2.1 / Fig. 2), the IS-exponent schedule and
the one weight formula every sampling path shares.

* :class:`SumTreePER` -- the array-backed sum tree: O(log n) descent per
  draw and a leaf-to-root delta walk per update, kept as the reference
  writes them (a rebuild of parents from their children would round
  differently).
* :class:`CumsumPER` -- prefix sum + ``searchsorted``, the same law in
  O(n) data-parallel work.

Both draw with P(i) = p_i / sum_k p_k over already-exponentiated
priorities, stratified (one uniform per batch segment) by default.  The
uniforms come from :mod:`repro_torch.prng` on the host; everything that
reads the table stays on its device.  Updates write in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import prng, resolve_device
from repro_torch.core.amper import last_writer
from repro_torch.xla_float import div_const


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _targets(key: torch.Tensor, total: torch.Tensor, batch: int,
             stratified: bool) -> torch.Tensor:
    """Draw targets in [0, total): ``(arange + u) * (total / batch)``
    stratified, else ``u * total``.  The constant divisor is a multiply
    by its float32 reciprocal, as the jitted reference computes it."""
    u = prng.uniform(key, (batch,), device=total.device)
    if stratified:
        pos = torch.arange(batch, dtype=torch.float32, device=total.device)
        return (pos + u) * div_const(total, batch)
    return u * total


class SumTreeState(NamedTuple):
    """Array-backed sum tree: ``tree[1]`` is the root, leaves sit at
    ``[n_pow2, n_pow2 + capacity)``."""

    tree: torch.Tensor      # float32[2 * n_pow2]
    n_leaves: torch.Tensor  # int32 scalar


class SumTreePER:
    """Faithful sum-tree PER (Fig. 2(c))."""

    def __init__(self, capacity: int, device="cuda"):
        self.capacity = capacity
        self.n_pow2 = _next_pow2(capacity)
        self.depth = self.n_pow2.bit_length() - 1  # levels below the root
        self.device = resolve_device(device)

    def init(self) -> SumTreeState:
        return SumTreeState(
            tree=torch.zeros(2 * self.n_pow2, dtype=torch.float32,
                             device=self.device),
            n_leaves=torch.tensor(self.capacity, dtype=torch.int32,
                                  device=self.device))

    def total(self, state: SumTreeState) -> torch.Tensor:
        return state.tree[1]

    def priorities(self, state: SumTreeState) -> torch.Tensor:
        return state.tree[self.n_pow2:self.n_pow2 + self.capacity]

    def update(self, state: SumTreeState, idx: torch.Tensor,
               priority: torch.Tensor) -> SumTreeState:
        """Set the priorities at ``idx``: per-level delta scatter-adds from
        the leaves to the root, in place.  Only the last occurrence of a
        duplicated row carries its delta, as in the reference."""
        tree = state.tree
        idx = idx.to(torch.int64)
        leaf = idx + self.n_pow2
        delta = priority.to(torch.float32) - tree[leaf]
        order = torch.arange(1, idx.shape[0] + 1, device=idx.device)
        last = torch.zeros(self.capacity, dtype=torch.int64,
                           device=idx.device).scatter_reduce_(
                               0, idx, order, "amax")
        delta = torch.where(last[idx] == order, delta,
                            torch.zeros_like(delta))
        node = leaf
        for _ in range(self.depth + 1):  # leaf level up to the root
            tree.index_add_(0, node, delta)
            node = node // 2
        return state

    def sample(self, state: SumTreeState, key: torch.Tensor, batch: int,
               stratified: bool = True) -> torch.Tensor:
        """Draw ``batch`` leaf indices by stochastic descent (Fig. 2(c))."""
        tree = state.tree
        total = torch.clamp(tree[1], min=1e-12)
        rem = _targets(key, total, batch, stratified)
        node = torch.ones(batch, dtype=torch.int64, device=tree.device)
        for _ in range(self.depth):
            left = 2 * node
            lsum = tree[left]
            go_left = rem < lsum
            node = torch.where(go_left, left, left + 1)
            rem = torch.where(go_left, rem, rem - lsum)
        return torch.clamp(node - self.n_pow2, 0,
                           self.capacity - 1).to(torch.int32)


class CumsumState(NamedTuple):
    priorities: torch.Tensor  # float32[capacity]


class CumsumPER:
    """Vector-machine PER: cumulative sum + searchsorted (same law)."""

    def __init__(self, capacity: int, device="cuda"):
        self.capacity = capacity
        self.device = resolve_device(device)

    def init(self) -> CumsumState:
        return CumsumState(priorities=torch.zeros(
            self.capacity, dtype=torch.float32, device=self.device))

    def total(self, state: CumsumState) -> torch.Tensor:
        return state.priorities.sum()

    def priorities(self, state: CumsumState) -> torch.Tensor:
        return state.priorities

    def update(self, state: CumsumState, idx: torch.Tensor,
               priority: torch.Tensor) -> CumsumState:
        state.priorities[idx] = priority.to(torch.float32)[last_writer(idx)]
        return state

    def sample(self, state: CumsumState, key: torch.Tensor, batch: int,
               stratified: bool = True) -> torch.Tensor:
        c = torch.cumsum(state.priorities, 0)
        target = _targets(key, torch.clamp(c[-1], min=1e-12), batch,
                          stratified)
        idx = torch.searchsorted(c, target, right=True)
        return torch.clamp(idx, 0, self.capacity - 1).to(torch.int32)


def beta_schedule(beta0: float, beta_end: float, step: int,
                  horizon: int) -> torch.Tensor:
    """Linearly annealed IS exponent beta(t) (Schaul et al. Sec. 3.4),
    clamped at ``beta_end`` past ``horizon``."""
    frac = torch.clamp(torch.tensor(step, dtype=torch.float32)
                       / max(horizon, 1), 0.0, 1.0)
    return beta0 + (beta_end - beta0) * frac


def importance_from_selected(p_sel: torch.Tensor, total: torch.Tensor,
                             size, beta) -> torch.Tensor:
    """PER IS weights from already-gathered priorities (Schaul et al. Eq. 2):
    ``w = (size * p / total)^-beta``, max-normalised."""
    total = torch.clamp(total, min=1e-12)
    p = torch.clamp(p_sel, min=1e-12) / total
    size = torch.as_tensor(size, dtype=torch.float32, device=p.device)
    w = (size * p) ** (-torch.as_tensor(beta, device=p.device))
    return w / torch.clamp(w.max(), min=1e-12)


def importance_weights(priorities: torch.Tensor, idx: torch.Tensor, size,
                       beta) -> torch.Tensor:
    """PER importance-sampling weights, max-normalised."""
    return importance_from_selected(priorities[idx], priorities.sum(), size,
                                    beta)
