"""Sampler protocol and registry.

Counterpart of ``repro/core/samplers.py``.  Every priority sampler has
the same five methods (init / update / sample / priorities / total) and
is built through :func:`make_sampler`, whose builders accept one shared
kwargs vocabulary and ignore what they do not consume:

  m, lam, lam_fr, csp_ratio, v_max, knn_mode, fr_mode, exact_radius,
  frac_bits -- AMPER hyper-parameters (``lam`` defaults to csp_ratio / 2;
  ``knn_mode``: sort / bisect / hist, default bisect; ``fr_mode``:
  broadcast / interval / window / kernel / fused, all bit-identical);
  csp_capacity -- overrides the csp_ratio-derived CSP size; min_csp --
  floor of the derived size (usually the train batch); device -- where
  the sampler's state lives (default ``"cuda"``).

Seven kinds are registered: ``uniform``, ``per-sumtree``, ``per-cumsum``
(alias ``per``), ``amper-k``, ``amper-fr``, and the sharded fronts
``amper-fr-sharded`` and ``per-sharded`` (``mesh`` and ``axis_names``
besides).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Protocol, runtime_checkable

import torch

from repro_torch.core import quantize as qz
from repro_torch.core.amper import (AmperConfig, AmperSampler,
                                    UniformSampler, last_writer)
from repro_torch.core.per import CumsumPER, SumTreePER
from repro_torch.core.sharded import ShardedAmperSampler, ShardedPERSampler
from repro_torch.distributed.sharding import default_mesh


@runtime_checkable
class Sampler(Protocol):
    """Structural interface every replay-priority sampler implements."""

    def init(self) -> Any: ...

    def update(self, state: Any, idx: torch.Tensor,
               priority: torch.Tensor) -> Any: ...

    def sample(self, state: Any, key: torch.Tensor,
               batch: int) -> torch.Tensor: ...

    def priorities(self, state: Any) -> torch.Tensor: ...

    def total(self, state: Any) -> torch.Tensor: ...


def masked_update(sampler: Sampler, state: Any, idx: torch.Tensor,
                  priority: torch.Tensor, valid: torch.Tensor) -> Any:
    """Out-of-band (deferred) priority write for any registry sampler.

    Rows with ``valid[i] == False`` are rewritten with their current
    priority (a no-op write), and every occurrence of a duplicated row
    carries the value of its last VALID occurrence, so all duplicate
    writes agree and the scatter's winner, undefined on CUDA, is
    irrelevant.
    """
    prios = sampler.priorities(state)
    winner = last_writer(idx, valid)
    value = torch.where(winner >= 0,
                        priority.to(torch.float32)[winner.clamp(min=0)],
                        prios[idx])
    return sampler.update(state, idx, value)


def on_meta(sampler: Sampler) -> Sampler:
    """A copy of ``sampler`` whose state lives on the meta device (every
    shard of a sharded one): its ``init()`` allocates no memory."""
    meta = torch.device("meta")
    twin = copy.copy(sampler)
    twin.device = meta
    if hasattr(twin, "devices"):
        twin.devices = [meta] * len(twin.devices)
    return twin


def abstract_state(sampler: Sampler) -> Any:
    """``sampler.init()`` on the meta device: the state's names, shapes
    and dtypes, with no memory.  It is the checkpoint-restore target for
    any registry kind (:mod:`repro_torch.train.replay_checkpoint`).  A
    sharded sampler's is its dense view (``to_dense``), the one global
    table a checkpoint holds."""
    twin = on_meta(sampler)
    state = twin.init()
    return twin.to_dense(state) if hasattr(twin, "to_dense") else state


_REGISTRY: dict[str, Callable[..., Sampler]] = {}


def register_sampler(name: str, *aliases: str):
    """Decorator: register ``builder(capacity, **kw) -> Sampler``."""

    def deco(builder):
        for n in (name, *aliases):
            _REGISTRY[n] = builder
        return builder

    return deco


def available_samplers() -> list[str]:
    return sorted(_REGISTRY)


def make_sampler(kind: str, capacity: int, **kw) -> Sampler:
    """Build a sampler by registry name (unknown kwargs are ignored)."""
    try:
        builder = _REGISTRY[kind]
    except KeyError:
        raise ValueError(f"unknown sampler kind: {kind!r} "
                         f"(available: {available_samplers()})") from None
    return builder(capacity, **kw)


@register_sampler("uniform")
def _build_uniform(capacity: int, *, device="cuda", **_unused) -> Sampler:
    return UniformSampler(capacity, device=device)


@register_sampler("per-sumtree")
def _build_sumtree(capacity: int, *, device="cuda", **_unused) -> Sampler:
    return SumTreePER(capacity, device=device)


@register_sampler("per-cumsum", "per")
def _build_cumsum(capacity: int, *, device="cuda", **_unused) -> Sampler:
    return CumsumPER(capacity, device=device)


def _amper_config(capacity: int, *, m: int = 20, lam_fr: float = 2.0,
                  csp_ratio: float = 0.15, lam: float | None = None,
                  v_max: float = 1.0, csp_capacity: int | None = None,
                  min_csp: int = 64, knn_mode: str = "bisect",
                  fr_mode: str = "broadcast", exact_radius: bool = False,
                  frac_bits: int | None = None, **_unused) -> AmperConfig:
    """The one place the kwargs vocabulary becomes an AmperConfig."""
    return AmperConfig(
        capacity=capacity, m=m, lam_fr=lam_fr,
        lam=csp_ratio / 2.0 if lam is None else lam, v_max=v_max,
        csp_capacity=(csp_capacity if csp_capacity is not None
                      else max(int(capacity * csp_ratio), min_csp)),
        frac_bits=qz.DEFAULT_FRAC_BITS if frac_bits is None else frac_bits,
        exact_radius=exact_radius, knn_mode=knn_mode, fr_mode=fr_mode)


@register_sampler("amper-k")
def _build_amper_k(capacity: int, *, device="cuda", **kw) -> Sampler:
    return AmperSampler(_amper_config(capacity, **kw), variant="k",
                        device=device)


@register_sampler("amper-fr")
def _build_amper_fr(capacity: int, *, device="cuda", **kw) -> Sampler:
    return AmperSampler(_amper_config(capacity, **kw), variant="fr",
                        device=device)


@register_sampler("amper-fr-sharded")
def _build_amper_fr_sharded(capacity: int, *, mesh=None,
                            axis_names=("pod", "data"),
                            local_csp_capacity: int | None = None,
                            device="cuda", **kw) -> Sampler:
    return ShardedAmperSampler(
        _amper_config(capacity, **kw),
        mesh if mesh is not None else default_mesh(device),
        axis_names=axis_names, local_csp_capacity=local_csp_capacity)


@register_sampler("per-sharded")
def _build_per_sharded(capacity: int, *, mesh=None,
                       axis_names=("pod", "data"), device="cuda",
                       **_unused) -> Sampler:
    return ShardedPERSampler(
        capacity, mesh if mesh is not None else default_mesh(device),
        axis_names=axis_names)
