"""Replay-health probes: the Fig. 7 divergences, live.

Counterpart of ``repro/obs/probes.py``:

* :data:`BINS`, :func:`priority_bin_counts`, :func:`kl_nats` and
  :func:`chi_square` are the sampled-priority binning and divergences,
  so that the port's Fig. 7 twin and the reference's study compute the
  same numbers from the same counts (numpy, on the host).
* :class:`SamplingErrorMonitor` keeps a windowed histogram of sampled
  priorities and reports KL / chi-square against the exact PER law as
  gauges: Fig. 7 as a dashboard line.
* :func:`make_replay_probe` re-derives one production draw off the hot
  path: given the sampler state and key the draw used, it replays the
  draw's key tree (split into (csp, pick), ``build_csp``, the uniform
  pick with its fallback), so its CSP counts and sampled priorities are
  that draw's.  For AMPER-fr in the ``kernel`` and ``fused`` modes the
  CSP build runs the ``multi_query_match`` kernel.
* :class:`ReplayHealth` writes the probe's readings into registry
  instruments.  It reads them to the host when it is called, never on
  the learn step.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.obs.metrics import Registry

# Sampled-PRIORITY histogram over (0, 1): Fig. 7(a) compares the
# distributions of sampled priority values, not per-item frequencies.
BINS = 64


def priority_bin_counts(values) -> np.ndarray:
    """The canonical binning: counts of sampled priorities over (0, 1)."""
    return np.histogram(np.asarray(values), bins=BINS, range=(0.0, 1.0))[0]


def kl_nats(p_counts, q_counts) -> float:
    """Total KL over the sample (binned counts, Laplace smoothed), as
    ``n * KL(p || q)`` nats to match the magnitudes of the paper's Fig. 7."""
    p_counts = np.asarray(p_counts, dtype=float)
    q_counts = np.asarray(q_counts, dtype=float)
    n_samples = p_counts.sum()
    p = (p_counts + 0.5) / (p_counts.sum() + 0.5 * len(p_counts))
    q = (q_counts + 0.5) / (q_counts.sum() + 0.5 * len(q_counts))
    return float(n_samples * np.sum(p * np.log(p / q)))


def chi_square(p_counts, q_counts) -> float:
    """Pearson chi-square of observed counts against the reference
    distribution (the same Laplace smoothing as :func:`kl_nats`)."""
    p_counts = np.asarray(p_counts, dtype=float)
    q_counts = np.asarray(q_counts, dtype=float)
    n = p_counts.sum()
    if n == 0:
        return 0.0
    q = (q_counts + 0.5) / (q_counts.sum() + 0.5 * len(q_counts))
    expected = n * q
    return float(np.sum((p_counts - expected) ** 2 / expected))


class SamplingErrorMonitor:
    """Windowed sampling-error monitor: Fig. 7 as a live gauge.

    Keeps bin counts of the last ``window`` observed draws (each draw one
    batch of sampled priorities) and compares them against a reference
    distribution, by default uniform until told better: usually the
    exact PER law, whose bin masses are the priority mass per bin.  The
    divergences are :func:`kl_nats` / :func:`chi_square` on the same
    binning as the offline Fig. 7 study, so the two agree exactly on
    identical draws.
    """

    def __init__(self, registry: Optional[Registry] = None,
                 window: int = 200, prefix: str = "sampling"):
        self.window = int(window)
        self._draws: deque[np.ndarray] = deque()
        self._counts = np.zeros(BINS, dtype=float)
        self._ref = np.ones(BINS, dtype=float)  # uniform until told better
        self._kl_gauge = self._chi2_gauge = self._n_gauge = None
        if registry is not None:
            self._kl_gauge = registry.gauge(
                f"{prefix}_kl_nats",
                help="windowed KL of sampled priorities vs exact PER law "
                     "(total nats, Fig. 7 convention)")
            self._chi2_gauge = registry.gauge(
                f"{prefix}_chi2",
                help="windowed chi-square of sampled priorities vs ref law")
            self._n_gauge = registry.gauge(
                f"{prefix}_window_samples",
                help="samples currently inside the monitor window")

    def set_reference_counts(self, q_counts) -> None:
        """Install reference bin counts or masses (any scale)."""
        self._ref = np.asarray(q_counts, dtype=float).copy()

    def set_reference_priorities(self, priorities) -> None:
        """The exact-PER-law reference of a live priority vector: bin
        mass b = sum of the priorities falling in bin b."""
        p = np.asarray(priorities, dtype=float)
        p = p[p > 0]
        self.set_reference_counts(
            np.histogram(p, bins=BINS, range=(0.0, 1.0), weights=p)[0])

    def observe(self, sampled_priorities) -> None:
        """Record one draw's sampled priority values and refresh gauges."""
        c = priority_bin_counts(sampled_priorities).astype(float)
        self._draws.append(c)
        self._counts += c
        while len(self._draws) > self.window:
            self._counts -= self._draws.popleft()
        if self._kl_gauge is not None:
            self._kl_gauge.set(self.kl())
            self._chi2_gauge.set(self.chi_square())
            self._n_gauge.set(self._counts.sum())

    @property
    def counts(self) -> np.ndarray:
        return self._counts.copy()

    def kl(self) -> float:
        return kl_nats(self._counts, self._ref)

    def chi_square(self) -> float:
        return chi_square(self._counts, self._ref)


def make_replay_probe(sampler, batch: int):
    """A probe of one draw: ``probe(sampler_state, key)``.

    For samplers with ``build_csp`` (AMPER-k, AMPER-fr) it replays the
    key tree of :meth:`AmperSampler.sample`: split into (csp, pick),
    build the CSP, uniform pick with fallback; every ``fr_mode``, the
    fused draw included, draws the same rows from the same key, so the
    outputs describe the production draw exactly.  Returns
    ``(match_count, csp_count, live, fallback, sampled_priorities,
    ref_mass)`` as tensors on the sampler's device; ``ref_mass`` is the
    exact-PER-law bin mass of the live priorities, for
    :class:`SamplingErrorMonitor`.

    Other samplers (PER, uniform and the sharded kinds) get a reduced
    probe: live size and sampled priorities, through ``sample``.

    Priorities are divided by the sampler's ``cfg.v_max`` (1 where it has
    none) so that the (0, 1) binning covers the live priority scale.
    """
    from repro_torch import prng
    from repro_torch.core.amper import sample_from_csp

    v_max = float(getattr(getattr(sampler, "cfg", None), "v_max", 0.0)
                  or 1.0)

    def ref_mass(prio):
        p = prio / v_max
        b = torch.clamp((p * BINS).to(torch.int32), 0, BINS - 1)
        return torch.zeros(BINS, dtype=torch.float32, device=p.device
                           ).index_add_(0, b.to(torch.int64),
                                        torch.where(p > 0, p,
                                                    torch.zeros_like(p)))

    if hasattr(sampler, "build_csp"):
        def probe(state, key):
            kcsp, kpick = prng.split(key)
            csp = sampler.build_csp(state, kcsp)
            live = state.valid.sum(dtype=torch.int32)
            idx = sample_from_csp(csp, kpick, batch, live)
            prio = sampler.priorities(state)
            match = csp.selected.sum(dtype=torch.int32)
            return (match, csp.count, live,
                    (csp.count == 0).to(torch.int32),
                    prio[idx.to(torch.int64)] / v_max, ref_mass(prio))

        return probe

    def probe(state, key):
        prio = sampler.priorities(state)
        live = (prio > 0).sum(dtype=torch.int32)
        idx = sampler.sample(state, key, batch)
        zero = torch.zeros((), dtype=torch.int32, device=prio.device)
        return (zero, zero, live, zero, prio[idx.to(torch.int64)] / v_max,
                ref_mass(prio))

    return probe


class ReplayHealth:
    """Bridges probe outputs into registry instruments.

    Construct once per run and call :meth:`update` at a chosen cadence
    with the sampler state and key a production draw used.  The probe is
    its own computation, off the learn step; the gauge writes are
    lock-free registry updates.
    """

    def __init__(self, registry: Registry, sampler, batch: int,
                 window: int = 200):
        self._probe = make_replay_probe(sampler, batch)
        self._csp_capacity = getattr(
            getattr(sampler, "cfg", None), "csp_capacity", 0)
        self._has_csp = hasattr(sampler, "build_csp")
        self.monitor = SamplingErrorMonitor(registry, window=window)
        r = registry
        self._g_count = r.gauge("csp_count",
                                help="CSP fill for last probed draw")
        self._g_occ = r.gauge("csp_occupancy",
                              help="CSP fill / csp_capacity (0..1)")
        self._g_match = r.gauge("csp_match_count",
                                help="TCAM match count before compaction")
        self._g_live = r.gauge("replay_live", help="live replay rows")
        self._c_fallback = r.counter(
            "fallback_draws", help="probed draws that fell back to uniform")
        self._c_probes = r.counter("probe_draws", help="probed draws")

    def update(self, state, key) -> dict:
        """Probe one draw; returns the host-side probe readings."""
        match, count, live, fallback, p_sel, ref = self._probe(state, key)
        match, count, live, fallback = (int(match), int(count), int(live),
                                        int(fallback))
        self._g_live.set(live)
        if self._has_csp:
            self._g_count.set(count)
            self._g_match.set(match)
            if self._csp_capacity:
                self._g_occ.set(count / self._csp_capacity)
        self._c_probes.add()
        if fallback:
            self._c_fallback.add()
        self.monitor.set_reference_counts(ref.cpu().numpy())
        # Clip into [0, 1] so normalised priorities at exactly the scale
        # ceiling bin with the reference's top-bin clamp (np.histogram's
        # last bin is right-closed).
        self.monitor.observe(np.clip(p_sel.cpu().numpy(), 0.0, 1.0))
        return {"match_count": match, "csp_count": count, "live": live,
                "fallback": fallback, "kl_nats": self.monitor.kl()}
