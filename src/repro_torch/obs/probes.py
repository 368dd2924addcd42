"""Sampled-priority binning and divergences (the Fig. 7 study).

Counterpart of the host-side definitions of ``repro/obs/probes.py``:
:data:`BINS`, :func:`priority_bin_counts`, :func:`kl_nats` and
:func:`chi_square`, so that the port's Fig. 7 twin and the reference's
study compute the same numbers from the same counts.  They work on
numpy arrays on the host.
"""
from __future__ import annotations

import numpy as np

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
