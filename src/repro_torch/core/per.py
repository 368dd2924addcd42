"""Importance-sampling weights of prioritized replay.

Counterpart of ``repro/core/per.py``: the IS-exponent schedule and the
one weight formula every sampling path shares.  The sum-tree and cumsum
PER samplers wait for a later slice of the port.
"""
from __future__ import annotations

import torch


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
